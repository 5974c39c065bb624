"""Double-buffered device prefetcher: overlap host->device with compute.

Port of ``horovod_tpu/data/prefetch.py``.  The transfer of batch N+1
must run while batch N computes, or every step pays ``transfer +
compute`` instead of ``max(transfer, compute)``.  A background thread
stages batches into a bounded queue ahead of the training thread; where
the JAX package calls ``jax.device_put``, each array here is copied
from pinned host memory on a side CUDA stream, and an event recorded
after the copies travels with the batch:

* the consumer's stream waits on that event when the batch is delivered
  (the copy and the step are ordered on the card, the host never
  blocks on the copy);
* every staged tensor is ``record_stream``-ed on the consumer's stream,
  so the caching allocator does not hand its memory to the side stream
  again while the step still reads it (the tensor was allocated on the
  side stream);
* the pinned source of a ``non_blocking`` copy is kept by PyTorch's
  host allocator until the copy completes.

``depth`` (``HVD_TPU_PREFETCH_DEPTH``, default 2) is the double buffer;
``depth=0`` stages synchronously on the consumer's thread (the A/B
baseline).  ``device_put=False`` yields CPU tensors; ``device`` (default
the rank's card, raising without one) says where the others go, and
``device="cpu"`` yields CPU tensors too.  ``cast`` (e.g. ``"bfloat16"``)
casts the floating arrays on the host before the copy; integer arrays
(labels) pass through.  Every batch comes out as a tuple of tensors.

Instrumented like the reference: queue-depth gauge, host-wait (input
starvation) and produce/transfer histograms, ``data.*`` trace spans,
the ``data.prefetch`` chaos site, and the local counters in
:meth:`DevicePrefetcher.stats`.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .. import chaos as _chaos
from .. import trace
from ..metrics import instruments as _instr

__all__ = ["DevicePrefetcher", "prefetch_to_device", "default_prefetch_depth"]

#: Env knob: staged device batches (0 = prefetch off, synchronous puts).
PREFETCH_ENV = "HVD_TPU_PREFETCH_DEPTH"

_SENTINEL = object()


def default_prefetch_depth() -> int:
    env = os.environ.get(PREFETCH_ENV)
    if env is not None:
        n = int(env)
        if n < 0:
            raise ValueError(f"{PREFETCH_ENV} must be >= 0, got {n}")
        return n
    return 2


def _cast_dtype(cast) -> Optional[torch.dtype]:
    if cast is None or isinstance(cast, torch.dtype):
        return cast
    dtype = getattr(torch, str(cast), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"cast must name a floating torch dtype, got "
                         f"{cast!r}")
    return dtype


def _host_tensors(batch, dtype: Optional[torch.dtype]):
    """A host batch as CPU tensors, floating arrays cast to ``dtype``
    (halves the bytes that cross PCIe for bf16)."""
    out = []
    for a in batch:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return tuple(out)


def _resolve_target(device) -> torch.device:
    """The batches' device: ``device``, else the rank's card (raising
    without one)."""
    from ..common import basics
    from ..common.device import resolve_device

    if device is None and basics.is_initialized():
        return basics.device()
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"batches go to a CUDA device or the CPU, not "
                         f"{dev}")
    return dev


class _Staged:
    """One batch on the card: its tensors and the event after their
    copies (None when no copy ran on a side stream)."""

    __slots__ = ("tensors", "ready")

    def __init__(self, tensors, ready):
        self.tensors = tensors
        self.ready = ready


class DevicePrefetcher:
    """Iterate device-resident batches, staged ``depth`` ahead.

    Wraps an iterator of host batches (tuples of numpy arrays or CPU
    tensors); yields tuples of tensors (see the module note).  The
    background thread is a daemon and also shuts down cleanly on
    ``close()``/GC; a producer exception re-raises on the consumer side
    in order.

    **Long-lived use.**  Exhaustion is sticky (iterating past the end
    keeps raising StopIteration), but :meth:`restart` re-arms an
    exhausted or closed prefetcher on a fresh iterable (cumulative
    :meth:`stats` keep summing), and :meth:`poll` is the non-blocking
    consume — ``None`` while the producer is still staging,
    :data:`EXHAUSTED` once the stream truly ended.
    """

    #: poll() return marker: the current stream ended (sticky until
    #: restart()).  Distinct from None = nothing staged *yet*.
    EXHAUSTED = object()

    def __init__(self, host_batches: Iterable, *,
                 depth: Optional[int] = None,
                 cast=None,
                 device=None,
                 device_put: bool = True,
                 source_kind: str = "custom"):
        self._host_iter = iter(host_batches)
        self.depth = default_prefetch_depth() if depth is None else int(depth)
        self.cast = _cast_dtype(cast)
        self.device_put = device_put
        self.device = _resolve_target(device) if device_put else \
            torch.device("cpu")
        self.source_kind = source_kind
        self._copy_stream = None
        # local mirrors of the registry instruments, for bench JSON
        self._batches = 0
        self._wait_s = 0.0
        self._produce_s = 0.0
        self._put_s = 0.0
        self._starved = 0
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._closed = False
        self._exhausted = False
        self._start()

    def _start(self) -> None:
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._producer, name="hvd-tpu-prefetch", daemon=True)
            self._thread.start()

    # -- staging -------------------------------------------------------------

    def _stage(self, batch) -> _Staged:
        """Cast + copy one host batch to the device."""
        # chaos: delay = staging jitter; raise/drop re-raise on the
        # consumer side through the queue; hang freezes the producer
        if _chaos.active:
            _chaos.raise_point("data.prefetch")
        t0 = time.perf_counter()
        tensors = _host_tensors(batch, self.cast)
        ready = None
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                tensors = tuple(t.pin_memory().to(self.device,
                                                  non_blocking=True)
                                for t in tensors)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        dt = time.perf_counter() - t0
        self._put_s += dt
        _instr.DATA_DEVICE_PUT.observe(dt)
        trace.add_span("data.device_put", t0, t0 + dt)
        return _Staged(tensors, ready)

    def _producer(self):
        # bind queue, iterator AND stop event locally: after restart()
        # replaces them, a producer that was blocked past the close()
        # join deadline must keep talking to ITS stream's queue and see
        # ITS stream's stop request
        q, it, stop = self._queue, self._host_iter, self._stop
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    q.put(_SENTINEL)
                    return
                dt = time.perf_counter() - t0
                self._produce_s += dt
                trace.add_span("data.produce", t0, t0 + dt)
                q.put(self._stage(item))
        except BaseException as e:  # re-raise on the consumer side
            q.put(e)

    def _deliver(self, staged: _Staged):
        """Order the consumer's stream after the batch's copies and tie
        the tensors' memory to that stream."""
        if staged.ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(staged.ready)
            for t in staged.tensors:
                t.record_stream(consumer)
        return staged.tensors

    # -- iteration -----------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self.depth == 0:
            # synchronous path: the measured baseline without overlap
            t0 = time.perf_counter()
            try:
                item = next(self._host_iter)
            except StopIteration:
                self._exhausted = True
                raise
            self._produce_s += time.perf_counter() - t0
            out = self._deliver(self._stage(item))
            self._account_delivery(waited=0.0)
            return out
        t0 = time.perf_counter()
        item = self._queue.get()
        waited = time.perf_counter() - t0
        out = self._resolve(item)
        if out is self.EXHAUSTED:
            raise StopIteration
        self._account_delivery(waited=waited)
        return out

    def _resolve(self, item):
        """Queue item -> delivered batch, EXHAUSTED, or raised error."""
        if item is _SENTINEL:
            self._queue.put(_SENTINEL)  # idempotent exhaustion
            self._exhausted = True
            return self.EXHAUSTED
        if isinstance(item, BaseException):
            self._queue.put(item)
            raise item
        return self._deliver(item)

    def poll(self, block: bool = False):
        """Non-blocking consume: a staged batch, ``None`` when nothing is
        staged yet, or :data:`EXHAUSTED` once the stream ended.
        ``block=True`` waits like ``next`` but still returns EXHAUSTED
        instead of raising.  With ``depth=0`` any poll runs the
        synchronous ``next`` (it may block on the host iterator)."""
        if self._closed:
            # close() drained the queue (sentinel included): a blocking
            # get here would hang; closed is terminal like exhausted
            return self.EXHAUSTED
        if self.depth == 0:
            try:
                return next(self)
            except StopIteration:
                return self.EXHAUSTED
        t0 = time.perf_counter()
        try:
            item = self._queue.get(block=block)
        except queue.Empty:
            return None
        out = self._resolve(item)
        if out is self.EXHAUSTED:
            return out
        self._account_delivery(waited=time.perf_counter() - t0)
        return out

    def _account_delivery(self, waited: float) -> None:
        self._batches += 1
        self._wait_s += waited
        if waited > 0.001:
            # span the input wait (host starvation) only when it is real
            end = time.perf_counter()
            trace.add_span("data.wait", end - waited, end)
            self._starved += 1
        _instr.DATA_HOST_WAIT.observe(waited)
        _instr.DATA_BATCHES.labels(source=self.source_kind).inc()
        _instr.DATA_PREFETCH_DEPTH.set(
            self._queue.qsize() if self._queue is not None else 0)

    # -- stats / lifecycle ---------------------------------------------------

    def stats(self) -> dict:
        """Pipeline counters for this iterator's lifetime.  ``*_total``
        fields sum cleanly across epoch iterators; the means are per
        delivered batch."""
        n = max(self._batches, 1)
        return {
            "batches": self._batches,
            "prefetch_depth": self.depth,
            "input_wait_ms_total": round(self._wait_s * 1e3, 3),
            "input_wait_ms_mean": round(self._wait_s / n * 1e3, 3),
            "host_produce_ms_total": round(self._produce_s * 1e3, 3),
            "host_produce_ms_mean": round(self._produce_s / n * 1e3, 3),
            "device_put_ms_total": round(self._put_s * 1e3, 3),
            "device_put_ms_mean": round(self._put_s / n * 1e3, 3),
            "starved_batches": self._starved,
        }

    @property
    def exhausted(self) -> bool:
        """True once the host iterator's end was delivered to the
        consumer (sticky until :meth:`restart`)."""
        return self._exhausted

    @property
    def closed(self) -> bool:
        return self._closed

    def restart(self, host_batches: Iterable) -> None:
        """Re-arm on a fresh host iterable.  Only legal once the previous
        stream is done: exhausted, or torn down with :meth:`close` (an
        active stream's producer thread would race the new one).
        Cumulative :meth:`stats` keep summing across streams."""
        if not (self._exhausted or self._closed):
            raise RuntimeError(
                "restart() on an active prefetcher; close() it or drain "
                "it to exhaustion first")
        if self._thread is not None:
            self._closed = True
            self._stop.set()  # per-stream: survives the _closed reset below
            self._drain_queue()  # unblock a producer parked on a full queue
            self._thread.join(timeout=5)
        self._host_iter = iter(host_batches)
        self._closed = False
        self._exhausted = False
        self._start()

    def _drain_queue(self) -> None:
        if self._queue is None:
            return
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def close(self) -> None:
        self._closed = True
        if self._stop is not None:
            self._stop.set()
        self._drain_queue()  # unblock a producer waiting on a full queue
        if self._thread is not None:
            self._thread.join(timeout=5)
        # release the upstream pipeline too (map_ordered holds a worker
        # pool open until its generator is closed)
        close_upstream = getattr(self._host_iter, "close", None)
        if close_upstream is not None:
            try:
                close_upstream()
            except Exception:
                pass  # generator mid-next on a stuck thread: GC handles it

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(host_batches: Iterable, depth: Optional[int] = None,
                       **kwargs) -> DevicePrefetcher:
    """Functional spelling of :class:`DevicePrefetcher` (flax-idiom name)."""
    return DevicePrefetcher(host_batches, depth=depth, **kwargs)
