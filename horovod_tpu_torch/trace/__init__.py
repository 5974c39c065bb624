"""Host-side span recorder (copied from ``horovod_tpu/trace/__init__.py``).

An always-on recorder that answers "what happened, in order, to THIS
request / THIS step": each thread records ``(site, t0, dur, args)``
tuples into its own fixed-size ring (``HVD_TPU_TRACE_RING`` records;
old records are overwritten), so the recorder can stay on for a
process's life.  ``HVD_TPU_TRACE=0`` turns :func:`span` / :func:`event`
into a single module-bool check.

Spans bridge into an active ``torch.profiler`` capture through
``torch.profiler.record_function`` (the JAX package bridges into
``jax.profiler.TraceAnnotation`` the same way), so the profiler's
timeline and the recorder see one set of span names.  The bridge is
resolved lazily and only when torch is already loaded, and a span opens
a profiler range only while its thread is being profiled
(``torch.autograd._profiler_enabled``): with no capture running the
bridge costs that one check, where an idle ``record_function`` costs
two dispatcher calls (≈ 20 µs a span on the CPU test host).

Export: :mod:`.export` renders Chrome trace-event JSON (perfetto-loadable;
``GET /trace`` on the metrics endpoint, loopback-only) and merges
per-rank dumps; :mod:`.flight` dumps the last N seconds of spans plus
metric deltas as a crash bundle (the fleet router's replica loss and
handoff chaos).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Any, List, Optional

__all__ = [
    "SITES", "add_span", "configure", "enabled", "epoch_us", "event",
    "host", "install_from_env", "new_trace_id", "now", "rank", "snapshot",
    "span",
]

#: Span/event sites the port records (the serving, fleet, training,
#: input pipeline, checkpoint, chaos, collective, overlap, guard and
#: elastic subset of the JAX package's catalogue, same names).
SITES = (
    "train.step",          # one training step (fit_epoch; global step)
    "data.wait",           # consumer wait on the prefetch queue
    "data.produce",        # host batch production (producer thread)
    "data.device_put",     # host->device staging copy
    "checkpoint.publish",  # crash-atomic checkpoint write (_atomic_publish)
    "collective.enqueue",  # negotiated-collective submission (controller)
    "collective.exec",     # fused collective dispatch->data-ready
    "chaos.inject",        # a chaos rule fired (instant, first-class)
    "serve.queued",        # request arrival -> admission (per request)
    "serve.prefill_chunk", # one prefill chunk computed (per request)
    "serve.step",          # one mixed/decode engine step (batch-wide)
    "serve.first_decode",  # the decode step that emitted a first token
    "serve.first_token",   # first-token emission (instant; TTFT arg)
    "serve.finish",        # request completion (instant)
    "serve.spec_verify",   # one request's speculative verify row scored
    "serve.spec_rollback", # rejected-draft KV tail trimmed (instant)
    "fleet.route",         # router placement decision (instant)
    "serve.migrate",       # one request's KV/stream handoff to a survivor
    "serve.hedge",         # hedged second dispatch issued (instant)
    "serve.handoff",       # prefill->decode tier handoff (disagg fleet)
    "fleet.scale",         # autoscaler applied a scale decision (instant)
    "overlap.bucket",      # one gradient bucket's collective call
    "overlap.autotune",    # one autotuner trial scored (instant)
    "fleet.preempt",       # preemption notice handled (instant)
    "guard.exchange",      # cross-rank digest/vote exchange (cadence)
    "elastic.restart",     # exec-restart about to replace the image
)

ENV_TRACE = "HVD_TPU_TRACE"
ENV_RING = "HVD_TPU_TRACE_RING"

now = time.perf_counter

# wall-clock anchor: records carry perf_counter() times (monotonic); the
# export maps them to epoch microseconds through this pair
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


_enabled = os.environ.get(ENV_TRACE, "1") != "0"
_ring_cap = max(256, _env_int(ENV_RING, 16384))

#: rank and host stamped on exports and bundles (install_from_env)
_rank = 0
_host = ""

_ann_cls: Optional[type] = None
_ann_on = None
_ann_tried = False


def _annotation_cls():
    """``torch.profiler.record_function`` while torch is loaded and this
    thread is being profiled, else None (no profiler range)."""
    global _ann_cls, _ann_on, _ann_tried
    if not _ann_tried and "torch" in sys.modules:
        _ann_tried = True
        try:
            from torch.autograd import _profiler_enabled
            from torch.profiler import record_function

            _ann_cls, _ann_on = record_function, _profiler_enabled
        except Exception:
            _ann_cls = None
    if _ann_cls is not None and _ann_on():
        return _ann_cls
    return None


class _Ring:
    """One thread's fixed-size record ring (single writer)."""

    __slots__ = ("buf", "idx", "cap", "tid", "owner")

    def __init__(self, cap: int, tid: str):
        self.buf: List[tuple] = []
        self.idx = 0
        self.cap = cap
        self.tid = tid
        self.owner: Optional[Any] = None

    def append(self, rec: tuple) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(rec)
        else:
            self.buf[self.idx % self.cap] = rec
        self.idx += 1

    def records(self) -> List[tuple]:
        if self.idx <= self.cap:
            return list(self.buf)
        start = self.idx % self.cap
        return self.buf[start:] + self.buf[:start]


_rings_lock = threading.Lock()
_rings: List[_Ring] = []
_local = threading.local()


def _ring() -> _Ring:
    r = getattr(_local, "ring", None)
    if r is None:
        import weakref

        t = threading.current_thread()
        r = _Ring(_ring_cap, f"{t.name}-{t.ident}")
        r.owner = weakref.ref(t)
        _local.ring = r
        with _rings_lock:
            _rings.append(r)
            # only dead threads' rings retire (a live main thread's
            # ring must never be evicted by worker-thread churn)
            if len(_rings) > 64:
                for old in _rings[:-64]:
                    owner = old.owner() if old.owner is not None else None
                    if owner is None or not owner.is_alive():
                        _rings.remove(old)
    return r


class _Span:
    __slots__ = ("site", "xname", "args", "t0", "ann")

    def __init__(self, site: str, xname: Optional[str], args):
        self.site = site
        self.xname = xname
        self.args = args
        self.ann = None

    def __enter__(self):
        if self.xname is not None:
            cls = _annotation_cls()
            if cls is not None:
                self.ann = cls(self.xname)
                self.ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if _enabled:
            _ring().append((self.site, self.t0, t1 - self.t0, self.args))
        if self.ann is not None:
            self.ann.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


def span(site: str, /, _xname: Optional[str] = None, **args):
    """Context manager recording one host-side span at ``site``;
    ``_xname`` overrides the name carried into an active profiler
    capture (default ``hvd_tpu::<site>``, ``False`` = no bridge)."""
    if not _enabled:
        if _xname:
            cls = _annotation_cls()
            if cls is not None:
                return cls(_xname)
        return _NULL
    xname = (None if _xname is False
             else (_xname or f"hvd_tpu::{site}"))
    return _Span(site, xname, args or None)


def event(site: str, /, **args) -> None:
    """Record one instant event at ``site``."""
    if not _enabled:
        return
    _ring().append((site, time.perf_counter(), None, args or None))


def add_span(site: str, t0: float, t1: float, /, **args) -> None:
    """Record a span with explicit ``now()``-clock extents."""
    if not _enabled:
        return
    _ring().append((site, t0, max(0.0, t1 - t0), args or None))


def snapshot(since: float = 0.0) -> List[tuple]:
    """Every live record with ``t0 >= since`` across all thread rings,
    time-ordered: ``(site, t0, dur_or_None, args_or_None, tid)``."""
    with _rings_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        for rec in r.records():
            if rec[1] >= since:
                out.append(rec + (r.tid,))
    out.sort(key=lambda r: r[1])
    return out


def enabled() -> bool:
    return _enabled


def configure(enabled: Optional[bool] = None,
              ring: Optional[int] = None) -> None:
    """Programmatic switch; ``ring`` applies to rings created later."""
    global _enabled, _ring_cap
    if enabled is not None:
        _enabled = bool(enabled)
    if ring is not None:
        _ring_cap = max(256, int(ring))


def epoch_us(t: float) -> float:
    """Map a ``now()``-clock time to epoch microseconds (export axis)."""
    return (_WALL0 + (t - _PERF0)) * 1e6


_id_lock = threading.Lock()
_id_counter = 0


def new_trace_id() -> str:
    """A process-unique trace-context id (router -> replica -> engine ->
    scheduler propagation)."""
    global _id_counter
    with _id_lock:
        _id_counter += 1
        n = _id_counter
    return f"t{_rank}-{os.getpid():x}-{n:x}"


def install_from_env(rank: int = 0, host: Optional[str] = None) -> bool:
    """Init-time hook: resolve the env switches, stamp the rank/host the
    export and flight bundles carry, mount the ``/trace`` control
    endpoint and baseline the flight recorder's metric snapshot.
    Returns whether recording is enabled."""
    global _enabled, _ring_cap, _rank, _host
    _enabled = os.environ.get(ENV_TRACE, "1") != "0"
    _ring_cap = max(256, _env_int(ENV_RING, 16384))
    _rank = int(rank)
    if host is None:
        import socket

        host = socket.gethostname()
    _host = host
    from . import export as _export
    from . import flight as _flight

    _export.register_trace_endpoint()
    _flight.note_metrics_baseline()
    return _enabled


def rank() -> int:
    return _rank


def host() -> str:
    return _host
