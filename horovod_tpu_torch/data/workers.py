"""Host-side worker pool: parallel decode/collate with ordered delivery.

Copied from ``horovod_tpu/data/workers.py`` (``HVD_TPU_DATA_WORKERS``,
the same ordered window).

The hot property is the *bounded in-flight window*: up to ``window``
batches are being decoded concurrently while results are handed out in
submission order.  That keeps (a) batch order deterministic — the
step's inputs must not depend on thread scheduling, (b) host
memory bounded — at most ``window`` decoded batches exist at once, and
(c) the pool saturated — a slow batch (cold page cache, big JPEG) does
not drain the pipeline because the window keeps later batches cooking.

Threads, not processes: the work is numpy slicing and PIL decode, both of
which release the GIL, and thread workers share the sources' mmaps
without pickling.  ``HVD_TPU_DATA_WORKERS=0`` degrades to synchronous
inline decode (debugging, single-threaded determinism checks).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, TypeVar

__all__ = ["default_num_workers", "map_ordered"]

T = TypeVar("T")
R = TypeVar("R")

#: Env knob: host decode/collate threads (0 = inline, no pool).
WORKERS_ENV = "HVD_TPU_DATA_WORKERS"


def default_num_workers() -> int:
    """``HVD_TPU_DATA_WORKERS`` or min(4, cpu_count).

    Four threads decode ~1 GB/s of JPEG on a typical host — past the
    point where a single PCIe/tunnel transfer stream is the bottleneck —
    while staying polite on shared CI boxes.
    """
    env = os.environ.get(WORKERS_ENV)
    if env is not None:
        n = int(env)
        if n < 0:
            raise ValueError(f"{WORKERS_ENV} must be >= 0, got {n}")
        return n
    return min(4, os.cpu_count() or 1)


def map_ordered(fn: Callable[[T], R], items: Iterable[T], *,
                num_workers: Optional[int] = None,
                window: int = 4) -> Iterator[R]:
    """Yield ``fn(item)`` in input order with a bounded concurrent window.

    Generator-lazy: nothing is submitted until iteration starts, and at
    most ``window`` futures are in flight.  An exception from ``fn``
    propagates at the yield point for its item (order preserved), after
    which the remaining window is cancelled.
    """
    if num_workers is None:
        num_workers = default_num_workers()
    if num_workers == 0:
        for item in items:
            yield fn(item)
        return
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")

    with ThreadPoolExecutor(
        max_workers=num_workers,
        thread_name_prefix="hvd-tpu-data",
    ) as pool:
        it = iter(items)
        inflight = []
        try:
            for item in it:
                inflight.append(pool.submit(fn, item))
                if len(inflight) >= window:
                    yield inflight.pop(0).result()
            while inflight:
                yield inflight.pop(0).result()
        finally:
            for f in inflight:
                f.cancel()
