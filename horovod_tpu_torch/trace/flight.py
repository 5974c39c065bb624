"""The black-box flight recorder: crash bundles from the span rings.

Copied from ``horovod_tpu/trace/flight.py`` (stdlib only); bundles are
written through the port's ``checkpoint._atomic_publish``.


A worker that dies, quarantines, rolls back, or gets preempted takes
its recent history with it — the ring buffers live in the process
image.  This module dumps them FIRST: the last
``HVD_TPU_TRACE_BUNDLE_SECONDS`` of spans plus the metric deltas since
the last baseline, written crash-atomically through
``checkpoint._atomic_publish`` into ``HVD_TPU_TRACE_BUNDLE_DIR``
*before* ``os._exit`` / ``execv`` replaces the image.  The chaos soak's
kill and sdc scenarios assert the bundle exists and contains the dying
rank's final spans — including the injected ``chaos.inject`` event —
so a fault is a self-explaining artifact, not log archaeology.

Dump triggers (each passes its ``reason``, which labels the
``hvd_tpu_trace_bundles_total`` counter and the bundle filename):

* ``chaos_kill``  — a chaos ``kill`` rule, just before ``os._exit``;
* ``quarantine``  — the integrity guard attributing THIS rank;
* ``rollback``    — a guard rollback discarding the poisoned window;
* ``preempt``     — a handled preemption notice (fleet guard);
* ``restart``     — any exec-restart (``_persist_and_exec``);
* ``replica_loss``— the fleet router ejecting a serving replica
  (before its in-flight requests migrate to survivors);
* ``slo_breach``  — the fleet autoscaler applying a scale-out.

Off by default: without ``HVD_TPU_TRACE_BUNDLE_DIR`` every trigger is
one env-dict lookup.  Never raises — a failing dump must not preempt
the recovery path it is documenting.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from ..metrics import instruments as _instr
from ..metrics.registry import REGISTRY, Histogram
from ..utils.logging import get_logger
from . import host, now, rank, snapshot
from .export import chrome_trace

__all__ = ["maybe_dump", "note_metrics_baseline", "read_bundle"]

ENV_BUNDLE_DIR = "HVD_TPU_TRACE_BUNDLE_DIR"
ENV_BUNDLE_SECONDS = "HVD_TPU_TRACE_BUNDLE_SECONDS"
ENV_BUNDLE_KEEP = "HVD_TPU_TRACE_BUNDLE_KEEP"

_lock = threading.Lock()
_baseline: Dict[str, float] = {}
_last_dump: Dict[str, float] = {}
_counter = 0


def _metric_values() -> Dict[str, float]:
    """Flat name{labels} -> value snapshot of every counter/gauge (and
    histogram sums/counts) in the default registry."""
    out: Dict[str, float] = {}
    try:
        for metric in REGISTRY.collect():
            for labelvalues, state in metric.samples():
                key = metric.name
                if labelvalues:
                    key += "{" + ",".join(
                        f"{n}={v}" for n, v in
                        zip(metric.labelnames, labelvalues)) + "}"
                if isinstance(metric, Histogram):
                    out[key + ":sum"] = float(state["sum"])
                    out[key + ":count"] = float(state["count"])
                else:
                    out[key] = float(state)
    except Exception:
        pass  # a torn registry read must not sink the dump
    return out


def note_metrics_baseline() -> None:
    """Snapshot the registry as the delta baseline (install time, and
    after every dump — "recent" deltas, not since-boot totals)."""
    global _baseline
    vals = _metric_values()
    with _lock:
        _baseline = vals


def maybe_dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Write a crash bundle if ``HVD_TPU_TRACE_BUNDLE_DIR`` is set.

    Returns the path written, or None (disabled, rate-limited, or the
    write failed — logged, never raised).  Rate limiting is PER CLASS:
    crash-class dumps (kill/quarantine/rollback/preempt/restart)
    suppress each other within 2 s — response paths stack (a rollback
    exec-restarts, whose restart hook would dump again) and the FIRST
    bundle is the one with the evidence — and routine dumps
    (slo_breach) likewise; but a ROUTINE dump never suppresses a crash
    dump, so an autoscaler bundle moments before a quarantine cannot
    cost the black box its whole purpose."""
    directory = os.environ.get(ENV_BUNDLE_DIR, "").strip()
    if not directory:
        return None
    global _counter
    cls = "routine" if reason == "slo_breach" else "crash"
    t = time.time()
    with _lock:
        if t - _last_dump.get(cls, 0.0) < 2.0:
            return None
        _last_dump[cls] = t
        _counter += 1
        n = _counter
    try:
        raw = os.environ.get(ENV_BUNDLE_SECONDS, "").strip()
        window = float(raw) if raw else 30.0
    except ValueError:
        window = 30.0
    try:
        current = _metric_values()
        with _lock:
            base = dict(_baseline)
        deltas = {k: v - base.get(k, 0.0) for k, v in current.items()
                  if v != base.get(k, 0.0)}
        bundle = {
            "format": "horovod_tpu.trace.bundle/1",
            "reason": reason,
            "rank": rank(),
            "host": host(),
            "pid": os.getpid(),
            "wall_time": t,
            "window_s": window,
            "trace": chrome_trace(since=now() - window),
            "metric_deltas": deltas,
        }
        if extra:
            bundle["extra"] = extra
        payload = json.dumps(bundle).encode()
        name = f"bundle-{reason}-rank{rank()}-{os.getpid()}-{n}.json"
        from .. import checkpoint as _checkpoint

        path = _checkpoint._atomic_publish(directory, name, payload)
        _instr.TRACE_BUNDLES.labels(reason).inc()
        note_metrics_baseline()
        _prune(directory)
        get_logger().warning(
            "trace: flight-recorder bundle (%s, %d events) -> %s",
            reason, len(bundle["trace"]["traceEvents"]), path)
        return path
    except Exception as e:  # never preempt the recovery path
        get_logger().warning("trace: bundle dump failed (%s: %s)",
                             type(e).__name__, e)
        return None


def _prune(directory: str) -> None:
    """Retention cap: keep the newest ``HVD_TPU_TRACE_BUNDLE_KEEP``
    (default 32) bundles.  A long-lived fleet under oscillating load
    dumps an ``slo_breach`` bundle per applied scale-out — without a
    cap the directory grows without bound and the one bundle that
    matters (a later crash) drowns in routine ones."""
    raw = os.environ.get(ENV_BUNDLE_KEEP, "").strip()
    try:
        keep = int(raw) if raw else 32
    except ValueError:
        keep = 32
    if keep < 1:
        return  # 0/negative = unbounded, the operator's explicit choice
    try:
        bundles = sorted(
            (os.path.join(directory, n) for n in os.listdir(directory)
             if n.startswith("bundle-") and n.endswith(".json")),
            key=os.path.getmtime)
        for stale in bundles[:-keep]:
            os.remove(stale)
    except OSError:
        pass  # retention must never sink the dump that just succeeded


def read_bundle(path: str) -> dict:
    """Load one bundle, stripping (and verifying) the CRC32 header the
    ``_atomic_publish`` write path wraps payloads in; bare-JSON bundles
    (the no-checkpoint fallback writer) load as-is."""
    import zlib

    with open(path, "rb") as f:
        blob = f.read()
    magic = b"HVDTPU-CRC32\n"
    if blob.startswith(magic):
        head = len(magic) + 9  # 8 hex digits + newline
        want = int(blob[len(magic):head - 1], 16)
        blob = blob[head:]
        if zlib.crc32(blob) != want:
            raise ValueError(f"bundle {path} fails its checksum")
    return json.loads(blob.decode())
