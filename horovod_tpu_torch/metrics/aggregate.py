"""Cluster-wide metric snapshots over the existing collectives.

Copied from ``horovod_tpu/metrics/aggregate.py`` (``snapshot`` and
``merge_snapshots`` unchanged; ``cluster_snapshot`` over the port's
``allgather``, whose uneven first dims carry the per-rank payloads).

Per-worker endpoints give per-rank views; operators also want job-wide
numbers without scraping every host.  This module rides the framework's
own data plane: each rank serializes its registry to JSON, the bytes are
allgathered (the engine's uneven-dim0 path handles per-rank size
differences), and every rank — in practice rank 0 — merges the results:

  * counters and histograms sum across ranks (histograms bucket-wise;
    mismatched bucket bounds fall back to sum/count only);
  * gauges stay per-rank, surfaced with a synthetic leading ``rank``
    label (a job-wide "mean of step-time gauges" hides exactly the
    straggler a gauge exists to show).

``cluster_snapshot`` is a COLLECTIVE: every member of the process set
must call it at the same point (the same SPMD-symmetry contract every
named collective already carries).  Call it from a rank-symmetric spot —
an epoch-end callback, a periodic reporter — never from a single rank.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import torch

from .registry import REGISTRY, Histogram, MetricsRegistry

__all__ = ["snapshot", "merge_snapshots", "cluster_snapshot",
           "SNAPSHOT_VERSION"]

SNAPSHOT_VERSION = 1


def snapshot(registry: MetricsRegistry = REGISTRY) -> Dict[str, Any]:
    """Serialize the registry to a JSON-safe dict (one rank's view)."""
    metrics: Dict[str, Any] = {}
    for metric in registry.collect():
        entry: Dict[str, Any] = {
            "kind": metric.kind,
            "doc": metric.documentation,
            "labelnames": list(metric.labelnames),
            "series": [
                [list(labelvalues), state]
                for labelvalues, state in metric.samples()
            ],
        }
        if isinstance(metric, Histogram):
            entry["buckets"] = list(metric.bucket_bounds)
        metrics[metric.name] = entry
    return {"version": SNAPSHOT_VERSION, "metrics": metrics}


def _merge_series(kind: str, dst: Dict[tuple, Any], rank: int,
                  series: List[Any]) -> None:
    for labelvalues, state in series:
        if kind == "gauge":
            key = (str(rank),) + tuple(labelvalues)
            dst[key] = state
        elif kind == "histogram":
            key = tuple(labelvalues)
            prev = dst.get(key)
            if prev is None:
                dst[key] = {
                    "buckets": list(state["buckets"]),
                    "sum": state["sum"], "count": state["count"],
                }
            elif len(prev["buckets"]) == len(state["buckets"]):
                prev["buckets"] = [
                    a + b for a, b in zip(prev["buckets"],
                                          state["buckets"])
                ]
                prev["sum"] += state["sum"]
                prev["count"] += state["count"]
            else:  # bound mismatch across ranks: keep sum/count only
                prev["buckets"] = []
                prev["sum"] += state["sum"]
                prev["count"] += state["count"]
        else:  # counter
            key = tuple(labelvalues)
            dst[key] = dst.get(key, 0.0) + float(state)


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-rank snapshots into one job-wide view (see module
    docstring for the per-kind semantics)."""
    merged: Dict[str, Any] = {}
    for rank, snap in enumerate(snaps):
        for name, entry in snap.get("metrics", {}).items():
            m = merged.get(name)
            if m is None:
                labelnames = list(entry["labelnames"])
                if entry["kind"] == "gauge":
                    labelnames = ["rank"] + labelnames
                m = merged[name] = {
                    "kind": entry["kind"],
                    "doc": entry["doc"],
                    "labelnames": labelnames,
                    "series": {},
                }
                if "buckets" in entry:
                    m["buckets"] = entry["buckets"]
            _merge_series(entry["kind"], m["series"], rank,
                          entry["series"])
    # back to JSON-safe lists
    for m in merged.values():
        m["series"] = [
            [list(k), v] for k, v in sorted(m["series"].items())
        ]
    return {"version": SNAPSHOT_VERSION, "ranks": len(snaps),
            "metrics": merged}


def cluster_snapshot(registry: MetricsRegistry = REGISTRY,
                     process_set=None,
                     name: str = "hvd_tpu.metrics.snapshot",
                     ) -> Dict[str, Any]:
    """Gather every member rank's snapshot and merge (COLLECTIVE — every
    member must call; see module docstring).  Returns the merged job-wide
    snapshot on every rank; per-rank raw snapshots ride along under
    ``"per_rank"``.  The payloads travel as ``uint8`` tensors on this
    rank's device (NCCL moves only device tensors), with their ``int32``
    lengths in a second allgather."""
    from ..common import basics
    from ..ops import collective_ops as _ops

    local = snapshot(registry)
    raw = json.dumps(local, sort_keys=True).encode()
    dev = basics._require_init().device
    payload = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    gathered = _ops.allgather(payload, name=name,
                              process_set=process_set).cpu().numpy()
    # recover the per-rank boundaries: each rank's payload length differs,
    # so gather the lengths too (a tiny (1,)-shaped collective)
    lengths = _ops.allgather(
        torch.tensor([len(raw)], dtype=torch.int32, device=dev),
        name=name + ".len", process_set=process_set).cpu().tolist()
    snaps, off = [], 0
    for n in lengths:
        chunk = gathered[off:off + n]
        off += n
        try:
            snaps.append(json.loads(bytes(chunk.tobytes()).decode()))
        except (ValueError, UnicodeDecodeError):
            snaps.append({"version": SNAPSHOT_VERSION, "metrics": {}})
    merged = merge_snapshots(snaps)
    merged["per_rank"] = snaps
    return merged
