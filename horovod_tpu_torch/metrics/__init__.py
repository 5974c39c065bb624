"""horovod_tpu_torch.metrics: the port's process-wide telemetry registry.

:mod:`.registry` holds Counters / Gauges / Histograms,
:mod:`.instruments` the named instruments (the same metric names as the
JAX package's, in the port's own registry) and :mod:`.aggregate` the
job-wide snapshot (``cluster_snapshot``, a collective).
"""

from __future__ import annotations

from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    DEFAULT_LATENCY_BUCKETS,
    counter,
    gauge,
    histogram,
)
from .aggregate import cluster_snapshot, merge_snapshots, snapshot

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS", "counter", "gauge", "histogram",
    "snapshot", "merge_snapshots", "cluster_snapshot",
]
