"""horovod_tpu_torch.metrics: the port's process-wide telemetry registry.

:mod:`.registry` holds Counters / Gauges / Histograms and
:mod:`.instruments` the serving slice's named instruments (the same
metric names as the JAX package's, in the port's own registry).
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

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS", "counter", "gauge", "histogram",
]
