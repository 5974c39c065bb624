"""Process-wide metric registry: Counters, Gauges, Histograms.

Copied unchanged from ``horovod_tpu/metrics/registry.py`` (jax-free);
only this copy is imported by the port, so its ``REGISTRY`` is the
port's own.

Reference analog: the per-component stats the native core already keeps
(ResponseCache hit/miss counters, StallInspector pending table,
ParameterManager score samples) — generalized into the metrics-registry
shape production training stacks expose to Prometheus.  The design goals
follow the stall-inspector's: negligible hot-path cost (one dict lookup
is pre-resolved away via labeled children, one lock, one float add — no
allocation), thread-safety everywhere (metrics are bumped from the
training thread, the C++ exec callback thread, the torch submit worker
and autograd threads concurrently), and a single process-wide registry
(``REGISTRY``) so every subsystem lands in one exposition.

Locking is striped per metric child, not per registry: two threads
bumping different counters (or different label sets of one counter)
never contend; the registry-level lock is only taken on child creation
and on ``collect()``.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "DEFAULT_LATENCY_BUCKETS",
]

#: Latency buckets in seconds, tuned for collective dispatch: the native
#: negotiation cycle is ~1 ms, a cached eager collective lands in the
#: 0.1-10 ms decades, a cold compile or a cross-DCN fused burst in the
#: 0.1-10 s decades.
DEFAULT_LATENCY_BUCKETS = (
    .0001, .00025, .0005, .001, .0025, .005, .01, .025, .05, .1,
    .25, .5, 1.0, 2.5, 5.0, 10.0,
)

_RESERVED_LABELS = frozenset({"le"})


def _validate_name(name: str) -> None:
    if not name or not all(
        c.isalnum() or c in "_:" for c in name
    ) or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")


class _Child:
    """One (metric, label-values) time series.  Holds its own lock so
    concurrent bumps of different series never contend."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def get(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    __slots__ = ("_fn",)

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        """Evaluate ``fn`` at collection time instead of a stored value
        (for values owned elsewhere, e.g. the native core's ctypes
        getters — polling at scrape keeps the hot path untouched)."""
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")


class _HistogramChild:
    """Fixed-bucket histogram.  ``observe`` is allocation-free: a bisect
    into the precomputed bounds and two float adds under one lock."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds  # ascending, without the +Inf bucket
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def get(self) -> dict:
        with self._lock:
            return {
                "buckets": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class _Metric:
    """Base: owns the labeled children table."""

    kind = "untyped"

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = ()):
        _validate_name(name)
        for ln in labelnames:
            if ln in _RESERVED_LABELS:
                raise ValueError(f"label name {ln!r} is reserved")
            _validate_name(ln)
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # unlabeled: one implicit child, pre-created so the hot path
            # is a direct attribute call
            self._default = self._new_child()
            self._children[()] = self._default

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *labelvalues, **labelkw):
        """Child for one label-value tuple.  Call once at setup and keep
        the returned child: the lookup here allocates the key tuple."""
        if labelkw:
            if labelvalues:
                raise ValueError("pass label values either positionally "
                                 "or by keyword, not both")
            try:
                labelvalues = tuple(
                    labelkw[ln] for ln in self.labelnames
                )
            except KeyError as e:
                raise ValueError(f"missing label {e.args[0]!r}") from None
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{labelvalues!r}"
            )
        key = tuple(str(v) for v in labelvalues)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def samples(self) -> List[Tuple[Tuple[str, ...], object]]:
        """Snapshot of (label_values, state) for every child."""
        with self._lock:
            items = list(self._children.items())
        return [(k, c.get()) for k, c in items]


class Counter(_Metric):
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def get(self) -> float:
        return self._default.get()


class Gauge(_Metric):
    """Point-in-time value (Prometheus gauge)."""

    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        self._default.set_function(fn)

    def get(self) -> float:
        return self._default.get()


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus histogram)."""

    kind = "histogram"

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(math.isinf(b) for b in bounds):
            bounds = tuple(b for b in bounds if not math.isinf(b))
        self._bounds = bounds
        super().__init__(name, documentation, labelnames)

    def _new_child(self):
        return _HistogramChild(self._bounds)

    @property
    def bucket_bounds(self) -> Tuple[float, ...]:
        return self._bounds

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def get(self) -> dict:
        return self._default.get()


class MetricsRegistry:
    """Holds the process's metrics; collection is a consistent-enough
    snapshot (each child snapshots under its own lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._polls: List[Callable[[], None]] = []

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                raise ValueError(
                    f"metric {metric.name!r} is already registered"
                )
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def register_poll(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every collection — the hook instrumentation
        uses to refresh pull-style gauges (e.g. native-core stats over
        ctypes) only when someone is actually looking."""
        with self._lock:
            self._polls.append(fn)

    def unregister_poll(self, fn: Callable[[], None]) -> None:
        with self._lock:
            try:
                self._polls.remove(fn)
            except ValueError:
                pass

    def collect(self) -> List[_Metric]:
        with self._lock:
            polls = list(self._polls)
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for fn in polls:
            try:
                fn()
            except Exception:
                pass  # a broken poll must never break exposition
        return metrics

    def clear(self) -> None:
        """Drop every metric and poll hook (tests only)."""
        with self._lock:
            self._metrics.clear()
            self._polls.clear()


#: The process-wide default registry every subsystem instruments into.
REGISTRY = MetricsRegistry()


def _get_or_create(cls, name: str, documentation: str,
                   labelnames: Sequence[str], registry: MetricsRegistry,
                   **kwargs):
    m = registry.get(name)
    if m is not None:
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with a different "
                f"type or label set"
            )
        if "buckets" in kwargs:
            # same normalization as Histogram.__init__, so the check
            # compares what the caller would actually have gotten
            want = tuple(sorted(
                float(b) for b in kwargs["buckets"]
                if not math.isinf(float(b))
            ))
            if m.bucket_bounds != want:
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"different buckets {m.bucket_bounds} (asked for "
                    f"{want})"
                )
        return m
    try:
        return registry.register(cls(name, documentation, labelnames,
                                     **kwargs))
    except ValueError:
        # lost a creation race: the winner's instance is authoritative
        m = registry.get(name)
        if m is None:
            raise
        return m


def counter(name: str, documentation: str,
            labelnames: Sequence[str] = (),
            registry: MetricsRegistry = REGISTRY) -> Counter:
    """Get-or-create a :class:`Counter` (idempotent — safe to call at
    module import and after re-init)."""
    return _get_or_create(Counter, name, documentation, labelnames,
                          registry)


def gauge(name: str, documentation: str,
          labelnames: Sequence[str] = (),
          registry: MetricsRegistry = REGISTRY) -> Gauge:
    """Get-or-create a :class:`Gauge`."""
    return _get_or_create(Gauge, name, documentation, labelnames, registry)


def histogram(name: str, documentation: str,
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
              registry: MetricsRegistry = REGISTRY) -> Histogram:
    """Get-or-create a :class:`Histogram`."""
    return _get_or_create(Histogram, name, documentation, labelnames,
                          registry, buckets=buckets)
