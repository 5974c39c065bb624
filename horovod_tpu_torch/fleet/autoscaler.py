"""The autoscale loop: policy decisions applied to a live fleet.

Copied from ``horovod_tpu/fleet/autoscaler.py`` (stdlib only).

One :class:`Autoscaler` closes the loop for either fleet kind:

* **training** — the elastic driver
  (``runner/elastic_driver.py``) builds it through
  :func:`maybe_training_autoscaler` with
  ``apply_fn=driver.request_world_size`` (the resize entry
  point): the decision lands as a planned membership change at the
  next epoch boundary; SLO mode takes signals from
  worker metrics endpoints (:class:`EndpointSignalSource`, the
  scrape surface) or from ``cluster_snapshot()`` dicts the training
  loop already produces (:func:`.policy.snapshot_signals`).
* **serving** — the :class:`~horovod_tpu_torch.fleet.router.FleetRouter`
  embeds the same policy engine directly (its signals are in-process;
  no scrape hop) and applies decisions as replica spawn/drain/retire.

The loop itself is deliberately dumb: read signals, evaluate, apply,
book the metrics, sleep.  Every interesting property (hysteresis,
cooldown, clamping) lives in :mod:`.policy` where it is unit-testable
without threads.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common.retry import env_float
from ..metrics import instruments as _instr
from ..utils.logging import get_logger
from .policy import Decision, histogram_quantile, plan_from_env

__all__ = [
    "Autoscaler", "EndpointSignalSource", "maybe_training_autoscaler",
    "parse_prom_text", "register_targets_endpoint",
]

ENV_INTERVAL = "HVD_TPU_FLEET_INTERVAL"
ENV_SCRAPE = "HVD_TPU_FLEET_SCRAPE"


class Autoscaler:
    """Periodic evaluate-and-apply driver around one policy.

    ``current_fn`` reports the fleet's live size, ``signals_fn`` (may
    be None for time-plan policies) its load signals, ``apply_fn``
    receives the desired size and returns truthy when the resize was
    accepted (a rejected apply — no free slots yet, replica spawn
    failed — leaves the policy's cooldown un-burnt so the next tick
    retries)."""

    def __init__(self, policy, apply_fn: Callable[[int], object], *,
                 current_fn: Callable[[], int],
                 signals_fn: Optional[Callable[[], Dict[str, float]]] = None,
                 interval_s: Optional[float] = None,
                 kind: str = "train",
                 clock=time.monotonic):
        self.policy = policy
        self._apply = apply_fn
        self._current = current_fn
        self._signals = signals_fn
        self.interval_s = (env_float(ENV_INTERVAL, 5.0)
                           if interval_s is None else float(interval_s))
        self.kind = kind
        self._clock = clock
        self._desired_g = _instr.FLEET_DESIRED_SIZE.labels(kind)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_decision: Optional[Decision] = None
        self._applied_desired: Optional[int] = None

    def tick(self, now: Optional[float] = None) -> Decision:
        """One evaluation: the unit the thread loops over (tests call
        it directly with injected clocks/signals)."""
        now = self._clock() if now is None else now
        signals = self._signals() if self._signals is not None else {}
        current = int(self._current())
        d = self.policy.evaluate(signals, current, now)
        self.last_decision = d
        self._desired_g.set(d.desired)
        if d.direction != "hold" and d.desired != current \
                and d.desired != self._applied_desired:
            # the != _applied_desired guard: a target already handed to
            # the applier stays in force there (request_world_size is
            # sticky) — re-applying it every tick while the fleet
            # converges (or while capacity is short) would inflate the
            # scale-event counter without bound for one decision
            get_logger().info(
                "fleet[%s]: scale %s %d -> %d (%s)", self.kind,
                d.direction, current, d.desired, d.reason)
            if self._apply(d.desired):
                _instr.FLEET_SCALE_EVENTS.labels(
                    self.kind, d.direction).inc()
                self._applied_desired = d.desired
                self.policy.note_applied(now)
                from .. import trace as _trace

                _trace.event("fleet.scale", kind=self.kind,
                             direction=d.direction, current=current,
                             desired=d.desired, reason=d.reason)
                if d.direction == "out":
                    # a scale-out IS an SLO breach being answered: the
                    # signals and spans of the 30 s leading up to it
                    # are exactly what the post-mortem wants
                    from ..trace import flight as _flight

                    _flight.maybe_dump("slo_breach", extra={
                        "kind": self.kind, "desired": d.desired,
                        "reason": d.reason})
        return d

    # -- thread form (the driver/router run it; tests use tick()) -----------

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"hvd_tpu_fleet_{self.kind}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:
                # the autoscaler must never take the driver down — a
                # scrape hiccup or a transient apply failure is a
                # skipped tick, not a dead fleet
                get_logger().warning("fleet[%s]: tick failed: %s",
                                     self.kind, e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- metrics-endpoint signals ------------------------------------------------


def parse_prom_text(text: str) -> Dict[Tuple[str, Tuple[str, ...]], float]:
    """Parse Prometheus text-format 0.0.4 samples into
    ``{(metric_name, (label_value, ...)): value}`` — just enough of the
    format to read back what :func:`..metrics.exposition.render` wrote
    (label VALUES in declaration order; names dropped — the reader
    knows the catalogue's label order from docs/METRICS.md)."""
    out: Dict[Tuple[str, Tuple[str, ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, value = line.rsplit(" ", 1)
            if "{" in head:
                name, rest = head.split("{", 1)
                labels = tuple(
                    p.split("=", 1)[1].strip('"')
                    for p in rest.rstrip("}").split('",')
                    if "=" in p)
            else:
                name, labels = head, ()
            out[(name, labels)] = float(value)
        except ValueError:
            continue
    return out


class EndpointSignalSource:
    """Policy signals scraped from worker ``/metrics`` endpoints (the
    exposition surface) — the driver-side loop's eyes when it has
    no in-process registry to read.

      queue_depth   sum of ``hvd_tpu_serve_queue_depth``
      p99_ttft      q0.99 of the ``first``-kind token-latency histogram
                    (windowed: computed on the bucket DELTAS since the
                    previous scrape, so old traffic can't mask a fresh
                    SLO breach)
      step_time     q0.50 of ``hvd_tpu_step_duration_seconds`` deltas
      throughput    rate of ``hvd_tpu_serve_steps_total`` between
                    scrapes
      decode_tokens_per_s
                    emitted-token rate (token-latency ``_count``
                    deltas) per scraped endpoint — the disaggregated
                    decode tier's throughput-floor signal

    Unreachable endpoints contribute nothing (the policy holds on "no
    watched signals" rather than act on a partial picture when every
    scrape fails)."""

    LATENCY = "hvd_tpu_serve_token_latency_seconds"
    STEP = "hvd_tpu_step_duration_seconds"
    QUEUE = "hvd_tpu_serve_queue_depth"
    STEPS_TOTAL = "hvd_tpu_serve_steps_total"

    def __init__(self, urls: Sequence[str], timeout_s: float = 2.0,
                 clock=time.monotonic):
        self.urls = [u if "://" in u else f"http://{u}" for u in urls]
        self.timeout_s = timeout_s
        self._clock = clock
        self._prev: Optional[Dict] = None
        self._prev_at: Optional[float] = None

    def _fetch(self) -> Dict[Tuple[str, Tuple[str, ...]], float]:
        merged: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        for url in self.urls:
            target = url.rstrip("/") + "/metrics"
            try:
                with urllib.request.urlopen(
                        target, timeout=self.timeout_s) as resp:
                    samples = parse_prom_text(
                        resp.read().decode("utf-8", "replace"))
            except OSError as e:
                get_logger().debug("fleet: scrape %s failed: %s",
                                   target, e)
                continue
            for k, v in samples.items():
                merged[k] = merged.get(k, 0.0) + v
        return merged

    def _buckets(self, samples, name: str, kind: Optional[str]
                 ) -> Tuple[List[float], List[float]]:
        """(ascending bounds, per-bucket cumulative counts) of one
        histogram series (``kind`` filters the leading label value)."""
        rows = []
        for (n, labels), v in samples.items():
            if n != name + "_bucket":
                continue
            if kind is not None and (not labels or labels[0] != kind):
                continue
            le = labels[-1]
            bound = float("inf") if le == "+Inf" else float(le)
            rows.append((bound, v))
        rows.sort(key=lambda r: r[0])
        return [b for b, _ in rows], [c for _, c in rows]

    def _quantile(self, cur, prev, name, kind, q) -> Optional[float]:
        bounds, cum = self._buckets(cur, name, kind)
        if not bounds:
            return None
        prev_cum = [0.0] * len(cum)
        if prev is not None:
            _pb, pc = self._buckets(prev, name, kind)
            if len(pc) == len(cum):
                prev_cum = pc
        # cumulative -> per-bucket, windowed on the scrape delta
        per = []
        last = 0.0
        for c, p in zip(cum, prev_cum):
            d = max(0.0, (c - p) - last)
            per.append(d)
            last = c - p
        if sum(per) <= 0:
            return None
        finite = [b for b in bounds if b != float("inf")]
        return histogram_quantile(finite, per[:len(finite) + 1], q)

    def __call__(self) -> Dict[str, float]:
        now = self._clock()
        cur = self._fetch()
        if not cur:
            self._prev, self._prev_at = None, None
            return {}
        out: Dict[str, float] = {}
        q = [v for (n, _l), v in cur.items() if n == self.QUEUE]
        if q:
            out["queue_depth"] = sum(q)
        p99 = self._quantile(cur, self._prev, self.LATENCY, "first", 0.99)
        if p99 is not None:
            out["p99_ttft"] = p99
        p50 = self._quantile(cur, self._prev, self.STEP, None, 0.5)
        if p50 is not None:
            out["step_time"] = p50
        if self._prev is not None and self._prev_at is not None:
            dt = now - self._prev_at
            if dt > 0:
                steps = sum(v for (n, _l), v in cur.items()
                            if n == self.STEPS_TOTAL)
                prev_steps = sum(v for (n, _l), v in self._prev.items()
                                 if n == self.STEPS_TOTAL)
                out["throughput"] = max(0.0, steps - prev_steps) / dt
                # decode-tier throughput per scraped endpoint: the
                # token-latency histogram's _count is one observation
                # per emitted token, so its scrape-to-scrape rate is
                # tokens/s — divided per endpoint it is the
                # decode_tokens_per_s floor signal the disaggregated
                # router's decode policy watches (docs/FLEET.md)
                toks = sum(v for (n, _l), v in cur.items()
                           if n == self.LATENCY + "_count")
                prev_toks = sum(v for (n, _l), v in self._prev.items()
                                if n == self.LATENCY + "_count")
                out["decode_tokens_per_s"] = (
                    max(0.0, toks - prev_toks) / dt
                    / max(1, len(self.urls)))
        self._prev, self._prev_at = cur, now
        return out


# -- wiring ------------------------------------------------------------------


def register_targets_endpoint(policy, name: str = "fleet/targets") -> None:
    """Mount the policy's targets on the metrics endpoint:
    ``GET /control/fleet/targets`` lists them,
    ``GET /control/fleet/targets?set=p99_ttft:0.5`` retunes one at
    runtime (docs/FLEET.md)."""
    from ..metrics import exposition as _expo

    def handler(params: Dict[str, str]) -> Tuple[int, dict]:
        if "set" in params:
            try:
                signal, raw = params["set"].split(":", 1)
                t = policy.set_target(signal.strip(), float(raw))
            except ValueError as e:
                return 400, {"error": str(e)}
            get_logger().warning(
                "fleet: target %s set to %s over HTTP", t.signal, t.value)
        return 200, {"targets": {
            s: {"value": t.value, "invert": t.invert}
            for s, t in policy.targets().items()}}

    _expo.register_control_handler(name, handler)


def maybe_training_autoscaler(request_world_size, current_fn,
                              *, min_size: int, max_size: Optional[int],
                              ) -> Optional[Autoscaler]:
    """The elastic driver's init hook
    (``runner/elastic_driver.py``): build a training autoscaler from
    the environment, or None when nothing opts in.

    ``HVD_TPU_FLEET_PLAN`` (a timed drill plan) wins; otherwise any
    armed ``HVD_TPU_FLEET_*_SLO``/``_FLOOR`` target plus
    ``HVD_TPU_FLEET_SCRAPE`` (comma-separated worker metrics
    endpoints) arms the SLO controller.  Driver min/max-np bound the
    policy either way."""
    import os

    from .policy import TargetTrackingPolicy

    hi = max_size if max_size is not None else 64
    plan = plan_from_env()
    if plan is not None:
        return Autoscaler(plan, request_world_size,
                          current_fn=current_fn, kind="train")
    policy = TargetTrackingPolicy.from_env(min_size=min_size, max_size=hi)
    if not policy.targets():
        return None
    urls = [u for u in os.environ.get(ENV_SCRAPE, "").split(",")
            if u.strip()]
    if not urls:
        get_logger().warning(
            "fleet: SLO targets armed but HVD_TPU_FLEET_SCRAPE is empty "
            "— the training autoscaler has no signal source; not started")
        return None
    register_targets_endpoint(policy)
    return Autoscaler(policy, request_world_size, current_fn=current_fn,
                      signals_fn=EndpointSignalSource(urls), kind="train")
