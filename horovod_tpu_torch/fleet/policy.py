"""Autoscale policy engine: decide capacity from live signals.

Copied from ``horovod_tpu/fleet/policy.py`` (stdlib only).


The closed loop's brain (docs/FLEET.md): the sensors already exist —
the registry's gauges and histograms, heartbeats and recovery
accounting — but nothing *decided* capacity; upstream
Horovod's elastic mode only ever reacts to failures (SURVEY §5.3).
This module turns "what the gauges say" into "how many workers /
serving replicas there should be", and nothing else: it never spawns,
drains or kills anything itself.  The appliers live in
:mod:`.autoscaler` (training worlds via
``ElasticDriver.request_world_size``) and :mod:`.router` (serving
replicas via spawn/drain/retire).

Two policies share the :meth:`evaluate` interface
``(signals, current, now) -> Decision``:

* :class:`TargetTrackingPolicy` — the SLO controller.  Each
  :class:`Target` names a signal (``p99_ttft``, ``queue_depth``,
  ``step_time``, ``throughput``...) and the value it should sit at;
  the load ratio ``observed / target`` (inverted for floor-style
  targets such as throughput) is the classic target-tracking control
  signal: ratio 2.0 means the fleet is carrying twice the load its
  capacity should, so capacity doubles.  Three dampers keep
  chaos-injected noise (and real-world flapping) from thrashing it:

  - a **deadband** around 1.0 inside which nothing happens,
  - **hysteresis** on scale-in: every watched ratio must sit under
    ``scale_in_at`` for N consecutive evaluations (capacity removal is
    the dangerous direction — a single quiet sample must not shed the
    replica that was absorbing the burst),
  - a **cooldown** after any applied action, both directions (the
    signal needs time to reflect the new capacity before it is judged
    again).

* :class:`SchedulePolicy` — a timed resize plan (``"4:3,10:2"`` =
  size 3 from t=4 s, size 2 from t=10 s).  The drill/soak form of the
  same loop: chaos-soak scenarios and capacity rehearsals drive the
  exact code path the SLO controller drives, with deterministic
  timing.  ``HVD_TPU_FLEET_PLAN`` wires it into the elastic driver.

Targets are settable three ways: at construction, from the
environment (:meth:`TargetTrackingPolicy.from_env`, the
``HVD_TPU_FLEET_*`` rows in docs/running.md), and over HTTP while the
job runs (:func:`horovod_tpu.fleet.autoscaler.register_targets_endpoint`
mounts ``/control/fleet/targets`` on the metrics endpoint).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.retry import env_float, env_int

__all__ = [
    "Decision", "SchedulePolicy", "Target", "TargetTrackingPolicy",
    "decode_policy_from_env", "histogram_quantile", "snapshot_signals",
]

# the SLO knobs (docs/running.md): a target is armed iff its variable
# is set to a positive value
ENV_TTFT_SLO = "HVD_TPU_FLEET_TTFT_SLO"
ENV_QUEUE_SLO = "HVD_TPU_FLEET_QUEUE_SLO"
ENV_STEP_TIME_SLO = "HVD_TPU_FLEET_STEP_TIME_SLO"
ENV_THROUGHPUT_FLOOR = "HVD_TPU_FLEET_THROUGHPUT_FLOOR"
#: decode-tier throughput floor (tokens/s per accepting decode
#: replica) for the disaggregated serving fleet — kept OUT of
#: :meth:`TargetTrackingPolicy.from_env` so setting it never arms a
#: decode target on a training fleet's policy (docs/FLEET.md)
ENV_DECODE_TPS_FLOOR = "HVD_TPU_FLEET_DECODE_TPS_FLOOR"


@dataclasses.dataclass(frozen=True)
class Target:
    """One SLO: ``signal`` should sit at ``value``.

    ``invert=False`` (ceilings: p99 TTFT, queue depth, step time):
    load ratio = observed / value — above 1.0 means overloaded.
    ``invert=True`` (floors: throughput): ratio = value / observed —
    a throughput UNDER the floor reads as overload the same way."""

    signal: str
    value: float
    invert: bool = False

    def ratio(self, observed: float) -> Optional[float]:
        if self.value <= 0:
            return None
        if not self.invert:
            return observed / self.value
        # a floor with a zero observation is infinitely underserved
        return math.inf if observed <= 0 else self.value / observed


@dataclasses.dataclass(frozen=True)
class Decision:
    """One policy evaluation's outcome.  ``direction`` is ``"out"``,
    ``"in"`` or ``"hold"``; ``desired`` is the capacity the fleet
    should converge to (== ``current`` on hold)."""

    direction: str
    desired: int
    reason: str
    signal: Optional[str] = None
    value: Optional[float] = None
    ratio: Optional[float] = None


class TargetTrackingPolicy:
    """Target-tracking scale controller with deadband, scale-in
    hysteresis and cooldown (module docstring).  Thread-safe:
    :meth:`set_target` may be called from the HTTP control handler
    while :meth:`evaluate` runs on the autoscaler thread."""

    def __init__(self, targets: Sequence[Target], *,
                 min_size: int = 1, max_size: int = 8,
                 deadband: float = 0.1, scale_in_at: float = 0.5,
                 hysteresis: int = 3, cooldown_s: float = 30.0):
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"need 1 <= min_size <= max_size, got {min_size}/{max_size}")
        if not 0.0 < scale_in_at < 1.0:
            raise ValueError(
                f"scale_in_at must be in (0, 1), got {scale_in_at}")
        if deadband < 0:
            raise ValueError(f"deadband must be >= 0, got {deadband}")
        self._lock = threading.Lock()
        self._targets: Dict[str, Target] = {t.signal: t for t in targets}
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.deadband = float(deadband)
        self.scale_in_at = float(scale_in_at)
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown_s = float(cooldown_s)
        self._low_streak = 0
        self._last_action_at: Optional[float] = None

    # -- targets (env-, call- and HTTP-settable) ----------------------------

    def targets(self) -> Dict[str, Target]:
        with self._lock:
            return dict(self._targets)

    def set_target(self, signal: str, value: float,
                   invert: Optional[bool] = None) -> Target:
        """Replace (or create) one target's value at runtime; the next
        evaluation uses it.  ``invert`` defaults to the existing
        target's orientation (False for a new signal)."""
        value = float(value)
        if value <= 0:
            raise ValueError(f"target for {signal!r} must be > 0")
        with self._lock:
            old = self._targets.get(signal)
            inv = old.invert if (invert is None and old is not None) \
                else bool(invert)
            t = Target(signal, value, inv)
            self._targets[signal] = t
            return t

    @classmethod
    def from_env(cls, *, min_size: Optional[int] = None,
                 max_size: Optional[int] = None) -> "TargetTrackingPolicy":
        """Build from the ``HVD_TPU_FLEET_*`` knobs (docs/running.md):
        a target is armed iff its SLO variable is set to a positive
        value; the damper knobs always apply."""
        targets = []
        for env, signal, invert in (
                (ENV_TTFT_SLO, "p99_ttft", False),
                (ENV_QUEUE_SLO, "queue_depth", False),
                (ENV_STEP_TIME_SLO, "step_time", False),
                (ENV_THROUGHPUT_FLOOR, "throughput", True)):
            v = env_float(env, 0.0)
            if v > 0:
                targets.append(Target(signal, v, invert))
        return cls(
            targets,
            min_size=min_size if min_size is not None
            else env_int("HVD_TPU_FLEET_MIN", 1),
            max_size=max_size if max_size is not None
            else env_int("HVD_TPU_FLEET_MAX", 8),
            deadband=env_float("HVD_TPU_FLEET_DEADBAND", 0.1),
            scale_in_at=env_float("HVD_TPU_FLEET_SCALE_IN_AT", 0.5),
            hysteresis=env_int("HVD_TPU_FLEET_HYSTERESIS", 3),
            cooldown_s=env_float("HVD_TPU_FLEET_COOLDOWN", 30.0),
        )

    # -- the decision --------------------------------------------------------

    def note_applied(self, now: Optional[float] = None) -> None:
        """The caller applied a decision: start the cooldown window.
        Kept separate from :meth:`evaluate` so a decision the applier
        could NOT honor (no free slots, replica spawn failed) does not
        burn the cooldown."""
        with self._lock:
            self._last_action_at = time.monotonic() if now is None else now

    def evaluate(self, signals: Dict[str, float], current: int,
                 now: Optional[float] = None) -> Decision:
        now = time.monotonic() if now is None else now
        current = max(1, int(current))
        with self._lock:
            targets = list(self._targets.values())
            cooling = (self._last_action_at is not None
                       and now - self._last_action_at < self.cooldown_s)
            ratios: List[Tuple[float, Target, float]] = []
            for t in targets:
                if t.signal not in signals:
                    continue
                v = float(signals[t.signal])
                r = t.ratio(v)
                if r is not None:
                    ratios.append((r, t, v))
            if not ratios:
                self._low_streak = 0
                return Decision("hold", current, "no watched signals")
            worst_r, worst_t, worst_v = max(ratios, key=lambda x: x[0])

            # -- scale out: any ratio past the deadband -----------------
            if worst_r > 1.0 + self.deadband:
                self._low_streak = 0
                if cooling:
                    return Decision("hold", current,
                                    "overloaded but cooling down",
                                    worst_t.signal, worst_v, worst_r)
                desired = min(self.max_size,
                              max(current + 1,
                                  math.ceil(current * min(worst_r, 8.0))))
                if desired <= current:
                    return Decision("hold", current, "already at max_size",
                                    worst_t.signal, worst_v, worst_r)
                return Decision(
                    "out", desired,
                    f"{worst_t.signal}={worst_v:.4g} is "
                    f"{worst_r:.2f}x its target {worst_t.value:.4g}",
                    worst_t.signal, worst_v, worst_r)

            # -- scale in: EVERY ratio low, streak + cooldown permitting
            if worst_r < self.scale_in_at:
                self._low_streak += 1
                if self._low_streak < self.hysteresis:
                    return Decision("hold", current,
                                    f"underloaded {self._low_streak}/"
                                    f"{self.hysteresis} evaluations",
                                    worst_t.signal, worst_v, worst_r)
                if cooling:
                    return Decision("hold", current,
                                    "underloaded but cooling down",
                                    worst_t.signal, worst_v, worst_r)
                if current <= self.min_size:
                    return Decision("hold", current, "already at min_size",
                                    worst_t.signal, worst_v, worst_r)
                # one step at a time: removing capacity is the risky
                # direction, and the cooldown re-judges before the next
                return Decision(
                    "in", current - 1,
                    f"all signals under {self.scale_in_at:.2f}x of "
                    f"target for {self._low_streak} evaluations",
                    worst_t.signal, worst_v, worst_r)

            self._low_streak = 0
            return Decision("hold", current, "within deadband",
                            worst_t.signal, worst_v, worst_r)


class SchedulePolicy:
    """A timed resize plan: ``[(t_offset_s, size), ...]``; the desired
    size is the last entry whose offset has elapsed (before the first
    entry: hold at current).  The drill form of the closed loop —
    chaos-soak scale scenarios and capacity rehearsals drive the same
    ``request_world_size``/replica paths the SLO controller drives,
    with deterministic timing.  Spec grammar (``HVD_TPU_FLEET_PLAN``):
    ``"T:N[,T:N...]"``, offsets in seconds, strictly ascending."""

    def __init__(self, plan: Sequence[Tuple[float, int]],
                 t0: Optional[float] = None):
        plan = [(float(t), int(n)) for t, n in plan]
        if not plan:
            raise ValueError("empty resize plan")
        if any(n < 1 for _, n in plan):
            raise ValueError(f"plan sizes must be >= 1: {plan}")
        if any(b <= a for (a, _), (b, _) in zip(plan, plan[1:])):
            raise ValueError(f"plan offsets must be strictly ascending: "
                             f"{plan}")
        self.plan = plan
        self._t0 = t0  # lazily pinned at the first evaluate

    @classmethod
    def parse(cls, spec: str, t0: Optional[float] = None) -> "SchedulePolicy":
        entries = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                t, n = part.split(":", 1)
                entries.append((float(t), int(n)))
            except ValueError:
                raise ValueError(
                    f"bad plan entry {part!r} (want T_SECONDS:SIZE)"
                ) from None
        return cls(entries, t0=t0)

    def evaluate(self, signals: Dict[str, float], current: int,
                 now: Optional[float] = None) -> Decision:
        now = time.monotonic() if now is None else now
        if self._t0 is None:
            self._t0 = now
        elapsed = now - self._t0
        desired = None
        for t, n in self.plan:
            if elapsed >= t:
                desired = n
        if desired is None or desired == current:
            return Decision("hold", current, f"plan holds at t={elapsed:.1f}s")
        direction = "out" if desired > current else "in"
        return Decision(direction, desired,
                        f"plan entry t<={elapsed:.1f}s wants {desired}")

    def note_applied(self, now: Optional[float] = None) -> None:
        pass  # the plan is time-driven; no cooldown state


# -- signal extraction -------------------------------------------------------


def histogram_quantile(bounds: Sequence[float], counts: Sequence[float],
                       q: float) -> float:
    """Prometheus-style quantile from fixed-bucket counts.

    ``counts`` are PER-BUCKET observation counts aligned with
    ``bounds`` plus one trailing overflow bucket (+Inf) — the registry
    snapshot/cluster_snapshot layout.  Linear interpolation within the
    winning bucket; the overflow bucket clamps to the last bound (the
    honest answer a bounded histogram can give)."""
    if len(counts) not in (len(bounds), len(bounds) + 1):
        raise ValueError(
            f"counts ({len(counts)}) must align with bounds "
            f"({len(bounds)}) plus an optional overflow bucket")
    total = float(sum(counts))
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    prev_bound = 0.0
    for i, n in enumerate(counts):
        lo = cum
        cum += float(n)
        if cum >= rank and n > 0:
            if i >= len(bounds):
                return float(bounds[-1])
            hi_bound = float(bounds[i])
            frac = (rank - lo) / float(n)
            return prev_bound + (hi_bound - prev_bound) * frac
        if i < len(bounds):
            prev_bound = float(bounds[i])
    return float(bounds[-1])


def _series_sum(entry: dict) -> float:
    return sum(float(state) for _labels, state in entry.get("series", []))


def snapshot_signals(snap: dict, prev: Optional[dict] = None,
                     dt: Optional[float] = None) -> Dict[str, float]:
    """Extract the policy's standard signals from a
    :func:`horovod_tpu.metrics.aggregate.cluster_snapshot` /
    ``snapshot()`` dict — the driver-side loop consumes the gauges the
    workers already publish instead of growing a second telemetry path.

      queue_depth  sum of ``hvd_tpu_serve_queue_depth`` across ranks
      p99_ttft     q0.99 of the ``first``-kind token-latency histogram
      step_time    q0.50 of ``hvd_tpu_step_duration_seconds``
      throughput   rate of ``hvd_tpu_serve_steps_total`` (or training
                   step count) between ``prev`` and ``snap`` over
                   ``dt`` seconds — needs both; omitted otherwise

    Missing metrics simply produce no signal (the policy skips absent
    signals), so one extractor serves training and serving snapshots.
    """
    metrics = snap.get("metrics", {})
    out: Dict[str, float] = {}
    q = metrics.get("hvd_tpu_serve_queue_depth")
    if q is not None:
        # gauges carry a synthetic leading rank label in merged
        # snapshots; summing the series is the fleet-wide queue either way
        out["queue_depth"] = _series_sum(q)
    lat = metrics.get("hvd_tpu_serve_token_latency_seconds")
    if lat is not None and lat.get("buckets"):
        for labels, state in lat.get("series", []):
            if list(labels) and list(labels)[-1] == "first" \
                    and state.get("count", 0) > 0:
                out["p99_ttft"] = histogram_quantile(
                    lat["buckets"], state["buckets"], 0.99)
                break
    step = metrics.get("hvd_tpu_step_duration_seconds")
    if step is not None and step.get("buckets"):
        buckets = [0.0] * (len(step["buckets"]) + 1)
        count = 0
        for _labels, state in step.get("series", []):
            count += state.get("count", 0)
            for i, n in enumerate(state.get("buckets", [])):
                if i < len(buckets):
                    buckets[i] += n
        if count > 0:
            out["step_time"] = histogram_quantile(
                step["buckets"], buckets, 0.5)
    if prev is not None and dt and dt > 0:
        cur_e = metrics.get("hvd_tpu_serve_steps_total")
        if cur_e is not None:
            prev_e = prev.get("metrics", {}).get(
                "hvd_tpu_serve_steps_total")
            delta = _series_sum(cur_e) - (
                _series_sum(prev_e) if prev_e else 0.0)
            out["throughput"] = max(0.0, delta) / dt
    return out


def decode_policy_from_env() -> Optional["TargetTrackingPolicy"]:
    """The disaggregated router's decode-tier policy
    (``HVD_TPU_FLEET_DECODE_TPS_FLOOR``, docs/FLEET.md): a floor-style
    target on ``decode_tokens_per_s`` — per-replica decode throughput
    UNDER the floor reads as overload (too few decode replicas for the
    handoff inflow), so the decode tier scales out; comfortably above
    it, the hysteresis/cooldown dampers let it shed.  Returns None
    unless the floor is set positive.  The prefill tier keeps the
    generic :meth:`TargetTrackingPolicy.from_env` (TTFT-shaped — time
    to first token is decided entirely before the handoff)."""
    floor = env_float(ENV_DECODE_TPS_FLOOR, 0.0)
    if floor <= 0:
        return None
    return TargetTrackingPolicy(
        [Target("decode_tokens_per_s", floor, invert=True)],
        min_size=env_int("HVD_TPU_FLEET_MIN", 1),
        max_size=env_int("HVD_TPU_FLEET_MAX", 8),
        deadband=env_float("HVD_TPU_FLEET_DEADBAND", 0.1),
        scale_in_at=env_float("HVD_TPU_FLEET_SCALE_IN_AT", 0.5),
        hysteresis=env_int("HVD_TPU_FLEET_HYSTERESIS", 3),
        cooldown_s=env_float("HVD_TPU_FLEET_COOLDOWN", 30.0),
    )


ENV_PLAN = "HVD_TPU_FLEET_PLAN"


def plan_from_env() -> Optional[SchedulePolicy]:
    """The driver's drill hook: a :class:`SchedulePolicy` when
    ``HVD_TPU_FLEET_PLAN`` is set, else None."""
    spec = os.environ.get(ENV_PLAN, "").strip()
    return SchedulePolicy.parse(spec) if spec else None
