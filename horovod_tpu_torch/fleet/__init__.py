"""SLO-driven autoscaling and the prefix-affinity serving fleet.

Port of ``horovod_tpu.fleet`` (docs/FLEET.md):

* :mod:`.policy` — target-tracking SLO controller and timed drill plans
  (:class:`TargetTrackingPolicy`, :class:`SchedulePolicy`);
* :mod:`.autoscaler` — the evaluate-and-apply loop, with signals from
  metrics endpoints (:class:`EndpointSignalSource`, which parses what
  ``metrics.exposition.render`` writes);
* :mod:`.router` / :mod:`.replica` — N in-process ``ServingEngine``
  replicas behind prefix-affinity placement, hedging, replica-loss
  migration and the disaggregated prefill→decode tiers;
* :mod:`.preemption` — :class:`PreemptionGuard`: a SIGTERM notice
  becomes a planned snapshot and a clean leave the elastic driver books
  as a scale-down; :func:`maybe_training_autoscaler` is the elastic
  driver's resize hook.

Import shape as in the JAX package: ``policy``/``autoscaler`` are
import-light; ``router``/``replica`` pull in the serving stack and are
re-exported lazily here, as is ``PreemptionGuard``.
"""

from __future__ import annotations

from .autoscaler import (  # noqa: F401
    Autoscaler, EndpointSignalSource, maybe_training_autoscaler,
    parse_prom_text, register_targets_endpoint,
)
from .policy import (  # noqa: F401
    Decision, SchedulePolicy, Target, TargetTrackingPolicy,
    decode_policy_from_env, histogram_quantile, plan_from_env,
    snapshot_signals,
)

__all__ = [
    "Autoscaler", "Decision", "EndpointSignalSource", "FleetRouter",
    "PreemptionGuard", "SchedulePolicy", "ServingReplica", "Target", "TargetTrackingPolicy",
    "decode_policy_from_env", "histogram_quantile",
    "maybe_training_autoscaler", "parse_prom_text", "plan_from_env",
    "register_targets_endpoint", "snapshot_signals",
]

_LAZY = {
    "FleetRouter": ".router",
    "PreemptionGuard": ".preemption",
    "ServingReplica": ".replica",
}


def __getattr__(name: str):
    # router/replica import the serving stack (torch); load on first touch
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod, __name__), name)
