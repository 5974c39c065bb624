"""Serving-replica lifecycle: spawn → warmup → ready → drain → retire.

Copied from ``horovod_tpu/fleet/replica.py`` (host-side); it wraps the
port's :class:`~horovod_tpu_torch.serving.engine.ServingEngine`.


One :class:`ServingReplica` wraps one
:class:`~horovod_tpu_torch.serving.engine.ServingEngine` behind the small
surface the :class:`~horovod_tpu_torch.fleet.router.FleetRouter` needs, and
reuses the metrics, retry and chaos machinery instead of growing its
own:

* **spawn** builds + warms the engine through
  :func:`~horovod_tpu_torch.common.retry.retry_call`
  (site ``fleet.replica_spawn`` — transient construction failures ride
  the shared backoff+jitter policy and land in
  ``hvd_tpu_retry_attempts``), and pins the warmup program count so
  ``compile_free`` is checkable per replica for its whole life;
* **heartbeat**: a replica that HAS work but hasn't completed a step
  within ``HVD_TPU_FLEET_REPLICA_STALL_SECONDS`` reports unhealthy —
  the same has-progress-vs-has-work distinction the transport
  heartbeats draw (busy-compiling peers keep beating; a wedged one
  doesn't).  Each replica registers a ``/healthz`` source
  (``fleet_replica_<name>``) for the life of its engine;
* **drain** stops intake (the engine's ``accepting`` gate) while
  in-flight and already-queued sequences keep stepping to completion;
  ``drained`` is the router's teardown gate — a retiring replica's
  work is never dropped;
* **retire** releases the engine (params + KV pools) and the health
  source.

The replica never decides anything: placement and scaling live in the
router/policy.  It is deliberately process-local — the in-process
fleet is the bench/CI shape, and the lifecycle surface is what a
multi-process deployment would speak over RPC.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from .. import chaos as _chaos
from ..common.retry import env_float, env_int, retry_call
from ..metrics import instruments as _instr
from ..metrics.exposition import (
    register_health_source, unregister_health_source,
)
from ..utils.logging import get_logger

__all__ = ["ServingReplica", "DRAINING", "NEW", "PARKED", "READY",
           "RETIRED"]

NEW = "new"
#: spawned + warmed but not taking traffic — the warm-spare pool the
#: router unparks on scale-out (activation is instant; building and
#: warming an engine mid-traffic is seconds of compile)
PARKED = "parked"
READY = "ready"
DRAINING = "draining"
RETIRED = "retired"

ENV_STALL = "HVD_TPU_FLEET_REPLICA_STALL_SECONDS"
ENV_SPAWN_RETRIES = "HVD_TPU_FLEET_REPLICA_SPAWN_RETRIES"
#: consecutive submit/step errors (or healthz stall trips) before the
#: router marks a replica SUSPECT — ejected from placement, in-flight
#: work re-routed once (docs/FLEET.md)
ENV_ERRORS = "HVD_TPU_FLEET_REPLICA_ERRORS"
#: engine steps between periodic KV snapshots (0 = off): every N
#: completed steps the replica exports its in-flight requests' verified
#: streams + full-block pages (``engine.export_requests``) so the
#: router has a warm migration source even when a replica dies without
#: a drain handshake (docs/SERVING.md fault tolerance)
ENV_SNAPSHOT_STEPS = "HVD_TPU_SERVE_SNAPSHOT_STEPS"


class ServingReplica:
    """One engine's lifecycle wrapper (module docstring)."""

    def __init__(self, name: str, build_fn: Callable[[], object], *,
                 tier: str = "mixed", clock=time.perf_counter):
        self.name = str(name)
        self._build = build_fn
        self._clock = clock
        #: placement tier in a disaggregated fleet: ``"prefill"``
        #: (engine role ``prefill`` — requests leave at the handoff
        #: boundary), ``"decode"`` (full-menu engine that receives the
        #: migrated KV), or ``"mixed"`` (the single-tier default; both
        #: phases on every replica).  Pure routing metadata — the
        #: lifecycle below is tier-blind (docs/FLEET.md).
        self.tier = str(tier)
        self.state = NEW
        self.engine = None
        self.warmed_programs = 0
        self.spawned_at: Optional[float] = None
        self.retired_at: Optional[float] = None
        self._last_progress: Optional[float] = None
        self._stall_s = env_float(ENV_STALL, 60.0)
        #: peak of :meth:`queue_depth` over this replica's life (bench)
        self.peak_queue_depth = 0
        #: SUSPECT: ejected from placement after consecutive errors or
        #: a stall trip (router re-routes its work; docs/FLEET.md)
        self.suspect = False
        #: the router's ejection already ran (re-entrancy guard: a
        #: voluntarily-DRAINING replica that then stalls must still be
        #: ejectable, so the guard is this flag, not the state)
        self.ejected = False
        self._errors = 0
        self._error_threshold = max(1, env_int(ENV_ERRORS, 3))
        #: EMA of step wall time — the router's queue-delay estimate
        #: (deadline-aware placement) multiplies it by queue depth
        self.avg_step_s: Optional[float] = None
        #: periodic KV snapshot cadence (steps; 0 = off) and the last
        #: snapshot taken — the router's warm-migration fallback when
        #: this replica dies without a drain handshake
        self._snapshot_steps = max(0, env_int(ENV_SNAPSHOT_STEPS, 0))
        self._steps_since_snapshot = 0
        self.kv_snapshots: dict = {}

    # -- lifecycle -----------------------------------------------------------

    def spawn(self, park: bool = False) -> "ServingReplica":
        """Build + warm the engine (retry-wrapped); READY on return —
        or PARKED with ``park=True`` (a warm spare: fully compiled,
        taking no traffic until :meth:`unpark`).  Warmup compiles the
        engine's WHOLE tier menu, so a replica activated mid-traffic
        serves its first request compile-free — the menu discipline
        every serving PR has held."""
        if self.state != NEW:
            raise RuntimeError(f"replica {self.name} already spawned "
                               f"({self.state})")
        self.engine = retry_call(
            self._build,
            site="fleet.replica_spawn",
            retry_on=(RuntimeError, OSError),
            attempts=max(1, env_int(ENV_SPAWN_RETRIES, 3)),
            describe=f"serving replica {self.name} build",
        )
        # every kvsnap this engine exports names its sender, so a
        # chain-hash reject on the far side of a handoff or migration
        # points at the originating replica
        self.engine.snap_source = self.name
        self.warmed_programs = self.engine.warmup()
        self.engine.token_log = []
        self.state = PARKED if park else READY
        self.spawned_at = self._last_progress = self._clock()
        register_health_source(f"fleet_replica_{self.name}", self._health)
        get_logger().info("fleet: replica %s %s (%d tier programs)",
                          self.name, self.state, self.warmed_programs)
        return self

    def unpark(self) -> None:
        """Activate a warm spare (instant — the engine is compiled)."""
        if self.state != PARKED:
            raise RuntimeError(
                f"replica {self.name} is {self.state}, not parked")
        self.state = READY
        self._last_progress = self._clock()

    def drain(self) -> None:
        """Stop intake; in-flight + queued sequences keep stepping."""
        if self.state in (READY, PARKED):
            self.state = DRAINING
            self.engine.accepting = False

    @property
    def drained(self) -> bool:
        """True once nothing is left in flight (the teardown gate).
        A parked handoff counts as in flight: the snapshot only lives
        in this engine until the router's next collection pass, so a
        prefill-tier replica retiring mid-drain must hold its engine
        until every handoff has been picked up."""
        if self.engine is None:
            return True
        return not self.has_work and not getattr(
            self.engine, "handoffs", None)

    def retire(self) -> None:
        """Release the engine (params + KV pools) and health source.
        Call only when :attr:`drained` — the router enforces it."""
        if self.state == RETIRED:
            return
        if not self.drained:
            raise RuntimeError(
                f"replica {self.name} still has work; drain before retire")
        unregister_health_source(f"fleet_replica_{self.name}")
        # final accounting outlives the engine (fleet-wide bench stats)
        sched = self.engine.scheduler
        self._final_hits = sched.prefix_hit_blocks
        self._final_lookups = sched.prefix_lookup_blocks
        self._final_compile_free = self.compile_free
        self._final_ttfts = self.ttft_samples()
        self.state = RETIRED
        self.retired_at = self._clock()
        self.engine = None
        get_logger().info("fleet: replica %s retired", self.name)

    # -- the router's working surface ----------------------------------------

    @property
    def accepting(self) -> bool:
        return self.state == READY and not self.suspect

    @property
    def has_work(self) -> bool:
        sched = self.engine.scheduler
        return bool(sched.running or sched.pending
                    or sched.staged_depth())

    def note_error(self) -> bool:
        """Book one submit/step error or stall trip.  Returns True on
        the transition to SUSPECT (``HVD_TPU_FLEET_REPLICA_ERRORS``
        consecutive errors) — the router then ejects the replica and
        re-routes its work."""
        self._errors += 1
        if self._errors >= self._error_threshold and not self.suspect:
            self.suspect = True
            _instr.FLEET_REPLICA_SUSPECTS.inc()
            get_logger().error(
                "fleet: replica %s SUSPECT after %d consecutive "
                "error(s); ejecting from placement", self.name,
                self._errors)
            return True
        return False

    def note_ok(self) -> None:
        """A successful operation resets the consecutive-error run."""
        self._errors = 0

    def submit(self, prompt, max_new_tokens: int, *, eos_id=None,
               arrival: Optional[float] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               spec_k: Optional[int] = None) -> int:
        if not self.accepting:
            raise RuntimeError(
                f"replica {self.name} is {self.state}, not accepting")
        # a dropped/killed dispatch raises here — the router books it
        # toward this replica's consecutive-error count and retries the
        # request on the next-best survivor (docs/FAULT_TOLERANCE.md)
        _chaos.raise_point("serve.dispatch")
        return self.engine.submit(prompt, max_new_tokens, eos_id=eos_id,
                                  arrival=arrival, deadline_s=deadline_s,
                                  trace_id=trace_id, spec_k=spec_k)

    def step(self) -> bool:
        """One engine step; progress timestamps feed the heartbeat and
        the step-time EMA feeds the queue-delay estimate.  Chaos site
        ``serve.replica_step`` fires BEFORE the engine steps — a raise
        here books toward the consecutive-error threshold exactly like
        a real step failure (the soak's replica-loss lever); a kill is
        the process-death case the periodic snapshots exist for."""
        _chaos.raise_point("serve.replica_step")
        t0 = self._clock()
        more = self.engine.step()
        now = self._clock()
        dt = max(0.0, now - t0)
        self.avg_step_s = dt if self.avg_step_s is None else (
            0.8 * self.avg_step_s + 0.2 * dt)
        self._last_progress = now
        if self._snapshot_steps > 0:
            self._steps_since_snapshot += 1
            if self._steps_since_snapshot >= self._snapshot_steps:
                self._steps_since_snapshot = 0
                self.snapshot_kv()
        return more

    def snapshot_kv(self) -> None:
        """Export every in-flight request's verified stream + full-block
        pages (the router's warm-migration fallback source).  Chaos
        site ``serve.snapshot``: a drop here skips THIS cadence — the
        previous snapshot stays valid (recovery falls further behind
        the stream, never wrong: the migrated prefix is still a
        verified prefix and the survivor regenerates the rest)."""
        try:
            _chaos.raise_point("serve.snapshot")
        except _chaos.ChaosInjected:
            return
        self.kv_snapshots = self.engine.export_requests()

    def est_queue_delay(self) -> float:
        """Rough seconds of queue ahead of a new request on this
        replica (queue depth x step-time EMA) — the router skips
        replicas whose estimate already exceeds a request's remaining
        deadline budget."""
        return (self.avg_step_s or 0.0) * self.queue_depth()

    def queue_depth(self) -> int:
        """Requests waiting for admission on this replica (scheduler
        pending + device-staged) — the least-queue routing signal,
        the same sum the ``hvd_tpu_serve_queue_depth`` gauge carries."""
        depth = self.engine.scheduler.queue_depth()
        self.peak_queue_depth = max(self.peak_queue_depth, depth)
        return depth

    def cached_prefix_blocks(self, tokens: Sequence[int]) -> int:
        """Blocks of ``tokens``' longest prefix this replica's
        published block-hash index already holds — the affinity
        placement score.  A pure peek: no refcounts move (the real
        match happens at admission on whichever replica wins)."""
        prompt = np.asarray(tokens).reshape(-1)
        bs = self.engine.allocator.block_size
        return self.engine.allocator.peek_prefix(
            prompt, max_blocks=(len(prompt) - 1) // bs)

    @property
    def compile_free(self) -> bool:
        """No step ran outside the menu its warmup booked (the JAX
        engine's zero post-warmup compiles; the port's engine books
        each step's tier key), per replica."""
        return (self.engine is not None
                and self.engine.program_count == self.warmed_programs)

    def ttft_samples(self):
        """(request_id, ttft_seconds) for every first token this
        replica emitted — the router's SLO signal feed; survives
        retirement (the final list is captured before the engine is
        released)."""
        if self.engine is None:
            return list(getattr(self, "_final_ttfts", ()))
        seen = set()
        out = []
        for rid, emit, arr in (self.engine.token_log or ()):
            if rid not in seen:
                seen.add(rid)
                out.append((rid, emit - arr))
        return out

    # -- heartbeat -----------------------------------------------------------

    def _health(self):
        stalled = False
        if self.state in (READY, DRAINING) and self.engine is not None \
                and self.has_work and self._last_progress is not None:
            stalled = (self._clock() - self._last_progress) > self._stall_s
        return not stalled, {
            "state": self.state,
            "queue_depth": self.queue_depth() if self.engine else 0,
            "stalled": stalled,
        }

    def healthy(self) -> bool:
        return self._health()[0]
