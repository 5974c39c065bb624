"""Fleet router: prefix-affinity placement + SLO-driven replica scale.

Copied from ``horovod_tpu/fleet/router.py`` (host-side); every engine
behind it is the port's.


The serving half of the closed loop (docs/FLEET.md).  One engine
serves from one card; serving more traffic than one card can carry
means *replicating* engines — and once there are replicas, placement IS
latency: the prefix cache is a large TTFT lever, and a request routed to a replica that has never seen its template pays the
full prefill that another replica would have served from cache.

**Placement rule** (SGLang's RadixAttention routing, on this repo's
block-hash index instead of a radix tree):

1. score every accepting replica by
   :meth:`~horovod_tpu_torch.fleet.replica.ServingReplica.cached_prefix_blocks`
   — the longest leading run of the prompt's chain hashes present in
   that replica's published block index (a pure peek; no refcounts
   move);
2. route to the best scorer (``affinity``);
3. on an all-zero tie — an unseen template — fall back to the
   replica with the least queue depth (``least_queue``), which both
   balances load AND spreads templates across replicas, so the cache
   working set partitions instead of replicating;
4. ``mode="round_robin"`` bypasses 1-3 — the A/B baseline
   ``tools/serve_bench.py --fleet`` measures against.

Placement moves *time*, never values: greedy decode is deterministic,
so outputs are token-identical under any routing (the bench asserts
it before reporting a number).

**Scaling**: the same :mod:`.policy` engine that resizes training
worlds evaluates the router's in-process signals — sliding-window p99
TTFT and mean queue depth per accepting replica — against the
``HVD_TPU_FLEET_*`` SLOs.  Scale-out spawns + warms a replica before
it takes traffic (zero mid-traffic compiles, the standing menu
contract); scale-in picks the accepting replica with the least queued
work, **drains** it (no new placements; in-flight and queued
sequences step to completion) and retires it only once empty.

**Disaggregation** (``prefill_replicas > 0`` /
``HVD_TPU_FLEET_PREFILL_REPLICAS``; the Splitwise /
DistServe shape): the fleet splits into a **prefill tier** (engines
built with ``role="prefill"`` — mixed chunk programs only, requests
leave at the handoff boundary) and a **decode tier** (full-menu
engines).  A request routes into the prefill tier, chunks its prompt
there, and at prefill completion its paged-KV block chain crosses the
tier boundary as a ``kvsnap/1`` snapshot (chaos site
``serve.handoff``): chain-hash verified re-registration on a decode
replica (**warm** — decode re-prefixes from cache, zero prefill
recompute) or, when the wire drops/corrupts, a deterministic cold
re-prefill.  Decode steps never share a batch with prefill chunks
again — the interference chunking only *bounded* is structurally
gone.  Each tier scales on its own signal: TTFT drives the prefill
tier (``policy``), per-replica decode tokens/s drives the decode tier
(``decode_policy`` / ``HVD_TPU_FLEET_DECODE_TPS_FLOOR``).  Placement
still moves time, never values — the handoff is the replica-loss
migration machinery on the happy path, so outputs stay token-identical.

The router is single-threaded and in-process: callers drive it with
:meth:`submit` + :meth:`step` (or :meth:`run_until_drained`), the
same way the engine itself is driven.  That is the bench/CI shape;
the surface (submit/step/scale) is what a multi-process front-end
would put behind RPC.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import chaos as _chaos
from .. import trace as _trace
from ..common.retry import env_float, env_int
from ..metrics import instruments as _instr
from ..ops.comm_model import measured_kvsnap_bytes
from ..trace import flight as _flight
from ..utils.logging import get_logger
from .policy import TargetTrackingPolicy, decode_policy_from_env
from .replica import DRAINING, PARKED, READY, RETIRED, ServingReplica

__all__ = ["FleetRouter"]


@dataclasses.dataclass
class _Placement:
    """Where one router-global request currently lives — enough to
    re-submit it verbatim if its replica turns suspect (greedy decode
    is deterministic, so a re-routed request regenerates identical
    tokens on the survivor)."""

    replica: ServingReplica
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    arrival: Optional[float]
    deadline_s: Optional[float]
    #: trace context born at submit — a re-route must carry it so the
    #: survivor's spans still correlate with the fleet.route event
    trace_id: Optional[str] = None
    #: per-request speculative lookahead knob — re-routes carry it so a
    #: survivor decodes the request under the same k (greedy outputs
    #: are k-independent; the knob moves throughput/latency only)
    spec_k: Optional[int] = None
    rerouted: bool = False
    #: the emitted-token WATERMARK: tokens already generated before a
    #: migration, carried in the re-submitted prompt.  ``prompt`` stays
    #: the ORIGINAL client prompt for its whole life, so the collection
    #: pass prepends this prefix to the survivor's output exactly once
    #: — generated tokens are never emitted twice (docs/SERVING.md)
    prefix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    #: live hedged second dispatch, (replica, rid); first completion
    #: wins, the loser is cancelled
    hedge: Optional[Tuple[ServingReplica, int]] = None
    #: a hedge decision was already taken for this placement (issued OR
    #: suppressed) — each request is considered at most once
    hedged: bool = False
    #: router-clock stamp of the current dispatch (the hedge age base)
    placed_at: Optional[float] = None
    #: which tier the request currently lives on: ``"mixed"`` (the
    #: single-tier fleet), ``"prefill"`` (disagg, pre-handoff) or
    #: ``"decode"`` (disagg, post-handoff) — hedging and ejection
    #: survivor walks stay within the placement's tier
    tier: str = "mixed"

_ROUTE_AFFINITY = _instr.FLEET_ROUTED.labels("affinity")
_ROUTE_LEAST_QUEUE = _instr.FLEET_ROUTED.labels("least_queue")
_ROUTE_RR = _instr.FLEET_ROUTED.labels("round_robin")
_MIGRATE_WARM = _instr.SERVE_MIGRATIONS.labels("warm")
_MIGRATE_COLD = _instr.SERVE_MIGRATIONS.labels("cold")
_HEDGE_WON = _instr.SERVE_HEDGES.labels("won")
_HEDGE_LOST = _instr.SERVE_HEDGES.labels("lost")
_HEDGE_SUPPRESSED = _instr.SERVE_HEDGES.labels("suppressed")
_HANDOFF_WARM = _instr.SERVE_HANDOFFS.labels("warm")
_HANDOFF_COLD = _instr.SERVE_HANDOFFS.labels("cold")

#: prefill-tier replica count: > 0 turns disaggregation on (the
#: ``replicas`` argument then sizes the decode tier); 0 (default)
#: keeps the classic single-tier fleet (docs/FLEET.md).
ENV_PREFILL_REPLICAS = "HVD_TPU_FLEET_PREFILL_REPLICAS"


class FleetRouter:
    """Spread open-loop load across N serving replicas (module
    docstring).  ``build_engine`` constructs one fresh
    :class:`~horovod_tpu_torch.serving.engine.ServingEngine` per replica
    (replicas must be homogeneous — same params, same menus — for
    placement-independent outputs)."""

    def __init__(self, build_engine: Callable[[], object], *,
                 replicas: int = 2, mode: str = "affinity",
                 policy: Optional[TargetTrackingPolicy] = None,
                 spares: int = 0, max_skew: int = 32,
                 ttft_window: int = 64,
                 prefill_replicas: Optional[int] = None,
                 decode_policy: Optional[TargetTrackingPolicy] = None,
                 clock=time.perf_counter):
        if mode not in ("affinity", "round_robin"):
            raise ValueError(f"unknown routing mode {mode!r}")
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        if prefill_replicas is None:
            prefill_replicas = env_int(ENV_PREFILL_REPLICAS, 0)
        if prefill_replicas < 0:
            raise ValueError(
                f"need >= 0 prefill replicas, got {prefill_replicas}")
        self._build = build_engine
        self.mode = mode
        self.policy = policy
        #: disaggregated two-tier fleet (module docstring): ``replicas``
        #: sizes the decode tier, ``prefill_replicas`` the prefill tier
        self.disagg = int(prefill_replicas) > 0
        #: decode-tier scale policy (tokens/s-per-replica floor); the
        #: generic ``policy`` drives the prefill tier in disagg mode
        self.decode_policy = decode_policy
        if self.disagg and self.decode_policy is None:
            self.decode_policy = decode_policy_from_env()
        #: cache affinity yields to load balance past this queue skew:
        #: when the cache-best replica's queue exceeds the fleet
        #: minimum by more than ``max_skew``, the request routes
        #: least-queue instead (and the new replica caches the
        #: template — load-driven cache replication, the RadixAttention
        #: balance rule)
        self.max_skew = int(max_skew)
        self._clock = clock
        self._next_name = 0
        self._rr = 0  # round-robin cursor
        self.replicas: List[ServingReplica] = []
        self.retired: List[ServingReplica] = []
        #: global id -> live placement record
        self._placed: Dict[int, _Placement] = {}
        self._next_gid = 0
        self.results: Dict[int, np.ndarray] = {}
        #: (arrival-ordered) sliding window of recent TTFTs — the
        #: policy's p99_ttft signal
        self._ttfts: collections.deque = collections.deque(
            maxlen=max(8, int(ttft_window)))
        self._ttft_seen: Dict[ServingReplica, int] = {}
        #: per-router placement counts (the metric counters aggregate
        #: across routers/legs; the bench wants per-leg numbers)
        self.route_counts = {"affinity": 0, "least_queue": 0,
                             "round_robin": 0}
        #: applied scale actions, in order: (direction, new_size) —
        #: disagg entries carry a third element, the resized tier
        self.scale_events: List[tuple] = []
        #: hedged dispatch (docs/SERVING.md fault tolerance): a request
        #: still waiting on its first token past the sliding p99 TTFT
        #: gets a second, identical dispatch; first completion wins
        self.hedge_enabled = bool(env_int("HVD_TPU_SERVE_HEDGE", 0))
        #: lifetime hedge allowance as a fraction of submitted requests
        #: — the retry budget that keeps hedging from amplifying an
        #: overload past the deadline-shedding bar
        self.hedge_budget = max(0.0, env_float(
            "HVD_TPU_SERVE_HEDGE_BUDGET", 0.1))
        self._submitted = 0
        self._hedges_issued = 0
        #: per-router hedge outcomes (the metric counters aggregate
        #: across routers; the bench wants per-leg numbers)
        self.hedges = {"won": 0, "lost": 0, "suppressed": 0}
        #: per-recovery records ({gid, path, ms}) — bench columns
        self.recovery: List[dict] = []
        #: tier-handoff outcome counts (disagg; bench columns)
        self.handoffs = {"warm": 0, "cold": 0}
        #: per-handoff records ({gid, path, ms, bytes, blocks}) — the
        #: bench's modeled==measured migrated-bytes evidence
        self.handoff_records: List[dict] = []
        #: kvsnap bytes that crossed a replica boundary warm (handoffs
        #: + loss migrations) — mirrors the registry counter per router
        self.migrated_bytes = 0
        #: EMA of handoff wall time — the two-hop deadline filter's
        #: middle term (prefill delay + THIS + decode delay)
        self._handoff_ema: Optional[float] = None
        self._decode_tokens = 0
        self._tok_rate_prev: Optional[Tuple[float, int]] = None
        if self.disagg:
            for _ in range(replicas):
                self._spawn_replica(tier="decode")
            for _ in range(int(prefill_replicas)):
                self._spawn_replica(tier="prefill")
        else:
            for _ in range(replicas):
                self._spawn_replica()
        # warm spares: spawned + warmed now (before traffic), activated
        # instantly at scale-out — building an engine mid-traffic (its
        # pools, the kernel library) costs seconds the SLO can't absorb
        # (disagg: spares join the decode tier — prefill scale-out is
        # the cheaper warmup, its menu is the mixed chunk family only)
        for _ in range(max(0, int(spares))):
            self._spawn_replica(park=True,
                                tier="decode" if self.disagg else "mixed")
        if self.policy is not None:
            self.policy.min_size = max(1, self.policy.min_size)
        if self.decode_policy is not None:
            self.decode_policy.min_size = max(
                1, self.decode_policy.min_size)

    # -- replica lifecycle ---------------------------------------------------

    def _build_for(self, tier: str) -> Callable[[], object]:
        """The engine factory for one tier.  A prefill-tier engine must
        be built with ``role="prefill"`` BEFORE warmup (the role decides
        the program menu): a ``build_engine`` that takes a ``role``
        kwarg gets it passed; otherwise the built engine's role is
        flipped post-construction (warmup runs later, in
        :meth:`ServingReplica.spawn`, so the menu still comes out
        right) and its drafter dropped — speculation is a decode
        accelerator the prefill tier can never use."""
        if tier != "prefill":
            return self._build
        build = self._build
        try:
            params = inspect.signature(build).parameters.values()
            takes_role = any(
                p.name == "role"
                or p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params)
        except (TypeError, ValueError):
            takes_role = False
        if takes_role:
            return lambda: build(role="prefill")

        def build_prefill():
            eng = build()
            eng.role = "prefill"
            eng._drafter = None
            return eng
        return build_prefill

    def _spawn_replica(self, park: bool = False,
                       tier: str = "mixed") -> ServingReplica:
        # tier-prefixed names in disagg mode ("prefill0"/"decode1") so
        # logs, health sources and kvsnap source tags read at a glance
        name = f"{tier}{self._next_name}" if tier != "mixed" \
            else str(self._next_name)
        r = ServingReplica(name, self._build_for(tier), tier=tier,
                           clock=self._clock)
        self._next_name += 1
        r.spawn(park=park)
        self.replicas.append(r)
        self._ttft_seen[r] = 0
        self._book_replica_gauges()
        return r

    def _book_replica_gauges(self) -> None:
        for state in (READY, DRAINING, PARKED):
            _instr.FLEET_REPLICAS.labels(state).set(
                sum(1 for r in self.replicas if r.state == state))

    def _accepting(self, tier: Optional[str] = None
                   ) -> List[ServingReplica]:
        return [r for r in self.replicas if r.accepting
                and (tier is None or r.tier == tier)]

    @property
    def size(self) -> int:
        """Accepting replicas — what the policy scales."""
        return len(self._accepting())

    def tier_size(self, tier: str) -> int:
        """Accepting replicas of one tier (the per-tier policies'
        ``current`` in disagg mode)."""
        return len(self._accepting(tier))

    def scale_to(self, n: int, tier: Optional[str] = None) -> bool:
        """Converge the accepting-replica count to ``n``: unpark warm
        spares (instant) or spawn+warm new replicas to grow, drain the
        least-loaded (retired once empty, by :meth:`step`) to shrink.
        ``tier`` scopes the resize to one tier of a disaggregated
        fleet (spares only unpark into their own tier — a parked
        decode engine has the wrong menu for prefill duty).  Returns
        True when the resize was applied."""
        n = max(1, int(n))
        acc = self._accepting(tier)
        if n > len(acc):
            for _ in range(n - len(acc)):
                spare = next((r for r in self.replicas
                              if r.state == PARKED
                              and (tier is None or r.tier == tier)),
                             None)
                if spare is not None:
                    spare.unpark()
                else:
                    self._spawn_replica(tier=tier or "mixed")
            self._book_replica_gauges()
            return True
        while len(acc) > n and len(acc) > 1:
            victim = min(acc, key=lambda r: (r.queue_depth(),
                                             len(r.engine.scheduler.running)))
            get_logger().info(
                "fleet: draining replica %s (queue %d)", victim.name,
                victim.queue_depth())
            victim.drain()
            acc = self._accepting(tier)
        self._book_replica_gauges()
        return True

    # -- placement -----------------------------------------------------------

    def _two_hop_overhead(self) -> float:
        """Estimated seconds a disaggregated request spends AFTER its
        prefill replica's queue: handoff (EMA) + the best decode-tier
        queue delay.  The deadline filter must charge the full two-hop
        path — judging a prefill replica by its own queue alone admits
        requests whose budget the handoff + decode hop then eats
        (0.0 for a single-tier fleet)."""
        if not self.disagg:
            return 0.0
        dq = min((x.est_queue_delay()
                  for x in self._accepting("decode")), default=0.0)
        return (self._handoff_ema or 0.0) + dq

    def _route(self, prompt: np.ndarray,
               remaining_budget: Optional[float] = None,
               exclude: Tuple[ServingReplica, ...] = (),
               tier: Optional[str] = None,
               extra_delay: float = 0.0) -> ServingReplica:
        acc = [r for r in self._accepting(tier) if r not in exclude]
        if not acc:
            raise RuntimeError("no accepting replicas")
        if self.mode == "round_robin":
            r = acc[self._rr % len(acc)]
            self._rr += 1
            _ROUTE_RR.inc()
            self.route_counts["round_robin"] += 1
            return r
        if remaining_budget is not None:
            # deadline-aware placement: a replica whose estimated queue
            # delay already exceeds the request's remaining budget
            # would only produce a shed — skip it while ANY viable
            # replica exists (all over budget: route normally and let
            # the engine's own deadline machinery shed honestly).
            # ``extra_delay`` charges the hops PAST this replica (the
            # two-hop handoff + decode delay in a disaggregated fleet)
            viable = [r for r in acc
                      if r.est_queue_delay() + extra_delay
                      <= remaining_budget]
            if viable:
                acc = viable
        scores = [(r.cached_prefix_blocks(prompt), r) for r in acc]
        best_score = max(s for s, _ in scores)
        if best_score > 0:
            # ties (same cached span on several replicas) break toward
            # the shorter queue — affinity must not defeat balance
            r = min((r for s, r in scores if s == best_score),
                    key=lambda r: r.queue_depth())
            # the balance escape: a cache hit is worth a bounded queue
            # penalty, not an unbounded one — past max_skew the
            # request routes least-queue and the template replicates
            # onto the cooler replica (load-driven cache replication)
            if r.queue_depth() - min(x.queue_depth() for x in acc) \
                    <= self.max_skew:
                _ROUTE_AFFINITY.inc()
                self.route_counts["affinity"] += 1
                return r
        r = min(acc, key=lambda r: r.queue_depth())
        _ROUTE_LEAST_QUEUE.inc()
        self.route_counts["least_queue"] += 1
        return r

    def submit(self, prompt, max_new_tokens: int, *, eos_id=None,
               arrival: Optional[float] = None,
               deadline_s: Optional[float] = None,
               spec_k: Optional[int] = None) -> int:
        """Place one request; returns a router-global id (key into
        :attr:`results`).  A replica whose ``submit`` raises books an
        error (SUSPECT + ejection at ``HVD_TPU_FLEET_REPLICA_ERRORS``
        consecutive) and THIS request retries on the next-best
        survivor — a raising replica can no longer keep winning
        affinity for its cached templates.  ``spec_k`` is the
        per-request speculative-lookahead knob, forwarded to whichever
        replica wins placement (and to any later re-route)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        remaining = None
        if deadline_s and deadline_s > 0:
            now = self._clock()
            arr = now if arrival is None else arrival
            remaining = max(0.0, deadline_s - (now - arr))
        # trace context is born HERE and propagates router -> replica
        # -> engine -> scheduler: every span the request touches
        # downstream carries this id (docs/TRACING.md)
        tid = _trace.new_trace_id() if _trace.enabled() else None
        # disagg: a fresh request always enters through the prefill
        # tier, and its viability filter charges the whole two-hop path
        tier = "prefill" if self.disagg else None
        extra = self._two_hop_overhead()
        tried: List[ServingReplica] = []
        for _ in range(len(self.replicas) + 1):
            r = self._route(prompt, remaining, exclude=tuple(tried),
                            tier=tier, extra_delay=extra)
            try:
                rid = r.submit(prompt, max_new_tokens, eos_id=eos_id,
                               arrival=arrival, deadline_s=deadline_s,
                               trace_id=tid, spec_k=spec_k)
                r.note_ok()
            except ValueError:
                # client-input validation (over-long prompt, zero
                # max_new_tokens): the CALLER's error, identical on
                # every replica — booking it as replica health would
                # let a few bad requests eject the whole fleet
                raise
            except Exception as e:
                get_logger().warning(
                    "fleet: replica %s submit raised (%s: %s)",
                    r.name, type(e).__name__, e)
                if r.note_error():
                    self._eject(r)
                tried.append(r)
                continue
            gid = self._next_gid
            self._next_gid += 1
            self._submitted += 1
            self._placed[gid] = _Placement(
                replica=r, rid=rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                arrival=arrival, deadline_s=deadline_s, trace_id=tid,
                spec_k=spec_k, placed_at=self._clock(),
                tier=tier or "mixed")
            _trace.event("fleet.route", gid=gid, rid=rid,
                         replica=r.name, mode=self.mode, trace=tid)
            return gid
        raise RuntimeError("no replica accepted the request")

    # -- driving -------------------------------------------------------------

    def step(self) -> bool:
        """One pass: step every replica that has work, collect
        completions and TTFT samples, eject suspects (consecutive step
        errors or a healthz stall trip), retire drained replicas, tick
        the scale policy.  Returns True while anything is in flight."""
        busy = False
        for r in list(self.replicas):
            if r.state == RETIRED or r.engine is None:
                continue
            r.queue_depth()  # sample: keeps peak_queue_depth honest
            # in every routing mode, not just where routing reads it
            if r.has_work:
                busy = True
                try:
                    r.step()
                    r.note_ok()
                except Exception as e:
                    get_logger().warning(
                        "fleet: replica %s step raised (%s: %s)",
                        r.name, type(e).__name__, e)
                    if r.note_error():
                        self._eject(r)
                        continue
            # the healthz stall source (has-work-but-no-progress) feeds
            # the same consecutive-error counter as submit/step raises
            if not r.suspect and r.state in (READY, DRAINING) \
                    and not r.healthy():
                if r.note_error():
                    self._eject(r)
                    continue
            self._collect(r)
            if r.state == DRAINING and r.drained:
                r.retire()
                self.replicas.remove(r)
                self.retired.append(r)
                self._book_replica_gauges()
        if self.disagg:
            # AFTER the per-replica pass: every prefill replica that
            # crossed the handoff boundary this step has parked its
            # snapshots by now; a handoff is only parked by a replica
            # that stepped (busy=True), so run_until_drained cannot
            # exit with one pending.  DRAINING prefill replicas hold
            # their engines until this pass empties them (the
            # handoff-aware ``drained`` gate).
            self._collect_handoffs()
        if self.hedge_enabled:
            self._maybe_hedge()
        if self.policy is not None or self.decode_policy is not None:
            self._maybe_scale()
        return busy

    def _first_token_at(self, p: _Placement) -> Optional[float]:
        """The placement's first-token timestamp on its primary, or
        None while it is still in prefill (the hedgeable phase)."""
        eng = p.replica.engine
        if eng is None:
            return None
        for seq in eng.scheduler.running:
            if seq.req.id == p.rid:
                return seq.first_token_at
        return None

    def _maybe_hedge(self) -> None:
        """Hedged dispatch (``HVD_TPU_SERVE_HEDGE``): a request still
        waiting on its FIRST token past the sliding-window p99 TTFT
        gets one identical second dispatch on the least-queue other
        replica; whichever completes first wins and the loser is
        cancelled (:meth:`_collect`).  Only prefill-phase requests
        hedge — a decoding request's progress would be thrown away,
        and decode stragglers are the ejection path's job.  The
        ``HVD_TPU_SERVE_HEDGE_BUDGET`` fraction bounds total hedges so
        tail-chasing cannot amplify an overload (The Tail at Scale)."""
        if len(self._ttfts) < 16:
            return  # no stable delay estimate yet
        xs = sorted(self._ttfts)
        delay = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        now = self._clock()
        for gid, p in list(self._placed.items()):
            if p.hedged or p.rerouted or p.placed_at is None:
                continue
            if now - p.placed_at <= delay:
                continue
            if self._first_token_at(p) is not None:
                p.hedged = True  # decoding: past the hedgeable phase
                continue
            if self._hedges_issued + 1 > self.hedge_budget * max(
                    1, self._submitted):
                p.hedged = True
                self.hedges["suppressed"] += 1
                _HEDGE_SUPPRESSED.inc()
                continue
            # tier-matched: a hedge is an identical dispatch, and only
            # the placement's own tier has the menu to serve it (in a
            # single-tier fleet every replica is "mixed", so this is
            # the old all-replicas set)
            others = [x for x in self._accepting(p.tier)
                      if x is not p.replica]
            tgt = min(others, key=lambda x: x.queue_depth(),
                      default=None)
            if tgt is None or tgt.est_queue_delay() > delay:
                # no survivor could plausibly beat the primary —
                # a hedge would only add load
                p.hedged = True
                self.hedges["suppressed"] += 1
                _HEDGE_SUPPRESSED.inc()
                continue
            try:
                hrid = tgt.submit(
                    np.concatenate([p.prompt, p.prefix])
                    if p.prefix.size else p.prompt,
                    p.max_new_tokens - int(p.prefix.size),
                    eos_id=p.eos_id, arrival=p.arrival,
                    deadline_s=p.deadline_s, trace_id=p.trace_id,
                    spec_k=p.spec_k)
                tgt.note_ok()
            except Exception as e:
                get_logger().warning(
                    "fleet: hedge to replica %s raised (%s: %s)",
                    tgt.name, type(e).__name__, e)
                tgt.note_error()
                p.hedged = True
                continue
            p.hedged = True
            p.hedge = (tgt, hrid)
            self._hedges_issued += 1
            _trace.event("serve.hedge", gid=gid,
                         primary=p.replica.name, hedge=tgt.name,
                         delay=delay, trace=p.trace_id)

    # -- the tier boundary (disagg): prefill -> decode handoff ---------------

    def _collect_handoffs(self) -> None:
        """Drain every prefill replica's parked handoffs (requests
        whose prefill just completed) into the decode tier."""
        for r in list(self.replicas):
            if r.tier != "prefill" or r.engine is None:
                continue
            pending = getattr(r.engine, "handoffs", None)
            if not pending:
                continue
            for rid in list(pending):
                stream, snap, arr = pending.pop(rid)
                self._dispatch_handoff(r, rid, stream, snap, arr)

    def _dispatch_handoff(self, src: ServingReplica, rid: int,
                          stream, snap: Optional[dict],
                          arr: Optional[float]) -> None:
        """Move ONE prefill-complete request across the tier boundary:
        its ``kvsnap/1`` block chain crosses the ``serve.handoff``
        chaos point and re-registers on a decode replica
        (:meth:`ServingEngine.import_kv` — **warm**: the re-submitted
        request re-prefixes the whole prompt + first token from cache,
        zero prefill recompute on the decode tier); a dropped or
        corrupted wire degrades to **cold** (the decode replica
        re-prefills — deterministic, never wrong, exactly the replica-loss
        migration contract).  The first token the prefill tier emitted
        becomes the placement's watermark, so collection prepends it
        exactly once and TTFT stays a prefill-tier measurement."""
        gid = p = None
        via_hedge = False
        for g, cand in self._placed.items():
            if cand.replica is src and cand.rid == rid:
                gid, p = g, cand
                break
            if cand.hedge is not None and cand.hedge[0] is src \
                    and cand.hedge[1] == rid:
                gid, p, via_hedge = g, cand, True
                break
        if p is None:
            return  # cancelled / already resolved elsewhere
        t0 = self._clock()
        # hedged prefill resolves FIRST-HANDOFF-WINS: both dispatches
        # of a hedged pair prefill independently and each would park a
        # handoff — the first one collected carries the request across,
        # the loser cancels AND its (possibly already-parked) handoff
        # is discarded so the request cannot cross the boundary twice
        if via_hedge:
            loser, lrid = p.replica, p.rid
            p.replica, p.rid = src, rid
            p.hedge = None
            if loser.engine is not None:
                loser.engine.cancel(lrid)
                getattr(loser.engine, "handoffs", {}).pop(lrid, None)
            self.hedges["won"] += 1
            _HEDGE_WON.inc()
        elif p.hedge is not None:
            loser, lrid = p.hedge
            p.hedge = None
            if loser.engine is not None:
                loser.engine.cancel(lrid)
                getattr(loser.engine, "handoffs", {}).pop(lrid, None)
            self.hedges["lost"] += 1
            _HEDGE_LOST.inc()
        # the engine request's prompt is p.prompt (+ any earlier
        # migration watermark), so slicing past the ORIGINAL prompt
        # recovers the full generated run — the _eject idiom
        gen = np.asarray(stream[len(p.prompt):], np.int32)
        if p.eos_id is not None and gen.size:
            hits = np.flatnonzero(gen == p.eos_id)
            if hits.size:
                gen = gen[:int(hits[0]) + 1]
        remaining = p.max_new_tokens - int(gen.size)
        if remaining < 1 or (p.eos_id is not None and gen.size
                             and gen[-1] == p.eos_id):
            # done AT the boundary (eos or budget on the first token):
            # no decode tier needed
            self.results[gid] = gen
            del self._placed[gid]
            return
        wire_snap = None
        if snap is not None:
            wire = np.asarray(snap["tokens"], np.int32).tobytes()
            out = _chaos.point("serve.handoff", wire)
            if out is not _chaos.DROP:
                wire_snap = dict(snap)
                wire_snap["tokens"] = np.frombuffer(out, np.int32)
        remaining_budget = None
        if p.deadline_s and p.deadline_s > 0:
            base = arr if arr is not None else (
                p.arrival if p.arrival is not None else t0)
            remaining_budget = max(0.0, p.deadline_s - (t0 - base))
        full = np.concatenate([p.prompt, gen]) if gen.size else p.prompt
        placed = None
        path = "cold"
        nbytes = 0
        tried: List[ServingReplica] = []
        for _ in range(len(self._accepting("decode")) + 1):
            try:
                tgt = self._route(full, remaining_budget,
                                  exclude=tuple(tried), tier="decode")
            except RuntimeError:
                break  # decode tier empty / exhausted
            try:
                path = "cold"
                if wire_snap is not None:
                    try:
                        tgt.engine.import_kv(wire_snap)
                        path = "warm"
                        nbytes = measured_kvsnap_bytes(wire_snap)
                    except ValueError as e:
                        get_logger().warning(
                            "fleet: handoff snapshot rejected for gid "
                            "%d (%s) — cold re-prefill", gid, e)
                        wire_snap = None  # bad wire: don't retry it
                nrid = tgt.submit(
                    full, int(remaining), eos_id=p.eos_id,
                    arrival=arr if arr is not None else p.arrival,
                    deadline_s=p.deadline_s, trace_id=p.trace_id,
                    spec_k=p.spec_k)
                tgt.note_ok()
                placed = (tgt, nrid)
                break
            except Exception as e:
                get_logger().warning(
                    "fleet: handoff to replica %s raised (%s: %s)",
                    tgt.name, type(e).__name__, e)
                if tgt.note_error():
                    self._eject(tgt)
                tried.append(tgt)
        if placed is None:
            # no decode replica accepted: complete with the watermark
            # (the boundary token) rather than wedge the request
            self.results[gid] = gen
            del self._placed[gid]
            return
        p.replica, p.rid = placed
        p.tier = "decode"
        p.prefix = gen
        p.placed_at = self._clock()
        p.hedged = True  # past the hedgeable (prefill) phase
        if placed[0].engine is not None:
            placed[0].engine.scheduler.resort_pending_by_arrival()
        dt = self._clock() - t0
        self._handoff_ema = dt if self._handoff_ema is None else (
            0.8 * self._handoff_ema + 0.2 * dt)
        self.handoffs[path] += 1
        (_HANDOFF_WARM if path == "warm" else _HANDOFF_COLD).inc()
        _instr.SERVE_HANDOFF_SECONDS.observe(dt)
        if path == "warm" and nbytes:
            _instr.SERVE_MIGRATED_BYTES.inc(nbytes)
            self.migrated_bytes += nbytes
        self.handoff_records.append({
            "gid": gid, "path": path, "ms": dt * 1e3, "bytes": nbytes,
            "blocks": len(snap["hashes"]) if snap else 0})
        _trace.add_span("serve.handoff", t0, self._clock(), gid=gid,
                        src=src.name, dst=placed[0].name, path=path,
                        bytes=nbytes, carried=int(gen.size),
                        trace=p.trace_id)

    def _eject(self, r: ServingReplica) -> None:
        """A replica turned SUSPECT: collect what it already finished,
        migrate its remaining work ONCE to survivors (a request whose
        survivor also fails completes with what it has rather than
        ping-ponging), release its scheduler bookkeeping (blocks free
        through the normal refcount path) and drain-retire it.

        Recovery is loss-free and token-identical (docs/SERVING.md):

        * the dying engine is asked to **export** its in-flight
          requests (tokens generated so far + a KV block snapshot);
          if it can't answer, the replica's last periodic
          ``kv_snapshots`` (``HVD_TPU_SERVE_SNAPSHOT_STEPS``) stand in;
        * **warm path** — the snapshot re-registers on the survivor
          (``import_kv``) so the re-submitted request re-prefixes from
          cache and pays no prefill recompute.  The snapshot crosses a
          ``serve.migrate`` chaos point; a corrupted wire FAILS the
          chain-hash verification and degrades to the cold path —
          never into wrong tokens;
        * **cold path** — re-submit ``prompt + generated-so-far``
          (greedy decode is deterministic, so the survivor regenerates
          the identical continuation);
        * generated tokens are never emitted twice: the already-
          generated prefix moves to ``p.prefix`` and the collection
          pass prepends it exactly once.

        A survivor crossing its own error threshold DURING the
        re-route is ejected afterwards (bounded: each ejection removes
        a replica).  A replica already DRAINING voluntarily
        (scale-down) that then stalls still gets the full ejection —
        the guard is the ``ejected`` flag, not the lifecycle state."""
        if r.ejected or r.state == RETIRED:
            return
        r.ejected = True
        t0 = self._clock()
        self._collect(r)
        # black box FIRST: the bundle must show the dying replica's
        # final spans, not the recovery's
        _flight.maybe_dump("replica_loss", extra={"replica": r.name})
        # a dying prefill replica's parked handoffs dispatch to the
        # decode tier NOW (their prefill work is done and exported —
        # losing it to the cancel_all below would waste it); the moved
        # placements then read ``p.replica is not r`` and skip the
        # migration loop.  Only the VICTIM's handoffs: a full
        # _collect_handoffs here could recurse through a decode
        # ejection back into this frame.
        if self.disagg and r.engine is not None:
            for hrid in list(getattr(r.engine, "handoffs", None) or ()):
                h_stream, h_snap, h_arr = r.engine.handoffs.pop(hrid)
                self._dispatch_handoff(r, hrid, h_stream, h_snap, h_arr)
        # freshest stream state wins: a live (merely suspect) engine
        # exports right now; a truly dead one falls back to its last
        # periodic snapshot
        handoff: Dict[int, tuple] = {}
        if r.engine is not None:
            try:
                handoff = r.engine.export_requests()
            except Exception as e:
                get_logger().warning(
                    "fleet: replica %s export failed (%s: %s) — "
                    "using last periodic snapshot", r.name,
                    type(e).__name__, e)
        if not handoff:
            handoff = dict(r.kv_snapshots)
        # disagg: survivors stay within the victim's tier — a decode
        # request re-routed onto a prefill engine would find no decode
        # programs.  The one safe crossing is prefill -> decode (a
        # "both"-role menu is a superset), taken only when the prefill
        # tier has no survivor left.
        if self.disagg:
            survivors = [x for x in self._accepting(r.tier) if x is not r]
            if not survivors and r.tier == "prefill":
                survivors = [x for x in self._accepting("decode")
                             if x is not r]
        else:
            survivors = [x for x in self._accepting() if x is not r]
        touched: List[ServingReplica] = []
        moved = dropped = 0
        for gid, p in list(self._placed.items()):
            if p.replica is not r:
                # a hedge living on the dying replica is simply lost
                if p.hedge is not None and p.hedge[0] is r:
                    p.hedge = None
                continue
            # first-wins promotion: if the primary dies while a live
            # hedge already carries this request elsewhere, the hedge
            # BECOMES the placement — no re-dispatch needed
            if p.hedge is not None and p.hedge[0] is not r \
                    and p.hedge[0].engine is not None:
                p.replica, p.rid = p.hedge
                p.hedge = None
                p.rerouted = True
                moved += 1
                continue
            p.hedge = None
            tokens, snap, arr = handoff.get(p.rid, (None, None, None))
            if tokens is not None:
                # the exported stream is context+generated of the
                # CURRENT engine request, whose prompt already includes
                # any earlier migration prefix — slicing past the
                # ORIGINAL prompt therefore recovers the FULL generated
                # run; never concat p.prefix on top of it
                gen = np.asarray(tokens[len(p.prompt):], np.int32)
            else:
                gen = p.prefix
            if p.rerouted:
                # one-reroute bound: a twice-unlucky request completes
                # with its watermark instead of ping-ponging
                self.results[gid] = gen
                del self._placed[gid]
                dropped += 1
                continue
            if p.eos_id is not None and gen.size:
                hits = np.flatnonzero(gen == p.eos_id)
                if hits.size:
                    gen = gen[:int(hits[0]) + 1]
            remaining = p.max_new_tokens - int(gen.size)
            if remaining < 1 or (p.eos_id is not None and gen.size
                                 and gen[-1] == p.eos_id):
                # already done — the kill landed between the last
                # token and collection
                self.results[gid] = gen
                del self._placed[gid]
                continue
            # warm-path wire: the snapshot's token stream crosses the
            # serve.migrate chaos point as bytes (drop => cold path;
            # corruption => chain-hash mismatch on import => cold path)
            wire_snap = None
            if snap is not None and survivors:
                wire = np.asarray(snap["tokens"], np.int32).tobytes()
                out = _chaos.point("serve.migrate", wire)
                if out is not _chaos.DROP:
                    wire_snap = dict(snap)
                    wire_snap["tokens"] = np.frombuffer(out, np.int32)
            placed = None
            path = "cold"
            # walk EVERY accepting survivor least-queue-first: one
            # survivor flaking must not drop a request another could
            # serve — and its flake books toward its own suspect
            # counter like any other submit error
            for tgt in sorted(survivors, key=lambda x: x.queue_depth()):
                if not tgt.accepting:
                    continue
                try:
                    path = "cold"
                    if wire_snap is not None:
                        try:
                            tgt.engine.import_kv(wire_snap)
                            path = "warm"
                            nb = measured_kvsnap_bytes(wire_snap)
                            _instr.SERVE_MIGRATED_BYTES.inc(nb)
                            self.migrated_bytes += nb
                        except ValueError as e:
                            get_logger().warning(
                                "fleet: KV snapshot rejected for gid "
                                "%d (%s) — cold re-prefill", gid, e)
                            wire_snap = None  # bad wire: don't retry it
                    nrid = tgt.submit(
                        np.concatenate([p.prompt, gen])
                        if gen.size else p.prompt,
                        int(remaining), eos_id=p.eos_id,
                        arrival=arr if arr is not None else p.arrival,
                        deadline_s=p.deadline_s,
                        trace_id=p.trace_id, spec_k=p.spec_k)
                    tgt.note_ok()
                    placed = (tgt, nrid)
                    break
                except Exception as e:
                    get_logger().warning(
                        "fleet: re-route to replica %s raised "
                        "(%s: %s)", tgt.name, type(e).__name__, e)
                    tgt.note_error()
            if placed is None:
                self.results[gid] = gen
                del self._placed[gid]
                dropped += 1
                continue
            p.replica, p.rid = placed
            p.tier = placed[0].tier  # prefill->decode fallback crossing
            p.rerouted = True
            p.prefix = gen
            p.placed_at = self._clock()
            moved += 1
            if placed[0] not in touched:
                touched.append(placed[0])
            (_MIGRATE_WARM if path == "warm" else _MIGRATE_COLD).inc()
            dt = self._clock() - t0
            _instr.SERVE_RECOVERY_SECONDS.observe(dt)
            self.recovery.append({"gid": gid, "path": path,
                                  "ms": dt * 1e3})
            _trace.event("serve.migrate", gid=gid, src=r.name,
                         dst=placed[0].name, path=path,
                         carried=int(gen.size), trace=p.trace_id)
        if r.engine is not None:
            # abort everything the engine still holds (blocks release
            # through the normal refcount path; partial results publish
            # so engine-sourced requests — which the router never
            # placed and cannot re-route — complete empty instead of
            # leaving their pollers waiting forever)
            r.engine.cancel_all()
        # arrival-order fairness: migrated requests joined the
        # survivors' pending queues at the tail — re-sort by original
        # arrival so ejection doesn't reorder admission
        for tgt in touched:
            if tgt.engine is not None:
                tgt.engine.scheduler.resort_pending_by_arrival()
        get_logger().error(
            "fleet: ejected suspect replica %s (%d request(s) "
            "re-routed, %d dropped)", r.name, moved, dropped)
        r.drain()
        self._book_replica_gauges()
        for tgt in survivors:
            if tgt.suspect:
                self._eject(tgt)

    def run_until_drained(self) -> Dict[int, np.ndarray]:
        while self.step():
            pass
        return self.results

    def _collect(self, r: ServingReplica) -> None:
        # disagg: only prefill-tier first tokens feed the TTFT window —
        # a decode replica's "first token" is the handed-off request's
        # first DECODE emission, stamped from the original arrival; it
        # measures the whole two-hop path and would poison the hedging
        # delay estimate and the prefill tier's p99_ttft signal
        if not self.disagg or r.tier == "prefill":
            for _rid, ttft in r.ttft_samples()[
                    self._ttft_seen.get(r, 0):]:
                self._ttfts.append(ttft)
                self._ttft_seen[r] = self._ttft_seen.get(r, 0) + 1
        if r.engine is None:
            return
        # map replica-local completions back to router-global ids;
        # hedged placements resolve FIRST-WINS (the loser cancels, its
        # blocks free through the normal refcount path)
        for gid, p in list(self._placed.items()):
            primary_done = p.replica is r and p.rid in r.engine.results
            hedge_done = (p.hedge is not None and p.hedge[0] is r
                          and p.hedge[0].engine is not None
                          and p.hedge[1] in p.hedge[0].engine.results)
            if not primary_done and not hedge_done:
                continue
            if primary_done:
                res = r.engine.results[p.rid]
                if p.hedge is not None:
                    loser, lrid = p.hedge
                    if loser.engine is not None:
                        loser.engine.cancel(lrid)
                    self.hedges["lost"] += 1
                    _HEDGE_LOST.inc()
            else:
                res = p.hedge[0].engine.results[p.hedge[1]]
                if p.replica.engine is not None:
                    p.replica.engine.cancel(p.rid)
                self.hedges["won"] += 1
                _HEDGE_WON.inc()
            # prepend the pre-migration watermark exactly once
            res = np.asarray(res, np.int32)
            if self.disagg and r.tier == "decode":
                # tokens this decode replica generated (the watermark
                # came from the prefill tier) — the decode tier's
                # tokens/s throughput-floor numerator
                self._decode_tokens += int(res.size)
            self.results[gid] = (np.concatenate([p.prefix, res])
                                 if p.prefix.size else res)
            del self._placed[gid]

    # -- SLO signals + scaling ----------------------------------------------

    def signals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        acc = self._accepting()
        if acc:
            out["queue_depth"] = sum(
                r.queue_depth() for r in acc) / len(acc)
        if self._ttfts:
            xs = sorted(self._ttfts)
            # exact small-window p99 (the registry histograms stay the
            # durable record; the policy wants the recent window)
            idx = min(len(xs) - 1, int(0.99 * len(xs)))
            out["p99_ttft"] = xs[idx]
            _instr.FLEET_ROUTER_P99_TTFT.set(out["p99_ttft"])
        if self.disagg:
            # decode tokens/s per accepting decode replica, rated
            # between signal reads — the decode tier's throughput
            # floor (the first read only pins the baseline)
            now = self._clock()
            if self._tok_rate_prev is not None:
                t_prev, n_prev = self._tok_rate_prev
                dt = now - t_prev
                if dt > 0:
                    out["decode_tokens_per_s"] = (
                        (self._decode_tokens - n_prev) / dt
                        / max(1, len(self._accepting("decode"))))
            self._tok_rate_prev = (now, self._decode_tokens)
        return out

    def _maybe_scale(self) -> None:
        sig = self.signals()
        now = self._clock()
        if not self.disagg:
            if self.policy is None:
                return
            d = self.policy.evaluate(sig, self.size, now)
            _instr.FLEET_DESIRED_SIZE.labels("serve").set(d.desired)
            if d.direction != "hold" and d.desired != self.size:
                get_logger().info(
                    "fleet: serve scale %s %d -> %d (%s)",
                    d.direction, self.size, d.desired, d.reason)
                if self.scale_to(d.desired):
                    _instr.FLEET_SCALE_EVENTS.labels(
                        "serve", d.direction).inc()
                    self.scale_events.append((d.direction, d.desired))
                    self.policy.note_applied(now)
            return
        # disagg: each tier scales on its own signal — TTFT is decided
        # entirely before the handoff (prefill capacity), decode
        # tokens/s entirely after it (decode capacity); scale_events
        # entries grow a tier field so the bench can tell them apart
        for pol, tier, kind in ((self.policy, "prefill",
                                 "serve_prefill"),
                                (self.decode_policy, "decode",
                                 "serve_decode")):
            if pol is None:
                continue
            cur = self.tier_size(tier)
            d = pol.evaluate(sig, cur, now)
            _instr.FLEET_DESIRED_SIZE.labels(kind).set(d.desired)
            if d.direction != "hold" and d.desired != cur:
                get_logger().info(
                    "fleet: %s tier scale %s %d -> %d (%s)", tier,
                    d.direction, cur, d.desired, d.reason)
                if self.scale_to(d.desired, tier=tier):
                    _instr.FLEET_SCALE_EVENTS.labels(
                        kind, d.direction).inc()
                    self.scale_events.append(
                        (d.direction, d.desired, tier))
                    pol.note_applied(now)

    # -- bench/introspection columns -----------------------------------------

    def prefix_stats(self) -> Tuple[int, int]:
        """(hit blocks, lookup blocks) aggregated over every replica,
        live and retired — the fleet-wide hit rate numerator and
        denominator."""
        hits = lookups = 0
        for r in self.replicas + self.retired:
            sched = getattr(r.engine, "scheduler", None) \
                if r.engine is not None else None
            if sched is not None:
                hits += sched.prefix_hit_blocks
                lookups += sched.prefix_lookup_blocks
            else:  # retired replicas keep their final counts
                hits += getattr(r, "_final_hits", 0)
                lookups += getattr(r, "_final_lookups", 0)
        return hits, lookups

    def all_ttfts(self) -> List[float]:
        """Every TTFT sample across live AND retired replicas — the
        bench's full-leg distribution (the policy's sliding window is
        deliberately smaller)."""
        out: List[float] = []
        for r in self.replicas + self.retired:
            out.extend(t for _rid, t in r.ttft_samples())
        return out

    def all_compile_free(self) -> bool:
        return all(r.compile_free for r in self.replicas) and all(
            getattr(r, "_final_compile_free", True) for r in self.retired)

    def hedge_rate(self) -> float:
        """Hedges issued per submitted request (bench column; the
        budget bounds it at ``hedge_budget``)."""
        return self._hedges_issued / max(1, self._submitted)

    def migration_ms(self) -> float:
        """Mean detection-to-re-dispatch latency over this router's
        recoveries, in milliseconds (0.0 when none happened)."""
        if not self.recovery:
            return 0.0
        return sum(x["ms"] for x in self.recovery) / len(self.recovery)
