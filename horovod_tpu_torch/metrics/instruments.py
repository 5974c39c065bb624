"""The port's metric instruments, in one place.

Copied from ``horovod_tpu/metrics/instruments.py``: the instruments the
serving slice (speculative decoding, KV migration and the fleet
router included), the overlapped optimizer, ZeRO, the input pipeline,
the training loop, the integrity guard, the elastic driver and worker,
preemption notices, the chaos engine, retries, the flight recorder,
the collectives (counts, bytes, per-tier bytes, latency), the overlap
inventory and the process identity book, under the same names, label
sets and buckets (the catalogue in docs/METRICS.md describes them).
The instruments whose producers are not ported yet (the native
controller's, the framework adapters' gradient norm and epoch metrics)
are left out.
"""

from __future__ import annotations

from .registry import DEFAULT_LATENCY_BUCKETS, counter, gauge, histogram

#: Executable-cache outcome per step-program lookup: the padding tiers
#: bound the (kind, tier...) keys, so steady state is all hits.
EXEC_CACHE = counter(
    "hvd_tpu_executable_cache_total",
    "Engine executable-cache lookups by outcome (hit/miss)",
    ["event"],
)

#: Public collective API submissions, by op and dispatch path
#: (native = C++ background controller, eager = in-line engine).
COLLECTIVES = counter(
    "hvd_tpu_collectives_total",
    "Collective submissions by op and dispatch path",
    ["op", "path"],
)

#: Payload bytes submitted to collectives, by op.
COLLECTIVE_BYTES = counter(
    "hvd_tpu_collective_bytes_total",
    "Tensor bytes submitted to collectives, by op",
    ["op"],
)

#: Modeled bytes the sum-family collectives moved on the fast
#: intra-slice fabric (ring model, ops/comm_model.py; booked at dispatch).
COLLECTIVE_ICI_BYTES = counter(
    "hvd_tpu_collective_ici_bytes_total",
    "Modeled intra-slice (ICI) fabric bytes moved by engine collectives",
)

#: Same, for the slow inter-slice fabric: the number hierarchical
#: routing and DCN wire compression exist to shrink.
COLLECTIVE_DCN_BYTES = counter(
    "hvd_tpu_collective_dcn_bytes_total",
    "Modeled inter-slice (DCN) fabric bytes moved by engine collectives",
)

#: End-to-end latency of a negotiated collective: enqueue() to future
#: resolution (includes negotiation, fusion and execution).
OP_LATENCY = histogram(
    "hvd_tpu_collective_latency_seconds",
    "Enqueue-to-resolution latency of negotiated collectives, by op",
    ["op"],
)

# -- input pipeline (data/ — docs/DATA.md) ------------------------------------

#: Device-ready batches currently staged in the prefetch queue.
DATA_PREFETCH_DEPTH = gauge(
    "hvd_tpu_data_prefetch_depth",
    "Device-ready batches currently staged in the prefetch queue",
)

#: Time the training thread blocked in next() waiting for a device batch —
#: THE input-starvation signal (0 when the pipeline is fully overlapped).
DATA_HOST_WAIT = histogram(
    "hvd_tpu_data_host_wait_seconds",
    "Training-thread wait for the next prefetched batch (input starvation)",
)

#: Host-side cost of producing one batch: source read + decode + collate
#: (worker-pool time, overlapped with device compute when healthy).
DATA_BATCH_PRODUCE = histogram(
    "hvd_tpu_data_batch_produce_seconds",
    "Host-side decode/collate time per batch (worker pool)",
)

#: Host->device staging cost of one batch (cast, pin, start the copy).
DATA_DEVICE_PUT = histogram(
    "hvd_tpu_data_device_put_seconds",
    "Host-to-device transfer staging time per prefetched batch",
)

#: Batches delivered to the training thread, by source kind.
DATA_BATCHES = counter(
    "hvd_tpu_data_batches_total",
    "Batches delivered by the input pipeline, by source kind",
    ["source"],
)

# -- inference serving (serving/ — docs/SERVING.md) --------------------------

#: Per-token emission latency: ``first`` = arrival to first token (TTFT,
#: includes queueing), ``inter`` = gap between consecutive tokens of one
#: request (TPOT).
SERVE_TOKEN_LATENCY = histogram(
    "hvd_tpu_serve_token_latency_seconds",
    "Per-token emission latency (first = TTFT incl. queueing, inter = TPOT)",
    ["kind"],
    buckets=DEFAULT_LATENCY_BUCKETS + (25.0, 60.0),
)

#: Requests waiting for admission.
SERVE_QUEUE_DEPTH = gauge(
    "hvd_tpu_serve_queue_depth",
    "Requests waiting for admission to the decode batch",
)

#: Fraction of allocatable KV blocks owned by running sequences.
SERVE_KV_OCCUPANCY = gauge(
    "hvd_tpu_serve_kv_block_occupancy_ratio",
    "Allocated fraction of the paged KV cache's block pool",
)

#: Sequences preempted (LIFO recompute eviction) because the pool ran
#: dry mid-growth.
SERVE_EVICTIONS = counter(
    "hvd_tpu_serve_evictions_total",
    "Sequences evicted from the decode batch to reclaim KV blocks",
)

#: Engine steps by kind (mixed / decode).
SERVE_STEPS = counter(
    "hvd_tpu_serve_steps_total",
    "Serving engine steps executed, by kind",
    ["kind"],
)

#: Prompt blocks served straight from the prefix cache at admission.
SERVE_PREFIX_HITS = counter(
    "hvd_tpu_serve_prefix_hits_total",
    "Prompt KV blocks mapped from the prefix cache at admission",
)

#: Full prompt blocks prefilled for lack of a cached prefix.
SERVE_PREFIX_MISSES = counter(
    "hvd_tpu_serve_prefix_misses_total",
    "Full prompt KV blocks prefilled for lack of a cached prefix",
)

#: Prefill chunks packed into mixed steps.
SERVE_PREFILL_CHUNKS = counter(
    "hvd_tpu_serve_prefill_chunks_total",
    "Prefill chunks executed inside mixed prefill+decode steps",
)

#: Fraction of allocatable KV blocks holding prefix-cache content.
SERVE_KV_CACHED = gauge(
    "hvd_tpu_serve_kv_cached_blocks_ratio",
    "Fraction of the KV block pool holding prefix-cache content",
)

#: Request lifecycle events (submitted/completed/expired).
SERVE_REQUESTS = counter(
    "hvd_tpu_serve_requests_total",
    "Serving request lifecycle events",
    ["event"],
)

#: Requests shed or cancelled past their deadline budget.
SERVE_DEADLINE_EXCEEDED = counter(
    "hvd_tpu_serve_deadline_exceeded_total",
    "Serving requests shed or cancelled past their deadline budget",
)

#: Per-rank bytes the tensor-sharded serving step's row-parallel
#: all-reduces stream (2 per decoder layer; modeled by
#: ops.comm_model.modeled_serve_psum_bytes).  Stays 0 on an unsharded
#: engine.
SERVE_SHARD_PSUM_BYTES = counter(
    "hvd_tpu_serve_shard_psum_bytes_total",
    "Per-chip ICI bytes streamed by the sharded serving step's psums",
)

#: KV blocks resident per shard of the tensor-sharded pool: every rank
#: holds ALL blocks (each at its num_kv_heads/shards head slice), so
#: the gauge equals the pool size.
SERVE_KV_BLOCKS_PER_SHARD = gauge(
    "hvd_tpu_serve_kv_blocks_per_shard",
    "KV blocks resident on each shard of the tensor-sharded pool",
)

#: Tokens proposed by the speculative drafter and fed to verify steps
#: (docs/SERVING.md speculative section).
SERVE_SPEC_DRAFTED = counter(
    "hvd_tpu_serve_spec_drafted_tokens_total",
    "Draft tokens fed to speculative verify steps",
)

#: Drafted tokens the greedy verifier accepted; accepted/drafted is the
#: fleet-wide acceptance rate (each verify step also emits one
#: non-drafted bonus token, so tokens/step = 1 + accepted/steps).
SERVE_SPEC_ACCEPTED = counter(
    "hvd_tpu_serve_spec_accepted_tokens_total",
    "Draft tokens accepted by greedy verification",
)

#: Drafted tokens rejected by verification — their speculative KV tail
#: is rolled back (block-aligned truncation; docs/SERVING.md).
SERVE_SPEC_ROLLED_BACK = counter(
    "hvd_tpu_serve_spec_rolled_back_tokens_total",
    "Draft tokens rejected and rolled back from the paged KV tail",
)

#: Per-request draft acceptance rate (accepted/drafted over the
#: request's lifetime), observed at completion for requests that ran
#: at least one verify step — the distribution behind the when-does-
#: speculation-pay threshold (docs/SERVING.md).
SERVE_SPEC_ACCEPT_RATE = histogram(
    "hvd_tpu_serve_spec_accept_rate",
    "Per-request speculative-draft acceptance rate at completion",
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
)

#: In-flight requests migrated off a lost replica, by recovery path:
#: ``warm`` = a verified KV block chain re-registered on the survivor
#: (chain hashes checked end to end), ``cold`` = prompt+generated
#: re-prefilled through the prefix cache (docs/SERVING.md fault
#: tolerance).
SERVE_MIGRATIONS = counter(
    "hvd_tpu_serve_migrations_total",
    "Requests migrated to a surviving replica, by recovery path",
    ["path"],  # warm / cold
)

#: Hedged-dispatch outcomes (``HVD_TPU_SERVE_HEDGE``): ``won`` = the
#: hedge finished first (primary cancelled), ``lost`` = the primary
#: finished first (hedge cancelled), ``suppressed`` = the retry budget
#: or the target's load guard withheld the hedge.
SERVE_HEDGES = counter(
    "hvd_tpu_serve_hedges_total",
    "Hedged dispatches by outcome",
    ["outcome"],  # won / lost / suppressed
)

#: Wall seconds from detecting a replica loss to each of its requests
#: being re-dispatched (or completed from its watermark) — the
#: recovery-latency SLO the serve_bench ``migration_ms`` column reads.
SERVE_RECOVERY_SECONDS = histogram(
    "hvd_tpu_serve_recovery_seconds",
    "Seconds from replica-loss detection to a request's re-dispatch",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
)

#: Prefill→decode tier handoffs in the disaggregated fleet, by path:
#: ``warm`` = the kvsnap chain re-registered on the decode replica (its
#: decode re-prefixes from cache), ``cold`` = the snapshot was dropped
#: or rejected and the decode replica re-prefilled (docs/FLEET.md).
SERVE_HANDOFFS = counter(
    "hvd_tpu_serve_handoffs_total",
    "Prefill-to-decode tier handoffs, by transfer path",
    ["path"],  # warm / cold
)

#: Wall time of one tier handoff: prefill-complete pickup to the
#: request queued on its decode replica (chain verify + page write +
#: re-submit) — the latency the two-hop deadline filter budgets for.
SERVE_HANDOFF_SECONDS = histogram(
    "hvd_tpu_serve_handoff_seconds",
    "Seconds from prefill-complete pickup to decode-tier re-dispatch",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
)

#: Paged-KV payload bytes that crossed a replica boundary warm (tier
#: handoffs and replica-loss migrations): K/V pages + token streams as
#: measured on the wire — the number ``modeled_kvsnap_bytes`` must
#: reproduce exactly (modeled == measured, comm_model idiom).
SERVE_MIGRATED_BYTES = counter(
    "hvd_tpu_serve_migrated_kv_bytes_total",
    "Paged-KV snapshot bytes moved between replicas on warm paths",
)

# -- fleet autoscaling + routing (fleet/ — docs/FLEET.md) --------------------

#: Capacity the policy engine last decided the fleet should converge
#: to (training workers or serving replicas, per the autoscaler's
#: ``kind`` label) — desired vs the live world-size/replica gauges is
#: the convergence view.
FLEET_DESIRED_SIZE = gauge(
    "hvd_tpu_fleet_desired_size",
    "Capacity the autoscale policy last decided on, by fleet kind",
    ["kind"],  # train / serve
)

#: Applied scale actions, by fleet kind and direction.
FLEET_SCALE_EVENTS = counter(
    "hvd_tpu_fleet_scale_events_total",
    "Scale actions the autoscaler applied, by fleet kind and direction",
    ["kind", "direction"],  # direction: out / in
)

#: Serving replicas by lifecycle state (ready/draining); retired
#: replicas leave the gauge.
FLEET_REPLICAS = gauge(
    "hvd_tpu_fleet_replicas",
    "Serving replicas currently held by the router, by lifecycle state",
    ["state"],
)

#: Router placement outcomes: ``affinity`` = prefix-index hit chose
#: the replica, ``least_queue`` = no cached prefix anywhere (fallback),
#: ``round_robin`` = the non-affinity baseline mode.
FLEET_ROUTED = counter(
    "hvd_tpu_fleet_routed_total",
    "Requests placed by the fleet router, by placement rule",
    ["route"],
)

#: The router's sliding-window p99 TTFT — the SLO signal its policy
#: evaluates (the per-replica histograms stay the durable record).
FLEET_ROUTER_P99_TTFT = gauge(
    "hvd_tpu_fleet_router_p99_ttft_seconds",
    "Sliding-window p99 time-to-first-token observed by the fleet router",
)

#: Preemption notices honored: SIGTERM grace -> planned snapshot ->
#: clean leave (fleet/preemption.py; the chaos ``fleet.preempt`` site).
FLEET_PREEMPTIONS = counter(
    "hvd_tpu_fleet_preemptions_total",
    "Preemption notices this worker honored with a planned leave",
)

#: Replicas the router marked suspect (ejected from placement, work
#: re-routed) after ``HVD_TPU_FLEET_REPLICA_ERRORS`` consecutive
#: submit/step errors or a healthz stall trip.
FLEET_REPLICA_SUSPECTS = counter(
    "hvd_tpu_fleet_replica_suspects_total",
    "Serving replicas marked suspect and ejected by the fleet router",
)

# -- backward/collective overlap (optim.DistributedOptimizer, ops/overlap.py) -

#: Stream-byte share of gradient collectives that trail ALL backward
#: compute in the compiled step — the static exposed-comm fraction the
#: bucket schedule exists to shrink (1.0 = unoverlapped jax.grad step;
#: ~ last-bucket share when the schedule interleaves).  Set from the
#: lowered program by ``ops.overlap.record_overlap_metrics``.
OVERLAP_EXPOSED_FRACTION = gauge(
    "hvd_tpu_overlap_exposed_comm_fraction",
    "Stream-byte fraction of gradient collectives trailing all backward "
    "compute in the compiled step (static schedule view)",
)

#: How early each bucket's collective launches: parameters still awaiting
#: their gradients when the hook launched it (0 = it trailed the backward).
OVERLAP_LAUNCH_LEAD = histogram(
    "hvd_tpu_overlap_bucket_launch_lead",
    "Backward compute remaining when a bucket's collective launches "
    "(compute ops after launch; torch: params still pending)",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128),
)

#: Bucket-size/tier trials the BucketAutotuner has scored.
OVERLAP_AUTOTUNE_TRIALS = counter(
    "hvd_tpu_overlap_autotune_trials_total",
    "Bucket-schedule candidates scored by the overlap autotuner",
)

#: The pinned (converged) bucket size; 0 until convergence.
OVERLAP_AUTOTUNE_PINNED_BYTES = gauge(
    "hvd_tpu_overlap_autotune_pinned_bucket_bytes",
    "Bucket bytes of the overlap autotuner's pinned winning plan",
)

# -- sharded optimizer (optim.py ZeRO wrapper) --------------------------------

#: Flattened-gradient bytes submitted to the ZeRO reduce-scatter (padded
#: buffer bytes per exchange; incremented at submission).
OPTIM_RS_BYTES = counter(
    "hvd_tpu_optim_reducescatter_bytes_total",
    "Flattened gradient bytes submitted to the ZeRO reduce-scatter",
)

#: Updated-parameter shard bytes submitted to the ZeRO allgather.
OPTIM_AG_BYTES = counter(
    "hvd_tpu_optim_allgather_bytes_total",
    "Updated parameter-shard bytes submitted to the ZeRO allgather",
)

#: This rank's sharded optimizer-state bytes (the ZeRO partition — about
#: 1/world_size of the replicated state; set after the first step).
OPTIM_STATE_SHARD_BYTES = gauge(
    "hvd_tpu_optim_state_shard_bytes",
    "Sharded optimizer-state bytes held by this rank (ZeRO partition)",
)

# -- integrity guard (guard.py — docs/FAULT_TOLERANCE.md, silent corruption) -

#: Detector evaluations at cadence, by check kind (finite sentinel /
#: EMA loss spike / cross-rank digest agreement).
GUARD_CHECKS = counter(
    "hvd_tpu_guard_checks_total",
    "Integrity-guard detector evaluations, by check kind",
    ["check"],  # finite / spike / digest
)

#: Detector trips — a check that found something wrong, by kind.
GUARD_TRIPS = counter(
    "hvd_tpu_guard_trips_total",
    "Integrity-guard detector trips (corruption signals), by check kind",
    ["check"],  # finite / spike / digest
)

#: Attribution outcomes after a digest mismatch: ``self`` = this rank
#: was named corrupt (quarantine path), ``peer`` = another rank was,
#: ``unattributed`` = no majority and no recompute vote (rollback-only).
GUARD_ATTRIBUTIONS = counter(
    "hvd_tpu_guard_attributions_total",
    "Corruption attribution outcomes after a cross-rank digest mismatch",
    ["outcome"],  # self / peer / unattributed
)

#: Rollbacks to the last verified checkpoint (poisoned-window discards).
GUARD_ROLLBACKS = counter(
    "hvd_tpu_guard_rollbacks_total",
    "Auto-rollbacks to the last integrity-verified checkpoint",
)

#: Newest step whose cross-rank agreement check passed — checkpoints at
#: or before it are trustable rollback targets.
GUARD_LAST_VERIFIED = gauge(
    "hvd_tpu_guard_last_verified_step",
    "Newest training step that passed the cross-rank integrity check",
)

#: Hosts the elastic driver quarantined after an integrity attribution
#: (every slot of the attributed worker's host leaves the spawn pool).
GUARD_QUARANTINES = counter(
    "hvd_tpu_guard_quarantined_hosts_total",
    "Hosts quarantined by the elastic driver after integrity attribution",
)

# -- elastic (runner/elastic_driver.py, elastic/worker.py) -------------------

ELASTIC_WORLD_SIZE = gauge(
    "hvd_tpu_elastic_world_size",
    "Member processes of the current elastic epoch",
)
ELASTIC_EPOCH = gauge(
    "hvd_tpu_elastic_epoch",
    "Current elastic rendezvous epoch",
)
ELASTIC_RENDEZVOUS = counter(
    "hvd_tpu_elastic_rendezvous_total",
    "Completed rendezvous epochs handed out by the driver",
)
ELASTIC_SPAWNS = counter(
    "hvd_tpu_elastic_workers_spawned_total",
    "Worker processes spawned by the elastic driver",
)
ELASTIC_FAILURES = counter(
    "hvd_tpu_elastic_worker_failures_total",
    "Worker processes that exited non-zero (slot blacklisted)",
)
ELASTIC_RESTARTS = counter(
    "hvd_tpu_elastic_restarts_total",
    "Exec-restarts this worker performed (planned + failure recovery)",
)
ELASTIC_RESTART_SECONDS = gauge(
    "hvd_tpu_elastic_last_restart_seconds",
    "Cost split of this worker's most recent exec-restart",
    ["phase"],  # persist / reboot / restore / total
)
ELASTIC_SNAPSHOT_BYTES = gauge(
    "hvd_tpu_elastic_last_snapshot_bytes",
    "Serialized state bytes carried across the last exec-restart",
)

#: Wall time from fault detection to training resumed (filled by the
#: elastic worker: restart total; and by auto-resume restores).
RECOVERY_SECONDS = gauge(
    "hvd_tpu_recovery_seconds",
    "Wall time of the most recent failure recovery, by phase",
    # restart / auto_resume / planned (preemption leave) /
    # rollback (guard: corruption detection -> post-boot verified resume)
    ["phase"],
)

# -- fault injection and the training loop ------------------------------------

#: Chaos faults injected, by site and action.
CHAOS_INJECTIONS = counter(
    "hvd_tpu_chaos_injections_total",
    "Chaos faults injected, by site and action",
    ["site", "action"],
)

#: Training step wall time, by adapter (the callbacks' TrainLoop books
#: it under "torch", the keras adapter's TelemetryCallback under
#: "keras").
STEP_DURATION = histogram(
    "hvd_tpu_step_duration_seconds",
    "Training step wall time, by adapter",
    ["adapter"],
    buckets=DEFAULT_LATENCY_BUCKETS + (25.0, 60.0),
)

#: Last epoch-end value of each Keras logged metric (the keras adapter's
#: TelemetryCallback sets it).
KERAS_EPOCH_METRIC = gauge(
    "hvd_tpu_keras_epoch_metric",
    "Last epoch-end value of each Keras logged metric",
    ["metric"],
)

# -- retries (common/retry.py) ------------------------------------------------

#: Attempts one retry_call() needed before success/exhaustion, by site.
RETRY_ATTEMPTS = histogram(
    "hvd_tpu_retry_attempts",
    "Attempts per retry_call invocation, by site",
    ["site"],
    buckets=(1, 2, 3, 5, 8, 13, 21, 34),
)

# -- distributed tracing (trace/) --------------------------------------------

#: Flight-recorder crash bundles written, by trigger reason
#: (chaos_kill / quarantine / rollback / preempt / restart /
#: slo_breach — docs/TRACING.md).
TRACE_BUNDLES = counter(
    "hvd_tpu_trace_bundles_total",
    "Flight-recorder crash bundles written, by trigger reason",
    ["reason"],
)

# -- process identity --------------------------------------------------------

PROCESS_INFO = gauge(
    "hvd_tpu_process_info",
    "Static process identity (value is always 1)",
    ["rank", "local_rank", "size", "num_processes"],
)
