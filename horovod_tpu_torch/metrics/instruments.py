"""The port's metric instruments, in one place.

Copied from ``horovod_tpu/metrics/instruments.py``: the instruments the
serving slice, the overlapped optimizer, ZeRO, the input pipeline, the
training loop and the chaos engine book, under the same names, label
sets and buckets (the catalogue in docs/METRICS.md describes them).  The
collective, fleet, guard and elastic instruments arrive with the slices
that book them.
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

#: KV blocks resident on the (single) device's pool.
SERVE_KV_BLOCKS_PER_SHARD = gauge(
    "hvd_tpu_serve_kv_blocks_per_shard",
    "KV blocks resident on each shard of the tensor-sharded pool",
)

# -- backward/collective overlap (optim.DistributedOptimizer, ops/overlap.py) -

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

# -- fault injection and the training loop ------------------------------------

#: Chaos faults injected, by site and action.
CHAOS_INJECTIONS = counter(
    "hvd_tpu_chaos_injections_total",
    "Chaos faults injected, by site and action",
    ["site", "action"],
)

#: Training step wall time, by adapter (the callbacks' TrainLoop books
#: it under "torch").
STEP_DURATION = histogram(
    "hvd_tpu_step_duration_seconds",
    "Training step wall time, by adapter",
    ["adapter"],
    buckets=DEFAULT_LATENCY_BUCKETS + (25.0, 60.0),
)
