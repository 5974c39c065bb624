"""The port's metric instruments, in one place.

Copied from ``horovod_tpu/metrics/instruments.py``: the instruments the
serving slice books, under the same names, label sets and buckets (the
catalogue in docs/METRICS.md describes them).  The collective, data,
fleet, guard and elastic instruments arrive with the slices that book
them.
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
