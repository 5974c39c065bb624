"""Continuous-batching inference serving on the paged KV cache.

Port of ``horovod_tpu.serving``: iteration-level scheduling (Orca) over
block-granular KV paging (PagedAttention), hash-indexed prefix caching
and Sarathi-style chunked prefill, with every attention call running the
hand-written paged flash-attention kernel.  Usage::

    from horovod_tpu_torch.models import llama3_8b, init_params
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = llama3_8b()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, serve=ServeConfig(prefill_chunk=256))
    rid = eng.submit(prompt_ids, max_new_tokens=32)
    out = eng.run()[rid]
"""

from .engine import ServeConfig, ServingEngine
from .kv_cache import (
    PREFIX_HASH_ROOT,
    BlockAllocator,
    PagedKVState,
    blocks_for,
    chain_hash,
    make_pools,
    modeled_decode_read_bytes,
    pool_bytes,
)
from .scheduler import ContinuousBatchingScheduler, Request, Sequence

__all__ = [
    "BlockAllocator",
    "ContinuousBatchingScheduler",
    "PREFIX_HASH_ROOT",
    "PagedKVState",
    "Request",
    "Sequence",
    "ServeConfig",
    "ServingEngine",
    "blocks_for",
    "chain_hash",
    "make_pools",
    "modeled_decode_read_bytes",
    "pool_bytes",
]
