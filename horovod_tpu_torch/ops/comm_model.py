"""Byte and timing models (a subset of the JAX package's).

Copied from ``horovod_tpu/ops/comm_model.py``:
:func:`modeled_serve_psum_bytes` (the tensor-sharded serving step's
all-reduce bytes), :func:`modeled_kvsnap_bytes`
and its measured twin :func:`measured_kvsnap_bytes`, the pair the fleet
router's warm handoffs and migrations are held to (modeled == measured,
exactly), and :func:`modeled_overlap_exposed`, the timing model of the
bucketed backward/collective overlap.  :func:`overlap_inventory` is the
JAX function's counterpart over the port's own record of a step: the
JAX one reads a lowered StableHLO program, which eager PyTorch does not
have, so the hooked reducer (``optim._BucketReducer``) records what it
launched instead.  The tier-byte inventories of that module wait for
the port of the hierarchical collectives.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

__all__ = ["measured_kvsnap_bytes", "modeled_kvsnap_bytes",
           "modeled_overlap_exposed", "modeled_serve_psum_bytes",
           "overlap_inventory"]

#: ring-stream factor of an allreduce: reduce-scatter + allgather
_ALL_REDUCE_FACTOR = 2.0

_ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "float64": 8,
             "int32": 4, "int8": 1, "uint8": 1}


def _itemsize(dtype) -> int:
    """Bytes per element of ``dtype``: a name (``"bfloat16"``), a numpy
    dtype or a torch dtype (``torch.bfloat16`` prints as
    ``"torch.bfloat16"``)."""
    name = str(dtype).split(".")[-1]
    if name in _ITEMSIZE:
        return _ITEMSIZE[name]
    return int(np.dtype(dtype).itemsize)


def modeled_serve_psum_bytes(
    batch: int,
    q_len: int,
    d_model: int,
    num_layers: int,
    shards: int,
    dtype: str = "float32",
) -> dict:
    """Per-rank ring-stream bytes of ONE tensor-sharded serving step's
    collectives (copied from the JAX package): the Megatron schedule
    runs exactly TWO row-parallel all-reduces per decoder layer
    (attention output projection, MLP down projection), each of that
    sublayer's ``(batch, q_len, d_model)`` output in the activation
    dtype; nothing else in the step communicates (the KV pool is
    head-sharded in place, block tables replicate, the embedding head
    is replicated).  The ring stream per rank is ``2*(shards-1)/shards
    * payload`` per all-reduce."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards == 1:
        return {"psum_count": 0, "payload_bytes": 0, "stream_bytes": 0}
    payload = int(batch) * int(q_len) * int(d_model) * _itemsize(dtype)
    per = 2 * (shards - 1) * payload // shards
    return {
        "psum_count": 2 * num_layers,
        "payload_bytes": payload,
        "stream_bytes": 2 * num_layers * per,
    }


def modeled_kvsnap_bytes(
    num_blocks: int,
    block_size: int,
    num_layers: int,
    kv_heads: int,
    head_dim: int,
    dtype="float32",
) -> dict:
    """Modeled wire bytes of ONE ``kvsnap/1`` paged-KV snapshot of
    ``num_blocks`` full blocks — the prefill→decode handoff (and
    replica-loss migration) payload.  Per block the snapshot carries one
    K page and one V page of ``(num_layers, block_size, kv_heads,
    head_dim)`` each, plus the block's verified int32 token run (bf16
    pages travel as ``ml_dtypes.bfloat16`` or ``uint16`` bits: the same
    bytes).  Returns
    ``{"page_bytes", "token_bytes", "wire_bytes"}`` (ints)."""
    if num_blocks < 0 or block_size < 1:
        raise ValueError(
            f"need num_blocks >= 0 and block_size >= 1, got "
            f"{num_blocks}/{block_size}")
    page = (2 * int(num_layers) * int(block_size) * int(kv_heads)
            * int(head_dim) * _itemsize(dtype))
    toks = int(num_blocks) * int(block_size) * 4  # int32 token runs
    return {
        "page_bytes": int(num_blocks) * page,
        "token_bytes": toks,
        "wire_bytes": int(num_blocks) * page + toks,
    }


def measured_kvsnap_bytes(snap: dict) -> int:
    """MEASURED wire bytes of one ``kvsnap/1`` snapshot: the K/V page
    arrays' ``nbytes`` plus the int32 token stream as actually
    serialized — :func:`modeled_kvsnap_bytes`'s measured twin (the
    router books it into ``hvd_tpu_serve_migrated_kv_bytes_total`` on
    every warm handoff/migration)."""
    toks = snap.get("tokens")
    n = len(toks) if toks is not None else 0  # may be an ndarray:
    total = n * 4                             # never bool() it
    for kp, vp in snap.get("pages") or ():
        total += int(np.asarray(kp).nbytes) + int(np.asarray(vp).nbytes)
    return total


def overlap_inventory(record: Dict[str, Any], min_payload_bytes: int = 0,
                      world: Optional[int] = None) -> Dict[str, object]:
    """Launch-order interleave check of one training step (the JAX
    package's ``overlap_inventory``, docs/tensor-fusion.md): for each
    gradient bucket's allreduce, how much backward compute was still to
    come when it launched.

    ``record`` is a reducer's ``last_record`` (``optim._BucketReducer``,
    ``step.reducer`` of ``training.data_parallel_train_step``):
    ``{"world", "buckets": [{"bucket", "payload_bytes", "pending"}]}`` in
    launch order, ``pending`` the gradients not yet produced when the
    bucket launched.  That count is this function's ``compute_after``;
    the JAX function's is the number of matmul-class lines after the
    collective in the program text.  Both are 0 exactly when the
    collective trails all backward compute, so which collectives trail,
    and everything computed from that, is defined the same way:
    ``stream_bytes`` is the ring-stream per-rank link bytes of an
    allreduce over ``world`` ranks (default: the record's),
    ``2 (g-1)/g × payload``; ``exposed_fraction`` the stream-byte share
    of the trailing collectives (0 when nothing streams, as at world 1);
    ``interleaved`` whether at least one collective launches with
    compute still after it while the trailing share is below 1.
    ``min_payload_bytes`` drops smaller collectives.  Returns
    ``{"collectives": [...], "total_stream_bytes",
    "trailing_stream_bytes", "exposed_fraction", "interleaved"}``.
    """
    g = int(world if world is not None else record.get("world", 1))
    total = trailing = 0
    out = []
    for rec in record.get("buckets", ()):
        payload = int(rec["payload_bytes"])
        if payload < min_payload_bytes:
            continue
        stream = int(_ALL_REDUCE_FACTOR * (g - 1) * payload // g)
        after = int(rec["pending"])
        total += stream
        if after == 0:
            trailing += stream
        out.append({"op": "all_reduce", "bucket": rec["bucket"],
                    "payload_bytes": payload, "stream_bytes": stream,
                    "compute_after": after})
    interleaved = (
        bool(out)
        and any(op["compute_after"] > 0 for op in out)
        and trailing < total
    )
    return {
        "collectives": out,
        "total_stream_bytes": int(total),
        "trailing_stream_bytes": int(trailing),
        "exposed_fraction": (trailing / total) if total else 0.0,
        "interleaved": interleaved,
    }


def modeled_overlap_exposed(
    bucket_bytes: Sequence[int],
    t_compute_s: float,
    link_bytes_per_s: float,
    world: int,
    dtype_ratio: float = 1.0,
) -> Dict[str, float]:
    """Timing model of the bucketed backward/collective overlap
    (docs/tensor-fusion.md derives it).

    Buckets (launch order, wire bytes each) are produced by a backward
    pass of duration ``t_compute_s`` at a rate proportional to bytes:
    bucket ``i`` is ready at ``t_compute_s * cum_bytes_i / total``.  Its
    ring allreduce costs ``2*(w-1)/w * bytes * dtype_ratio /
    link_bytes_per_s`` and the link is serial, so transfers queue:
    ``start_i = max(ready_i, end_{i-1})``.  Exposed communication is
    whatever finishes after the compute does; the unoverlapped baseline
    exposes everything (``exposed_fraction == 1``).

    Returns ``{"t_comm_s", "t_exposed_s", "exposed_fraction",
    "t_step_s", "n_buckets"}``.
    """
    sizes = [int(b) for b in bucket_bytes if int(b) > 0]
    total = sum(sizes)
    if not sizes or world <= 1 or link_bytes_per_s <= 0:
        return {
            "t_comm_s": 0.0, "t_exposed_s": 0.0, "exposed_fraction": 0.0,
            "t_step_s": float(t_compute_s), "n_buckets": len(sizes),
        }
    ring = 2.0 * (world - 1) / world * dtype_ratio / link_bytes_per_s
    t_comm = sum(s * ring for s in sizes)
    cum = 0
    end = 0.0
    for s in sizes:
        cum += s
        ready = t_compute_s * cum / total
        end = max(ready, end) + s * ring
    exposed = max(0.0, end - t_compute_s)
    return {
        "t_comm_s": t_comm,
        "t_exposed_s": exposed,
        "exposed_fraction": exposed / t_comm if t_comm else 0.0,
        "t_step_s": t_compute_s + exposed,
        "n_buckets": len(sizes),
    }
