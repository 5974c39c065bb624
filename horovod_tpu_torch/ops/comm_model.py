"""Byte and timing models (a subset of the JAX package's).

Copied from ``horovod_tpu/ops/comm_model.py``:
:func:`modeled_collective_bytes`, the per-tier byte model of one
allreduce (flat or two-level, with or without a cross-tier wire dtype;
the JAX module's docstring and docs/COLLECTIVES.md derive it),
:func:`modeled_serve_psum_bytes` (the tensor-sharded serving step's
all-reduce bytes), :func:`modeled_kvsnap_bytes`
and its measured twin :func:`measured_kvsnap_bytes`, the pair the fleet
router's warm handoffs and migrations are held to (modeled == measured,
exactly), and :func:`modeled_overlap_exposed`, the timing model of the
bucketed backward/collective overlap.

The measured sides read the port's own records, where the JAX package
reads a lowered StableHLO program, which eager PyTorch does not have.
:func:`overlap_inventory` reads what the hooked reducer
(``optim._BucketReducer``) launched in a step.  :func:`measured_tier_bytes`
reads the records that the flat-buffer primitives of
:mod:`.collective_ops` keep, inside ``collective_ops.recording()``, of
each ``torch.distributed`` call they issue: its kind, the bytes it
hands over (the operand of a reduce-style call or an all-to-all, the
result of a gather) and its group's ranks.  The ring-stream factor turns
those bytes into per-rank link bytes as the JAX inventory does, and a
group whose ranks span more than one slice counts on the cross (DCN)
tier, any other on the local (ICI) tier.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["collective_record", "measured_kvsnap_bytes",
           "measured_tier_bytes", "mesh_slice_ids",
           "modeled_collective_bytes", "modeled_kvsnap_bytes",
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


#: Accepted short spellings for wire dtypes (as compression.py's).
_DTYPE_ALIAS = {"bf16": "bfloat16", "fp16": "float16", "half": "float16"}


def _dtype_name(dtype) -> str:
    name = str(dtype).split(".")[-1]
    return _DTYPE_ALIAS.get(name, name)


def _payload_itemsize(dtype) -> int:
    """Bytes per element of a payload or wire dtype: a name, a short
    spelling, a numpy or a torch dtype; ``ValueError`` for an unknown
    one."""
    name = _dtype_name(dtype)
    if name in _ITEMSIZE:
        return _ITEMSIZE[name]
    import torch

    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    try:
        return int(np.dtype(name).itemsize)
    except TypeError:
        raise ValueError(
            f"unknown dtype {dtype!r} in the collective byte model"
        ) from None


def modeled_collective_bytes(
    shape: Sequence[int],
    world: int,
    n_ici: int,
    wire_dtype: Optional[str] = None,
    dtype: str = "float32",
) -> dict:
    """Modeled per-tier bytes of ONE allreduce of ``shape`` (copied from
    the JAX package).

    ``world`` ranks take part, ``n_ici`` of them a slice: ``world`` =
    flat over one slice, all on the local tier; ``1`` = flat over a
    world that spans slices, every ring step's bytes attributed to the
    cross tier (its bottleneck link); anything between = the two-level
    routing: a local reduce-scatter and all-gather of the payload padded
    to a multiple of ``n_ici``, ``2·(n_ici-1)/n_ici · padded`` bytes,
    and a cross hop of the 1/n_ici shard: an all-reduce,
    ``2·(n_dcn-1)/n_dcn · shard``, or, with a wire dtype that narrows a
    floating payload, an all-gather of the wire shard summed locally in
    full precision, ``(n_dcn-1) · wire_shard``.  ``wire_dtype``: None,
    ``"bfloat16"``, ``"float16"`` or a short spelling; ``dtype``: the
    payload's.  Bytes per rank (local) and per slice-boundary link
    (cross), without protocol framing.  Returns ``{"ici_bytes",
    "dcn_bytes", "wire_dtype", "algorithm"}``."""
    world = int(world)
    n_ici = int(n_ici)
    if world < 1 or n_ici < 1 or (n_ici > 1 and world % n_ici):
        raise ValueError(
            f"invalid world={world} / n_ici={n_ici} (n_ici must divide)")
    n = int(np.prod(np.asarray(list(shape), dtype=np.int64))) if len(
        tuple(shape)) else 1
    item = _payload_itemsize(dtype)
    payload = n * item
    wire_name = _dtype_name(wire_dtype) if wire_dtype else None
    if world == 1:
        return {"ici_bytes": 0, "dcn_bytes": 0, "wire_dtype": None,
                "algorithm": "local"}
    if n_ici == world:
        return {"ici_bytes": int(2 * (world - 1) * payload // world),
                "dcn_bytes": 0, "wire_dtype": None, "algorithm": "flat"}
    if n_ici == 1:
        return {"ici_bytes": 0,
                "dcn_bytes": int(2 * (world - 1) * payload // world),
                "wire_dtype": None, "algorithm": "flat"}
    n_dcn = world // n_ici
    padded = -(-n // n_ici) * n_ici  # ceil to the scatter multiple
    shard = padded // n_ici
    # the wire engages only where compress_shard narrows the payload
    # (floating, wider than the wire); otherwise the hop is the
    # uncompressed all-reduce and the model follows it
    compressible = (wire_name is not None
                    and "float" in _dtype_name(dtype)
                    and _payload_itemsize(wire_name) < item)
    if compressible:
        dcn = int((n_dcn - 1) * shard * _payload_itemsize(wire_name))
    else:
        dcn = int(2 * (n_dcn - 1) * shard * item // n_dcn)
    return {
        "ici_bytes": int(2 * (n_ici - 1) * padded * item // n_ici),
        "dcn_bytes": dcn,
        "wire_dtype": wire_name if compressible else None,
        "algorithm": "hierarchical",
    }


def mesh_slice_ids(grid) -> List[int]:
    """Slice of every rank of a ``(dcn, ici)`` rank grid
    (``hierarchical_mesh()``), indexed by world rank: row ``d`` is slice
    ``d``."""
    grid = np.asarray(grid)
    ids = [0] * grid.size
    for d, row in enumerate(grid):
        for r in row:
            ids[int(r)] = d
    return ids


#: ring-stream factor per collective kind: a rank moves ``factor ·
#: (g-1)/g`` bytes per byte of the payload over a group of g
_COLLECTIVE_FACTOR = {"all_reduce": 2.0, "all_gather": 1.0,
                      "reduce_scatter": 1.0, "all_to_all": 1.0}


def collective_record(op: str, payload_bytes: int,
                      group: Sequence[int]) -> Dict[str, object]:
    """One record of a ``torch.distributed`` call for
    :func:`measured_tier_bytes`: ``op`` (``all_reduce``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``), the bytes it hands over (the
    operand; a gather's result) and its group's world ranks."""
    g = len(group)
    stream = int(_COLLECTIVE_FACTOR[op] * (g - 1) * payload_bytes // g)
    return {"op": op, "payload_bytes": int(payload_bytes),
            "group": tuple(int(r) for r in group), "group_size": g,
            "stream_bytes": stream}


def measured_tier_bytes(records: Sequence[Dict[str, object]],
                        slice_ids: Sequence[int]) -> Dict[str, object]:
    """Per-tier link bytes of recorded collectives (the counterpart of
    the JAX function, which reads a lowered program): each record's
    ring-stream bytes count on the cross (DCN) tier when its group spans
    more than one slice of ``slice_ids`` (world rank -> slice) and on
    the local (ICI) tier otherwise.  Returns ``{"ici_bytes",
    "dcn_bytes", "ops": [per-call records with their tier]}``."""
    ici = dcn = 0
    ops = []
    for rec in records:
        crosses = len({slice_ids[r] for r in rec["group"]}) > 1
        if crosses:
            dcn += rec["stream_bytes"]
        else:
            ici += rec["stream_bytes"]
        ops.append(dict(rec, tier="dcn" if crosses else "ici"))
    return {"ici_bytes": int(ici), "dcn_bytes": int(dcn), "ops": ops}


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
