"""Byte models of the KV snapshot wire (a subset of the JAX package's).

Copied from ``horovod_tpu/ops/comm_model.py``: :func:`modeled_kvsnap_bytes`
and its measured twin :func:`measured_kvsnap_bytes`, the pair the fleet
router's warm handoffs and migrations are held to (modeled == measured,
exactly).  The collective and overlap inventories of that module wait
for the port of the hierarchical collectives.
"""

from __future__ import annotations

import numpy as np

__all__ = ["measured_kvsnap_bytes", "modeled_kvsnap_bytes"]

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
