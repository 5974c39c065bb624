"""Shared process-set helpers for the parallelism modules.

Port of ``horovod_tpu/parallel/_mesh_utils.py``.  Where the JAX package
builds a 1-D mesh of chips for a tensor axis, the port, with one process
per GPU, builds a process set of ranks (``common/process_sets.py``):
its group carries the axis's collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..common import basics
from ..common.process_sets import ProcessSet


def _registry():
    return basics._require_init().process_set_registry


def tensor_shard_mesh(axis: str, shards: int,
                      devices: Optional[Sequence[int]] = None) -> ProcessSet:
    """The process set of ``shards`` ranks, one GPU each, that a
    tensor-sharded serving engine (``ServingEngine`` with
    ``ServeConfig.shards``) runs its per-layer all-reduces over.

    Without ``devices`` the world is cut into consecutive blocks of
    ``shards`` ranks and this rank gets its own block's set (every
    process creates every block's group, in order: ``dist.new_group``
    is collective).  ``devices`` names the ranks by hand; it must hold
    exactly ``shards`` of them, and every process passes the same list.
    ``axis`` names the axis, as the reference's mesh does.

    The reference's DCN-exclusion rule becomes one host: a set whose
    ranks span hosts (``basics.local_size()``) is refused, because its
    all-reduces run twice a decoder layer on every decode step and must
    stay on the host's NVLink."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    st = basics._require_init()
    if devices is not None:
        # an explicit pick must match exactly: silently truncating a
        # hand-chosen list would serve on other cards than intended
        ranks = [int(r) for r in devices]
        if len(ranks) != shards:
            raise ValueError(
                f"explicit devices list has {len(ranks)} entries but "
                f"shards={shards} — pass exactly the ranks to shard over")
        blocks = [ranks]
    else:
        if st.size < shards:
            raise ValueError(
                f"need {shards} devices for the serving shard axis, have "
                f"{st.size}")
        blocks = [list(range(b, b + shards))
                  for b in range(0, st.size - shards + 1, shards)]
    hosts = [{r // st.local_size for r in block} for block in blocks]
    for block, ids in zip(blocks, hosts):
        if len(ids) > 1:
            raise ValueError(
                f"serving shard axis {axis!r} would span hosts "
                f"{sorted(ids)} (ranks {block}) — tensor-parallel "
                f"all-reduces run per decode step and must stay on one "
                f"host's NVLink; shard within one host and replicate "
                f"engines across hosts instead")
    sets = [_registry().find_or_add(block) for block in blocks]
    mine = [ps for ps in sets if ps.included(st.rank)]
    if not mine:
        if devices is not None:
            return sets[0]
        raise ValueError(
            f"rank {st.rank} has no full block of {shards} ranks in a "
            f"world of {st.size}")
    return mine[0]


def axis_size_or_1(process_set: Optional[ProcessSet]) -> int:
    """Size of a process set, or 1 when ``process_set`` is None (a layer
    used unsharded)."""
    if process_set is None:
        return 1
    return process_set.size()
