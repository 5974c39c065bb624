"""The two-level collectives: local reduce-scatter, cross hop, local
all-gather.

Port of ``horovod_tpu/ops/spmd_ops.py``'s ``_two_level_sum_leaf``,
``hierarchical_allreduce``, ``_two_level_reduce_scatter_flat`` and
``_two_level_all_gather_flat`` as functions on tensors over this rank's
local and cross groups (:class:`~..common.topology.Tiers`; the JAX
package's ``ici`` and ``dcn`` mesh axes).  The reference Horovod's
NCCLHierarchicalAllreduce has the same shape: each byte crosses the
slow tier once per ``n_ici`` ranks instead of once per rank.

The sum of one flat buffer (:func:`two_level_sum_start`):

1. pad to a multiple of ``n_ici`` and reduce-scatter over the local
   group at full precision: position ``i`` of a slice holds chunk ``i``
   of its slice's sum;
2. the cross hop of that 1/n_ici shard over the cross group: an
   all-reduce, or, with a :class:`~..compression.DcnCompression` that
   narrows it, an all-gather of the wire shard that every rank sums
   locally in the accumulation dtype, slices in order (never an
   all-reduce in the wire dtype, which would accumulate in it);
3. all-gather the shards over the local group and drop the padding.

The steps run on the port's rank-ordered primitives
(``collective_ops._reduce_scatter_start``, ``_sum_async``,
``_all_gather_flat``): a floating sum over three or more ranks of a
group adds them in rank order, so an element's sum is (its slice's sum
in rank order), added across slices in slice order, whatever buffer
the element lies in.  The result is then the same on every rank and
does not depend on how buckets cut a gradient.  It differs from the
flat rank-ordered sum only in association (bit-equal on dyadic
values).

The primitives record every ``torch.distributed`` call they issue
while a ``collective_ops.recording`` block is open: the op handed to
the backend, the bytes of the buffer and the group's ranks, which
``comm_model.measured_tier_bytes`` turns into per-tier bytes.  Where
the issued calls are not the model's (``comm_model.
modeled_collective_bytes``), the records say so: over gloo a local
reduce-scatter of two ranks is an all-reduce of the whole buffer, and a
rank-ordered cross sum over three or more slices is an all-to-all and
an all-gather of the shard padded to a multiple of ``n_dcn``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from ..common.topology import Tiers
from . import collective_ops as co
from .reduce_ops import ReduceOp


def _wait(works) -> None:
    for w in works:
        w.wait()


def _narrows(compression, t: torch.Tensor) -> bool:
    """Whether ``compression`` casts ``t`` to a narrower wire dtype."""
    return (compression is not None and t.dtype.is_floating_point
            and t.dtype.itemsize > compression.wire_dtype.itemsize)


def _cross_sum(piece: torch.Tensor, tiers: Tiers, compression,
               residual: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The cross hop: ``piece`` (this rank's own copy) summed over the
    cross group; ``(sum, new residual)``."""
    if _narrows(compression, piece):
        wire, new_residual = compression.compress_shard(piece, residual)
        gathered = wire.new_empty(tiers.n_dcn * wire.numel())
        co._all_gather_flat(gathered, wire.contiguous(),
                            group=tiers.cross_group)
        rows = compression.decompress_shard(
            gathered.view(tiers.n_dcn, -1), piece.dtype)
        return co._sum_rows(rows), new_residual
    works, res = co._sum_async(piece, tiers.cross_group, tiers.n_dcn,
                               tiers.slice_index, ordered=True)
    _wait(works)
    return res(), residual


def two_level_sum_start(buf: torch.Tensor, tiers: Tiers,
                        dcn_compression=None,
                        residual: Optional[torch.Tensor] = None
                        ) -> Tuple[List, Callable[[], Tuple[
                            torch.Tensor, Optional[torch.Tensor]]]]:
    """Start the two-level sum of a 1-D buffer across the world (module
    docstring): ``(works, result)``, where ``result()`` gives ``(sum,
    new residual)`` once the works are done.  The local reduce-scatter
    starts here; the cross hop and the local all-gather run in
    ``result()``, so every rank must take its results in the same order
    (over gloo and NCCL alike, a group's collectives pair up in issue
    order).  ``residual`` is the error-feedback state of this buffer's
    shard (None: none yet)."""
    numel = buf.numel()
    buf = co._pad_to(buf, tiers.n_ici)
    works, piece = co._reduce_scatter_start(buf, tiers.local_group,
                                            tiers.n_ici, tiers.position)

    def result():
        shard, new_residual = _cross_sum(piece(), tiers, dcn_compression,
                                         residual)
        full = shard.new_empty(shard.numel() * tiers.n_ici)
        co._all_gather_flat(full, shard, group=tiers.local_group)
        return full[:numel], new_residual

    return works, result


def two_level_sum(buf: torch.Tensor, tiers: Tiers, dcn_compression=None,
                  residual: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`two_level_sum_start`, waited: ``(sum, new residual)``."""
    works, result = two_level_sum_start(buf, tiers, dcn_compression,
                                        residual)
    _wait(works)
    return result()


def _require_tiers(tiers: Optional[Tiers]) -> Tiers:
    if tiers is None:
        from ..common import topology

        tiers = topology.tiers()
        if tiers is None:
            raise ValueError(
                "the world is a single slice: there is no cross tier for "
                "a two-level collective")
    return tiers


def hierarchical_allreduce(tensor: Any, average: Optional[bool] = None,
                           op: Optional[ReduceOp] = None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           dcn_compression=None, residual: Any = None,
                           tiers: Optional[Tiers] = None) -> Any:
    """Two-level allreduce of a tensor or tree across the world, leaf by
    leaf (port of ``spmd_ops.hierarchical_allreduce``): Sum or Average
    only, like the reference op; pre- and postscale multiply in the
    leaf's dtype; Average divides the sum by the world size.
    ``dcn_compression`` casts only the cross-tier shard.  With
    ``error_feedback`` compression the call returns ``(result, new
    residual)``, and ``residual`` (the previous call's, a tree of
    shard-shaped leaves, or None the first time) must be threaded by
    the caller.  ``tiers`` defaults to the world's
    (:func:`~..common.topology.tiers`); a world of one slice raises."""
    rop = co._normalize_op(op, average)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"hierarchical_allreduce supports Sum/Average, got {rop!r}")
    tiers = _require_tiers(tiers)
    feedback = bool(getattr(dcn_compression, "error_feedback", False))
    leaves, build = co._flatten(tensor)
    res_leaves = (co._flatten(residual)[0] if residual is not None
                  else [None] * len(leaves))
    out, new_res = [], []
    for t, res in zip(leaves, res_leaves):
        flat = co._scale(t.detach().reshape(-1), prescale_factor)
        red, nr = two_level_sum(flat, tiers, dcn_compression, res)
        if rop == ReduceOp.AVERAGE:
            red = co._divide(red, tiers.size)
        out.append(co._scale(red, postscale_factor).view(t.shape))
        new_res.append(nr)
    if feedback:
        return build(out), build(new_res)
    return build(out)


def two_level_reduce_scatter_flat(buf: torch.Tensor, tiers: Tiers,
                                  dcn_compression=None,
                                  residual: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]:
    """Two-level reduce-scatter of a 1-D buffer whose length divides by
    the world size: the rank at grid cell ``(d, i)`` receives the fully
    reduced chunk ``d·n_ici + i``, the chunk a flat reduce-scatter in
    grid order hands it (port of ``_two_level_reduce_scatter_flat``).

    Landing control: a chunk transpose before the local reduce-scatter
    (position ``i`` then holds chunk ``d·n_ici + i`` of every ``d``),
    then the cross hop scatters the 1/n_ici piece: a reduce-scatter, or
    with a narrowing compression an all-to-all of wire chunks summed in
    the accumulation dtype.  Returns ``(shard, new residual)``; the
    residual is piece-shaped (``numel / n_ici``)."""
    n_ici, n_dcn = tiers.n_ici, tiers.n_dcn
    s = buf.numel() // (n_ici * n_dcn)
    permuted = buf.reshape(n_dcn, n_ici, s).transpose(0, 1).reshape(-1)
    works, res = co._reduce_scatter_start(permuted, tiers.local_group,
                                          n_ici, tiers.position)
    _wait(works)
    piece = res()  # this rank's slice sums of its n_dcn chunks
    if _narrows(dcn_compression, piece):
        wire, new_residual = dcn_compression.compress_shard(piece,
                                                            residual)
        wire = wire.contiguous()
        recv = torch.empty_like(wire)
        co._all_to_all_flat(recv, wire, group=tiers.cross_group)
        rows = dcn_compression.decompress_shard(recv.view(n_dcn, s),
                                                piece.dtype)
        return co._sum_rows(rows), new_residual
    works, res = co._reduce_scatter_start(piece, tiers.cross_group, n_dcn,
                                          tiers.slice_index)
    _wait(works)
    return res(), residual


def two_level_all_gather_flat(shard: torch.Tensor, tiers: Tiers,
                              dcn_compression=None) -> torch.Tensor:
    """Inverse of :func:`two_level_reduce_scatter_flat`: the cross
    all-gather (in the wire dtype where ``dcn_compression`` narrows the
    shard; every rank casts alike, so the copies stay identical), the
    local all-gather, then the inverse chunk transpose."""
    n_ici, n_dcn, s = tiers.n_ici, tiers.n_dcn, shard.numel()
    wire = shard
    if _narrows(dcn_compression, shard):
        wire, _ = dcn_compression.compress_shard(shard, None)
    gathered = wire.new_empty(n_dcn * s)
    co._all_gather_flat(gathered, wire.contiguous(),
                        group=tiers.cross_group)
    piece = (dcn_compression.decompress_shard(gathered, shard.dtype)
             if wire is not shard else gathered)
    full = piece.new_empty(n_ici * n_dcn * s)
    co._all_gather_flat(full, piece, group=tiers.local_group)
    return full.view(n_ici, n_dcn, s).transpose(0, 1).reshape(-1)


__all__ = ["hierarchical_allreduce", "two_level_all_gather_flat",
           "two_level_reduce_scatter_flat", "two_level_sum",
           "two_level_sum_start"]
