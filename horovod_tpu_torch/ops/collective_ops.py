"""Collectives with Horovod's API, over ``torch.distributed``.

Port of ``horovod_tpu/ops/collective_ops.py`` (the eager API) with the
arithmetic of ``horovod_tpu/ops/spmd_ops.py``.  There is no separate
SPMD layer: with one process per GPU every rank already runs the same
program, so these calls are what a ``shard_map``-ed step's collectives
were (the ``spmd_ops`` names stay queued in ROADMAP).

* Every op takes a tensor or a list / tuple / dict of tensors and
  returns new tensors; the inputs are left alone.
* ``allreduce`` fuses the leaves into per-dtype buckets
  (:mod:`.fusion`), one collective per bucket.  ``Average`` is SUM
  followed by a division by ``size()`` in the tensor's dtype — as
  ``spmd_ops.allreduce`` does, and never ``dist.ReduceOp.AVG`` (gloo
  lacks it, NCCL rounds differently).  Pre- and postscale factors
  multiply in the tensor's dtype before and after the reduction, and
  only Sum and Average take them.
* ``allreduce_async`` returns a :class:`Handle` at once;
  :func:`synchronize` waits for it and returns the result, :func:`poll`
  says whether it is done.
* ``Adasum`` raises ``NotImplementedError`` (queued).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from .fusion import FusionPlan, fuse, fusion_threshold, unfuse
from .reduce_ops import Average, ReduceOp, Sum

_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.AVERAGE: dist.ReduceOp.SUM,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _flatten(tree: Any):
    """``(leaves, build)``: the tensors of a tensor / list / tuple / dict
    tree in order, and a function rebuilding the tree from new leaves."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return len(leaves) - 1
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        raise TypeError(f"collectives take tensors, lists, tuples and "
                        f"dicts of tensors, not {type(x).__name__}")

    skeleton = walk(tree)

    def build(values):
        def fill(s):
            if isinstance(s, int):
                return values[s]
            if isinstance(s, dict):
                return {k: fill(v) for k, v in s.items()}
            return type(s)(fill(v) for v in s)
        return fill(skeleton)

    return leaves, build


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    if factor == 1.0:
        return x
    return x * torch.tensor(factor, dtype=x.dtype, device=x.device)


class Handle:
    """An op in flight (reference: horovod/torch/handle_manager.h): the
    ``torch.distributed`` works it waits on and the epilogue that turns
    their buffers into the result."""

    __slots__ = ("_works", "_finish", "_value")

    def __init__(self, works: Sequence, finish: Callable[[], Any]):
        self._works = list(works)
        self._finish = finish
        self._value = None

    def wait(self) -> Any:
        if self._finish is not None:
            for w in self._works:
                w.wait()
            self._value = self._finish()
            self._finish = None
        return self._value

    def done(self) -> bool:
        return self._finish is None or all(w.is_completed()
                                           for w in self._works)


def synchronize(handle: Handle) -> Any:
    """Wait for ``handle`` and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True when ``handle``'s op has completed."""
    return handle.done()


def _normalize_op(op: Optional[ReduceOp], average: Optional[bool]
                  ) -> ReduceOp:
    """The reference's average/op reconciliation."""
    if op is not None and average is not None:
        raise ValueError("specify either op or average, not both")
    if op is None:
        op = Average if (average is None or average) else Sum
    return ReduceOp(op)


def allreduce_async(tensor: Any, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> Handle:
    """Start a fused allreduce of a tensor or tree; returns a
    :class:`Handle` (``name`` is accepted for the reference's
    signature)."""
    rop = _normalize_op(op, average)
    if rop == ReduceOp.ADASUM:
        raise NotImplementedError("Adasum is not ported yet (ROADMAP)")
    sum_like = rop in (ReduceOp.SUM, ReduceOp.AVERAGE)
    if not sum_like and (prescale_factor != 1.0 or postscale_factor != 1.0):
        raise ValueError(
            f"prescale/postscale factors are not supported with op={rop!r}")
    n = basics.size()
    leaves, build = _flatten(tensor)
    plan = FusionPlan(leaves, fusion_threshold())
    bufs = fuse(leaves, plan)
    if sum_like:
        bufs = [_scale(b, prescale_factor) for b in bufs]
    works = [dist.all_reduce(b, op=_DIST_OP[rop], async_op=True)
             for b in bufs]

    def finish():
        out = bufs
        if rop == ReduceOp.AVERAGE:
            out = [b / torch.tensor(n, dtype=b.dtype, device=b.device)
                   for b in out]
        if sum_like:
            out = [_scale(b, postscale_factor) for b in out]
        return build(unfuse(out, plan))

    return Handle(works, finish)


def allreduce(tensor: Any, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> Any:
    """Fused allreduce of a tensor or tree (reference:
    horovod/torch/mpi_ops.py allreduce)."""
    return allreduce_async(tensor, average, name, op, prescale_factor,
                           postscale_factor).wait()


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      **kwargs) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused group (reference:
    grouped_allreduce; ``allreduce``'s keyword arguments)."""
    return allreduce(list(tensors), **kwargs)


def _gather_leaf(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.dim() == 0:
        raise ValueError("allgather needs tensors of rank >= 1")
    dim0 = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(dim0) for _ in range(n)]
    dist.all_gather(sizes, dim0)
    sizes = [int(s) for s in sizes]
    most = max(sizes)
    buf = t.contiguous()
    if t.shape[0] < most:  # ranks may hold different first dims
        pad = torch.zeros((most - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        buf = torch.cat([buf, pad])
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def allgather(tensor: Any, name: Optional[str] = None) -> Any:
    """Concatenate every rank's tensor along dim 0 (reference:
    horovod/torch/mpi_ops.py allgather); first dims may differ."""
    n = basics.size()
    leaves, build = _flatten(tensor)
    return build([_gather_leaf(t, n) for t in leaves])


def broadcast(tensor: Any, root_rank: int, name: Optional[str] = None
              ) -> Any:
    """Every rank receives ``root_rank``'s value (reference:
    horovod/torch/mpi_ops.py broadcast)."""
    n = basics.size()
    if not 0 <= root_rank < n:
        raise ValueError(f"root_rank {root_rank} outside world of size {n}")
    leaves, build = _flatten(tensor)
    out = []
    for t in leaves:
        buf = t.detach().clone().contiguous()
        wire = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
        dist.broadcast(wire, src=root_rank)
        out.append(buf)
    return build(out)


def reducescatter(tensor: Any, op: ReduceOp = Sum,
                  name: Optional[str] = None) -> Any:
    """Reduce across ranks, then keep this rank's slice of dim 0
    (reference: horovod/torch/mpi_ops.py reducescatter; dim 0 must
    divide by ``size()``, as ``spmd_ops.reducescatter`` requires).  Sum
    or Average; Average divides in the tensor's dtype."""
    op = Sum if op is None else ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports Sum and Average")
    st = basics._require_init()
    n, me = st.size, st.rank
    leaves, build = _flatten(tensor)
    out = []
    for t in leaves:
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(f"reducescatter needs dim 0 divisible by "
                             f"{n}, got shape {tuple(t.shape)}")
        if st.backend == "nccl":
            part = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(part, t.contiguous())
        else:  # gloo has no reduce-scatter: reduce all, keep the slice
            full = t.detach().clone().contiguous()
            dist.all_reduce(full)
            part = full.chunk(n)[me].clone()
        if op == ReduceOp.AVERAGE:
            part = part / torch.tensor(n, dtype=part.dtype,
                                       device=part.device)
        out.append(part)
    return build(out)


def barrier() -> None:
    """Block until every rank arrives (reference: horovod_barrier)."""
    st = basics._require_init()
    if st.backend == "nccl":
        dist.barrier(device_ids=[st.device.index])
    else:
        dist.barrier()
