"""Pipeline parallelism: GPipe-style microbatched stage execution.

Port of ``horovod_tpu/parallel/pipeline.py``.  (Huang et al., "GPipe",
2019.)  Each rank of a process set holds one *stage*; the batch is split
into M microbatches; at every tick each rank runs its stage on the
microbatch it holds and passes the activation on to the next rank (one
``batch_isend_irecv`` a tick, where the JAX package runs one
``ppermute``).  After ``M + n - 1`` ticks every microbatch has left the
last stage, and one broadcast brings the outputs home to every rank.

Where a rank holds no microbatch at a tick (the pipeline filling or
draining) the JAX schedule computes and passes on a value that is never
collected; the port skips that tick's stage and exchange, on both sides
of the hop, and changes no result.

The JAX package gets the backward from ``jax.grad`` taken outside the
``shard_map``.  The port writes it by hand in one autograd function: the
ticks run in reverse, each microbatch's gradient travels one hop back
per tick, and each stage's parameter gradients add up over its
microbatches.  The outputs are replicated on every rank, so the loss
behind them is counted ONCE: the last stage receives the mean of the
ranks' output cotangents — one copy's when the ranks compute the same
loss — as ``shard_map``'s transpose of a replicated output gives it.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..common import basics


class _Stages:
    """This rank's place in the pipeline of a process set."""

    def __init__(self, process_set):
        st = basics._require_init()
        ps = st.process_set_registry.resolve(process_set)
        self.group, self.ranks = ps.group, list(ps.ranks)
        self.n, self.idx = len(self.ranks), ps.rank_in_set(st.rank)

    def holds(self, t: int, m: int) -> bool:
        """Whether this rank's stage runs a real microbatch at tick t."""
        return 0 <= t - self.idx < m

    def exchange(self, send=None, send_to: int = 0, recv_like=None,
                 recv_from: int = 0):
        """Post one send (to the stage ``send_to`` places on) and/or one
        receive (from the stage ``recv_from`` places on) and wait."""
        ops, got = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  self.ranks[self.idx + send_to], self.group))
        if recv_like is not None:
            got = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, got,
                                  self.ranks[self.idx + recv_from],
                                  self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return got


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stages, stage_fn, spec, m, x, *leaves):
        n, idx = stages.n, stages.idx
        zero = torch.zeros_like(x[0])
        held = None
        outs = [zero] * m
        ticks = []  # (microbatch, input leaf, output) of every real tick
        p_leaves = [p.detach().requires_grad_(p.requires_grad)
                    for p in leaves]
        p_tree = tree_unflatten(p_leaves, spec)
        for t in range(m + n - 1):
            if stages.holds(t, m):
                j = t - idx
                inp = (x[j] if idx == 0 else held).detach().requires_grad_()
                with torch.enable_grad():
                    out = stage_fn(p_tree, inp)
                ticks.append((j, inp, out))
                if idx == n - 1:
                    outs[j] = out.detach()
            # the hop: this tick's output on, the next tick's input in
            held = stages.exchange(
                send=ticks[-1][2].detach() if stages.holds(t, m)
                and idx < n - 1 else None, send_to=1,
                recv_like=zero if idx > 0 and stages.holds(t + 1, m)
                else None, recv_from=-1)
        y = torch.stack(outs)
        # the last stage's outputs home to every rank
        dist.broadcast(y, stages.ranks[n - 1], group=stages.group)
        ctx.stages, ctx.ticks, ctx.m = stages, ticks, m
        ctx.p_leaves, ctx.x_shape = p_leaves, x.shape
        return y

    @staticmethod
    def backward(ctx, gy):
        stages, m = ctx.stages, ctx.m
        n, idx = stages.n, stages.idx
        # the replicated outputs' loss counts once: the mean of the
        # ranks' cotangents, on the last stage
        gy = gy.contiguous().clone()
        dist.all_reduce(gy, group=stages.group)
        gy = gy / n
        dx = gy.new_zeros(ctx.x_shape) if idx == 0 else None
        gps: List[Any] = [None] * len(ctx.p_leaves)
        want = [i for i, p in enumerate(ctx.p_leaves) if p.requires_grad]
        by_tick = {j: (inp, out) for j, inp, out in ctx.ticks}
        g_out = None
        for t in reversed(range(m + n - 1)):
            g_in = None
            if stages.holds(t, m):
                j = t - idx
                inp, out = by_tick.pop(j)
                g = gy[j] if idx == n - 1 else g_out
                grads = torch.autograd.grad(
                    out, [inp] + [ctx.p_leaves[i] for i in want], g,
                    allow_unused=True)
                g_in = grads[0] if grads[0] is not None \
                    else torch.zeros_like(inp)
                for i, gp in zip(want, grads[1:]):
                    if gp is not None:
                        gps[i] = gp if gps[i] is None else gps[i] + gp
                if idx == 0:
                    dx[j] = g_in
            # this tick's input gradient back; the previous tick's
            # output gradient in
            g_out = stages.exchange(
                send=g_in if idx > 0 and g_in is not None else None,
                send_to=-1,
                recv_like=gy[0] if idx < n - 1 and stages.holds(t - 1, m)
                else None, recv_from=1)
        ctx.ticks = None
        return (None, None, None, None, dx, *gps)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor,
                   num_microbatches: int, process_set=None
                   ) -> torch.Tensor:
    """Run a pipelined stack of stages over ``process_set``'s ranks
    (default: the world), one stage a rank, in rank order.

    Args:
      stage_fn: ``(params_for_this_stage, activations) -> activations``;
        applied by every rank to the microbatch it holds.  Must be
        shape-preserving (transformer-block pipelining).
      stage_params: this rank's stage parameters (a tensor or a tuple /
        list / dict of them).
      x: (M, mb, ...) — the microbatched input, the same shape on every
        rank; only the first rank's values are read.
      num_microbatches: M.
      process_set: the pipeline's ranks.

    Returns:
      (M, mb, ...) outputs of the final stage, on every rank.
      Differentiable in ``x`` (the first rank's) and ``stage_params``
      (see the module docstring for the replicated loss).
    """
    m = num_microbatches
    if x.shape[0] != m:
        raise ValueError(f"x dim0 ({x.shape[0]}) must equal M ({m})")
    stages = _Stages(process_set)
    if stages.n == 1:
        return torch.stack([stage_fn(stage_params, x[i]) for i in range(m)])
    leaves, spec = tree_flatten(stage_params)
    return _Pipeline.apply(stages, stage_fn, spec, m, x, *leaves)
