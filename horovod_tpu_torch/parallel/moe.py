"""Mixture-of-Experts with expert parallelism over a process set.

Port of ``horovod_tpu/parallel/moe.py``.  (Lepikhin et al., "GShard",
2020; top-1 switch routing, Fedus et al. 2021, with capacity-factor
dropping.)

* each rank of the set holds ``num_experts / ep`` experts' weights;
* a learned gate (fp32) routes each token to one expert; a rank packs
  its tokens into per-expert capacity buffers (dropped tokens pass
  through as zeros, for the residual to carry);
* ONE all-to-all sends the buffers to the experts' owners, the expert
  MLPs run as batched products over the local experts, and a second
  all-to-all brings the outputs back.

The JAX layer dispatches and combines with one-hot einsums (static
shapes for XLA).  Each token has one (expert, slot) at most, so the port
scatters and gathers by index instead: the same values, each sum having
one term.  The expert MLPs are ``torch.bmm`` (the JAX layer's einsums
run outside any Pallas kernel).  ``all_to_all_single`` splits dim 0
only, so the two exchanges permute around it to give ``tiled=True``'s
layouts: out split on the expert dim and concatenated on capacity, back
split on the source dim and concatenated on experts.  Each exchange is
an autograd function whose backward is the inverse exchange.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..common.device import resolve_device
from ._mesh_utils import axis_size_or_1 as _axis_size
from .tensor_parallel import gelu, lecun_normal_
from .ulysses import _all_to_all as _a2a


def _dispatch(buffers: torch.Tensor, process_set, local_e: int):
    """(E, C, d) -> (local_E, ep·C, d): expert chunk o to owner o; the
    received buffers concatenate on capacity in source order."""
    e, c, d = buffers.shape
    ep = e // local_e
    got = _a2a(buffers.reshape(ep, local_e, c, d), process_set)
    return got.permute(1, 0, 2, 3).reshape(local_e, ep * c, d)


def _combine(out: torch.Tensor, process_set, ep: int):
    """(local_E, ep·C, d) -> (E, C, d): source chunk c back to rank c;
    the owners' outputs stack on experts in owner order (global expert
    order)."""
    local_e, n, d = out.shape
    c = n // ep
    got = _a2a(out.reshape(local_e, ep, c, d).permute(1, 0, 2, 3),
               process_set)
    return got.reshape(ep * local_e, c, d)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buffers, process_set, local_e):
        ctx.process_set, ctx.ep = process_set, buffers.shape[0] // local_e
        return _dispatch(buffers, process_set, local_e)

    @staticmethod
    def backward(ctx, g):
        return _combine(g, ctx.process_set, ctx.ep), None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, process_set, ep):
        ctx.process_set, ctx.local_e = process_set, out.shape[0]
        return _combine(out, process_set, ep)

    @staticmethod
    def backward(ctx, g):
        return _dispatch(g, ctx.process_set, ctx.local_e), None, None


class ExpertParallelMoe(nn.Module):
    """Switch-style top-1 MoE layer, its experts sliced over
    ``process_set`` (None: one rank holds them all).

    ``forward(x)``: x (B, S, d_model), this rank's batch/sequence shard;
    returns ``(output, aux_loss)``.  Add ``aux_loss`` (load balancing,
    Fedus et al. eq. 4: ``E · Σ_e frac_e · mean_prob_e``) to the
    training loss.  Parameters (flax's names): ``gate`` (d, E) fp32 and
    this rank's experts ``wi`` (E/ep, d, d_ff), ``wo`` (E/ep, d_ff, d)."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 process_set=None, capacity_factor: float = 1.25,
                 activation: Callable = gelu, dtype=torch.float32,
                 device=None):
        super().__init__()
        ep = _axis_size(process_set)
        if num_experts % ep:
            raise ValueError(
                f"experts {num_experts} not divisible by ep={ep}")
        dev = resolve_device(device)
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.process_set, self.ep = process_set, ep
        self.activation, self.dtype = activation, dtype
        local_e = num_experts // ep
        self.gate = nn.Parameter(torch.empty(
            (d_model, num_experts), dtype=torch.float32, device=dev))
        self.wi = nn.Parameter(torch.empty(
            (local_e, d_model, d_ff), dtype=torch.float32, device=dev))
        self.wo = nn.Parameter(torch.empty(
            (local_e, d_ff, d_model), dtype=torch.float32, device=dev))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's lecun-normal draws (fan-in = the contracted width)."""
        lecun_normal_(self.gate, self.gate.shape[0], generator)
        lecun_normal_(self.wi, self.wi.shape[1], generator)
        lecun_normal_(self.wo, self.wo.shape[1], generator)

    def forward(self, x):
        b, s, d = x.shape
        e, local_e = self.num_experts, self.wi.shape[0]
        tokens = x.reshape(b * s, d)
        n_tok = b * s
        capacity = max(1, int(self.capacity_factor * n_tok / e))

        # -- the gate, in fp32 for routing stability ------------------------
        probs = torch.softmax(tokens.float() @ self.gate, dim=-1)  # (T, E)
        gate_val, expert_idx = probs.max(dim=-1)  # ties: the first index
        one_hot = torch.nn.functional.one_hot(expert_idx, e).float()
        frac = one_hot.mean(dim=0)
        aux_loss = e * torch.sum(frac * probs.mean(dim=0))

        # -- each token's slot in its expert's buffer -----------------------
        pos = (torch.cumsum(one_hot, dim=0) - 1.0).gather(
            1, expert_idx[:, None])[:, 0]
        keep = pos < capacity
        gate_val = gate_val * keep
        slot = expert_idx * capacity + pos.long()  # flat (expert, slot)
        kept = torch.nonzero(keep)[:, 0]

        # (E, C, d) capacity buffers: the kept tokens scattered to slots
        buffers = tokens.float().new_zeros((e * capacity, d)).index_put(
            (slot[kept],), tokens.float()[kept]).to(self.dtype)
        buffers = buffers.reshape(e, capacity, d)

        # -- to the experts' owners -----------------------------------------
        if self.ep > 1:
            buffers = _Dispatch.apply(buffers, self.process_set, local_e)
        # -- the local experts: batched products over local_E ---------------
        h = self.activation(torch.bmm(buffers, self.wi.to(self.dtype)))
        out = torch.bmm(h, self.wo.to(self.dtype))
        # -- the return trip ------------------------------------------------
        if self.ep > 1:
            out = _Combine.apply(out, self.process_set, self.ep)
        out = out.reshape(e * capacity, d)

        # back to token order (a dropped token gets zeros), weighted by
        # its gate value
        combined = out.new_zeros((n_tok, d)).index_put(
            (kept,), out[slot[kept]])
        combined = combined * gate_val[:, None].to(self.dtype)
        return combined.reshape(b, s, d), aux_loss
