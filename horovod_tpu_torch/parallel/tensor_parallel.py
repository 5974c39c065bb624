"""Tensor (model) parallelism: Megatron-style sharded layers.

Port of ``horovod_tpu/parallel/tensor_parallel.py``.  (Shoeybi et al.,
"Megatron-LM", 2019.)  A JAX tensor axis becomes a process set of the
port (``common/process_sets.py``): its ranks each hold one slice of the
weights, and its group carries the all-reduces.

* :class:`ColumnParallelDense`: the weight sliced on its *output* dim;
  no communication in the forward.
* :class:`RowParallelDense`: the weight sliced on its *input* dim; one
  all-reduce over the set reassembles the output, and the bias is added
  once, after it.

An attention block is QKV column-parallel (the heads split over the
set), local attention on H/n heads, and a row-parallel output
projection; the MLP is column → gelu → row.  One all-reduce each.

Gradients.  JAX derives the backward collectives from its SPMD
transposes.  The port writes them by hand as Megatron does, in two
autograd functions: :class:`_CopyToTP` (``f``: identity forward,
all-reduce backward) in front of every column-parallel layer, and
:class:`_ReduceFromTP` (``g``: all-reduce forward, identity backward)
behind every row-parallel one.  That is the gradient of the loss taken
once, where the loss is replicated over the set; the JAX package's
multi-axis step, which takes its gradient inside ``shard_map``, gets
the tp-sharded leaves' gradients tp times too large (ROADMAP §C5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from ..ops.collective_ops import _count_submission
from ._mesh_utils import axis_size_or_1 as _axis_size


def _all_reduce(x: torch.Tensor, process_set) -> torch.Tensor:
    """``x`` summed over the set: the plain ``dist.all_reduce`` on the
    set's group (every rank receives the same bits), booked like the
    eager API's: one ``allreduce`` in ``COLLECTIVES`` and its payload
    in ``COLLECTIVE_BYTES``."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=process_set.group)
    _count_submission("allreduce", "eager", out)
    return out


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: identity forward; the input's gradient summed
    over the set in the backward (each rank's slice contributed its
    part)."""

    @staticmethod
    def forward(ctx, x, process_set):
        ctx.process_set = process_set
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.process_set), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: the partial outputs summed over the set in the
    forward; identity backward (the loss behind it counts once)."""

    @staticmethod
    def forward(ctx, x, process_set):
        return _all_reduce(x, process_set)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, process_set) -> torch.Tensor:
    """``f`` over ``process_set`` (identity for None or a set of one)."""
    if _axis_size(process_set) == 1:
        return x
    return _CopyToTP.apply(x, process_set)


def reduce_from_tp(x: torch.Tensor, process_set) -> torch.Tensor:
    """``g`` over ``process_set`` (identity for None or a set of one)."""
    if _axis_size(process_set) == 1:
        return x
    return _ReduceFromTP.apply(x, process_set)


# -- the flagship Transformer's layout ----------------------------------------


def _leaf_dim(names) -> Optional[int]:
    """The sliced dimension of one leaf of the flagship ``Transformer``
    (its path's names), or None (replicated)."""
    if "attn" in names:
        if any(n in names for n in ("q", "k", "v")):
            return 1  # (D, H, d): column-parallel on the head dim
        if "o" in names:
            return 0  # (H, d, D): row-parallel on the head dim
    if "mlp" in names:
        if "gate" in names or "up" in names:
            return 1  # (D, F): column-parallel on F
        if "down" in names:
            return 0  # (F, D): row-parallel on F
    return None


def transformer_shard_specs(params: Mapping) -> Any:
    """For each leaf of the flagship ``Transformer``'s params — the
    port's flat state dict (``layer_0.attn.q.kernel``) or a flax-shaped
    nested tree — the dimension it is sliced on, or None where it is
    replicated, in the same structure:

    * ``attn/{q,k,v}`` kernels (D, H, d): the head dim (1), column-
      parallel — each rank projects its local heads, no communication;
    * ``attn/o`` kernel (H, d, D): the head dim (0), row-parallel — the
      partial outputs meet in the block's first all-reduce;
    * ``mlp/{gate,up}`` kernels (D, F): F (1);
    * ``mlp/down`` kernel (F, D): F (0) — the second all-reduce;
    * the embedding, the norms, everything else: replicated.
    """

    def walk(tree, path):
        out = {}
        for key, val in tree.items():
            names = path + str(key).split(".")
            out[key] = walk(val, names) if isinstance(val, Mapping) \
                else _leaf_dim(names)
        return out

    return walk(params, [])


def shard_slice(t, dim: Optional[int], rank: int, shards: int):
    """Rank ``rank``'s contiguous slice of ``t`` on ``dim`` (all of it
    for None), as ``shard_map`` cuts a global array."""
    if dim is None or shards == 1:
        return t
    n = t.shape[dim]
    if n % shards:
        raise ValueError(
            f"shards ({shards}) must divide dim {dim} of size {n}")
    w = n // shards
    idx = [slice(None)] * len(t.shape)
    idx[dim] = slice(rank * w, (rank + 1) * w)
    return t[tuple(idx)]


# -- the layers ---------------------------------------------------------------


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so that its std is ``1/sqrt(fan_in)``."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ColumnParallelDense(nn.Module):
    """Dense with its output features sliced over ``process_set``: this
    rank holds ``features // n`` columns (``kernel`` (in, features/n),
    uninitialized; ``bias`` (features/n,) zeros; fp32).  No
    communication in the forward; the input's gradient is summed over
    the set (``f``)."""

    def __init__(self, in_features: int, features: int, process_set=None,
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        n = _axis_size(process_set)
        if features % n:
            raise ValueError(f"features {features} not divisible by tp={n}")
        dev = resolve_device(device)
        self.process_set, self.dtype = process_set, dtype
        local = features // n
        self.kernel = nn.Parameter(torch.empty(
            (in_features, local), dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.zeros(
            (local,), dtype=torch.float32, device=dev)) if use_bias else None

    def forward(self, x):
        x = copy_to_tp(x, self.process_set)
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RowParallelDense(nn.Module):
    """Dense with its input features sliced over ``process_set``
    (``kernel`` (in/n, features)): the partial products are summed with
    ONE all-reduce over the set (``g``), then the bias (replicated) is
    added once."""

    def __init__(self, in_features: int, features: int, process_set=None,
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        n = _axis_size(process_set)
        if in_features % n:
            raise ValueError(
                f"in_features {in_features} not divisible by tp={n}")
        dev = resolve_device(device)
        self.process_set, self.dtype = process_set, dtype
        self.kernel = nn.Parameter(torch.empty(
            (in_features // n, features), dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.zeros(
            (features,), dtype=torch.float32, device=dev)) if use_bias \
            else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        y = reduce_from_tp(y, self.process_set)
        if self.bias is not None:
            # applied once, after the reduction
            y = y + self.bias.to(self.dtype)
        return y


class TensorParallelMlp(nn.Module):
    """Column → activation → Row: the Megatron MLP with one forward
    all-reduce (``wi`` and ``wo`` as flax names them)."""

    def __init__(self, d_model: int, d_ff: int, process_set=None,
                 activation: Callable = gelu, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.activation = activation
        self.wi = ColumnParallelDense(d_model, d_ff, process_set,
                                      dtype=dtype, device=device)
        self.wo = RowParallelDense(d_ff, d_model, process_set, dtype=dtype,
                                   device=device)

    def forward(self, x):
        return self.wo(self.activation(self.wi(x)))


class TensorParallelAttention(nn.Module):
    """Multi-head attention with its heads sliced over the set.

    QKV column-parallel (one fused ``qkv`` kernel: this rank computes
    H/n heads), attention local, the output projection ``proj``
    row-parallel (one all-reduce).  The fused kernel's local columns are
    read per rank as (3, H/n, d), as the reference reshapes them, so a
    global kernel is a different function at each tp: the port slices
    it exactly as ``shard_map`` does.  ``attn_fn`` defaults to exact
    causal attention and may be swapped for ring or Ulysses attention
    to compose TP × SP."""

    def __init__(self, num_heads: int, head_dim: int, d_model: int,
                 process_set=None, attn_fn: Optional[Callable] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        n = _axis_size(process_set)
        if num_heads % n:
            raise ValueError(f"heads {num_heads} not divisible by tp={n}")
        self.local_heads, self.head_dim = num_heads // n, head_dim
        self.attn_fn = attn_fn
        feats = num_heads * head_dim
        self.qkv = ColumnParallelDense(d_model, 3 * feats, process_set,
                                       use_bias=False, dtype=dtype,
                                       device=device)
        self.proj = RowParallelDense(feats, d_model, process_set,
                                     use_bias=False, dtype=dtype,
                                     device=device)

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(b, s, 3, self.local_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = self.attn_fn
        if attn is None:
            from ..models.transformer import causal_dot_attention

            attn = causal_dot_attention
        out = attn(q, k, v)  # (B, S, H/n, d)
        return self.proj(out.reshape(b, s, self.local_heads * self.head_dim))
