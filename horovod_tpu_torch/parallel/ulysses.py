"""Ulysses (DeepSpeed-style) sequence parallelism via all-to-all.

Port of ``horovod_tpu/parallel/ulysses.py``.  (Jacobs et al., "DeepSpeed
Ulysses", 2023.)  Activations are sequence-sharded: each rank of a
process set holds S/n of the sequence.  Before attention one all-to-all
re-shards from sequence-split to head-split (each rank then holds H/n
heads over the FULL sequence), ordinary attention runs locally, and a
second all-to-all restores the sequence split.  Two all-to-alls a layer
against ring attention's n hops.

Where the JAX package calls ``lax.all_to_all`` with ``tiled=True``, the
port calls ``dist.all_to_all_single`` over the set's group, which splits
dim 0 only: each re-shard permutes the split dimension to the front
before it and the received chunks into place after it.  Each of the two
is an autograd function whose backward is the other.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..common import basics


def _all_to_all(x: torch.Tensor, process_set) -> torch.Tensor:
    """Chunk i of dim 0 to the set's rank i; the received chunks stacked
    on dim 0 in rank order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=process_set.group)
    return out


def _seq_to_heads(x: torch.Tensor, process_set) -> torch.Tensor:
    b, s, h, d = x.shape
    n = process_set.size()
    # split the heads: (n, B, S/n, H/n, D), chunk j to rank j
    x = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    y = _all_to_all(x, process_set)  # (n_src, B, S/n, H/n, D)
    # the sources' sequence chunks concatenate in rank order
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, process_set) -> torch.Tensor:
    b, s, h, d = x.shape
    n = process_set.size()
    # split the sequence: (n, B, S/n, H/n, D), chunk j to rank j
    x = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    y = _all_to_all(x, process_set)  # (n_src, B, S/n, H/n, D)
    # the sources' head chunks concatenate in rank order
    return y.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set):
        ctx.process_set = process_set
        return _seq_to_heads(x, process_set)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.process_set), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set):
        ctx.process_set = process_set
        return _heads_to_seq(x, process_set)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.process_set), None


def _resolve(process_set):
    st = basics._require_init()
    return st.process_set_registry.resolve(process_set)


def seq_to_heads(x: torch.Tensor, process_set=None) -> torch.Tensor:
    """(B, S/n, H, D) sequence-sharded -> (B, S, H/n, D) head-sharded
    over ``process_set`` (default: the world); differentiable, its
    backward :func:`heads_to_seq`."""
    return _SeqToHeads.apply(x, _resolve(process_set))


def heads_to_seq(x: torch.Tensor, process_set=None) -> torch.Tensor:
    """(B, S, H/n, D) head-sharded -> (B, S/n, H, D) sequence-sharded;
    differentiable, its backward :func:`seq_to_heads`."""
    return _HeadsToSeq.apply(x, _resolve(process_set))


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    process_set=None,
    attn_fn: Optional[Callable] = None,
    impl: str = "dense",
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention over a sequence-sharded process set via two
    all-to-alls.

    Args:
      q, k, v: (B, S_local, H, D) — this rank's sequence shard; global
        order follows the rank's index in the set.  H must be divisible
        by the set's size, and under GQA so must the kv head count H_kv
        (the all-to-all splits both).
      process_set: the ranks the sequence is sharded over (default: the
        world).
      attn_fn: local attention ``(q, k, v) -> out`` on full-sequence,
        head-sharded tensors; overrides ``impl`` (and ``causal`` /
        ``window``: apply your own masking).
      impl: with no ``attn_fn``, ``"dense"`` runs the exact dot
        attention and ``"flash"`` the port's ``flash_attention`` (the
        hand-written kernels: the forward, and dQ and dK/dV under
        autograd) over the FULL sequence on H/n heads.
      causal: True = decoder mask; False = bidirectional.
      window: sliding window, passed to the local attention (positions
        are global there: the all-to-all restored the whole sequence).
    Returns:
      (B, S_local, H, D), sequence-sharded like the input.
    """
    ps = _resolve(process_set)
    n = ps.size()
    if attn_fn is None:
        if impl == "flash":
            from ..ops.flash_attention import flash_attention

            attn_fn = functools.partial(flash_attention, causal=causal,
                                        window=window)
        elif impl == "dense":
            from ..models.transformer import causal_dot_attention

            attn_fn = functools.partial(causal_dot_attention,
                                        causal=causal, window=window)
        else:
            raise ValueError(f"unknown ulysses attention impl {impl!r}")
    if n == 1:
        return attn_fn(q, k, v)
    h, h_kv = q.shape[2], k.shape[2]
    if h % n or h_kv % n:
        raise ValueError(
            f"ulysses needs query heads ({h}) and kv heads ({h_kv}) "
            f"divisible by axis size ({n})")
    q, k, v = (_SeqToHeads.apply(t, ps) for t in (q, k, v))
    out = attn_fn(q, k, v)  # (B, S, H/n, D), the full sequence
    return _HeadsToSeq.apply(out, ps)
