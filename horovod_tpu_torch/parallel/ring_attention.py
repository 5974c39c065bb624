"""Ring attention: exact attention (causal or bidirectional) over a
sequence sharded across ranks.

Port of ``horovod_tpu/parallel/ring_attention.py``.  Each rank keeps its
Q shard; the K/V shards rotate around the ring of ranks while a
flash-style online softmax accumulates exact results, so memory per
rank is O(S/n).  (Liu et al., "Ring Attention with Blockwise
Transformers", 2023.)

Where the JAX package rotates with ``lax.ppermute`` over a mesh axis,
the port sends and receives over ``torch.distributed``: one
``batch_isend_irecv`` a hop, each rank sending to the next rank of the
ring and receiving from the one before (NCCL on the card, gloo on the
CPU).  The ring is a process set's ranks in order (``process_set=``,
default the world, the one axis a port with one process per GPU has).
A world of one falls back to the single-device attention, as the
reference does.

Two impls:

* ``"dense"``: each K/V block through plain einsums (:func:`_block_update`,
  the online-softmax step); differentiable by autograd, the rotation an
  autograd function whose gradients travel back one hop.
* ``"flash"`` (:func:`ring_flash_attention`): each block through the
  hand-written flash kernels at the block's global offset
  ``kv_offset = (src − idx)·S`` (``ops/flash_attention.py``), the
  partial outputs merged by their log-sum-exps in fp32.  Its backward
  (an autograd function, the reference's ``custom_vjp``) rotates K/V
  again and uses FlashAttention-2's decomposition: with the final
  (out, lse) fixed, each block's (dq, dk, dv) is independent, and the
  fp32 dK/dV accumulators travel around the ring with their block, then
  one home shift of −(steps − 1) hops returns them.

The schedule is factored into per-step functions,
:func:`ring_flash_forward_step` and :func:`ring_flash_backward_step`,
which the loops call; a caller may replay n ranks' schedule in one
process with them, in the ring's own order, and get the bits each rank
would.

Two departures from the reference in the flash ring, neither changing
a value:

* It skips a causal ring's future block (``src > idx``): the reference
  computes it and discards it (its lse set to the −1e30 sentinel, whose
  merge multiplies the running output by exactly 1 and adds 0; its
  gradients set to 0).  The exchange goes on as before, so a causal
  ring of n ranks runs n(n+1)/2 blocks' kernels, not n².  (The dense
  ring computes every block, as the reference does.)
* The flash ring posts the next hop's K/V exchange before it computes
  the current block, so the transfer runs beside the kernels (the
  reference leaves overlap to XLA's scheduler); the backward's dK/dV
  accumulators go on only after their block's kernels.

Sliding windows compose: masks act on global positions, and for a
causal window the rotation stops after :func:`ring_window_steps` steps.
GQA: ``k``/``v`` may carry fewer heads than ``q``; only those rotate.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from ..common import basics
from ..ops.flash_attention import (
    flash_attention, flash_block_forward, flash_bwd_dkv, flash_bwd_dq,
)

_NEG_INF = -1e30


def ring_window_steps(n: int, s_local: int, causal: bool = True,
                      window: Optional[int] = None) -> int:
    """Number of ring steps (including the resident/diagonal step 0)
    that can contribute any in-window (q, k) pair on any rank.

    For a CAUSAL sliding window, ring step t >= 1 pairs each rank with
    the K shard t hops behind it; the closest (q, k) distance in that
    pairing is (t-1)*s_local + 1, so the step contributes iff
    (t-1)*s_local + 1 <= window - 1.  Steps beyond that bound are pure
    waste for EVERY rank — the schedule skips them entirely (no compute,
    no exchange).  Bidirectional windows still need the full rotation
    (a shard must transit the whole ring to reach ranks on its other
    side), so only the per-rank masking prunes there."""
    if not causal or window is None:
        return n
    if window <= 1:
        return 1
    return min(n, (window - 2) // s_local + 2)


def _block_update(o, l, m, q, k, v, q_offset, k_offset, causal=True,
                  window=None):
    """One online-softmax accumulation step over a K/V block.

    o: (B,H,Sq,D) f32 accumulator; l: (B,H,Sq) row sums; m: (B,H,Sq) row
    maxes; q: (B,Sq,H,D); k,v: (B,Sk,H_kv,D) with H_kv | H (GQA groups
    the einsums — no repeat).  ``causal=False`` attends the whole block;
    ``window`` restricts reach to GLOBAL positions (the offsets make the
    mask exact across shards).  Logits are taken in the input dtype and
    cast to fp32, the probabilities cast back to v's dtype for P·V: the
    reference's numerics."""
    from ..models.transformer import sliding_mask

    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if h_kv != h:
        qg = q.reshape(b, s_q, h_kv, h // h_kv, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).reshape(
            b, h, s_q, s_k).float()
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / math.sqrt(d)
    masked = causal or window is not None
    if masked:
        mask = sliding_mask(
            q_offset + torch.arange(s_q, device=q.device),
            k_offset + torch.arange(s_k, device=q.device),
            causal=causal, window=window)[None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    new_m = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - new_m[..., None])
    if masked:
        # a fully masked row keeps new_m at the sentinel, where
        # exp(s - new_m) would be 1
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m - new_m)
    new_l = l * corr + p.sum(dim=-1)
    if h_kv != h:
        pv = torch.einsum(
            "bhgqk,bkhd->bhgqd",
            p.reshape(b, h_kv, h // h_kv, s_q, s_k).to(v.dtype), v,
        ).reshape(b, h, s_q, d)
    else:
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v)
    return o * corr[..., None] + pv.float(), new_l, new_m


# -- the ring of ranks --------------------------------------------------------


class _Pending:
    """One posted exchange: ``wait()`` returns the received tensors (the
    sent ones stay referenced until then)."""

    def __init__(self, works, sent, received):
        self._works, self._sent, self._received = works, sent, received

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sent = None
        return self._received


class _Ring:
    """This process's place on the ring of a process set (default: the
    world): the group, its ranks in ring order, this rank's index."""

    def __init__(self, process_set=None):
        st = basics._require_init()
        ps = st.process_set_registry.resolve(process_set)
        self.group = ps.group  # raises when the set is not attached
        self.ranks = list(ps.ranks)
        self.n = len(self.ranks)
        self.idx = ps.rank_in_set(st.rank)

    def start(self, tensors, shift: int = 1, tag: int = 0) -> _Pending:
        """Post one batch: each of ``tensors`` goes to the rank ``shift``
        places on around the ring, and as many tensors of the same
        shapes come from the rank ``shift`` places back (one send and
        one receive per tensor, every rank posting the same batch)."""
        dst = self.ranks[(self.idx + shift) % self.n]
        src = self.ranks[(self.idx - shift) % self.n]
        sent = [t.contiguous() for t in tensors]
        received = [torch.empty_like(t) for t in sent]
        ops = [dist.P2POp(dist.isend, t, dst, self.group, tag + i)
               for i, t in enumerate(sent)]
        ops += [dist.P2POp(dist.irecv, t, src, self.group, tag + i)
                for i, t in enumerate(received)]
        return _Pending(dist.batch_isend_irecv(ops), sent, received)


class _Rotate(torch.autograd.Function):
    """K/V one hop on around the ring (the reference's ``ppermute`` by
    +1); their gradients travel one hop back."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(ring.start(tensors).wait())

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.start(grads, shift=-1).wait())


def _ring_dense(q, k, v, ring, causal, window):
    b, s, h, d = q.shape
    steps = ring_window_steps(ring.n, s, causal=causal, window=window)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    kk, vv = k, v
    for t in range(steps):
        if t:
            kk, vv = _Rotate.apply(ring, kk, vv)
        # a causal ring's future block is wholly masked, a no-op update,
        # but it is computed all the same: every rank's rotated K/V must
        # reach the backward, whose reverse hops are collective
        src = (ring.idx - t) % ring.n
        o, l, m = _block_update(o, l, m, q, kk, vv, ring.idx * s, src * s,
                                causal=causal, window=window)
    # every row sees at least the diagonal (causal, window >= 1) or
    # everything (bidirectional), so l > 0 everywhere
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


# -- flash-block ring attention -----------------------------------------------


def ring_flash_forward_step(o, lse, q, k, v, idx: int, src: int,
                            causal: bool = True,
                            window: Optional[int] = None):
    """One step of the flash ring's forward, on the rank at ring index
    ``idx`` holding the K/V shard ``src``: the block's flash attention
    (the diagonal, ``src == idx``, masked as the whole sequence is; an
    off-diagonal block bidirectional with the window on global
    positions, at ``kv_offset = (src − idx)·S``), merged by log-sum-exp
    into the running ``(o, lse)``: o (B, S, H, D) fp32, lse (B, H, S)
    fp32, both None before the first block (then the block's own).  A
    causal ring's future block (``src > idx``) is skipped.  Returns the
    new ``(o, lse)``."""
    if causal and src > idx:
        return o, lse
    if src == idx:
        o_t, lse_t = flash_block_forward(q, k, v, causal, window)
    else:
        o_t, lse_t = flash_block_forward(q, k, v, False, window,
                                         kv_offset=(src - idx) * q.shape[1])
    if o is None:
        return o_t.float(), lse_t
    new = torch.logaddexp(lse, lse_t)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    c = torch.exp(lse_t - new).transpose(1, 2)[..., None]
    return o * a + o_t.float() * c, new


def ring_flash_backward_step(dq, dk, dv, q, k, v, do, lse, delta, idx: int,
                             src: int, causal: bool = True,
                             window: Optional[int] = None):
    """One step of the flash ring's backward, on the rank at ring index
    ``idx`` holding K/V shard ``src`` with that block's travelling dK/dV
    accumulators: the block's (dq, dk, dv) at its offset from the FINAL
    lse (B, H, S) and δ = rowsum(dO·O) (B, H, S), added in fp32 into
    ``dq`` (this rank's) and ``dk``/``dv`` (the block's).  None before
    the first block: the sums start from the block's own.  A causal
    ring's future block is skipped (its contribution is zero).  Returns
    the new ``(dq, dk, dv)``."""
    if causal and src > idx:
        return dq, dk, dv
    blk_causal, off = (causal, 0) if src == idx else \
        (False, (src - idx) * q.shape[1])
    dq_t = flash_bwd_dq(q, k, v, do, lse, delta, blk_causal, window, off)
    dk_t, dv_t = flash_bwd_dkv(q, k, v, do, lse, delta, blk_causal, window,
                               off)
    if dq is None:
        return dq_t.float(), dk_t.float(), dv_t.float()
    return dq + dq_t.float(), dk + dk_t.float(), dv + dv_t.float()


class _RingFlash(torch.autograd.Function):
    """The flash ring with its custom backward (the reference's
    ``_ring_flash`` custom VJP): the forward saves ``(q, k, v, out,
    lse)``; the backward rotates K/V again with their fp32 dK/dV
    accumulators, then shifts the accumulators home."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, window):
        steps = ring_window_steps(ring.n, q.shape[1], causal=causal,
                                  window=window)
        o = lse = pending = None
        kk, vv = k, v
        for t in range(steps):
            if t:
                kk, vv = pending.wait()
            if t + 1 < steps:  # the next hop travels while this one computes
                pending = ring.start((kk, vv))
            o, lse = ring_flash_forward_step(
                o, lse, q, kk, vv, ring.idx, (ring.idx - t) % ring.n,
                causal, window)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.window, ctx.steps = ring, causal, window, \
            steps
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ring, steps = ctx.ring, ctx.steps
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)  # (B, S, H)
        delta = delta.transpose(1, 2).contiguous()
        dq = dk = dv = kv_next = acc_next = None
        kk, vv = k, v
        for t in range(steps):
            if t:
                kk, vv = kv_next.wait()
                dk, dv = acc_next.wait()
            if t + 1 < steps:
                kv_next = ring.start((kk, vv), tag=0)
            dq, dk, dv = ring_flash_backward_step(
                dq, dk, dv, q, kk, vv, g, lse, delta, ring.idx,
                (ring.idx - t) % ring.n, ctx.causal, ctx.window)
            if t + 1 < steps:
                acc_next = ring.start((dk, dv), tag=2)
        if steps > 1:
            # the accumulators travelled steps-1 hops with their block:
            # one shift returns each to its home rank (the single
            # forward hop when the rotation was full)
            dk, dv = ring.start((dk, dv), shift=-(steps - 1), tag=2).wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _check(q, k, v, window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    h, h_kv = q.shape[2], k.shape[2]
    if h_kv <= 0 or h % h_kv:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({h_kv})")


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name: Optional[str] = None, causal: bool = True,
                         window: Optional[int] = None,
                         process_set=None) -> torch.Tensor:
    """Ring attention whose per-block compute is the flash kernels (see
    the module docstring).  Differentiable; numerics match
    ``ring_attention(..., impl="dense")`` and the single-device flash
    attention.  ``axis_name`` is accepted for the reference's signature:
    the ring is ``process_set``'s ranks (default the world)."""
    _check(q, k, v, window)
    ring = _Ring(process_set)
    if ring.n == 1:
        return flash_attention(q, k, v, causal=causal, window=window)
    return _RingFlash.apply(q, k, v, ring, bool(causal), window)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: Optional[str] = None, impl: str = "dense",
                   causal: bool = True, window: Optional[int] = None,
                   process_set=None) -> torch.Tensor:
    """Exact attention with K/V rotating around the ring of ranks.

    Args:
      q, k, v: (B, S_local, H, D) — this rank's sequence shard; global
        sequence order follows the rank's index in the ring.  GQA: k/v
        may carry H_kv < H heads (H_kv | H) — only the kv heads rotate.
      axis_name: the reference's mesh axis; the port's one axis is the
        ring of ``process_set``'s ranks (default: the world), whatever
        the name.
      impl: ``"dense"`` (einsums, (S/n)² logits a step) or ``"flash"``
        (:func:`ring_flash_attention`: the flash kernels, no logits
        tile in device memory).
      causal: True = decoder (causal mask over GLOBAL positions); False
        = encoder/bidirectional.
      window: sliding window over GLOBAL positions (each token attends
        the last ``window`` positions, itself included; symmetric when
        bidirectional); with ``causal=True`` the rotation stops after
        :func:`ring_window_steps` steps.
      process_set: the ranks the sequence is sharded over.
    Returns:
      (B, S_local, H, D) attention output for the local Q shard, in q's
      dtype.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if impl == "flash":
        return ring_flash_attention(q, k, v, axis_name, causal=causal,
                                    window=window, process_set=process_set)
    if impl != "dense":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    _check(q, k, v, window)
    ring = _Ring(process_set)
    if ring.n == 1:
        from ..models.transformer import causal_dot_attention

        return causal_dot_attention(q, k, v, causal=causal, window=window)
    return _ring_dense(q, k, v, ring, causal, window)


def replay_ring_flash(qs, ks, vs, grads, causal: bool = True,
                      window: Optional[int] = None):
    """The flash ring of ``len(qs)`` ranks, forward and backward, in one
    process: rank i's shards are ``qs[i]``, ``ks[i]``, ``vs[i]`` and the
    gradient of its output ``grads[i]``.  The per-step functions run in
    the ring's own order — the forward rank by rank, the backward step
    by step with each block's accumulators passed on as the ring sends
    them — so each rank's result has the bits a real ring's rank gets
    (a hop moves bits, it does not change them).  Returns ``(outs,
    dqs, dks, dvs)``, lists in rank order, in the inputs' dtypes."""
    n, s = len(qs), qs[0].shape[1]
    steps = ring_window_steps(n, s, causal=causal, window=window)
    outs, lses, deltas = [], [], []
    for idx in range(n):
        o = lse = None
        for t in range(steps):
            src = (idx - t) % n
            o, lse = ring_flash_forward_step(o, lse, qs[idx], ks[src],
                                             vs[src], idx, src, causal,
                                             window)
        outs.append(o.to(qs[idx].dtype))
        lses.append(lse)
        g = grads[idx].contiguous()
        deltas.append((g.float() * outs[-1].float()).sum(dim=-1)
                      .transpose(1, 2).contiguous())
    dq, dk, dv = [None] * n, [None] * n, [None] * n  # dk/dv by block
    for t in range(steps):
        for idx in range(n):
            src = (idx - t) % n
            dq[idx], dk[src], dv[src] = ring_flash_backward_step(
                dq[idx], dk[src], dv[src], qs[idx], ks[src], vs[src],
                grads[idx].contiguous(), lses[idx], deltas[idx], idx, src,
                causal, window)
    return (outs, [x.to(q.dtype) for x, q in zip(dq, qs)],
            [x.to(k.dtype) for x, k in zip(dk, ks)],
            [x.to(v.dtype) for x, v in zip(dv, vs)])
