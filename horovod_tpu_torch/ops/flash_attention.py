"""Flash attention: the attention kernels of the serving and training paths.

Port of ``horovod_tpu/ops/flash_attention.py``.  The Pallas kernels
become CUDA C++ for Hopper, built at first use by :mod:`._build`; each
source's note says what bounds it on the card and what its design does
about that:

* ``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_fwd.cu`` — ``_fwd_kernel``
  in both of its launches: the per-row-offset one
  (:func:`flash_chunk_attention`, :func:`flash_decode_attention`, the
  serving path) and the uniform-offset one (the forward of
  :func:`flash_attention`, which also writes the log-sum-exp).  Two
  variants, picked by :func:`_fwd_variant` from dtype, head_dim and
  query rows: ``sm90`` (wgmma + TMA on the tensor cores: bf16, D in
  {64, 128}, C > 4 — training forwards and prefill chunks) and ``simt``
  (the CUDA-core kernel: fp32, other head widths, gathered decode);
* ``csrc/flash_decode.cu`` — the same ``_fwd_kernel``'s decode launch
  as serving runs it (:func:`flash_decode_paged`): one query row per
  sequence, K/V read through the block table from the paged pools (no
  gather), a GQA group per block, the key range split across blocks and
  merged in split order;
* ``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_bwd.cu`` —
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, the backward of
  :func:`flash_attention`.  Two variants, picked by :func:`_bwd_variant`
  from dtype and head_dim: ``sm90`` (wgmma + TMA: bf16, D in {64, 128} —
  the training path) and ``simt`` (the CUDA-core kernels: fp32, other
  head widths).

All three take the JAX kernels' uniform ``kv_offset``: the global
position of the first key minus that of the first query, 0 for
self-attention and ``(src − idx)·S`` for the off-diagonal blocks of ring
attention (``parallel/ring_attention.py``), which call
:func:`flash_block_forward` and :func:`flash_bwd_dq` /
:func:`flash_bwd_dkv` with it.  Masks and loop bounds act on global
positions.

Beside each kernel, computing the same function in plain PyTorch:
:func:`flash_chunk_attention_reference`, :func:`flash_attention_reference`,
:func:`flash_decode_paged_reference` (:func:`gather_pages`, then the
chunk reference), :func:`flash_bwd_dq_reference` and
:func:`flash_bwd_dkv_reference`
(dense fp32 logits, the same mask, masked entries zeroed).  The CPU path
and the tests use them; ``chip_smoke.py`` holds each kernel against its
plain version on the card.  :func:`_tile_mask`, :func:`_kb_range` and
:func:`_qb_range` mirror the JAX kernels' mask and loop bounds exactly
(the CUDA kernels apply the same rules to their own tiles).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain versions, CUDA tensors launch the kernels (or raise).  Each
kernel wrapper counts its launches in ``<wrapper>.launches``, and per
variant in ``<wrapper>.sm90_launches`` and ``<wrapper>.simt_launches``
(:func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda`,
:func:`flash_bwd_dkv_cuda`), those at a non-zero uniform ``kv_offset``
also in ``.offset_sm90_launches`` and ``.offset_simt_launches``; the
paged decode in ``flash_decode_paged.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30


def _tile_mask(q_pos, k_pos, causal, window, seq_len, kv_off=0):
    """Bool mask — padding, causality, sliding window — on GLOBAL
    positions: ``kv_off`` is the global K start minus the global Q start
    (``horovod_tpu/ops/flash_attention.py::_tile_mask``)."""
    mask = k_pos < seq_len
    rel = q_pos - k_pos - kv_off
    if causal:
        mask = mask & (rel >= 0)
    if window is not None:
        mask = mask & (rel < window)
        if not causal:
            mask = mask & (rel > -window)
    return mask


def _kb_range(q_off, block_q, block_k, padded_kb, causal, window, kv_off=0):
    """K-block loop bounds ``[lo, hi)`` for one Q block (integers): the
    blocks wholly outside the causal diagonal / sliding window are
    skipped (``horovod_tpu/ops/flash_attention.py::_kb_range``)."""
    hi = padded_kb
    if causal:
        hi = min(hi, (q_off + block_q - 1 - kv_off) // block_k + 1)
    elif window is not None:
        hi = min(hi, (q_off + block_q - 1 + window - 1 - kv_off)
                 // block_k + 1)
    lo = 0 if window is None else max(
        0, (q_off - (window - 1) - kv_off) // block_k)
    return lo, max(hi, 0)


def _qb_range(k_off, block_k, block_q, n_qb, causal, window, kv_off=0):
    """Q-block loop bounds ``[lo, hi)`` of the dK/dV kernel for the K
    block at ``k_off``: :func:`_kb_range` with the q and k roles swapped
    and the offset negated (the window's reach is symmetric), joined by
    max with the causal lower bound — the first Q block at or after the
    shifted diagonal (``_bwd_dkv_kernel``'s bounds)."""
    lo, hi = _kb_range(k_off, block_k, block_q, n_qb, False, window, -kv_off)
    if causal:
        lo = max(lo, max(0, (k_off + kv_off) // block_q))
    return lo, hi


def _group_of(q, k) -> int:
    h, h_kv = q.shape[2], k.shape[2]
    if h_kv <= 0 or h % h_kv:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({h_kv})")
    return h // h_kv


def _row_offsets(q_starts, kv_start, b, device) -> torch.Tensor:
    """(B,) int32 ``kv_start - q_starts`` (kv_start None = 0)."""
    qs = torch.as_tensor(q_starts, dtype=torch.int32, device=device)
    qs = qs.reshape(b)
    if kv_start is None:
        return -qs
    ks = torch.as_tensor(kv_start, dtype=torch.int32, device=device)
    return ks.reshape(b) - qs


def _grouped_dots(x, kv):
    """(B, H, C, S) fp32 products of x (B, C, H, D) with every row of kv
    (B, S, H_kv, D); query head h reads kv head h // group."""
    b, c, h, d = x.shape
    h_kv, s_k = kv.shape[2], kv.shape[1]
    return torch.einsum(
        "bchgd,bshd->bhgcs", x.float().reshape(b, c, h_kv, h // h_kv, d),
        kv.float()).reshape(b, h, c, s_k)


def _grouped_logits(q, k):
    """Logits of ``q·sm_scale`` (q cast to fp32 first, as the kernels
    do) against every key."""
    return _grouped_dots(q.float() * (1.0 / (q.shape[-1] ** 0.5)), k)


def _masked_attention(q, k, v, mask):
    """Dense masked softmax attention: ``mask`` broadcasts to (B, H, C,
    S).  Returns the output in q's dtype and the (B, H, C) fp32
    log-sum-exp of the scaled logits, with fully masked rows at 0 and
    the −1e30 sentinel — the kernels' contract."""
    b, c, h, d = q.shape
    h_kv, s_k = k.shape[2], k.shape[1]
    logits = torch.where(mask, _grouped_logits(q, k),
                         torch.tensor(_NEG_INF, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bhgcs,bshd->bchgd", p.reshape(b, h_kv, h // h_kv, c, s_k), v.float(),
    ).reshape(b, c, h, d)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))  # (B, H, C, 1)
    out = out / safe_l.permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(safe_l),
                      torch.full_like(l, _NEG_INF))[..., 0]
    return out.to(q.dtype), lse


def flash_chunk_attention_reference(q, k, v, q_starts, *, window=None,
                                    kv_start=None):
    """Plain PyTorch version of :func:`flash_chunk_attention`: dense fp32
    logits of q·sm_scale against every gathered key, the ``_tile_mask``
    on global positions, and a masked softmax whose fully masked rows
    come out as 0.  Same arguments and output as the kernel's entry."""
    b, c = q.shape[:2]
    _group_of(q, k)
    s_k = k.shape[1]
    offs = _row_offsets(q_starts, kv_start, b, q.device)
    q_pos = torch.arange(c, device=q.device)[None, :, None]
    k_pos = torch.arange(s_k, device=q.device)[None, None, :]
    mask = _tile_mask(q_pos, k_pos, True, window, s_k,
                      offs.long()[:, None, None])[:, None]  # (B,1,C,S)
    return _masked_attention(q, k, v, mask)[0]


def gather_pages(k, v, tables, lens, *, window=None, q_span=1,
                 max_pages=None):
    """Gather each sequence's pages of one layer's pools contiguous
    (``horovod_tpu/serving/kv_cache.py::PagedKVState.gather``).

    k, v: (num_blocks, block_size, H_kv, D); tables: (B, max_blocks)
    int64 block tables; lens: (B,) tokens written before this step.
    Only the first ``max_pages`` table columns are read (default all).
    Without ``window`` those columns are gathered; with one, only the
    trailing pages that can hold the window (widened by ``q_span - 1``
    for chunks) plus a page of alignment slack.  Returns (k, v,
    kv_start): k/v (B, n_pages * block_size, H_kv, D) and kv_start (B,)
    int32, the global position of each gathered row 0."""
    bs = k.shape[1]
    b, width = tables.shape
    n_cols = width if max_pages is None else min(int(max_pages), width)
    if window is None:
        tbl = tables[:, :n_cols] if n_cols < width else tables
        kv_start = torch.zeros((b,), dtype=torch.int32, device=lens.device)
    else:
        n_win = min(n_cols, (window + q_span - 1) // bs + 2)
        first = torch.clamp(
            torch.div(lens.long() + 1 - window, bs, rounding_mode="floor"),
            0, n_cols - n_win)
        idx = first[:, None] + torch.arange(n_win, device=first.device)
        tbl = tables.gather(1, idx)
        kv_start = (first * bs).to(torch.int32)
    n = tbl.shape[1]
    h_kv, d = k.shape[2], k.shape[3]
    return (k[tbl].reshape(b, n * bs, h_kv, d),
            v[tbl].reshape(b, n * bs, h_kv, d), kv_start)


def flash_decode_paged_reference(q, k_pool, v_pool, tables, kv_lens, *,
                                 layer, window=None, max_pages=None):
    """Plain PyTorch version of :func:`flash_decode_paged`: the pages
    gathered through the tables as serving's gather does
    (:func:`gather_pages`), then :func:`flash_chunk_attention_reference`
    for the one query at ``kv_lens - 1``.  Same arguments and output as
    the kernel's entry."""
    lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                           device=q.device).reshape(q.shape[0]) - 1
    gk, gv, kv_start = gather_pages(
        k_pool[layer], v_pool[layer], tables, lens, window=window,
        max_pages=max_pages)
    return flash_chunk_attention_reference(q, gk, gv, lens, window=window,
                                           kv_start=kv_start)


def _self_mask(s, causal, window, device, kv_offset=0):
    """(S, S) ``_tile_mask`` of S queries over S keys whose first key
    sits ``kv_offset`` positions after the first query (0: self-
    attention); every key and every query row valid (``_recompute_p``'s
    ``q_pos < seq_len`` holds for every row of an unpadded tensor)."""
    pos = torch.arange(s, device=device)
    return _tile_mask(pos[:, None], pos[None, :], causal, window, s,
                      kv_offset).expand(s, s)


def flash_attention_reference(q, k, v, causal=True, window=None,
                              kv_offset=0):
    """Plain PyTorch version of the forward kernel's uniform-offset
    launch: ``(out, lse)`` with out (B, S, H, D) in q's dtype and lse
    (B, H, S) fp32 — dense fp32 logits of q·sm_scale, the ``_tile_mask``
    at ``kv_offset``, a masked softmax (rows that see no key: zeros and
    the −1e30 sentinel)."""
    _group_of(q, k)
    return _masked_attention(q, k, v, _self_mask(
        q.shape[1], causal, window, q.device, kv_offset))


def _recompute_p(q, k, lse, causal, window, kv_offset=0):
    """(B, H, S, S) fp32 probabilities from the saved lse, masked entries
    zeroed explicitly (``_recompute_p``)."""
    mask = _self_mask(q.shape[1], causal, window, q.device, kv_offset)
    p = torch.exp(_grouped_logits(q, k) - lse[..., None])
    return torch.where(mask, p, torch.zeros_like(p))


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=True,
                           window=None, kv_offset=0):
    """Plain PyTorch version of the dq kernel: P from the saved lse
    (B, H, S), ``dS = P∘(dO·Vᵀ − δ)`` with δ (B, H, S),
    ``dQ = dS·K · sm_scale``, the mask at ``kv_offset``; returns dQ
    (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    p = _recompute_p(q, k, lse, causal, window, kv_offset)
    ds = p * (_grouped_dots(do, v) - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd",
                      ds.reshape(b, h_kv, h // h_kv, s, s), k.float())
    return (dq.reshape(b, s, h, d) * (1.0 / (d ** 0.5))).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True,
                            window=None, kv_offset=0):
    """Plain PyTorch version of the dkv kernel: ``dV = Σ Pᵀ·dO`` and
    ``dK = Σ dSᵀ·Q · sm_scale``, each summed over the query heads that
    share a kv head, the mask at ``kv_offset``; returns (dK, dV)
    (B, S, H_kv, D) in k's dtype."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    p = _recompute_p(q, k, lse, causal, window, kv_offset)
    ds = p * (_grouped_dots(do, v) - delta[..., None])

    def per_kv(x, y):  # Σ over the group of xᵀ·y -> (B, S, H_kv, D)
        out = torch.einsum("bhqk,bqhd->bkhd", x, y.float())
        return out.reshape(b, s, h_kv, h // h_kv, d).sum(dim=3)

    dk = per_kv(ds, q) * (1.0 / (d ** 0.5))
    return dk.to(k.dtype), per_kv(p, do).to(v.dtype)


# -- the kernels --------------------------------------------------------------


def _check_cuda(q, k, v, *extra):
    """Raise unless q/k/v (and ``extra`` (name, tensor) pairs) are CUDA
    tensors on q's device in one supported dtype, GQA-shaped, with a
    contiguous last dim and 16-byte aligned rows (:func:`_check_aligned`)."""
    b, _, _, d = q.shape
    tensors = (("q", q), ("k", k), ("v", v)) + extra
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dtype {q.dtype} not supported (bf16 or fp32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} / {tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    _group_of(q, k)
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d} must be a multiple of 8, <= 256")
    _check_layout([(name, t) for name, t in tensors
                   if t.dtype == q.dtype and t.dim() == 4])


def _check_layout(tensors):
    """Raise ``ValueError`` unless each (name, tensor) of ``tensors`` —
    the 4-D tensors a kernel addresses, inputs and outputs — has a
    contiguous last dim and 16-byte aligned rows (:func:`_check_aligned`).
    Reads only pointers and strides: no device access."""
    for name, t in tensors:
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {t.stride()}")
        _check_aligned(name, t.data_ptr(), t.stride()[:3], t.element_size())


def _check_aligned(name, ptr, strides, element_size):
    """Raise ``ValueError`` unless a tensor at address ``ptr`` with
    element ``strides`` (every dim but the contiguous last) suits the
    kernels' 16-byte accesses: base 16-byte aligned, each stride a
    multiple of 16 bytes below 2**40 bytes — what the CUDA-core kernels'
    vector loads need, and the sm90 forward's TMA tensor maps.  Pure: no
    device access."""
    if ptr % 16:
        raise ValueError(f"{name} needs a 16-byte aligned base pointer "
                         f"(16-byte loads, TMA), got address {ptr:#x}")
    for s in strides:
        nbytes = s * element_size
        if nbytes % 16 or not 0 <= nbytes < 2 ** 40:
            raise ValueError(
                f"{name} needs strides that are multiples of 16 bytes "
                f"below 2**40, got {tuple(strides)} elements of "
                f"{element_size} bytes")


def _check_stats(b, h, s, device, **stats):
    for name, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be a contiguous (B, H, S) fp32 "
                             f"tensor on {device}")


#: head widths the sm90 forward takes (a 128-byte TMA swizzle row is 64
#: bf16 columns; the kernel's tiles are one or two such regions)
_SM90_HEAD_DIMS = (64, 128)


def _fwd_variant(dtype, d, c) -> str:
    """Which forward kernel a CUDA launch takes, by a fixed rule of dtype,
    head_dim and query rows: ``"sm90"`` (``csrc/flash_fwd_sm90.cu``,
    wgmma + TMA) for bf16 with D in {64, 128} and C > 4 — the training
    forward and prefill chunks; ``"simt"`` (``csrc/flash_fwd.cu``, CUDA
    cores) for fp32, any other D, and decode (C <= 4)."""
    if dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS and c > 4:
        return "sm90"
    return "simt"


def _bwd_variant(dtype, d) -> str:
    """Which backward kernels (dq and dkv alike) a CUDA launch takes, by
    a fixed rule of dtype and head_dim: ``"sm90"``
    (``csrc/flash_bwd_sm90.cu``, wgmma + TMA) for bf16 with D in
    {64, 128} — the training path; ``"simt"`` (``csrc/flash_bwd.cu``,
    CUDA cores) for fp32 and any other D."""
    if dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_FWD_ARGS = {"hvd_flash_fwd": [_P] * 6 + [_I] * 6 + [_L] * 12
             + [_I, _I, _F, _I, _P]}
_SM90_ARGS = {"hvd_flash_fwd_sm90": [_P] * 6 + [_I] * 6 + [_L] * 12
              + [_I, _I, _F, _P],
              "hvd_wgmma_tile": [_P, _P, _P, _I, _I, _P]}
_BWD_ARGS = {
    "hvd_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_P, _I, _I, _I, _F, _I, _P],
    "hvd_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P, _I, _I, _I, _F, _I, _P],
}
_BWD_SM90_ARGS = {
    "hvd_flash_bwd_dq_sm90": [_P] * 7 + [_I] * 5 + [_P, _I, _I, _I, _F, _P],
    "hvd_flash_bwd_dkv_sm90": [_P] * 8 + [_I] * 5 + [_P, _I, _I, _I, _F,
                                                     _P],
    "hvd_wgmma_bwd_tile": [_P, _P, _P, _I, _I, _P],
}


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(wrapper, variant, at_offset=False):
    """One successful launch of ``wrapper``'s kernel in ``variant``
    (``at_offset``: at a non-zero uniform ``kv_offset``)."""
    wrapper.launches += 1
    for name in [f"{variant}_launches"] + (
            [f"offset_{variant}_launches"] if at_offset else []):
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _zero_counts(*wrappers):
    """Each wrapper's launch counts, as they start: 0."""
    for fn in wrappers:
        fn.launches = fn.sm90_launches = fn.simt_launches = 0
        fn.offset_sm90_launches = fn.offset_simt_launches = 0


_UNIFORM_OFFS = {}


def _uniform_offs(b, kv_offset, device) -> torch.Tensor:
    """The (B,) int32 offsets of a uniform launch, made once per
    (device, B, offset) and kept: the copy to the card completes before
    the first launch reads it, and no launch writes it."""
    key = (device, b, kv_offset)
    offs = _UNIFORM_OFFS.get(key)
    if offs is None:
        if len(_UNIFORM_OFFS) >= 1024:
            _UNIFORM_OFFS.clear()
        offs = torch.full((b,), kv_offset, dtype=torch.int32).to(device)
        _UNIFORM_OFFS[key] = offs
    return offs


def flash_fwd_cuda(q, k, v, offs, *, window=None, with_lse=False,
                   causal=True):
    """Launch the forward kernel on CUDA tensors: attention on global
    positions, every key valid.  The variant follows :func:`_fwd_variant`:
    ``csrc/flash_fwd_sm90.cu`` (bf16, D in {64, 128}, C > 4) or
    ``csrc/flash_fwd.cu`` (the rest).

    q: (B, C, H, D); k, v: (B, S, H_kv, D) with ``H_kv | H``; offs: (B,)
    int32 global K start minus global Q start per row, or an int: one
    offset for every row (the uniform launch; its (B,) tensor is kept
    on the card, :func:`_uniform_offs`).  bf16 or fp32, last dim
    contiguous, base pointers and strides 16-byte aligned
    (:func:`_check_aligned`), D a multiple of 8 up to 256.
    ``causal=False`` is bidirectional (a window then reaches both
    ways).
    Returns o (B, C, H, D) in q's dtype, plus the fp32 log-sum-exp
    (B, H, C) when ``with_lse`` (rows that see no key: zeros and the
    −1e30 sentinel).  Raises on anything the kernel does not take and
    on a launch error; ``flash_fwd_cuda.launches`` counts successful
    launches, ``flash_fwd_cuda.sm90_launches`` and ``.simt_launches``
    those of each variant, ``.offset_sm90_launches`` and
    ``.offset_simt_launches`` those at a non-zero uniform offset."""
    b, c, h, d = q.shape
    at_offset = isinstance(offs, int) and offs != 0
    if isinstance(offs, int):
        offs = _uniform_offs(b, offs, q.device)
    _check_cuda(q, k, v, ("offs", offs))
    if offs.dtype != torch.int32 or offs.shape != (b,) \
            or not offs.is_contiguous():
        raise ValueError("offs must be a contiguous (B,) int32 tensor")
    variant = _fwd_variant(q.dtype, d, c)
    if variant == "sm90":
        lib = _build.bound("flash_fwd_sm90.cu", _SM90_ARGS)
        entry, tail = "hvd_flash_fwd_sm90", ()
    else:
        lib = _build.bound("flash_fwd.cu", _FWD_ARGS)
        entry, tail = "hvd_flash_fwd", (int(q.dtype == torch.bfloat16),)
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, c), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        _build.launch(lib, entry, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None, offs.data_ptr(),
            b, c, h, k.shape[2], k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 0 if window is None else int(window),
            int(bool(causal)), 1.0 / math.sqrt(d), *tail, _stream(q)))
    _count(flash_fwd_cuda, variant, at_offset)
    return (o, lse) if with_lse else o


def wgmma_tile_cuda(a, b, pv):
    """One tile product of the sm90 forward on one warpgroup, through its
    own TMA loads, descriptors and ``wgmma`` (the card's unit tests):
    ``pv=False``: a (64, D) · b (BK, D)ᵀ, both operands K-major (S =
    Q·Kᵀ); ``pv=True``: a (64, BK) · b (BK, D), a from registers, b
    MN-major (O = P·V).  bf16, contiguous, D in {64, 128}; BK = 128 at
    D = 64 and 64 at D = 128.  Returns the fp32 product."""
    d = b.shape[1]
    bk = 128 if d == 64 else 64
    want_a = (64, bk) if pv else (64, d)
    if d not in _SM90_HEAD_DIMS or tuple(b.shape) != (bk, d) \
            or tuple(a.shape) != want_a:
        raise ValueError(f"tile shapes {tuple(a.shape)} {tuple(b.shape)}")
    return _tile_product("flash_fwd_sm90.cu", _SM90_ARGS, "hvd_wgmma_tile",
                         a, b, d if pv else bk, pv)


def _tile_product(source, args, entry, a, b, cols, flag):
    """Launch a one-tile product entry (``wgmma_tile_cuda``,
    ``wgmma_bwd_tile_cuda``) on contiguous bf16 CUDA tiles a and b (D =
    b's width); returns its (64, cols) fp32 output."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 CUDA tensor")
        _check_aligned(name, t.data_ptr(), t.stride()[:-1],
                       t.element_size())
    out = torch.empty((64, cols), dtype=torch.float32, device=a.device)
    lib = _build.bound(source, args)
    with torch.cuda.device(a.device):
        _build.launch(lib, entry, (
            a.data_ptr(), b.data_ptr(), out.data_ptr(), b.shape[1],
            int(bool(flag)), _stream(a)))
    return out


def wgmma_bwd_tile_cuda(a, b, rs):
    """One tile product of the sm90 backward on one warpgroup, through
    its own TMA loads, descriptors and ``wgmma`` (the card's unit tests):
    ``rs=False``: a (64, D) · b (64, D)ᵀ, both operands K-major (S = Q·Kᵀ,
    dP = dO·Vᵀ, Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ); ``rs=True``: a (64, 64) · b
    (64, D), a from registers (rounded to bf16), b MN-major (dS·K, Pᵀ·dO,
    dSᵀ·Q).  bf16, contiguous, D in {64, 128}.  Returns the fp32
    product."""
    d = b.shape[1]
    want_a = (64, 64) if rs else (64, d)
    if d not in _SM90_HEAD_DIMS or tuple(b.shape) != (64, d) \
            or tuple(a.shape) != want_a:
        raise ValueError(f"tile shapes {tuple(a.shape)} {tuple(b.shape)}")
    return _tile_product("flash_bwd_sm90.cu", _BWD_SM90_ARGS,
                         "hvd_wgmma_bwd_tile", a, b, d if rs else 64, rs)


def _bwd_cuda(entry, q, k, v, do, lse, delta, outs, causal, window,
              kv_offset):
    """Check and launch one backward kernel, ``entry`` (``hvd_flash_bwd_
    dq`` or ``hvd_flash_bwd_dkv``) in the variant :func:`_bwd_variant`
    gives, at the uniform ``kv_offset``; ``outs`` the (name, tensor)
    outputs.  Returns the variant."""
    b, s, h, d = q.shape
    if k.shape[1] != s:
        raise ValueError(f"k length {k.shape[1]} != q length {s}")
    _check_cuda(q, k, v, ("dO", do))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    _check_stats(b, h, s, q.device, lse=lse, delta=delta)
    _check_layout(outs)
    outs = [t for _, t in outs]
    strides = [x for t in [q, k, v, do] + outs for x in t.stride()[:3]]
    variant = _bwd_variant(q.dtype, d)
    if variant == "sm90":
        lib = _build.bound("flash_bwd_sm90.cu", _BWD_SM90_ARGS)
        entry, tail = entry + "_sm90", ()
    else:
        lib = _build.bound("flash_bwd.cu", _BWD_ARGS)
        tail = (int(q.dtype == torch.bfloat16),)
    arr = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        _build.launch(lib, entry, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b, s, h, k.shape[2], d, ctypes.addressof(arr),
            int(bool(causal)), 0 if window is None else int(window),
            int(kv_offset), 1.0 / math.sqrt(d), *tail, _stream(q)))
    return variant


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal=True, window=None,
                      kv_offset=0):
    """Launch the dq kernel on CUDA tensors, in the variant
    :func:`_bwd_variant` gives: ``csrc/flash_bwd_sm90.cu`` (bf16, D in
    {64, 128}) or ``csrc/flash_bwd.cu`` (the rest).

    q, dO: (B, S, H, D); k, v: (B, S, H_kv, D) whose first key sits
    ``kv_offset`` positions after the first query (an int; 0 for
    self-attention); lse, delta: contiguous (B, H, S) fp32.  Same dtype
    and layout rules as :func:`flash_fwd_cuda`.  Returns dQ (B, S, H, D)
    in q's dtype (rows that see no key: zeros);
    ``flash_bwd_dq_cuda.launches`` counts successful launches,
    ``.sm90_launches`` and ``.simt_launches`` those of each variant,
    ``.offset_sm90_launches`` and ``.offset_simt_launches`` those at a
    non-zero offset."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    variant = _bwd_cuda("hvd_flash_bwd_dq", q, k, v, do, lse, delta,
                        [("dQ", dq)], causal, window, kv_offset)
    _count(flash_bwd_dq_cuda, variant, kv_offset != 0)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal=True,
                       window=None, kv_offset=0):
    """Launch the dkv kernel on CUDA tensors (the arguments, variant
    rule and counts of :func:`flash_bwd_dq_cuda`).  Returns (dK, dV),
    each (B, S, H_kv, D) in k's dtype, the query-head group summed (keys
    no query sees: zeros)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    variant = _bwd_cuda("hvd_flash_bwd_dkv", q, k, v, do, lse, delta,
                        [("dK", dk), ("dV", dv)], causal, window, kv_offset)
    _count(flash_bwd_dkv_cuda, variant, kv_offset != 0)
    return dk, dv


_zero_counts(flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)


# -- the paged decode kernel (csrc/flash_decode.cu) ---------------------------

#: SMs of an H100 SXM, and the blocks the split plan aims for on each:
#: several, so that rows of very different lengths even out
_SMS, _BLOCKS_PER_SM = 132, 4
#: fewest keys worth a split of their own (a shorter split's fixed cost,
#: its first copy's latency and its partials, outweighs its keys), and
#: most table columns one split holds (its page ids sit in shared memory)
_MIN_SPLIT_KEYS, _MAX_SPLIT_PAGES = 256, 4096
_DECODE_ARGS = {"hvd_flash_decode_paged": [_P] * 8 + [_I] * 10
                + [_P, _F, _I, _P]}


def _decode_rows_per_block(group) -> int:
    """Query rows one decode block holds: the GQA group rounded up to 1,
    2, 4 or 8 (a wider group takes ``ceil(group / 8)`` blocks) — the
    kernel's own rule (``flash_decode.cu::launch_t``)."""
    return 1 if group == 1 else 2 if group == 2 else 4 if group <= 4 else 8


def _decode_page_bound(n_cols, block_size, window) -> int:
    """Most table columns one row's live keys can span: all ``n_cols``
    without a window; with one, the pages ``window`` consecutive
    positions can touch."""
    if window is None:
        return n_cols
    return min(n_cols, (window + block_size - 2) // block_size + 1)


def _decode_split_plan(blocks, page_bound, block_size):
    """``(nsplit, pps)``: how many blocks share one row's key range, and
    the table columns each owns, from the blocks a split launches
    (``B * H_kv * ceil(group / rows)``) and the step's page bound — host
    integers only, no device lengths.  Enough splits that the grid holds
    ``_BLOCKS_PER_SM`` blocks per SM, none shorter than
    ``_MIN_SPLIT_KEYS`` keys or longer than ``_MAX_SPLIT_PAGES`` columns,
    and none that would own no column."""
    want = -(-_SMS * _BLOCKS_PER_SM // max(1, blocks))
    most = -(-page_bound * block_size // _MIN_SPLIT_KEYS)
    nsplit = max(1, min(want, most), -(-page_bound // _MAX_SPLIT_PAGES))
    pps = -(-page_bound // nsplit)
    return -(-page_bound // pps), pps


def _decode_split_keys(split, pps, kv_len, block_size, window, n_cols):
    """``(k0, k1)``: the key positions split ``split`` of a row reads
    (``k0 == k1``: none).  The row's live keys are ``[lo, hi)`` — ``lo =
    kv_len - window`` (0 without a window), ``hi = kv_len`` capped at
    ``n_cols`` pages — and split s owns the ``pps`` table columns from
    ``lo // block_size + s * pps``: the kernel's ``split_keys``."""
    hi = min(kv_len, n_cols * block_size)
    lo = 0 if window is None else max(0, kv_len - window)
    if lo >= hi:
        return 0, 0
    p0 = lo // block_size + split * pps
    k0, k1 = max(lo, p0 * block_size), min(hi, (p0 + pps) * block_size)
    return (k0, k1) if k0 < k1 else (0, 0)


def _decode_paged_cuda(q, k_pool, v_pool, tables, kv_lens, layer, window,
                       max_pages):
    """Check and launch ``csrc/flash_decode.cu`` (and its merge kernel
    when the key range is split); returns o (B, 1, H, D)."""
    b, _, h, d = q.shape
    kp, vp = k_pool[layer], v_pool[layer]
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    for name, t, dtype in (("k_pool", k_pool, q.dtype),
                           ("v_pool", v_pool, q.dtype),
                           ("tables", tables, torch.int64),
                           ("kv_lens", kv_lens, torch.int32)):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dtype {q.dtype} not supported (bf16 or fp32)")
    if kp.shape[3] != d or d % 8 or d > 256:
        raise ValueError(f"head_dim {d} (pools {kp.shape[3]}) must match "
                         f"and be a multiple of 8, <= 256")
    if tables.stride(1) != 1:
        raise ValueError("tables needs a contiguous last dim")
    if tuple(kv_lens.shape) != (b,) or not kv_lens.is_contiguous():
        raise ValueError("kv_lens must be a contiguous (B,) int32 tensor")
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    _check_layout([("q", q), ("k_pool", kp), ("v_pool", vp), ("o", o)])
    num_blocks, bs, h_kv = kp.shape[0], kp.shape[1], kp.shape[2]
    group = h // h_kv
    n_cols = tables.shape[1] if max_pages is None \
        else min(int(max_pages), tables.shape[1])
    blocks = b * h_kv * -(-group // _decode_rows_per_block(group))
    nsplit, pps = _decode_split_plan(
        blocks, _decode_page_bound(n_cols, bs, window), bs)
    part_acc = part_ml = None
    if nsplit > 1:
        part_acc = torch.empty((b * h * nsplit, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * h * nsplit, 2), dtype=torch.float32,
                              device=q.device)
    strides = [q.stride(0), q.stride(2), *kp.stride()[:3], *vp.stride()[:3],
               o.stride(0), o.stride(2), tables.stride(0)]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    lib = _build.bound("flash_decode.cu", _DECODE_ARGS)
    with torch.cuda.device(q.device):
        _build.launch(lib, "hvd_flash_decode_paged", (
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            tables.data_ptr(), kv_lens.data_ptr(),
            b, h, h_kv, d, bs, n_cols, num_blocks,
            0 if window is None else int(window), nsplit, pps,
            ctypes.addressof(arr), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), _stream(q)))
    return o


# -- entry points ------------------------------------------------------------


def flash_chunk_attention(q, k, v, q_starts, *, window=None, kv_start=None):
    """Per-row-offset attention over gathered KV-cache pages: the mixed
    chunked-prefill + decode step's kernel.

    q: (B, C, H, D) — row i's C queries sit at global positions
    ``q_starts[i] + 0 .. q_starts[i] + C - 1`` (columns past a row's
    true chunk are pad whose outputs the engine discards).
    k, v: (B, S_kv, H_kv, D), ``H_kv | H`` — each sequence's pages
    gathered contiguous, this chunk's own K/V included; positions past a
    row's written length may hold garbage the causal mask never attends.
    q_starts: (B,) int32; kv_start: optional (B,) int32 global position
    of ``k[:, 0]`` (0 when the gather starts at the sequence head).
    window: sliding window on global positions.

    Output: (B, C, H, D) in q's dtype.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    b = q.shape[0]
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {k.shape} vs {v.shape}")
    _group_of(q, k)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_chunk_attention_reference(
            q, k, v, q_starts, window=window, kv_start=kv_start)
    offs = _row_offsets(q_starts, kv_start, b, q.device).contiguous()
    return flash_fwd_cuda(q, k, v, offs, window=window)


def flash_decode_attention(q, k, v, kv_lens, *, window=None, kv_start=None):
    """Single-token decode attention — the q_len=1 case of
    :func:`flash_chunk_attention`: the query sits at global position
    ``kv_lens - 1`` and attends keys ``0..kv_lens-1``.  Rows with
    ``kv_lens <= 0`` (pad slots of a partial decode batch) come back
    all-zero.  Output: (B, 1, H, D) in q's dtype."""
    b, s_q = q.shape[0], q.shape[1]
    if s_q != 1:
        raise ValueError(f"decode expects q_len=1, got {s_q}")
    kv_lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                              device=q.device).reshape(b)
    return flash_chunk_attention(q, k, v, kv_lens - 1, window=window,
                                 kv_start=kv_start)


def flash_decode_paged(q, k_pool, v_pool, tables, kv_lens, *, layer,
                       window=None, max_pages=None):
    """Single-token decode attention read straight from the paged KV
    pools: what :func:`flash_decode_attention` computes on the pages
    :func:`gather_pages` would gather, without the gather.

    q: (B, 1, H, D); k_pool, v_pool: (num_layers, num_blocks,
    block_size, H_kv, D) with ``H_kv | H``, of which ``layer`` is read;
    tables: (B, max_blocks) int64 block tables; kv_lens: (B,) int32 —
    row b's query sits at global position ``kv_lens[b] - 1`` and attends
    keys ``0 .. kv_lens[b] - 1`` (the last ``window`` of them with a
    window), rows with ``kv_lens <= 0`` come back all-zero.  Only the
    first ``max_pages`` table columns are read (the step's page bound;
    default all).

    Output: (B, 1, H, D) in q's dtype.  CPU tensors run the plain
    version (:func:`flash_decode_paged_reference`); CUDA tensors launch
    ``csrc/flash_decode.cu`` (bf16 or fp32, D a multiple of 8 up to 256,
    16-byte aligned rows) or raise.  ``flash_decode_paged.launches``
    counts successful launches."""
    b, s_q = q.shape[0], q.shape[1]
    if s_q != 1:
        raise ValueError(f"decode expects q_len=1, got {s_q}")
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be two equal 5-D shapes, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} outside the pools' "
                         f"{k_pool.shape[0]} layers")
    _group_of(q, k_pool[layer])
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be (B={b}, max_blocks), got "
                         f"{tuple(tables.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if max_pages is not None and max_pages < 1:
        raise ValueError(f"max_pages must be >= 1, got {max_pages}")
    kv_lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                              device=q.device).reshape(b)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(
            q, k_pool, v_pool, tables, kv_lens, layer=layer, window=window,
            max_pages=max_pages)
    out = _decode_paged_cuda(q, k_pool, v_pool, tables, kv_lens, layer,
                             window, max_pages)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_forward(q, k, v, causal=True, window=None, kv_offset=0):
    """The uniform-offset forward: ``(out, lse)``, lse (B, H, S) fp32 —
    the kernel on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, window, kv_offset)
    return flash_fwd_cuda(q, k, v, int(kv_offset), window=window,
                          with_lse=True, causal=causal)


def _check_block(q, k, v, window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {k.shape} vs {v.shape}")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"k length {k.shape[1]} != q length {q.shape[1]}")
    _group_of(q, k)


def flash_block_forward(q, k, v, causal, window=None, kv_offset=None):
    """One K/V block's attention for a Q block whose keys start
    ``kv_offset`` positions after its queries (global K start minus
    global Q start; None or 0: self-attention): the ring's building
    block (``horovod_tpu/ops/flash_attention.py::flash_block_forward``).

    q: (B, S, H, D); k, v: (B, S, H_kv, D), ``H_kv | H``.  Returns
    ``(out, lse)``: out (B, S, H, D) in q's dtype, normalized within this
    block; lse (B, H, S) fp32, the log-sum-exp of this block's scaled
    logits, with the −1e30 sentinel (and zero output) for rows that see
    no key of the block, so a log-sum-exp merge leaves them untouched.
    CUDA tensors launch the forward kernel (a non-zero offset is counted
    in ``flash_fwd_cuda.offset_*_launches``), CPU tensors run the plain
    version."""
    _check_block(q, k, v, window)
    return flash_forward(q, k, v, bool(causal), window, kv_offset or 0)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, window=None,
                 kv_offset=0):
    """dQ of :func:`flash_attention` (of :func:`flash_block_forward` at
    ``kv_offset``, given the final lse and δ): the kernel on CUDA
    tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, window,
                                      kv_offset)
    return flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal,
                             window=window, kv_offset=int(kv_offset))


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, window=None,
                  kv_offset=0):
    """(dK, dV) of :func:`flash_attention` (of one block at
    ``kv_offset``, as :func:`flash_bwd_dq`): the kernel on CUDA tensors,
    the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       window, kv_offset)
    return flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                              window=window, kv_offset=int(kv_offset))


class _FlashAttention(torch.autograd.Function):
    """``_flash`` with its custom VJP: the forward saves
    ``(q, k, v, out, lse)``; the backward forms δ = rowsum(dO·O) in fp32
    from the saved output in its own dtype (``_fold_bwd_invariants``),
    then runs the dq and dkv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)  # (B, S, H)
        delta = delta.transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, g, lse, delta, ctx.causal, ctx.window)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None):
    """Flash attention over (B, S, H, D) tensors, differentiable: the
    training path's attention (``horovod_tpu/ops/flash_attention.py::
    flash_attention``).  Softmax statistics in fp32, output in the input
    dtype.

    GQA is native: ``k``/``v`` may carry ``H_kv`` heads with ``H_kv | H``
    (query head ``h`` reads kv head ``h // (H/H_kv)``); their gradients
    come back in their own (B, S, H_kv, D) shape, nothing repeated.
    ``causal=False`` is bidirectional; ``window`` is a sliding window
    (each token attends the last ``window`` positions, itself included;
    symmetric when bidirectional).  Any S works: the kernels mask the
    ragged tail of their tiles."""
    _check_block(q, k, v, window)
    return _FlashAttention.apply(q, k, v, bool(causal), window)
