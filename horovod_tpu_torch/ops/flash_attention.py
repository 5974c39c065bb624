"""Paged flash attention: the serving path's attention kernel.

Port of ``horovod_tpu/ops/flash_attention.py``'s per-row-offset entries
(``flash_chunk_attention`` / ``flash_decode_attention``), which launch
the Pallas ``_fwd_kernel`` with one kv offset per batch row.  Here the
kernel is CUDA C++ for Hopper (``csrc/flash_fwd.cu``, built at first use
by :mod:`._build`); its source note says what bounds it on the card and
what its design does about that.

Beside the kernel, and computing the same function:

* :func:`flash_chunk_attention_reference` — the plain PyTorch version
  (dense fp32 logits, the same global-position mask, a masked softmax
  that returns 0 for fully masked rows).  The CPU path and the tests use
  it; ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`_tile_mask` / :func:`_kb_range` — the mask and the K-block loop
  bounds of the JAX kernel, mirrored exactly (the CUDA kernel applies
  the same two rules to its own tiles).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes
import math

import torch

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


def flash_chunk_attention_reference(q, k, v, q_starts, *, window=None,
                                    kv_start=None):
    """Plain PyTorch version of :func:`flash_chunk_attention`: dense fp32
    logits of q·sm_scale against every gathered key, the ``_tile_mask``
    on global positions, and a masked softmax whose fully masked rows
    come out as 0.  Same arguments and output as the kernel's entry."""
    b, c, h, d = q.shape
    group = _group_of(q, k)
    h_kv, s_k = k.shape[2], k.shape[1]
    offs = _row_offsets(q_starts, kv_start, b, q.device)
    qf = q.float() * (1.0 / (d ** 0.5))
    kf, vf = k.float(), v.float()
    logits = torch.einsum(
        "bchgd,bshd->bhgcs", qf.reshape(b, c, h_kv, group, d), kf,
    ).reshape(b, h, c, s_k)
    q_pos = torch.arange(c, device=q.device)[None, :, None]
    k_pos = torch.arange(s_k, device=q.device)[None, None, :]
    mask = _tile_mask(q_pos, k_pos, True, window, s_k,
                      offs.long()[:, None, None])[:, None]  # (B,1,C,S)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bhgcs,bshd->bchgd", p.reshape(b, h_kv, group, c, s_k), vf,
    ).reshape(b, c, h, d)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))  # (B, H, C, 1)
    out = out / safe_l.permute(0, 2, 1, 3)
    return out.to(q.dtype)


def flash_fwd_cuda(q, k, v, offs, *, window=None, with_lse=False):
    """Launch the CUDA kernel (``csrc/flash_fwd.cu``) on CUDA tensors:
    causal attention on global positions, every gathered key valid.

    q: (B, C, H, D); k, v: (B, S, H_kv, D) with ``H_kv | H``; offs: (B,)
    int32 global K start minus global Q start per row.  bf16 or fp32,
    last dim contiguous and 16-byte aligned rows, D a multiple of 8 up
    to 256.
    Returns o (B, C, H, D) in q's dtype, plus the fp32 log-sum-exp
    (B, H, C) when ``with_lse``.  Raises on anything the kernel does
    not take and on a launch error; ``flash_fwd_cuda.launches`` counts
    successful launches."""
    from . import _build

    b, c, h, d = q.shape
    s_k = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v), ("offs", offs)):
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
    if offs.dtype != torch.int32 or offs.shape != (b,) \
            or not offs.is_contiguous():
        raise ValueError("offs must be a contiguous (B,) int32 tensor")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dim and 16-byte aligned "
                f"rows, got strides {t.stride()}")
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, c), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.library("flash_fwd.cu")
    fn = lib.hvd_flash_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 6 + [L] * 12
                       + [I, ctypes.c_float, I, P])
        fn.restype = I
        lib.hvd_cuda_error_string.argtypes = [I]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 offs.data_ptr(), b, c, h, k.shape[2], s_k, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], 0 if window is None else int(window),
                 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: "
            f"{lib.hvd_cuda_error_string(err).decode()} (code {err})")
    flash_fwd_cuda.launches += 1
    return (o, lse) if with_lse else o


flash_fwd_cuda.launches = 0


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
    b, c, h, d = q.shape
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
