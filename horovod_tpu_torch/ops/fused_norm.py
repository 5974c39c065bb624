"""Fused training-mode BatchNorm(+residual)+ReLU: the ResNet's norm sites.

Port of ``horovod_tpu/ops/fused_norm.py``.  Its four Pallas kernels
become CUDA C++ for Hopper in ``csrc/fused_norm.cu`` (built at first use
by :mod:`._build`); the source's note says what bounds them on the card
and what the design does about it:

* :func:`bn_stats_cuda` — ``_stats_kernel``: per-channel Σx, Σx² in fp32
  (then mean, var, rstd, scale, shift per channel);
* :func:`bn_apply_cuda` — ``_apply_kernel``: ``y = x·scale + shift``
  [+ residual] [ReLU];
* :func:`bn_bwd_reduce_cuda` — ``_bwd_reduce_kernel``: Σdy′, Σdy′·x̂ with
  ``dy′ = dy·[y > 0]``;
* :func:`bn_dx_cuda` — ``_dx_kernel``: ``dx = γ·rstd·(dy′ − Σdy′/M −
  x̂·Σdy′x̂/M)`` and ``dres = dy′``.

Beside each kernel, the plain PyTorch version of the same function
(:func:`bn_stats_reference`, :func:`bn_apply_reference`,
:func:`bn_bwd_reduce_reference`, :func:`bn_dx_reference`), op for op as
the JAX package's ``_reference`` and the reference branch of
``_fused_bwd``.  Means are sums divided by the row count, as ``jnp.mean``
computes them.  The CPU path and the tests use the plain versions;
``chip_smoke.py`` holds each kernel against its plain version on the
card.

Dispatch is by the tensors' device: CPU tensors take the plain versions,
CUDA tensors launch the kernels or raise (a dtype, layout or device the
kernels do not take raises; nothing falls back).  ``impl="reference"``
asks for the plain versions on any device.  Each kernel wrapper counts
its launches in ``<wrapper>.launches``.

The layout is the JAX one at the boundary: ``x`` is channels-last
``(..., C)``, viewed as ``(M, C)`` with ``M = N·H·W``.  The TPU path's
lane folding (C < 128) is not carried over: the kernels take any M and
C.  ``process_group`` is the sync-BN seam: the per-channel sums of the
stats kernel, and those of the backward-reduce kernel, are all-reduced
(Sum) over the group between the two kernels of each pair, and M is the
global row count — flax's ``axis_name`` pmean of E[x] and E[x²] for
equal per-rank batches, and its transpose in the backward.  The
gradients of γ and β stay local (each rank's own rows), as JAX's are
before its step averages them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import _build

#: threads of one kernel block; the blocks the streaming kernels aim for
#: (about two waves of 8 resident blocks on each of 132 SMs), and the
#: blocks the reduction kernels aim for (one wave of 4 on each SM, their
#: register budget), whose partials the finishing kernel then sums
_THREADS = 256
_TARGET_BLOCKS = 2048
_REDUCE_BLOCKS = 528
#: the backward reduction keeps its (blocks, 2, C) fp32 partials at most
#: 1/16 of a bf16 input's bytes: one block per 64 rows at most
_ROWS_PER_PARTIAL = 64
#: the stats kernel (``csrc/fused_norm.cu`` bn_stats): the blocks an SM
#: its plan launches (one wave; at most the kernel's
#: ``kStatsBlocksPerSM``; one a SM measured faster than two over a
#: ResNet-50 step, ``tools/bn_stats_ab.py``), the loads of x a thread
#: keeps in flight and the accumulator pairs it sums them into
#: (``kLoads``, ``kAcc`` there); the 16-byte vectors of a column tile's
#: row on the vector path (8: 128 bytes); the most partial bytes the
#: finishing block of a column tile reads; the longest sequential chain
#: of fp32 additions in a sum (the chip check's tolerance rests on it)
_STATS_BLOCKS_PER_SM = 1
_STATS_LOADS = 8
_STATS_ACC = 1
_STATS_TILE_VECS = 8
_STATS_FINISH_BYTES = 150 * 1024
_STATS_CHAIN = 500


# -- plain versions -----------------------------------------------------------


def _global_count(m: int, process_group) -> int:
    """The global row count: ``m`` times the group's size (equal
    per-rank batches, as flax's pmean assumes)."""
    if process_group is None:
        return m
    return m * dist.get_world_size(process_group)


def bn_stats_reference(x2d, eps, process_group=None):
    """Plain version of the stats kernel and its finish: ``(mean, var,
    rstd)`` of the (M, C) view in fp32, ``var = max(E[x²] − mean², 0)``;
    with a group, the two sums are all-reduced first."""
    xf = x2d.float()
    sums = torch.stack([xf.sum(dim=0), (xf * xf).sum(dim=0)])
    if process_group is not None:
        dist.all_reduce(sums, group=process_group)
    count = _global_count(x2d.shape[0], process_group)
    mean = sums[0] / count
    var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def bn_apply_reference(x2d, gamma, beta, mean, rstd, res2d=None,
                       relu=True):
    """Plain version of the apply kernel: ``(x − mean)·rstd·γ + β``
    [+ residual] [ReLU] in fp32, in x's dtype."""
    y = (x2d.float() - mean) * rstd * gamma + beta
    if res2d is not None:
        y = y + res2d.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2d.dtype)


def _masked_dy(dy2d, y2d, relu):
    dyf = dy2d.float()
    if relu:
        dyf = torch.where(y2d > 0, dyf, torch.zeros_like(dyf))
    return dyf


def bn_bwd_reduce_reference(x2d, dy2d, y2d, mean, rstd, relu=True):
    """Plain version of the backward-reduce kernel: ``(Σdy′, Σdy′·x̂)``
    per channel in fp32."""
    dyf = _masked_dy(dy2d, y2d, relu)
    xhat = (x2d.float() - mean) * rstd
    return dyf.sum(dim=0), (dyf * xhat).sum(dim=0)


def bn_dx_reference(x2d, dy2d, y2d, gamma, mean, rstd, dbeta, dgamma_hat,
                    count, relu=True, has_residual=False):
    """Plain version of the dx kernel: ``(dx, dres)`` in x's dtype, dres
    None without a residual."""
    dyf = _masked_dy(dy2d, y2d, relu)
    xhat = (x2d.float() - mean) * rstd
    dx = (gamma * rstd * (dyf - dbeta / count - xhat * dgamma_hat / count)
          ).to(x2d.dtype)
    return dx, (dyf.to(x2d.dtype) if has_residual else None)


# -- the kernels --------------------------------------------------------------


def _layout(m: int, c: int, vec: int) -> Tuple[int, int, int, int]:
    """``(TX, gx, gy_stream, gy_reduce)`` for an (m, c) launch with
    ``vec`` elements a thread-column: TX threads across the C/vec
    channel vectors (a power of two up to 32), 256/TX down the rows; the
    streaming kernels (apply, dx) take ``gy_stream`` row blocks, the
    backward reduction ``gy_reduce``, fewer where M is small, so its
    partials stay small (the stats kernel's plan is
    :func:`_stats_plan`)."""
    cv = c // vec
    tx = min(32, 1 << max(0, cv - 1).bit_length())
    ty = _THREADS // tx
    gx = -(-cv // tx)
    rows = -(-m // ty)
    gy_stream = max(1, min(rows, -(-_TARGET_BLOCKS // gx), 65535))
    gy_reduce = max(1, min(rows, -(-_REDUCE_BLOCKS // gx),
                           m // _ROWS_PER_PARTIAL))
    return tx, gx, gy_stream, gy_reduce


class _StatsPlan(NamedTuple):
    """The stats kernel's launch: ``tx`` threads across the channel
    vectors of a column tile (``ty = 256 / tx`` down the rows), ``gx``
    column tiles of ``tx·vec`` channels, ``gy`` row blocks a tile, block
    ``y`` taking rows ``[y·rows, min(m, (y + 1)·rows))`` (``rows`` a
    multiple of ``ty``; no block is empty); its scratch: ``partials``
    fp32 elements (``(gy, 2, c)``) and ``counters`` int32 (one a tile)."""
    tx: int
    ty: int
    gx: int
    gy: int
    rows: int
    partials: int
    counters: int


def _stats_plan(m: int, c: int, vec: int, sms: int) -> _StatsPlan:
    """The stats kernel's plan for an (m, c) site with ``vec`` elements
    a thread-column on a card of ``sms`` SMs.  A column tile is
    ``_STATS_TILE_VECS`` vectors of a row on the vector path (128 bytes)
    and up to 32 channels on the scalar path.  The row blocks fill one wave of
    ``_STATS_BLOCKS_PER_SM`` blocks on every SM, but no fewer than
    ``_STATS_LOADS`` rows a thread (a small site then takes fewer, fuller
    blocks) and no more partials a tile than ``_STATS_FINISH_BYTES``; a
    tall site takes more blocks where a thread's rows would exceed
    ``_STATS_CHAIN`` a pair."""
    cv = c // vec
    tx = min(_STATS_TILE_VECS if vec > 1 else 32,
             1 << max(0, cv - 1).bit_length())
    ty = _THREADS // tx
    gx = -(-cv // tx)
    gy = min(max(1, sms * _STATS_BLOCKS_PER_SM // gx),
             -(-m // (ty * _STATS_LOADS)),
             max(1, _STATS_FINISH_BYTES // (8 * tx * vec)))
    gy = min(max(gy, -(-m // (ty * _STATS_ACC * _STATS_CHAIN))), 65535)
    rows = -(-(-(-m // gy)) // ty) * ty
    gy = -(-m // rows)
    return _StatsPlan(tx, ty, gx, gy, rows, gy * 2 * c, gx)


_SMS = {}


def _sm_count(dev) -> int:
    """The card's SM count, read once a device."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


_COUNTERS = {}


def _stats_counters(dev, stream: int, n: int):
    """The stats kernel's column-tile counters on ``stream``: one int32
    buffer per (device, stream), zero when made, left zero by every
    launch (its last block of each tile resets its counter), so no call
    clears it; grown (made anew, zero) when a launch needs more tiles."""
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _vec_of(c: int, *tensors) -> int:
    """Elements a thread moves as one 16-byte vector, or 1 (the scalar
    path) where C is not a multiple of it or a row is not 16-byte
    aligned."""
    vec = 16 // tensors[0].element_size()
    if c % vec or any(t.data_ptr() % 16 for t in tensors if t is not None):
        return 1
    return vec


def _check_rows(name, t, like):
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match "
                         f"x {tuple(like.shape)} {like.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (M, C) view (the "
                         f"channels-last activation), got strides "
                         f"{t.stride()}")


def _check_cuda(x2d, *rows, **channels):
    """Raise unless x2d is a contiguous (M, C) bf16/fp32 CUDA tensor,
    ``rows`` (name, tensor) pairs match it, and ``channels`` are
    contiguous (C,) / (k, C) fp32 tensors on its device."""
    if x2d.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x2d.device}")
    if x2d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dtype {x2d.dtype} not supported (bf16 or fp32)")
    if x2d.dim() != 2 or x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (M, C) view, got "
                         f"{tuple(x2d.shape)}")
    _check_rows("x", x2d, x2d)
    for name, t in rows:
        if t is not None:
            _check_rows(name, t, x2d)
    c = x2d.shape[1]
    for name, t in channels.items():
        if t.dtype != torch.float32 or t.shape[-1] != c \
                or not t.is_contiguous() or t.device != x2d.device:
            raise ValueError(f"{name} must be a contiguous fp32 tensor of "
                             f"{c} channels on {x2d.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGS = {
    "hvd_bn_stats": [_P, _L, _I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _F,
                     _F, _P, _P],
    "hvd_bn_finalize": [_P, _I, _P, _P, _F, _F, _P, _P],
    "hvd_bn_apply": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P],
    "hvd_bn_bwd_reduce": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P,
                          _P, _P],
    "hvd_bn_dx": [_P, _P, _P, _P, _P, _P, _P, _F, _L, _I, _I, _I, _I, _I, _I,
                  _P, _P, _P],
}


def _lib():
    return _build.bound("fused_norm.cu", _ARGS)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def bn_stats_cuda(x2d, gamma, beta, eps, process_group=None):
    """Launch the stats kernel (``csrc/fused_norm.cu``: one launch, its
    last blocks finish) on a contiguous (M, C) bf16/fp32 CUDA tensor.
    Returns the (5, C) fp32 stats: mean, var, rstd, scale = γ·rstd,
    shift = β − mean·scale.  With ``process_group`` the kernel writes the
    sums only, which are all-reduced (Sum) before the finalize, over
    ``M·world`` rows.  ``bn_stats_cuda.launches`` counts successful
    launches."""
    _check_cuda(x2d, gamma=gamma, beta=beta)
    m, c = x2d.shape
    vec = _vec_of(c, x2d)
    dev = x2d.device
    plan = _stats_plan(m, c, vec, _sm_count(dev))
    stream = _stream(x2d)
    counters = _stats_counters(dev, stream, plan.counters)
    partials = torch.empty(plan.partials, dtype=torch.float32, device=dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    stats = torch.empty((5, c), dtype=torch.float32, device=dev)
    count = float(_global_count(m, process_group))
    lib = _lib()
    bf16 = int(x2d.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        _build.launch(lib, "hvd_bn_stats", (
            x2d.data_ptr(), m, c, bf16, int(vec > 1), plan.tx, plan.gy,
            plan.rows, partials.data_ptr(), counters.data_ptr(),
            sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(), count,
            float(eps),
            None if process_group is not None else stats.data_ptr(),
            stream))
        if process_group is not None:
            dist.all_reduce(sums, group=process_group)
            _build.launch(lib, "hvd_bn_finalize", (
                sums.data_ptr(), c, gamma.data_ptr(), beta.data_ptr(), count,
                float(eps), stats.data_ptr(), stream))
    bn_stats_cuda.launches += 1
    return stats


bn_stats_cuda.launches = 0


def bn_apply_cuda(x2d, stats, res2d=None, relu=True):
    """Launch the apply kernel: ``y = x·stats[3] + stats[4]`` [+ res2d]
    [ReLU], in x's dtype.  ``bn_apply_cuda.launches`` counts successful
    launches."""
    _check_cuda(x2d, ("residual", res2d), stats=stats)
    m, c = x2d.shape
    y = torch.empty_like(x2d)
    vec = _vec_of(c, x2d, res2d, y)
    tx, _, gy, _ = _layout(m, c, vec)
    with torch.cuda.device(x2d.device):
        _build.launch(_lib(), "hvd_bn_apply", (
            x2d.data_ptr(), _ptr(res2d), stats.data_ptr(), m, c,
            int(x2d.dtype == torch.bfloat16), int(vec > 1), tx, gy,
            int(bool(relu)), y.data_ptr(), _stream(x2d)))
    bn_apply_cuda.launches += 1
    return y


bn_apply_cuda.launches = 0


def bn_bwd_reduce_cuda(x2d, dy2d, y2d, mean, rstd, relu=True):
    """Launch the backward-reduce kernel (then its finishing kernel):
    ``(2, C)`` fp32 ``(Σdy′, Σdy′·x̂)`` given the per-channel mean and
    rstd.  ``bn_bwd_reduce_cuda.launches`` counts successful launches."""
    _check_cuda(x2d, ("dy", dy2d), ("y", y2d), mean=mean, rstd=rstd)
    m, c = x2d.shape
    vec = _vec_of(c, x2d, dy2d, y2d)
    tx, _, _, gy = _layout(m, c, vec)
    partials = torch.empty((gy, 2, c), dtype=torch.float32,
                           device=x2d.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        _build.launch(_lib(), "hvd_bn_bwd_reduce", (
            x2d.data_ptr(), dy2d.data_ptr(), y2d.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), m, c, int(x2d.dtype == torch.bfloat16),
            int(vec > 1), tx, gy,
            int(bool(relu)), partials.data_ptr(), sums.data_ptr(),
            _stream(x2d)))
    bn_bwd_reduce_cuda.launches += 1
    return sums


bn_bwd_reduce_cuda.launches = 0


def bn_dx_cuda(x2d, dy2d, y2d, gamma, mean, rstd, sums, count, relu=True,
               has_residual=False):
    """Launch the dx kernel: ``(dx, dres)`` in x's dtype (dres None
    without a residual) from the backward sums over ``count`` rows.
    ``bn_dx_cuda.launches`` counts successful launches."""
    _check_cuda(x2d, ("dy", dy2d), ("y", y2d), gamma=gamma, mean=mean,
                rstd=rstd, sums=sums)
    m, c = x2d.shape
    dx = torch.empty_like(x2d)
    dres = torch.empty_like(x2d) if has_residual else None
    vec = _vec_of(c, x2d, dy2d, y2d, dx, dres)
    tx, _, gy, _ = _layout(m, c, vec)
    with torch.cuda.device(x2d.device):
        _build.launch(_lib(), "hvd_bn_dx", (
            x2d.data_ptr(), dy2d.data_ptr(), y2d.data_ptr(), gamma.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), sums.data_ptr(), float(count),
            m, c,
            int(x2d.dtype == torch.bfloat16), int(vec > 1), tx, gy,
            int(bool(relu)), dx.data_ptr(), _ptr(dres), _stream(x2d)))
    bn_dx_cuda.launches += 1
    return dx, dres


bn_dx_cuda.launches = 0


# -- the op -------------------------------------------------------------------


def _forward(x2d, gamma, beta, res2d, eps, relu, plain, group):
    """``(y, mean, var, rstd)`` of the (M, C) view."""
    if plain:
        mean, var, rstd = bn_stats_reference(x2d, eps, group)
        y = bn_apply_reference(x2d, gamma, beta, mean, rstd, res2d, relu)
        return y, mean, var, rstd
    stats = bn_stats_cuda(x2d, gamma, beta, eps, group)
    y = bn_apply_cuda(x2d, stats, res2d, relu)
    return y, stats[0], stats[1], stats[2]


class _FusedBatchNormAct(torch.autograd.Function):
    """``_fused`` with its custom VJP.  The forward saves what JAX's
    ``_fused_vjp_fwd`` saves — x, y, γ, mean, rstd, and whether there is
    a residual; the backward returns dx, dγ, dβ and dres and ignores the
    cotangents of mean and var (the running-stats outputs; dx already
    carries the whole dependence through the batch statistics)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps, relu, plain, group):
        c = x.shape[-1]
        if residual is not None and residual.shape != x.shape:
            raise ValueError(f"residual {tuple(residual.shape)} does not "
                             f"match x {tuple(x.shape)}")
        if not plain:
            for name, t in (("x", x), ("residual", residual)):
                if t is not None and not t.is_contiguous():
                    raise ValueError(
                        f"{name} must be contiguous (the channels-last "
                        f"activation's (..., C) view), got strides "
                        f"{t.stride()}")
        x2d = x.reshape(-1, c)
        res2d = None if residual is None else residual.reshape(-1, c)
        y, mean, var, rstd = _forward(x2d, gamma, beta, res2d, eps, relu,
                                      plain, group)
        ctx.save_for_backward(x2d, y, gamma, mean, rstd)
        ctx.has_residual = residual is not None
        ctx.relu, ctx.plain, ctx.group = relu, plain, group
        ctx.shape = x.shape
        ctx.mark_non_differentiable(mean, var)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, y2d, gamma, mean, rstd = ctx.saved_tensors
        relu, group = ctx.relu, ctx.group
        # the incoming gradient's layout is autograd's choice (a
        # broadcast from the mean-pool, a permuted conv gradient): the
        # kernels read the contiguous (M, C) rows
        dy2d = dy.contiguous().view(x2d.shape)
        count = _global_count(x2d.shape[0], group)
        if ctx.plain:
            dbeta, dgamma_hat = bn_bwd_reduce_reference(x2d, dy2d, y2d, mean,
                                                        rstd, relu)
            sums = torch.stack([dbeta, dgamma_hat])
        else:
            sums = bn_bwd_reduce_cuda(x2d, dy2d, y2d, mean, rstd, relu)
        local = sums
        if group is not None:
            local = sums.clone()
            dist.all_reduce(sums, group=group)
        if ctx.plain:
            dx, dres = bn_dx_reference(x2d, dy2d, y2d, gamma, mean, rstd,
                                       sums[0], sums[1], count, relu,
                                       ctx.has_residual)
        else:
            dx, dres = bn_dx_cuda(x2d, dy2d, y2d, gamma, mean, rstd, sums,
                                  count, relu, ctx.has_residual)
        shape = ctx.shape
        return (dx.view(shape), local[1], local[0],
                None if dres is None else dres.view(shape),
                None, None, None, None)


def fused_batch_norm_act(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    relu: bool = True,
    impl: Optional[str] = None,
    process_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN (+ optional residual add) (+ optional ReLU) over
    the channels-last ``x`` ``(..., C)``: ``(y, batch_mean, batch_var)``
    with y in x's dtype and the biased batch statistics in fp32 (the
    caller owns the running-stats update).  Differentiable in x, γ, β
    and the residual.

    ``impl``: None (the kernels for CUDA tensors, the plain versions for
    CPU ones) or "reference" (the plain versions on any device).  On a
    CUDA tensor the kernels need ``x`` (and the residual) contiguous:
    the ``(M, C)`` view of a channels-last activation.
    ``process_group``: a ``torch.distributed`` group whose ranks share
    the batch statistics (sync BN), or None."""
    if impl not in (None, "reference"):
        raise ValueError(f"impl must be None or 'reference', got {impl!r}")
    plain = impl == "reference" or x.device.type == "cpu"
    return _FusedBatchNormAct.apply(x, gamma.float(), beta.float(), residual,
                                    float(eps), bool(relu), plain,
                                    process_group)
