"""ResNet family in PyTorch: channels-last, BatchNorm on the fused kernels.

Port of ``horovod_tpu/models/resnet.py`` (the ResNet-50 of the
reference's synthetic benchmarks).  The same blocks, stems, presets,
names and numerics, so logits, gradients and running statistics match
the flax model on the same weights:

* the input is NHWC, as in JAX; inside, activations are NCHW-logical
  tensors in ``torch.channels_last`` memory, so ``x.permute(0, 2, 3, 1)``
  is the contiguous ``(M, C)`` view that
  :func:`~horovod_tpu_torch.ops.fused_norm.fused_batch_norm_act` takes
  (no copy; the op raises on anything else);
* :class:`Conv` is flax ``nn.Conv`` without bias: an fp32 master kernel,
  stored OIHW (torch's layout; the flax HWIO kernel transposed), cast to
  ``dtype`` in channels-last memory where it is used, and "SAME" padding
  as flax computes it — asymmetric (0, 1) for a 3x3 stride-2 conv on an
  even input, which torch's symmetric ``padding=`` cannot express, so
  that case pads explicitly; the convolutions are cuDNN's (XLA computes
  them outside any Pallas kernel in JAX);
* :class:`BatchNorm` is flax ``nn.BatchNorm(momentum=0.9, epsilon=
  1e-5)``: fp32 ``scale``/``bias`` parameters and fp32 ``mean``/``var``
  buffers.  In training it runs the fused op — ``relu=True`` where the
  norm is followed by the activation, the residual and ``relu=True`` for
  a block's last norm (``act(residual + y)``), ``relu=False`` for
  ``norm_proj`` — and folds the **biased** batch statistics into the
  running ones flax's way, ``ra = 0.9·ra + 0.1·stat`` (not torch's
  ``momentum=0.1`` convention, nor its unbiased variance).  In eval
  (``model.eval()``) it is the plain affine map over the running
  statistics, as flax's is (the JAX op has no eval kernel either).

``bn_group`` is the port's ``bn_axis_name``: a ``torch.distributed``
group (or :data:`WORLD`) over which every BatchNorm shares its batch
statistics (sync BN, through the op's ``process_group`` seam).

``remat=True`` checkpoints every residual block, not the stem, saving
nothing but the block's input (flax's ``nn.remat(block_cls)``), in
training with grad enabled.  The backward recomputes each block's
forward: its norms run the fused kernels again (the stats kernel sums in
a fixed order, so the recomputed statistics have the forward's bits;
under sync BN the statistics all-reduce runs again, in the same order on
every rank, as JAX's remat repeats its ``psum``), but a recomputing
BatchNorm leaves its running statistics alone — the checkpoint's
recompute-only context switches the update off — so they move once a
step, as without remat.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from ..ops.fused_norm import fused_batch_norm_act
from ._remat import recompute_only, remat_call

#: ``bn_group`` / ``process_group`` value naming the default (world)
#: group, resolved when the norm runs (the group need not exist yet when
#: the model is built)
WORLD = "world"

_TRUNC = 0.87962566103423978  # std of a unit normal truncated at ±2


def _trunc_normal(t, std, generator):
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/lax "SAME" padding of one spatial dim: out = ceil(size /
    stride), the total pad split with the extra element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` over NCHW channels-last input.
    ``kernel`` is (O, I, kh, kw) fp32, initialised as flax's
    ``variance_scaling(2.0, "fan_out", "normal")``; ``padding`` is "SAME"
    or ``((top, bottom), (left, right))``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding="SAME", *,
                 dtype: torch.dtype, device, generator):
        super().__init__()
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype
        self.kernel = nn.Parameter(torch.empty(
            (features, in_features, *kernel_size), dtype=torch.float32,
            device=device))
        fan_out = features * kernel_size[0] * kernel_size[1]
        with torch.no_grad():
            _trunc_normal(self.kernel, math.sqrt(2.0 / fan_out) / _TRUNC,
                          generator)

    def pads(self, h: int, w: int):
        kh, kw = self.kernel.shape[2:]
        if self.padding == "SAME":
            return (_same_pads(h, kh, self.strides[0]),
                    _same_pads(w, kw, self.strides[1]))
        return self.padding

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        (t, b), (l, r) = self.pads(h, w)
        kh, kw = self.kernel.shape[2:]
        return ((h + t + b - kh) // self.strides[0] + 1,
                (w + l + r - kw) // self.strides[1] + 1)

    def forward(self, x):
        (t, b), (l, r) = self.pads(x.shape[2], x.shape[3])
        w = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        if t == b and l == r:
            return F.conv2d(x, w, stride=self.strides, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.strides)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW channels-last
    activation, with the block's residual add and ReLU folded in
    (``forward(x, residual=None, relu=False)``); see the module note."""

    def __init__(self, features: int, *, scale_init: float = 1.0,
                 momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, process_group=None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.process_group = process_group
        self.scale = nn.Parameter(torch.full((features,), float(scale_init),
                                             dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.zeros((features,), dtype=torch.float32,
                                             device=dev))
        self.register_buffer("mean", torch.zeros(
            (features,), dtype=torch.float32, device=dev))
        self.register_buffer("var", torch.ones(
            (features,), dtype=torch.float32, device=dev))
        #: set while a remat backward recomputes this norm's block: the
        #: running statistics already moved in the forward
        self.recomputing = False

    def group(self):
        """The process group the statistics are shared over, or None."""
        if self.process_group == WORLD:
            return dist.group.WORLD
        return self.process_group

    def forward(self, x, residual=None, relu: bool = False):
        if self.training:
            y, mean, var = fused_batch_norm_act(
                x.permute(0, 2, 3, 1), self.scale, self.bias,
                None if residual is None else residual.permute(0, 2, 3, 1),
                eps=self.eps, relu=relu, process_group=self.group())
            if self.recomputing:
                return y.permute(0, 3, 1, 2)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1 - m)
                self.var.mul_(m).add_(var, alpha=1 - m)
            return y.permute(0, 3, 1, 2)
        # flax's _normalize over the running statistics, then the block's
        # residual add and activation in the activation dtype
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        y = (x - self.mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)
        y = y.to(self.dtype)
        if residual is not None:
            y = residual + y
        return F.relu(y) if relu else y


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) lecun-normal, ``bias``
    zeros, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype = torch.float32, device, generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (in_features, features), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros((features,), dtype=torch.float32,
                                             device=device))
        with torch.no_grad():
            _trunc_normal(self.kernel, 1.0 / math.sqrt(in_features) / _TRUNC,
                          generator)

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut."""

    expansion = 4

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int], *, conv, norm):
        super().__init__()
        out = features * self.expansion
        self.Conv_0 = conv(in_features, features, (1, 1))
        self.BatchNorm_0 = norm(features)
        self.Conv_1 = conv(features, features, (3, 3), strides)
        self.BatchNorm_1 = norm(features)
        self.Conv_2 = conv(features, out, (1, 1))
        self.BatchNorm_2 = norm(out, scale_init=0.0)
        if in_features != out or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, out, (1, 1), strides)
            self.norm_proj = norm(out)

    def norm_sites(self):
        """``(conv, norm, relu, residual?)`` in the order they run."""
        sites = [(self.Conv_0, self.BatchNorm_0, True, False),
                 (self.Conv_1, self.BatchNorm_1, True, False)]
        if hasattr(self, "conv_proj"):
            sites.append((self.conv_proj, self.norm_proj, False, False))
        return sites + [(self.Conv_2, self.BatchNorm_2, True, True)]

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.BatchNorm_1(self.Conv_1(y), relu=True)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return self.BatchNorm_2(self.Conv_2(y), residual=residual, relu=True)


class ResNetBlock(nn.Module):
    """Basic 3x3 -> 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int], *, conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_features, features, (3, 3), strides)
        self.BatchNorm_0 = norm(features)
        self.Conv_1 = conv(features, features, (3, 3))
        self.BatchNorm_1 = norm(features, scale_init=0.0)
        if in_features != features or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, features, (1, 1), strides)
            self.norm_proj = norm(features)

    def norm_sites(self):
        sites = [(self.Conv_0, self.BatchNorm_0, True, False)]
        if hasattr(self, "conv_proj"):
            sites.append((self.conv_proj, self.norm_proj, False, False))
        return sites + [(self.Conv_1, self.BatchNorm_1, True, True)]

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return self.BatchNorm_1(self.Conv_1(y), residual=residual, relu=True)


@contextlib.contextmanager
def _recomputing(block: nn.Module):
    """Mark ``block``'s norms as recomputing for the duration."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def space_to_depth(x):
    """(N, H, W, C) -> (N, H/2, W/2, 4C): the MLPerf stem's 2x2
    space-to-depth, channel order (row parity, column parity, C) as in
    ``space_to_depth_stem``."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H and W, got {h}x{w}")
    xs = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(n, h // 2, w // 2, 4 * c)


class ResNet(nn.Module):
    """``horovod_tpu.models.resnet.ResNet``: input (N, H, W, 3) images,
    output fp32 logits.  ``stem``: "conv" (classic 7x7/s2) or
    "space_to_depth" (the same linear map as a 4x4/s1 conv over the 2x2
    space-to-depth input).  Weights are made on ``device`` from
    ``generator`` (which must live there; default: seed 0)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, bn_group=None,
                 stem: str = "conv", remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(dev).manual_seed(0)
        self.dtype, self.stem, self.remat = dtype, stem, remat
        conv = functools.partial(Conv, dtype=dtype, device=dev, generator=gen)
        norm = functools.partial(BatchNorm, dtype=dtype, device=dev,
                                 process_group=bn_group)
        if stem == "space_to_depth":
            self.conv_init = conv(4 * 3, num_filters, (4, 4),
                                  padding=((2, 1), (2, 1)))
        else:
            self.conv_init = conv(3, num_filters, (7, 7), (2, 2),
                                  padding=((3, 3), (3, 3)))
        self.bn_init = norm(num_filters)
        self.block_names: List[str] = []
        features = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                width = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(features, width, strides,
                                                conv=conv, norm=norm))
                self.block_names.append(name)
                features = width * block_cls.expansion
        self.head = Dense(features, num_classes, device=dev, generator=gen)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
        x = self.bn_init(self.conv_init(x), relu=True)
        x = F.max_pool2d(x, 3, 2, 1)  # flax max_pool pads with -inf too
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if remat:
                x = remat_call(block, "full", x, context_fn=recompute_only(
                    functools.partial(_recomputing, block)))
            else:
                x = block(x)
        # jnp.mean of a bf16 activation sums in fp32 and rounds the mean
        x = (x.sum(dim=(2, 3), dtype=torch.float32)
             / (x.shape[2] * x.shape[3])).to(self.dtype)
        return self.head(x.float())

    def bn_sites(self, batch: int, height: int, width: int
                 ) -> List[Tuple[int, int, bool, bool]]:
        """``(M, C, relu, residual)`` of every BatchNorm the training
        forward runs on a (batch, height, width, C) input, in order:
        the shapes the fused kernels see."""
        h, w = height, width
        if self.stem == "space_to_depth":
            h, w = h // 2, w // 2
        h, w = self.conv_init.out_size(h, w)
        sites = [(batch * h * w, self.bn_init.scale.numel(), True, False)]
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # the 3x3/s2 max pool
        for name in self.block_names:
            block = getattr(self, name)
            block_h, block_w = h, w
            for conv, bn, relu, res in block.norm_sites():
                if conv is getattr(block, "conv_proj", None):
                    ch, cw = conv.out_size(block_h, block_w)
                else:
                    ch, cw = conv.out_size(h, w)
                    h, w = ch, cw
                sites.append((batch * ch * cw, bn.scale.numel(), relu, res))
        return sites


ResNet18 = functools.partial(
    ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = functools.partial(
    ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
ResNet152 = functools.partial(
    ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock)
# Tiny variant for CPU tests.
ResNetTiny = functools.partial(
    ResNet, stage_sizes=[1, 1], block_cls=ResNetBlock, num_filters=8,
    num_classes=10)


def running_stats(model: nn.Module) -> List[torch.Tensor]:
    """Every :class:`BatchNorm`'s running ``mean`` and ``var`` buffers,
    in module order (what the data-parallel step averages)."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.mean, m.var)]
