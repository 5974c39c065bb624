"""Small models: MLP and LeNet.

Port of ``horovod_tpu/models/simple.py`` (the reference's MNIST
examples' nets).  Flax infers each layer's input width at init; these
take it up front (``in_features`` / ``in_shape``).  Parameter names and
layouts follow flax (``Dense_i.kernel`` (in, out), ``Conv_i.kernel``
stored OIHW as :class:`~.resnet.Conv` stores it), so
:func:`~.convert.resnet_params_from_flax` carries flax weights over.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from .resnet import Dense, _TRUNC, _trunc_normal


class _BiasConv(nn.Module):
    """flax ``nn.Conv`` with its defaults: "SAME" padding, a bias,
    lecun-normal kernel (stored OIHW)."""

    def __init__(self, in_features, features, kernel_size, *, dtype, device,
                 generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (features, in_features, *kernel_size), dtype=torch.float32,
            device=device))
        self.bias = nn.Parameter(torch.zeros((features,), dtype=torch.float32,
                                             device=device))
        fan_in = in_features * kernel_size[0] * kernel_size[1]
        with torch.no_grad():
            _trunc_normal(self.kernel, 1.0 / math.sqrt(fan_in) / _TRUNC,
                          generator)

    def forward(self, x):
        kh, kw = self.kernel.shape[2:]
        # odd kernels at stride 1: "SAME" is symmetric
        return F.conv2d(x, self.kernel.to(self.dtype),
                        self.bias.to(self.dtype), padding=(kh // 2, kw // 2))


class MLP(nn.Module):
    """Dense+ReLU layers of ``features`` widths, then an fp32 head of
    ``num_classes`` (``Dense_0`` .. ``Dense_n``)."""

    def __init__(self, in_features: int, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(dev).manual_seed(0)
        widths = [in_features, *features]
        self.hidden = len(features)
        for i in range(self.hidden):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                              dtype=dtype, device=dev,
                                              generator=gen))
        setattr(self, f"Dense_{self.hidden}", Dense(
            widths[-1], num_classes, device=dev, generator=gen))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.hidden}")(x.float())


class LeNet(nn.Module):
    """LeNet-5-style conv net (two conv+pool stages, two dense layers)
    over NHWC input of ``in_shape`` (H, W, C), e.g. (28, 28, 1)."""

    def __init__(self, in_shape: Tuple[int, int, int] = (28, 28, 1),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(dev).manual_seed(0)
        self.dtype = dtype
        h, w, c = in_shape
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.Conv_0 = _BiasConv(c, 10, (5, 5), **kw)
        self.Conv_1 = _BiasConv(10, 20, (5, 5), **kw)
        flat = (h // 4) * (w // 4) * 20
        self.Dense_0 = Dense(flat, 50, **kw)
        self.Dense_1 = Dense(50, num_classes, device=dev, generator=gen)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x.float())
