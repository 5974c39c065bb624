"""Gradient compression: a 16-bit wire format around the allreduce.

Port of ``horovod_tpu/compression.py`` (``Compressor``,
``NoneCompressor``, ``FP16Compressor``, ``BF16Compressor``,
``Compression``) in the shape of the reference's torch flavour
(``horovod_tpu/torch/compression.py``): ``compress(tensor) -> (tensor,
ctx)`` and ``decompress(tensor, ctx) -> tensor`` on one tensor, which
``DistributedOptimizer`` applies to each gradient before its bucket is
fused and undoes after the reduction.

Floating tensors wider than the wire type are cast to it, clamped to
its finite range first: fp16's largest value is 65504, and a gradient
past it would otherwise become inf and poison the whole sum.  bf16 keeps
fp32's exponent range, so its clamp never bites.  Narrower tensors and
integers pass through.  ``DcnCompression`` (the wire format of the
two-level collectives' slow hop) waits for those collectives (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _to_wire(tensor: torch.Tensor, dtype: torch.dtype
             ) -> Tuple[torch.Tensor, Optional[torch.dtype]]:
    if not tensor.dtype.is_floating_point or \
            tensor.dtype.itemsize <= dtype.itemsize:
        return tensor, None
    lim = torch.finfo(dtype).max
    return tensor.clamp(-lim, lim).to(dtype), tensor.dtype


class Compressor:
    """The reference's compressor contract."""

    @staticmethod
    def compress(tensor: torch.Tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity (reference: NoneCompressor)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """fp32 / fp64 travel as fp16 (reference: FP16Compressor)."""

    @staticmethod
    def compress(tensor):
        return _to_wire(tensor, torch.float16)

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BF16Compressor(Compressor):
    """fp32 / fp64 travel as bf16, which needs no loss scale."""

    @staticmethod
    def compress(tensor):
        return _to_wire(tensor, torch.bfloat16)

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class Compression:
    """The reference's ``hvd.Compression`` namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
