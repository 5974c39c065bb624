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
integers pass through.

:class:`DcnCompression` is the wire format of the two-level
collectives' cross hop (:mod:`.ops.hierarchical`): only the 1/n_ici
shard that crosses the slow tier is cast, and it is summed back in the
accumulation dtype.  :func:`dcn_compression_from_name` resolves the
``HVD_TPU_DCN_WIRE_DTYPE`` spelling.  The cast is plain PyTorch, as the
JAX package computes it outside any kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .utils.logging import get_logger


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


def _dtype(spec) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"bfloat16"``)."""
    if isinstance(spec, torch.dtype):
        return spec
    dt = getattr(torch, str(spec), None) if isinstance(spec, str) else None
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"not a dtype: {spec!r}")
    return dt


class DcnCompression:
    """Wire format of the cross hop of the two-level collectives (port of
    ``horovod_tpu/compression.py::DcnCompression``).

    Unlike :class:`Compressor`, which casts the whole tensor around the
    whole collective, this casts only the 1/n_ici shard that crosses the
    slow tier: the local reduce-scatter runs at full precision, the
    shard travels in ``wire_dtype``, and every rank sums the gathered
    wire shards in the accumulation dtype, so the accumulation never
    leaves full precision.

    ``error_feedback=True`` adds the error-feedback residual (Seide et
    al., 1-bit SGD; Karimireddy et al., 2019): this step's quantization
    error is carried by the caller and added back before the next
    step's cast, so repeated steps accumulate no bias.  The residual is
    shard-shaped state; the stateless routed collectives run without it
    and ``ZeroDistributedOptimizer`` keeps it in its optimizer state."""

    def __init__(self, wire_dtype="bfloat16", error_feedback: bool = False):
        self.wire_dtype = _dtype(wire_dtype)
        if not self.wire_dtype.is_floating_point:
            raise ValueError(
                f"DCN wire dtype must be floating, got {wire_dtype!r}")
        self.error_feedback = bool(error_feedback)

    def __repr__(self) -> str:
        return (f"DcnCompression(wire_dtype={str(self.wire_dtype)[6:]}, "
                f"error_feedback={self.error_feedback})")

    def compress_shard(self, shard: torch.Tensor,
                       residual: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(wire shard, new residual)``.  ``residual`` is the previous
        step's quantization error (None on the first step or without
        error feedback); the new residual is None unless
        ``error_feedback`` is set.  Integer and already narrow shards
        pass through with their residual."""
        if not shard.dtype.is_floating_point or \
                shard.dtype.itemsize <= self.wire_dtype.itemsize:
            return shard, residual
        if self.error_feedback and residual is not None:
            shard = shard + residual.to(shard.dtype)
        wire, _ = _to_wire(shard, self.wire_dtype)
        new_residual = (shard - wire.to(shard.dtype)
                        if self.error_feedback else None)
        return wire, new_residual

    @staticmethod
    def decompress_shard(wire: torch.Tensor, dtype) -> torch.Tensor:
        """Back to the accumulation dtype."""
        dtype = _dtype(dtype)
        return wire if wire.dtype == dtype else wire.to(dtype)


#: the spellings already warned about (once each, not per collective)
_warned_wire_dtypes: set = set()


def dcn_compression_from_name(name: Optional[str]
                              ) -> Optional[DcnCompression]:
    """Resolve the ``HVD_TPU_DCN_WIRE_DTYPE`` spelling (none / bf16 /
    fp16 or a full dtype name) into a :class:`DcnCompression`, or None
    for off.  A spelling that is not a 16-bit floating type warns once
    and turns compression off, as the package's env knobs do: a typo
    must not kill the first routed allreduce of a long job.  Error
    feedback is never on here: the routed collectives are stateless."""
    if not name:
        return None
    key = name.strip().lower()
    if key in ("", "0", "none", "off", "false"):
        return None
    alias = {"bf16": "bfloat16", "fp16": "float16", "half": "float16"}
    try:
        comp = DcnCompression(wire_dtype=alias.get(key, key))
    except (TypeError, ValueError):
        comp = None
    # only 16-bit floats are wire formats for fp32 gradients; a wider or
    # equal wire would be a silent no-op that still skews the byte model
    if comp is not None and comp.wire_dtype.itemsize == 2:
        return comp
    if key not in _warned_wire_dtypes:
        _warned_wire_dtypes.add(key)
        get_logger().warning(
            "HVD_TPU_DCN_WIRE_DTYPE=%r is not a 16-bit floating wire "
            "dtype; DCN-hop compression disabled", name)
    return None
