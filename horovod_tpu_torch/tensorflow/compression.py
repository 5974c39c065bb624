"""Gradient compression for the TensorFlow adapter.

Port of ``horovod_tpu/tensorflow/compression.py`` (reference parity:
horovod/tensorflow/compression.py) — ``Compression.none`` and
``Compression.fp16``, applied to gradients before the wire and undone
after.
"""

from __future__ import annotations

import tensorflow as tf


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
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
    """Cast fp32/fp64 to fp16 on the wire (reference: FP16Compressor)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating:
            return tf.cast(tensor, tf.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tf.cast(tensor, ctx) if ctx is not None else tensor


class Compression:
    """Namespace matching the reference's ``hvd.Compression`` surface."""

    none = NoneCompressor
    fp16 = FP16Compressor
