"""Cross-worker synchronized batch normalization for Keras 3.

Port of ``horovod_tpu/tensorflow/sync_batch_norm.py`` (reference parity:
horovod/tensorflow/sync_batch_norm.py, SyncBatchNormalization
overriding _calculate_mean_and_var to allreduce the batch statistics).
Keras 3 funnels the statistics through ``BatchNormalization._moments``,
so that single override point serves the tensorflow backend (and numpy
values).  The JAX package's jax path (a ``jax.custom_vjp`` over
``jax.pure_callback``) is not ported: this package imports no jax.  For
torch models, ``horovod_tpu_torch.SyncBatchNorm`` is the layer.

Global moments from per-worker sums (the reference's formulation, robust
to ragged per-rank batch sizes): allreduce [Σx, Σx², n] per channel, then
mean = Σx/n and var = Σx²/n − mean².
"""

from __future__ import annotations

import keras
from keras import ops

from ..common import basics
from ..ops import collective_ops as _ops
from ..ops.reduce_ops import Sum
from .mpi_ops import _to_numpy, _to_torch
from .optimizer import _NO_JAX, _grad_kind


def _allreduce_sum(x, name, process_set):
    """Backend-dispatching, DIFFERENTIABLE Sum allreduce of one tensor.

    The batch statistics feed the normalization output, so autodiff must
    flow through this op.  The numpy bridge (py_function) records nothing
    on the tape, so the gradient is attached explicitly:
    d(sum-allreduce)/dx = sum-allreduce of the cotangent — the same
    gradient the reference registers for its HorovodAllreduceOp (every
    rank backprops its local loss; summing the cotangents yields the
    global-loss gradient)."""
    kind = _grad_kind(x)
    if kind == "torch":
        raise NotImplementedError(
            "SyncBatchNormalization supports the tensorflow Keras backend; "
            "for torch models use horovod_tpu_torch.SyncBatchNorm"
        )
    if kind == "jax":
        raise TypeError(f"SyncBatchNormalization got {_NO_JAX}")
    if kind == "tf":
        import tensorflow as tf

        from . import mpi_ops

        @tf.custom_gradient
        def ar(t):
            out = mpi_ops.allreduce(t, op=Sum, name=name,
                                    process_set=process_set)

            def grad(dy):
                return mpi_ops.allreduce(dy, op=Sum, name=f"{name}.grad",
                                         process_set=process_set)

            return out, grad

        return ar(x)
    return ops.convert_to_tensor(_to_numpy(_ops.allreduce(
        _to_torch(x), op=Sum, name=name, process_set=process_set,
    )))


class SyncBatchNormalization(keras.layers.BatchNormalization):
    """Drop-in BatchNormalization whose batch statistics are computed over
    ALL workers (reference: hvd.SyncBatchNormalization) — needed when the
    per-worker batch is too small for stable statistics."""

    def __init__(self, *args, process_set=None, **kwargs):
        kwargs.pop("synchronized", None)  # we ARE the synchronized variant
        super().__init__(*args, **kwargs)
        self._hvd_process_set = process_set

    def _moments(self, inputs, mask):
        multi = basics.is_initialized() and basics.size() > 1
        if mask is not None and multi:
            # local moments here would silently desynchronize the ranks —
            # the exact defect this layer exists to prevent
            raise NotImplementedError(
                "SyncBatchNormalization does not support masked inputs in "
                "a multi-process run (the masked weighted sums are not "
                "allreduced)"
            )
        if mask is not None or not multi:
            return super()._moments(inputs, mask)

        x = ops.cast(inputs, "float32")
        reduction_axes = [a for a in range(len(x.shape))
                          if a != self.axis % len(x.shape)]
        local_sum = ops.sum(x, axis=reduction_axes)          # (C,)
        local_sqsum = ops.sum(x * x, axis=reduction_axes)    # (C,)
        n_channels = x.shape[self.axis]
        local_count = ops.cast(ops.size(x), "float32") / float(n_channels)
        packed = ops.concatenate(
            [local_sum, local_sqsum, ops.reshape(local_count, (1,))]
        )
        # one deterministic name per layer: every rank's training step
        # runs the same layers in the same order
        packed = _allreduce_sum(
            packed, f"sync_bn.{self.name}", self._hvd_process_set
        )
        packed = ops.cast(packed, "float32")
        total_sum = packed[:n_channels]
        total_sqsum = packed[n_channels:2 * n_channels]
        total_count = packed[2 * n_channels]
        mean = total_sum / total_count
        variance = total_sqsum / total_count - mean * mean
        return mean, variance
