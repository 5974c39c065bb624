"""SyncBatchNorm for the port's models.

Port of ``horovod_tpu/sync_batch_norm.py`` (reference parity:
horovod/torch/sync_batch_norm.py): batch statistics shared by every
rank of a group each training step.  Where flax binds ``axis_name`` and
its ``pmean`` lowers to an all-reduce inside the step, the port's
:class:`~.models.resnet.BatchNorm` takes a ``process_group``: the fused
kernels all-reduce their per-channel sums over it between the two
kernels of each pair (forward and backward), so sync BN runs the same
kernels as local BN.
"""

from __future__ import annotations

import functools

from .models.resnet import WORLD, BatchNorm


class SyncBatchNorm(BatchNorm):
    """The port's ``BatchNorm`` whose statistics sync over
    ``process_group``, by default the world group (reference:
    hvd.SyncBatchNorm)."""

    def __init__(self, features: int, *, process_group=WORLD, **kwargs):
        super().__init__(features, process_group=process_group, **kwargs)


def cross_replica(bn_cls=BatchNorm, group=WORLD):
    """``bn_cls`` with ``group`` bound as its ``process_group``: a norm
    constructor whose statistics sync over that group."""
    return functools.partial(bn_cls, process_group=group)
