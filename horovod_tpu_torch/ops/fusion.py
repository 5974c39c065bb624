"""Tensor fusion: dtype-bucketed flattening of many tensors.

Port of ``horovod_tpu/ops/fusion.py``'s :class:`FusionPlan`, :func:`fuse`
and :func:`unfuse`.  One collective per bucket instead of one per tensor
amortises launch and ring latency (the reference's FusionBufferManager);
a byte threshold splits large buckets; and the bucket layout is a pure
function of the tensors' shapes, dtypes and the threshold, so every rank
fuses identically without negotiating.  The layout rules are the JAX
package's, bucket for bucket (``tests/test_torch_collectives.py`` holds
them equal).  ``BucketSchedule`` (launch order for backward overlap)
comes with the overlap slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from ..common.retry import env_int

#: HOROVOD_FUSION_THRESHOLD's default (64 MiB)
DEFAULT_THRESHOLD = 64 * 1024 * 1024


def fusion_threshold() -> int:
    """Bucket byte threshold: ``HVD_TPU_FUSION_THRESHOLD`` (or the
    reference's ``HOROVOD_FUSION_THRESHOLD``); 0 disables fusion."""
    return env_int("HVD_TPU_FUSION_THRESHOLD",
                   env_int("HOROVOD_FUSION_THRESHOLD", DEFAULT_THRESHOLD))


class FusionPlan:
    """Deterministic partition of a tensor list into dtype buckets.

    ``buckets`` is a list of ``(dtype, [leaf indices])``: same-dtype
    leaves pack greedily in list order while the bucket stays within
    ``threshold_bytes`` (a leaf larger than the threshold gets a bucket
    of its own); ``threshold_bytes <= 0`` gives one bucket per leaf."""

    def __init__(self, leaves: Sequence[torch.Tensor], threshold_bytes: int):
        self._init_from_specs([(tuple(t.shape), t.dtype) for t in leaves],
                              threshold_bytes)

    @classmethod
    def from_specs(cls, specs: Sequence[Tuple[Sequence[int], torch.dtype]],
                   threshold_bytes: int) -> "FusionPlan":
        """A plan from ``(shape, dtype)`` specs, without tensors."""
        plan = cls.__new__(cls)
        plan._init_from_specs([(tuple(s), d) for s, d in specs],
                              threshold_bytes)
        return plan

    def _init_from_specs(self, specs, threshold_bytes: int):
        self.specs: List[Tuple[Tuple[int, ...], torch.dtype]] = list(specs)
        self.threshold_bytes = int(threshold_bytes)
        self.buckets: List[Tuple[torch.dtype, List[int]]] = []
        if threshold_bytes <= 0:
            self.buckets = [(dtype, [i])
                            for i, (_, dtype) in enumerate(self.specs)]
            return
        open_: Dict[torch.dtype, List[int]] = {}
        open_bytes: Dict[torch.dtype, int] = {}
        for i, (shape, dtype) in enumerate(self.specs):
            nbytes = math.prod(shape) * dtype.itemsize
            if dtype in open_ and (
                    open_bytes[dtype] + nbytes <= threshold_bytes
                    or open_bytes[dtype] == 0):
                open_[dtype].append(i)
                open_bytes[dtype] += nbytes
            else:
                if dtype in open_:
                    self.buckets.append((dtype, open_[dtype]))
                open_[dtype] = [i]
                open_bytes[dtype] = nbytes
        self.buckets.extend(open_.items())


def fuse(leaves: Sequence[torch.Tensor], plan: FusionPlan
         ) -> List[torch.Tensor]:
    """Flatten + concatenate each bucket into one new 1-D buffer (always
    a copy, so a collective may work on it in place)."""
    return [torch.cat([leaves[i].reshape(-1) for i in idxs])
            for _, idxs in plan.buckets]


def unfuse(fused: Sequence[torch.Tensor], plan: FusionPlan
           ) -> List[torch.Tensor]:
    """Inverse of :func:`fuse`: views of the buffers in the leaves'
    shapes (the buffer's dtype, which a reduction may have changed)."""
    out: List[torch.Tensor] = [None] * len(plan.specs)  # type: ignore
    for (_, idxs), buf in zip(plan.buckets, fused):
        offset = 0
        for i in idxs:
            shape = plan.specs[i][0]
            n = math.prod(shape)
            out[i] = buf[offset:offset + n].view(shape)
            offset += n
    return out
