"""Tensor fusion: dtype-bucketed flattening of many tensors.

Port of ``horovod_tpu/ops/fusion.py``'s :class:`FusionPlan`, :func:`fuse`
and :func:`unfuse`.  One collective per bucket instead of one per tensor
amortises launch and ring latency (the reference's FusionBufferManager);
a byte threshold splits large buckets; and the bucket layout is a pure
function of the tensors' shapes, dtypes and the threshold, so every rank
fuses identically without negotiating.  The layout rules are the JAX
package's, bucket for bucket (``tests/test_torch_collectives.py`` holds
them equal).  :class:`BucketSchedule` adds a launch order for the
backward overlap: the buckets a hooked ``DistributedOptimizer`` reduces
while the backward still runs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.env_parser import Config


def fusion_threshold() -> int:
    """Bucket byte threshold: ``HVD_TPU_FUSION_THRESHOLD`` (or the
    reference's ``HOROVOD_FUSION_THRESHOLD``, default 64 MiB), read
    anew on each call through ``Config``; 0 disables fusion, and a
    garbled or negative value raises."""
    return Config.from_env().fusion_threshold_bytes


def _dtype(d: Any) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"float32"``)."""
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def dtype_name(d: Any) -> str:
    """The numpy-style name of a dtype (``torch.float32`` -> ``"float32"``),
    the spelling the JAX package's layouts use."""
    return str(_dtype(d)).replace("torch.", "")


def _spec_nbytes(spec) -> int:
    shape, dtype = spec
    return math.prod(shape) * _dtype(dtype).itemsize


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

    def signature(self) -> Tuple:
        """Hashable key of the leaf specs and the bucket layout (two
        plans over the same leaves under different thresholds differ)."""
        return (
            tuple((tuple(s), dtype_name(d)) for s, d in self.specs),
            tuple((dtype_name(dt), tuple(idxs)) for dt, idxs in self.buckets),
        )


class BucketSchedule(FusionPlan):
    """A :class:`FusionPlan` whose buckets carry a launch order for
    backward/collective overlap (port of ``horovod_tpu/ops/fusion.py::
    BucketSchedule``).

    ``production_order[i]`` is the position at which leaf ``i``'s
    gradient is complete in the backward (0 = first).  By default the
    leaves are in registration (forward) order and the production order
    is its reverse: the backward produces the last layer's gradients
    first.

    * Leaves sort by ``(production_order, dtype, shape, bytes)``: a pure
      function of the specs, so every rank builds the identical layout
      whatever order its own hooks fire in.
    * Consecutively produced same-dtype leaves pack greedily under
      ``threshold_bytes`` (``<= 0``: one bucket per leaf).
    * Buckets run in order of ``ready_at``, the production position of
      their last member: the earliest moment their collective can
      launch.
    """

    def __init__(self, leaves: Sequence[torch.Tensor], threshold_bytes: int,
                 production_order: Optional[Sequence[int]] = None):
        self._init_schedule([(tuple(t.shape), t.dtype) for t in leaves],
                            threshold_bytes, production_order)

    @classmethod
    def from_specs(cls, specs: Sequence[Tuple[Sequence[int], Any]],
                   threshold_bytes: int,
                   production_order: Optional[Sequence[int]] = None
                   ) -> "BucketSchedule":
        """A schedule from ``(shape, dtype)`` specs (a dtype or its
        name), without tensors."""
        sched = cls.__new__(cls)
        sched._init_schedule([(tuple(s), _dtype(d)) for s, d in specs],
                             threshold_bytes, production_order)
        return sched

    def _init_schedule(self, specs, threshold_bytes, production_order):
        self.specs = list(specs)
        self.threshold_bytes = int(threshold_bytes)
        n = len(self.specs)
        if production_order is None:
            production_order = [n - 1 - i for i in range(n)]
        if len(production_order) != n:
            raise ValueError(f"production_order has {len(production_order)} "
                             f"entries for {n} leaves")
        self.production_order = [int(p) for p in production_order]

        def key(i):
            shape, dtype = self.specs[i]
            return (self.production_order[i], dtype_name(dtype), shape,
                    _spec_nbytes(self.specs[i]))

        self.buckets = []
        self.ready_at: List[int] = []
        self.bucket_nbytes: List[int] = []
        open_by_dtype: Dict[str, int] = {}  # dtype -> open bucket slot
        for i in sorted(range(n), key=key):
            dtype = self.specs[i][1]
            nbytes = _spec_nbytes(self.specs[i])
            slot = open_by_dtype.get(dtype_name(dtype))
            if (threshold_bytes > 0 and slot is not None
                    and (self.bucket_nbytes[slot] + nbytes <= threshold_bytes
                         or self.bucket_nbytes[slot] == 0)):
                self.buckets[slot][1].append(i)
                self.bucket_nbytes[slot] += nbytes
                self.ready_at[slot] = max(self.ready_at[slot],
                                          self.production_order[i])
            else:
                open_by_dtype[dtype_name(dtype)] = len(self.buckets)
                self.buckets.append((dtype, [i]))
                self.bucket_nbytes.append(nbytes)
                self.ready_at.append(self.production_order[i])
        # launch order: earliest ready first; the dtype and content break
        # ties, so the order stays a pure function of the specs
        launch = sorted(range(len(self.buckets)), key=lambda b: (
            self.ready_at[b], dtype_name(self.buckets[b][0]),
            tuple(key(i) for i in self.buckets[b][1])))
        self.buckets = [self.buckets[b] for b in launch]
        self.ready_at = [self.ready_at[b] for b in launch]
        self.bucket_nbytes = [self.bucket_nbytes[b] for b in launch]

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def signature(self) -> Tuple:
        return super().signature() + (tuple(self.production_order),
                                      tuple(self.ready_at))

    def layout(self) -> Tuple:
        """Per bucket, the ordered ``(shape, dtype name, production
        order)`` of its members: comparable across ranks and across
        permuted leaf lists."""
        return tuple(
            tuple((self.specs[i][0], dtype_name(self.specs[i][1]),
                   self.production_order[i]) for i in idxs)
            for _, idxs in self.buckets)


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
