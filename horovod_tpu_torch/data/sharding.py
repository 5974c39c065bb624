"""Per-rank dataset sharding driven by the live topology.

Copied from ``horovod_tpu/data/sharding.py``: the same world-independent
epoch permutation (numpy ``RandomState(seed + epoch)``), truncation and
striding, so a (source, seed, epoch, rank, world) gives the JAX
package's index stream exactly; the shard is read from the port's
``common.basics``.

Reference analog: ``torch.utils.data.DistributedSampler`` as used by every
reference example, plus the re-shard-on-reset behavior of its elastic
sampler (horovod/torch/elastic/sampler.py — already mirrored by
``horovod_tpu.elastic.ElasticSampler`` for the rollback-window case).

The split here is deliberately the same as the reference's: shuffle the
epoch's indices with a world-independent permutation (seeded by
``seed + epoch``), truncate to a multiple of the world size, and stride
the result across ranks.  Because the permutation does not depend on the
world, an elastic restart that changes ``num_shards`` re-shards the SAME
epoch ordering — ranks see disjoint, jointly-exhaustive slices before and
after the resize (mid-epoch progress accounting stays ElasticSampler's
job; this sampler is the steady-state/per-epoch path).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["ShardSpec", "current_shard", "ShardedIndexSampler"]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Which slice of the dataset this process reads."""

    shard: int
    num_shards: int

    def __post_init__(self):
        if not 0 <= self.shard < self.num_shards:
            raise ValueError(
                f"shard {self.shard} out of range [0, {self.num_shards})"
            )


def current_shard() -> ShardSpec:
    """The live process's shard, from ``common.topology`` rank/size.

    One shard per *process* (``cross_rank``/``cross_size``; the port
    runs one process per card, so that is the rank).  Before
    ``hvd.init()`` the whole dataset is one shard, so the loader works
    standalone.  Resolved at call time, never cached: a restart into a
    new world re-shards at the next epoch.
    """
    from ..common import basics

    if basics.is_initialized():
        return ShardSpec(basics.cross_rank(), max(basics.cross_size(), 1))
    return ShardSpec(0, 1)


class ShardedIndexSampler:
    """Deterministic per-epoch index stream for one shard.

    ``batches(batch_size)`` yields ``np.ndarray`` index blocks of exactly
    ``batch_size`` (``drop_remainder=True``, the default, keeps the
    step's shapes constant) for this rank's slice of the shuffled epoch
    ordering.
    """

    def __init__(self, num_samples: int, *, shard: Optional[ShardSpec] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        if num_samples <= 0:
            raise ValueError(f"empty dataset (num_samples={num_samples})")
        self.num_samples = int(num_samples)
        self._fixed_shard = shard
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    @property
    def shard(self) -> ShardSpec:
        return self._fixed_shard or current_shard()

    def shard_indices(self) -> np.ndarray:
        """This rank's slice of the current epoch's global ordering."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        spec = self.shard
        # truncate so every shard has identical length (the reference's
        # DistributedSampler drops the tail the same way); strided so a
        # world resize re-slices the same ordering
        per = self.num_samples // spec.num_shards
        if per == 0:
            raise ValueError(
                f"dataset of {self.num_samples} samples cannot feed "
                f"{spec.num_shards} shards"
            )
        return order[: per * spec.num_shards][spec.shard :: spec.num_shards]

    def num_batches(self, batch_size: int) -> int:
        n = len(self.shard_indices())
        if self.drop_remainder:
            return n // batch_size
        return -(-n // batch_size)

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        idx = self.shard_indices()
        stop = (len(idx) // batch_size) * batch_size if self.drop_remainder \
            else len(idx)
        for lo in range(0, stop, batch_size):
            yield idx[lo : lo + batch_size]
