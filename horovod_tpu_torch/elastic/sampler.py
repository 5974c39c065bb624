"""ElasticSampler: dataset sharding that survives membership changes.

Copied from ``horovod_tpu/elastic/sampler.py`` (reference parity:
horovod/torch/elastic/sampler.py) — shard a dataset's indices over the
current world, track which indices were already processed this epoch,
and on a reset re-shard only the *remaining* indices over the new world
so no sample is dropped or duplicated beyond the rollback window.  The
index order is the JAX package's for the same size, world, rank, seed,
epoch and progress.  A replica is a process here (one per GPU), as a
process is there.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class ElasticSampler:
    """Framework-agnostic index sampler (the reference subclasses
    ``torch.utils.data.Sampler``; this one iterates plain ints usable
    with any loader).

    Register it on the elastic state so its progress commits/restores and
    syncs with everything else::

        sampler = hvd.elastic.ElasticSampler(len(dataset))
        state = hvd.elastic.TpuState(sampler=sampler, epoch=0)
    """

    def __init__(self, dataset_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset_size = int(dataset_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: List[int] = []
        self.remaining_indices: List[int] = []
        self.num_replicas = 0
        self.rank = 0
        self.reset()

    # -- world/topology ----------------------------------------------------

    def reset(self) -> None:
        """Re-shard remaining indices over the current world (reference:
        ElasticSampler.reset, called by TorchState.on_reset)."""
        from ..common import basics

        if basics.is_initialized():
            self.num_replicas = basics.size()
            self.rank = basics.rank()
        else:
            self.num_replicas = 1
            self.rank = 0
        self._reshard()

    def set_epoch(self, epoch: int) -> None:
        """Start a new epoch: new shuffle, clear processed set (reference:
        ElasticSampler.set_epoch)."""
        self.epoch = int(epoch)
        self.processed_indices = []
        self._reshard()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark one *global* batch (all replicas' shards) processed
        (reference: ElasticSampler.record_batch)."""
        start = batch_idx * batch_size
        for r in range(self.num_replicas):
            shard = self._shard_for(r)
            self.processed_indices.extend(shard[start:start + batch_size])

    # -- iteration ---------------------------------------------------------

    def __iter__(self) -> Iterator[int]:
        return iter(self._shard_for(self.rank))

    def __len__(self) -> int:
        return len(self._shard_for(self.rank))

    # -- commit/restore/sync plumbing (picked up by ObjectState) -----------

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "processed_indices": list(self.processed_indices),
        }

    def load_state_dict(self, d: dict) -> None:
        self.epoch = d["epoch"]
        self.processed_indices = list(d["processed_indices"])
        self._reshard()

    # -- internals ---------------------------------------------------------

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _recompute_remaining(self) -> None:
        processed = set(self.processed_indices)
        self.remaining_indices = [
            int(i) for i in self._epoch_order() if int(i) not in processed
        ]

    def _reshard(self) -> None:
        self._recompute_remaining()
        # truncate so every replica gets the same shard length (the
        # reference drops the tail remainder as DistributedSampler does)
        n = len(self.remaining_indices)
        per = n // max(self.num_replicas, 1)
        self._shards = [
            self.remaining_indices[r * per:(r + 1) * per]
            for r in range(max(self.num_replicas, 1))
        ]

    def _shard_for(self, rank: int) -> Sequence[int]:
        if rank < len(self._shards):
            return self._shards[rank]
        return []
