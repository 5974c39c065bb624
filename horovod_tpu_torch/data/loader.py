"""DataLoader: sharded source -> worker pool -> device prefetcher.

Port of ``horovod_tpu/data/loader.py``: the same sampler, worker pool
and collate (``data.batch`` chaos site, ``DATA_BATCH_PRODUCE``), and the
same ``make_loader`` flags, with uint8 ``npy``/``folder`` images
normalized to fp32 in [0, 1] on the worker pool in numpy.  Batches come
out as tensors on the rank's card (``device_put=False``: CPU tensors).
The reference's ``sharding=`` (a ``jax.sharding.Sharding`` placing a
batch over a process's many chips) has no counterpart: the port runs
one process per card, so a batch goes to that card.

The one object user code touches.  Equivalent composed pipeline::

    sampler = ShardedIndexSampler(len(source), ...)      # sharding.py
    host    = map_ordered(collate, sampler.batches(bs))  # workers.py
    batches = DevicePrefetcher(host, depth=2)            # prefetch.py

Usage (the drop-in loop for training.py's step)::

    loader = hvd.data.DataLoader(source, batch_size=128, cast="bfloat16")
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for images, labels in loader:        # on the card already
            state, loss = step(state, images, labels)

``batch_size`` is per shard (= per process).  The shard resolves from the
live topology at each ``__iter__`` — an elastic exec-restart lands in a
new world and the next epoch re-shards with no user code (steady-state
path; mid-epoch rollback accounting remains ``ElasticSampler``'s job).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

from .. import chaos as _chaos
from ..metrics import instruments as _instr
from . import prefetch as _prefetch
from . import sharding as _sharding
from . import workers as _workers
from .sources import DataSource, open_source

__all__ = ["DataLoader", "make_loader"]


class DataLoader:
    """Sharded, worker-fed, device-prefetched batch iterator.

    Args:
      source: a :class:`~horovod_tpu_torch.data.DataSource`.
      batch_size: samples per batch *per shard* (per process).
      shuffle/seed: epoch shuffling of the global index order.
      drop_remainder: keep batch shapes static.
      transform: ``fn(inputs, labels) -> (inputs, labels)`` applied on the
        worker pool (augmentation, normalization, dtype massaging).
      num_workers: host decode threads (default ``HVD_TPU_DATA_WORKERS``).
      prefetch_depth: staged device batches (default
        ``HVD_TPU_PREFETCH_DEPTH``); 0 = synchronous staging.
      cast: host-side dtype cast for float arrays ("bfloat16" halves the
        host->device bytes).
      device: where batches go (default: the rank's card; "cpu" keeps
        them on the host).
      device_put: False yields CPU tensors (the caller places them).
      shard: pin a :class:`ShardSpec` (tests); default = live topology.
    """

    def __init__(self, source: DataSource, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True,
                 transform: Optional[Callable] = None,
                 num_workers: Optional[int] = None,
                 prefetch_depth: Optional[int] = None,
                 cast=None,
                 device=None,
                 device_put: bool = True,
                 shard: Optional[_sharding.ShardSpec] = None):
        self.source = source
        self.batch_size = int(batch_size)
        self.transform = transform
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.cast = cast
        self.device = device
        self.device_put = device_put
        self.sampler = _sharding.ShardedIndexSampler(
            len(source), shard=shard, shuffle=shuffle, seed=seed,
            drop_remainder=drop_remainder)
        self._last: Optional[_prefetch.DevicePrefetcher] = None

    # -- epoch plumbing ------------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        """New epoch: fresh shuffle (mirrors DistributedSampler.set_epoch)."""
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        """Batches this shard yields per epoch."""
        return self.sampler.num_batches(self.batch_size)

    # -- iteration -----------------------------------------------------------

    def _collate(self, indices):
        # chaos: delay = a slow decode burst; raise/drop = a decode
        # failure surfacing at the training thread's yield point (the
        # ordered window then cancels the in-flight tail)
        if _chaos.active and _chaos.point("data.batch") is _chaos.DROP:
            raise _chaos.ChaosInjected("chaos: batch dropped at data.batch")
        t0 = time.perf_counter()
        inputs, labels = self.source.batch(indices)
        if self.transform is not None:
            inputs, labels = self.transform(inputs, labels)
        _instr.DATA_BATCH_PRODUCE.observe(time.perf_counter() - t0)
        return inputs, labels

    def __iter__(self) -> Iterator:
        if self._last is not None:
            # an abandoned prior iteration (break / next(iter(loader)))
            # must not keep its producer thread and staged device batches
            # alive — close it before building the new pipeline
            self._last.close()
        workers = (_workers.default_num_workers()
                   if self.num_workers is None else self.num_workers)
        depth = (_prefetch.default_prefetch_depth()
                 if self.prefetch_depth is None else self.prefetch_depth)
        host = _workers.map_ordered(
            self._collate, self.sampler.batches(self.batch_size),
            num_workers=workers,
            # the decode window feeds the staging queue: one extra batch
            # cooking per staged slot keeps the pool busy across jitter
            window=max(2 * max(depth, 1), workers or 1),
        )
        self._last = _prefetch.DevicePrefetcher(
            host, depth=depth, cast=self.cast, device=self.device,
            device_put=self.device_put, source_kind=self.source.kind)
        return self._last

    # -- instrumentation -----------------------------------------------------

    def stats(self) -> dict:
        """Pipeline stats of the most recent iteration."""
        if self._last is None:
            return {}
        return self._last.stats()


def make_loader(data: str, path: Optional[str] = None, *,
                batch_size: int, image_size: int = 224,
                synthetic_samples: int = 2048,
                seed: int = 0, **loader_kwargs) -> DataLoader:
    """Build a loader from bench-style flags (``--data``/``--data-path``).

    ``synthetic`` ignores ``path`` and serves ``synthetic_samples``
    deterministic ImageNet-shaped samples; ``npy``/``folder`` open the
    on-disk layouts (sources.py).  uint8 image sources are normalized to
    float32 in [0, 1] on the worker pool, matching the standard decode
    path.
    """
    source = open_source(data, path, image_size=image_size,
                         **({"num_samples": synthetic_samples,
                             "seed": seed} if data == "synthetic" else {}))
    transform = loader_kwargs.pop("transform", None)
    if transform is None and data in ("npy", "folder"):
        transform = _normalize_uint8
    return DataLoader(source, batch_size, transform=transform,
                      seed=seed, **loader_kwargs)


def _normalize_uint8(inputs, labels):
    import numpy as np

    if inputs.dtype == np.uint8:
        inputs = inputs.astype(np.float32) / 255.0
    return inputs, labels
