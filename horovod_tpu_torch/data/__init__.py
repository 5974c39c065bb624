"""``horovod_tpu_torch.data`` — the async device-feeding input pipeline.

Port of ``horovod_tpu/data``: a per-rank sharded dataset (driven by the
live topology), a host-side worker pool for decode/augment, and a
double-buffered prefetcher that copies batch N+1 to the card on a side
CUDA stream while batch N computes.  See ``docs/DATA.md``.

Quick start::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import data

    hvd.init()
    loader = data.make_loader("npy", "/data/imagenet-npy",
                              batch_size=128, cast="bfloat16")
    for epoch in range(90):
        loader.set_epoch(epoch)
        for images, labels in loader:      # on the card, prefetched
            state, loss = step(state, images, labels)

Env knobs: ``HVD_TPU_DATA_WORKERS`` (decode threads),
``HVD_TPU_PREFETCH_DEPTH`` (staged device batches, 0 = off).
"""

from .loader import DataLoader, make_loader
from .prefetch import (
    DevicePrefetcher,
    default_prefetch_depth,
    prefetch_to_device,
)
from .sharding import ShardSpec, ShardedIndexSampler, current_shard
from .sources import (
    ArraySource,
    DataSource,
    ImageFolderSource,
    NpyShardSource,
    SyntheticSource,
    open_source,
    write_npy_shards,
)
from .workers import default_num_workers, map_ordered

__all__ = [
    "DataLoader",
    "make_loader",
    "DevicePrefetcher",
    "prefetch_to_device",
    "default_prefetch_depth",
    "ShardSpec",
    "ShardedIndexSampler",
    "current_shard",
    "ArraySource",
    "DataSource",
    "ImageFolderSource",
    "NpyShardSource",
    "SyntheticSource",
    "open_source",
    "write_npy_shards",
    "default_num_workers",
    "map_ordered",
]
