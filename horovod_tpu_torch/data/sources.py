"""Dataset sources: where samples come from.

Copied from ``horovod_tpu/data/sources.py``: the same random-access
``DataSource`` contract (``len(src)``, ``src.batch(indices) -> (inputs,
labels)`` as numpy arrays), the same deterministic synthesis, on-disk
layout and decode, so a source yields the JAX package's bytes:

* :class:`SyntheticSource` — deterministic random tensors (per-index
  Philox streams);
* :class:`NpyShardSource` — directories of ``*-inputs.npy`` /
  ``*-labels.npy`` shard pairs, memory-mapped (:func:`write_npy_shards`
  produces the layout);
* :class:`ImageFolderSource` — the torchvision ``ImageFolder`` layout
  (``root/<class>/<image>``), PIL-decoded and resized host-side (PIL is
  imported when the source is built).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DataSource",
    "ArraySource",
    "SyntheticSource",
    "NpyShardSource",
    "ImageFolderSource",
    "write_npy_shards",
    "open_source",
]

#: File extensions ImageFolderSource admits (PIL handles all of them).
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


class DataSource:
    """Random-access sample store.

    Subclasses implement :meth:`__len__` and :meth:`sample`; ``batch`` has
    a generic gather-and-stack default that sources with a cheaper bulk
    path (mmap fancy-indexing, vectorized synthesis) override.
    """

    #: short label for metrics / bench JSON ("synthetic", "npy", ...)
    kind = "custom"

    def __len__(self) -> int:
        raise NotImplementedError

    def sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(input, label)`` numpy arrays for one sample."""
        raise NotImplementedError

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Gather ``indices`` into stacked ``(inputs, labels)`` arrays."""
        pairs = [self.sample(int(i)) for i in indices]
        inputs = np.stack([p[0] for p in pairs])
        labels = np.asarray([p[1] for p in pairs])
        return inputs, labels


class ArraySource(DataSource):
    """In-memory arrays — the trivial source (and the test workhorse)."""

    kind = "array"

    def __init__(self, inputs: np.ndarray, labels: np.ndarray):
        if len(inputs) != len(labels):
            raise ValueError(
                f"inputs ({len(inputs)}) and labels ({len(labels)}) "
                "disagree on sample count"
            )
        self.inputs = inputs
        self.labels = labels

    def __len__(self) -> int:
        return len(self.inputs)

    def sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.inputs[index], self.labels[index]

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices)
        return self.inputs[idx], self.labels[idx]


class SyntheticSource(DataSource):
    """Deterministic random ImageNet-shaped samples.

    Index ``i`` always yields the same tensor regardless of sharding or
    epoch, so elastic re-shards see a consistent dataset.  Synthesis is
    vectorized per batch (one RandomState per sample would dominate at
    small images).
    """

    kind = "synthetic"

    def __init__(self, num_samples: int, image_size: int = 224,
                 channels: int = 3, num_classes: int = 1000,
                 seed: int = 0, dtype=np.float32):
        self.num_samples = int(num_samples)
        self.image_size = int(image_size)
        self.channels = int(channels)
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.dtype = np.dtype(dtype)

    def __len__(self) -> int:
        return self.num_samples

    def sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        inputs, labels = self.batch([index])
        return inputs[0], labels[0]

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, dtype=np.int64)
        shape = (len(idx), self.image_size, self.image_size, self.channels)
        # per-sample determinism independent of batch composition: sample
        # i's bytes come from a counter-based Philox stream keyed (seed, i)
        rows = np.empty(shape, dtype=self.dtype)
        for row, i in enumerate(idx):
            g = np.random.Generator(np.random.Philox(key=self.seed + 1,
                                                     counter=int(i)))
            rows[row] = g.standard_normal(shape[1:], dtype=np.float32)
        labels = (idx * 2654435761 + self.seed) % self.num_classes
        return rows, labels.astype(np.int32)


class NpyShardSource(DataSource):
    """Directory of ``<stem>-inputs.npy`` / ``<stem>-labels.npy`` pairs.

    Shards are opened with ``mmap_mode="r"`` so construction is O(#shards)
    metadata reads and a batch read touches only the pages its rows live
    on — the property that lets a 100 GB dataset feed a host with a few
    GB of RAM.  A single un-sharded ``inputs.npy``/``labels.npy`` pair is
    the degenerate one-shard case of the same layout.
    """

    kind = "npy"

    def __init__(self, root: str):
        self.root = str(root)
        stems = sorted(
            f[: -len("-inputs.npy")]
            for f in os.listdir(self.root)
            if f.endswith("-inputs.npy")
        )
        if os.path.exists(os.path.join(self.root, "inputs.npy")):
            stems.insert(0, "")
        if not stems:
            raise FileNotFoundError(
                f"no '*-inputs.npy' shards under {self.root!r} "
                "(see horovod_tpu_torch.data.write_npy_shards)"
            )
        self._inputs = []
        self._labels = []
        lengths = []
        for stem in stems:
            prefix = f"{stem}-" if stem else ""
            x = np.load(os.path.join(self.root, f"{prefix}inputs.npy"),
                        mmap_mode="r")
            y = np.load(os.path.join(self.root, f"{prefix}labels.npy"),
                        mmap_mode="r")
            if len(x) != len(y):
                raise ValueError(
                    f"shard {stem or 'inputs'!r}: inputs ({len(x)}) and "
                    f"labels ({len(y)}) disagree on sample count"
                )
            self._inputs.append(x)
            self._labels.append(y)
            lengths.append(len(x))
        self._offsets = np.concatenate([[0], np.cumsum(lengths)])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _locate(self, index: int) -> Tuple[int, int]:
        shard = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return shard, index - int(self._offsets[shard])

    def sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        s, off = self._locate(int(index))
        return np.asarray(self._inputs[s][off]), np.asarray(
            self._labels[s][off])

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, dtype=np.int64)
        shard_ids = np.searchsorted(self._offsets, idx, side="right") - 1
        first = self._inputs[0]
        inputs = np.empty((len(idx),) + first.shape[1:], dtype=first.dtype)
        labels = np.empty((len(idx),), dtype=self._labels[0].dtype)
        # group by shard so each mmap is fancy-indexed once per batch
        for s in np.unique(shard_ids):
            rows = np.nonzero(shard_ids == s)[0]
            local = idx[rows] - int(self._offsets[s])
            order = np.argsort(local)  # mmap reads like sequential order
            inputs[rows[order]] = self._inputs[s][local[order]]
            labels[rows[order]] = self._labels[s][local[order]]
        return inputs, labels


class ImageFolderSource(DataSource):
    """``root/<class_name>/<image file>`` — the torchvision ImageFolder
    layout, decoded with PIL and resized host-side.

    The decode is the worker pool's job (workers.py): PIL releases the
    GIL inside decode/resize, so threads parallelize it.
    """

    kind = "folder"

    def __init__(self, root: str, image_size: int = 224,
                 classes: Optional[Sequence[str]] = None):
        try:
            from PIL import Image  # noqa: F401
        except ImportError as e:  # pragma: no cover - PIL ships in image
            raise ImportError(
                "ImageFolderSource needs Pillow for image decode "
                "(pip install Pillow)"
            ) from e
        self.root = str(root)
        self.image_size = int(image_size)
        if classes is None:
            classes = sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
            )
        self.classes = list(classes)
        if not self.classes:
            raise FileNotFoundError(
                f"no class directories under {self.root!r} "
                "(expected root/<class>/<image> layout)"
            )
        self._files = []
        self._file_labels = []
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(self.root, cls)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(_IMAGE_EXTS):
                    self._files.append(os.path.join(cdir, f))
                    self._file_labels.append(label)
        if not self._files:
            raise FileNotFoundError(
                f"no image files ({'/'.join(_IMAGE_EXTS)}) under "
                f"{self.root!r}"
            )

    def __len__(self) -> int:
        return len(self._files)

    def sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        with Image.open(self._files[index]) as im:
            im = im.convert("RGB")
            # resize-shortest-side + center crop: the standard eval
            # transform; augmentation belongs in the loader's transform
            w, h = im.size
            scale = self.image_size / min(w, h)
            im = im.resize((max(self.image_size, round(w * scale)),
                            max(self.image_size, round(h * scale))))
            w, h = im.size
            left = (w - self.image_size) // 2
            top = (h - self.image_size) // 2
            im = im.crop((left, top, left + self.image_size,
                          top + self.image_size))
            arr = np.asarray(im, dtype=np.uint8)
        return arr, np.int32(self._file_labels[index])


def write_npy_shards(root: str, inputs: np.ndarray, labels: np.ndarray,
                     num_shards: int = 1) -> list:
    """Write ``inputs``/``labels`` as the NpyShardSource layout.

    Returns the shard stems written: the documented way to materialize a
    real-array dataset for the pipeline (the JAX package's ``bench.py
    --data npy`` seeds itself this way).
    """
    if len(inputs) != len(labels):
        raise ValueError("inputs and labels disagree on sample count")
    if num_shards < 1 or num_shards > max(len(inputs), 1):
        raise ValueError(f"bad num_shards {num_shards} for "
                         f"{len(inputs)} samples")
    os.makedirs(root, exist_ok=True)
    stems = []
    bounds = np.linspace(0, len(inputs), num_shards + 1, dtype=np.int64)
    for s in range(num_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        stem = f"shard-{s:05d}"
        np.save(os.path.join(root, f"{stem}-inputs.npy"), inputs[lo:hi])
        np.save(os.path.join(root, f"{stem}-labels.npy"), labels[lo:hi])
        stems.append(stem)
    return stems


def open_source(kind: str, path: Optional[str] = None,
                image_size: int = 224, **synthetic_kwargs) -> DataSource:
    """Open a source by bench-flag name (``synthetic``/``npy``/``folder``)."""
    if kind == "synthetic":
        return SyntheticSource(image_size=image_size, **synthetic_kwargs)
    if path is None:
        raise ValueError(f"--data {kind} requires a dataset path")
    if kind == "npy":
        return NpyShardSource(path)
    if kind == "folder":
        return ImageFolderSource(path, image_size=image_size)
    raise ValueError(f"unknown data source kind {kind!r} "
                     "(expected synthetic|npy|folder)")
