"""Fixed-shape sample shards (images + labels), memory-mapped — a copy of
``container_engine_accelerators_tpu/data/arrays.py``, so that the port
imports nothing of the JAX package; the two read and write the same
files.

A dataset directory holds ``NNNNN.images`` (raw sample arrays, any fixed
shape/dtype) and ``NNNNN.labels`` (int32) pairs plus an ``index.json``
recording the sample shape/dtype and per-shard counts.  Readers
memory-map both files, so a job touches only the samples its batches
slice.

uint8 storage is the intended format for images (4x smaller than f32
on disk and over the network); the loader scales it to [0, 1] f32 on
the host, off the step path.
"""

import json
import os
from typing import Iterable, List, Tuple

import numpy as np

INDEX_NAME = "index.json"
FORMAT_VERSION = 1


def write_array_shards(directory: str,
                       batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                       ) -> List[str]:
    """Write (images, labels) pairs, one shard each; rebuild the index.

    Every images array must share dtype and per-sample shape; labels
    are int32 with matching leading dimension.

    A directory that already holds shards is refused: unlike token
    shards (any uint32 file is valid data), array shards carry
    per-dataset shape/dtype, and folding stale files into a rebuilt
    index could silently reinterpret old bytes under the new sample
    shape.
    """
    os.makedirs(directory, exist_ok=True)
    stale = [f for f in os.listdir(directory) if f.endswith(".images")]
    if stale:
        raise ValueError(
            f"{directory} already holds {stale[0]} — refusing to mix "
            f"datasets (write into a fresh directory)")
    paths = []
    sample_shape = None
    dtype = None
    count = 0
    for images, labels in batches:
        images = np.ascontiguousarray(images)
        labels = np.ascontiguousarray(labels, dtype="<i4")
        if images.shape[0] != labels.shape[0] or labels.ndim != 1:
            raise ValueError(
                f"shard {count}: images {images.shape} vs labels "
                f"{labels.shape}")
        if sample_shape is None:
            sample_shape, dtype = images.shape[1:], images.dtype
        elif images.shape[1:] != sample_shape or images.dtype != dtype:
            raise ValueError(
                f"shard {count}: shape/dtype {images.shape[1:]}"
                f"/{images.dtype} != first shard {sample_shape}/{dtype}")
        base = os.path.join(directory, f"{count:05d}")
        for suffix, arr in ((".images", images), (".labels", labels)):
            tmp = base + suffix + ".tmp"
            with open(tmp, "wb") as f:
                f.write(arr.tobytes())
            os.replace(tmp, base + suffix)
        paths.append(base + ".images")
        count += 1
    if sample_shape is None:
        raise ValueError("no batches given")
    _write_index(directory, sample_shape, dtype)
    return paths


def _write_index(directory, sample_shape, dtype) -> None:
    sample_bytes = int(np.prod(sample_shape)) * dtype.itemsize
    shards = sorted(
        f for f in os.listdir(directory) if f.endswith(".images")
    )
    index = {
        "version": FORMAT_VERSION,
        "sample_shape": list(int(d) for d in sample_shape),
        "dtype": dtype.name,
        "shards": [
            {"name": s[:-7],
             "samples": os.path.getsize(os.path.join(directory, s))
             // sample_bytes}
            for s in shards
        ],
    }
    tmp = os.path.join(directory, INDEX_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1)
    os.replace(tmp, os.path.join(directory, INDEX_NAME))


class ArrayShardReader:
    """One logical (images, labels) stream with modular slicing."""

    def __init__(self, directory: str):
        index_path = os.path.join(directory, INDEX_NAME)
        try:
            with open(index_path) as f:
                index = json.load(f)
        except OSError as e:
            raise FileNotFoundError(
                f"{index_path}: not an array dataset (write one with "
                f"data.write_array_shards)") from e
        if index.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"{index_path}: format version {index.get('version')!r}"
                f" != {FORMAT_VERSION}")
        if "sample_shape" not in index:
            raise ValueError(f"{index_path}: token-dataset index? "
                             f"(no sample_shape)")
        self.sample_shape = tuple(index["sample_shape"])
        self.dtype = np.dtype(index["dtype"])
        self._images = []
        self._labels = []
        self._starts = []
        total = 0
        for entry in index["shards"]:
            base = os.path.join(directory, entry["name"])
            img = np.memmap(base + ".images", dtype=self.dtype, mode="r")
            img = img.reshape((-1,) + self.sample_shape)
            lab = np.memmap(base + ".labels", dtype="<i4", mode="r")
            if img.shape[0] != entry["samples"] \
                    or lab.shape[0] != entry["samples"]:
                raise ValueError(
                    f"{base}: {img.shape[0]} images / {lab.shape[0]} "
                    f"labels on disk != {entry['samples']} in index")
            self._images.append(img)
            self._labels.append(lab)
            self._starts.append(total)
            total += entry["samples"]
        if total == 0:
            raise ValueError(f"{directory}: dataset has 0 samples")
        self.total_samples = total

    def read(self, start: int, n: int):
        """(images [n, ...], labels [n]) at logical offset (modular)."""
        images = np.empty((n,) + self.sample_shape, dtype=self.dtype)
        labels = np.empty((n,), np.int32)
        filled = 0
        pos = int(start) % self.total_samples
        while filled < n:
            i = int(np.searchsorted(self._starts, pos, side="right") - 1)
            off = pos - self._starts[i]
            take = min(n - filled, self._images[i].shape[0] - off)
            images[filled:filled + take] = self._images[i][off:off + take]
            labels[filled:filled + take] = self._labels[i][off:off + take]
            filled += take
            pos = (pos + take) % self.total_samples
        return images, labels
