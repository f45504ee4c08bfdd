"""Token shard format: flat uint32 streams, memory-mapped reads — a copy
of ``container_engine_accelerators_tpu/data/tokens.py`` (jax-free there
too), so that the PyTorch port imports nothing of the JAX package.

A dataset is a directory of ``NNNNN.tokens`` files (little-endian
uint32, no header — the format a native packer can emit with plain
writes; see native/tokpack) plus an ``index.json`` carrying the shard
token counts and a format version.  Readers memory-map each shard, so
a training job touches only the pages its global-batch slices actually
read — the property that matters on a pod where every host maps the
same dataset but reads a disjoint batch shard.

The reference's analog is the mounted-ImageNet + tf.data path of the
demo trainers (demo/gpu-training/generate_job.sh:54-70); here the
format is deliberately trivial so the WRITER can be anything (the
in-tree native packer, a Python script, a Beam job) and the contract
is just "uint32s + index.json".
"""

import json
import os
from typing import Iterable, List

import numpy as np

INDEX_NAME = "index.json"
FORMAT_VERSION = 1
_DTYPE = np.dtype("<u4")


def write_token_shards(directory: str, streams: Iterable[np.ndarray],
                       name_offset: int = 0) -> List[str]:
    """Write each stream as one shard; (re)write ``index.json``.

    Appending to an existing dataset: pass ``name_offset`` = number of
    existing shards; the index is rebuilt from the directory contents
    so it always reflects what is actually on disk.
    """
    # Validate EVERY stream before writing ANY shard: a mid-loop
    # rejection would leave earlier shards on disk with no index
    # rebuild — an orphan a later write's directory-scan rebuild would
    # silently adopt.
    arrays = []
    for i, stream in enumerate(streams):
        arr = np.ascontiguousarray(np.asarray(stream), dtype=_DTYPE)
        if arr.ndim != 1:
            raise ValueError(f"stream {i}: want 1-D tokens, got "
                             f"shape {arr.shape}")
        if arr.size == 0:
            # A 0-byte shard would crash TokenShardReader inside
            # np.memmap with an opaque mmap error (ADVICE r4); fail at
            # the format level, at write time.
            raise ValueError(f"stream {i}: empty token stream — a "
                             f"zero-byte shard cannot be memory-mapped")
        arrays.append(arr)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, arr in enumerate(arrays):
        path = os.path.join(directory, f"{name_offset + i:05d}.tokens")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(arr.tobytes())
        os.replace(tmp, path)  # never a half-written shard at its name
        paths.append(path)
    _write_index(directory)
    return paths


def _write_index(directory: str) -> None:
    shards = sorted(
        f for f in os.listdir(directory) if f.endswith(".tokens")
    )
    index = {
        "version": FORMAT_VERSION,
        "shards": [
            {"name": s,
             "tokens": os.path.getsize(os.path.join(directory, s))
             // _DTYPE.itemsize}
            for s in shards
        ],
    }
    tmp = os.path.join(directory, INDEX_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1)
    os.replace(tmp, os.path.join(directory, INDEX_NAME))


class TokenShardReader:
    """Memory-mapped view over a shard directory as ONE logical token
    stream with O(1) random slicing.

    ``read(start, n)`` returns ``n`` tokens starting at logical offset
    ``start`` (wrapping around the end of the dataset — epochs are the
    caller's modular arithmetic, which keeps the step->data mapping a
    pure function; see loader.py).
    """

    def __init__(self, directory: str):
        index_path = os.path.join(directory, INDEX_NAME)
        try:
            with open(index_path) as f:
                index = json.load(f)
        except OSError as e:
            raise FileNotFoundError(
                f"{index_path}: not a token dataset (write one with "
                f"data.write_token_shards or native/tokpack)") from e
        if index.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"{index_path}: format version {index.get('version')!r}"
                f" != {FORMAT_VERSION}")
        self.directory = directory
        self._maps = []
        self._starts = []  # logical start offset of each shard
        total = 0
        for entry in index["shards"]:
            path = os.path.join(directory, entry["name"])
            m = np.memmap(path, dtype=_DTYPE, mode="r")
            if m.size != entry["tokens"]:
                raise ValueError(
                    f"{path}: {m.size} tokens on disk != "
                    f"{entry['tokens']} in index (stale index.json?)")
            self._maps.append(m)
            self._starts.append(total)
            total += m.size
        if total == 0:
            raise ValueError(f"{directory}: dataset has 0 tokens")
        self.total_tokens = total

    def read(self, start: int, n: int) -> np.ndarray:
        """``n`` tokens at logical offset ``start`` (modular)."""
        out = np.empty((n,), dtype=np.uint32)
        filled = 0
        pos = int(start) % self.total_tokens
        while filled < n:
            shard_i = int(
                np.searchsorted(self._starts, pos, side="right") - 1)
            m = self._maps[shard_i]
            off = pos - self._starts[shard_i]
            take = min(n - filled, m.size - off)
            out[filled:filled + take] = m[off:off + take]
            filled += take
            pos = (pos + take) % self.total_tokens
        return out
