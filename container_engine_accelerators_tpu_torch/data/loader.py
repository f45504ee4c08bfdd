"""Deterministic batch loaders with background prefetch — a copy of
``container_engine_accelerators_tpu/data/loader.py``: tokens for the LM
trainer, images and labels for the image trainer.

Two properties carry the whole design:

1. **The step->batch mapping is a pure function.**  Row ``r`` of step
   ``s`` is the ``seq_len+1``-token window at logical offset
   ``(s * batch_size + r) * seq_len`` (modular over the dataset), read
   through the memory-mapped :class:`~.tokens.TokenShardReader`.  No
   iterator state exists to checkpoint: resuming a preempted job at
   step ``k`` (models/checkpoint.py restores ``k``) replays exactly the
   batches steps ``k, k+1, ...`` would have seen — data-pipeline resume
   for free, and every host of a pod computes the identical global
   batch (the multi-host contract cmd/train_lm.py's ``globalize``
   already assumes for its synthetic streams).

2. **Prefetch happens off the step path.**  A daemon thread keeps a
   small queue of ready numpy batches while the accelerator runs the
   current step; the reference leaned on tf.data's C++ pipeline for the
   same overlap (demo/gpu-training/generate_job.sh:54-70).

Labels are next-token within the same window (the reader hands out
``seq_len + 1`` tokens), so every position has a real target and the
mask is all-ones — no batch-boundary dead positions.
"""

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from container_engine_accelerators_tpu_torch.data.arrays import ArrayShardReader
from container_engine_accelerators_tpu_torch.data.tokens import TokenShardReader

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _prefetched(batch_fn, start_step: int, num_steps: int,
                prefetch: int) -> Iterator:
    """Yield ``batch_fn(s)`` for s in [start, start+num) in order,
    produced by a background thread.  Producer errors (e.g. vocab
    overflow) are re-raised at the consuming step, not swallowed.

    An abandoned iterator (exception/SystemExit mid-training, partial
    consumption) must not leak the producer: a blocking ``q.put``
    would park the thread forever once the consumer stops draining
    (ADVICE r4), so every put polls a ``closed`` event that the
    consumer's ``finally`` sets — generator close/GC wakes the
    producer within one poll interval and it exits."""
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    closed = threading.Event()

    def put_until_closed(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for s in range(start_step, start_step + num_steps):
                if not put_until_closed(batch_fn(s)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            put_until_closed(e)

    threading.Thread(target=produce, daemon=True,
                     name="tokenloader-prefetch").start()
    try:
        for _ in range(num_steps):
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        closed.set()


class TokenBatchLoader:
    """``shard=(index, count)`` makes ``batch_at`` return only rows
    ``[index * b/count, (index + 1) * b/count)`` of the global batch
    (one data-parallel rank's), as :class:`ImageBatchLoader` does: the
    union over the shards is the global batch, and the mapping stays
    pure."""

    def __init__(self, reader: TokenShardReader, batch_size: int,
                 seq_len: int, vocab_size: Optional[int] = None,
                 prefetch: int = 2, shard: Tuple[int, int] = (0, 1)):
        if batch_size < 1 or seq_len < 1:
            raise ValueError("batch_size and seq_len must be >= 1")
        index, count = shard
        if count < 1 or not 0 <= index < count or batch_size % count:
            raise ValueError(
                f"shard {shard} invalid for batch_size {batch_size}")
        self.shard = shard
        self.reader = reader
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.prefetch = prefetch

    def batch_at(self, step: int) -> Batch:
        """(tokens, labels, mask), each [B, T] (this shard's rows) — pure
        in ``step``."""
        b, t = self.batch_size, self.seq_len
        index, count = self.shard
        rows = b // count
        window = np.stack([
            self.reader.read((step * b + r) * t, t + 1)
            for r in range(index * rows, (index + 1) * rows)
        ])
        peak = int(window.max())
        if peak >= 2**31:
            # The on-disk contract is full-range uint32; int32 batches
            # would wrap this negative and gather a garbage embedding.
            raise ValueError(
                f"dataset token {peak} >= 2**31 overflows the int32 "
                f"batch dtype (step {step})")
        if self.vocab_size is not None and peak >= self.vocab_size:
            raise ValueError(
                f"dataset token {peak} >= model vocab "
                f"{self.vocab_size} (step {step}): retokenize or "
                f"raise --vocab-size")
        tokens = window[:, :-1].astype(np.int32)
        labels = window[:, 1:].astype(np.int32)
        return tokens, labels, np.ones((rows, t), np.float32)

    def iter_batches(self, start_step: int,
                     num_steps: int) -> Iterator[Batch]:
        """Prefetched batches for steps [start, start+num) in order."""
        return _prefetched(self.batch_at, start_step, num_steps,
                           self.prefetch)

    def steps_per_epoch(self) -> int:
        """Steps to consume the dataset once (floor; the modular
        mapping keeps running past it seamlessly)."""
        return max(
            1,
            self.reader.total_tokens
            // (self.batch_size * self.seq_len),
        )



class ImageBatchLoader:
    """Image/label twin of :class:`TokenBatchLoader` — same pure
    step->batch mapping (global batch ``s`` is samples
    ``[s*B, (s+1)*B)``, modular) and the same prefetch thread.

    ``shard=(pid, num_procs)`` makes ``batch_at`` return only this
    process's rows of the global batch — image rows are independent, so
    a host never has to materialize or scale the other hosts' slices.
    The mapping stays a pure function of (step, shard): resume is exact
    and the union over shards is exactly the global batch.

    Batches are NHWC numpy arrays (the trainer permutes them to NCHW,
    ``channels_last``, on the device).  uint8 storage is scaled to
    [0, 1] float32 on the host; float storage passes through as f32.
    ``num_classes`` bounds labels the way ``vocab_size`` bounds tokens.
    """

    def __init__(self, reader: ArrayShardReader, batch_size: int,
                 num_classes: Optional[int] = None, prefetch: int = 2,
                 shard: Tuple[int, int] = (0, 1)):
        pid, num_procs = shard
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if num_procs < 1 or not 0 <= pid < num_procs \
                or batch_size % num_procs:
            raise ValueError(
                f"shard {shard} invalid for batch_size {batch_size}")
        self.reader = reader
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.prefetch = prefetch
        self.shard = shard

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(images [b, ...] f32, labels [b] int32), b = this shard's rows
        — pure in ``step``."""
        pid, num_procs = self.shard
        local = self.batch_size // num_procs
        images, labels = self.reader.read(
            step * self.batch_size + pid * local, local)
        if self.num_classes is not None:
            peak = int(labels.max())
            if peak >= self.num_classes:
                raise ValueError(
                    f"dataset label {peak} >= num_classes "
                    f"{self.num_classes} (step {step})")
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        else:
            images = images.astype(np.float32, copy=False)
        return images, labels

    def iter_batches(self, start_step: int, num_steps: int):
        """Prefetched batches for steps [start, start+num) in order."""
        return _prefetched(self.batch_at, start_step, num_steps,
                           self.prefetch)

    def steps_per_epoch(self) -> int:
        return max(1, self.reader.total_samples // self.batch_size)
