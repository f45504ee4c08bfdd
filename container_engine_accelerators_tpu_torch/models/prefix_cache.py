"""Prefix caching: prefill a shared prompt prefix once, reuse its KV
across requests — counterpart of
``container_engine_accelerators_tpu/models/prefix_cache.py``.

Serving fleets front most requests with the same system prompt; plain
``generate()`` re-runs the full prefill for every request.  This module
keeps the prefix's KV block after one prefill and copies it into each
request's fresh cache, so the per-request prefill covers only the
suffix:

- the stored block is the prefix prefill's one-lane cache at its
  power-of-two BUCKET length; slots beyond the true ``prefix_len`` hold
  dead pad KV;
- ``generate.splice_prefix`` copies the block into slots [0, bucket) of
  the request's zero cache and cues the cursor at ``prefix_len``; the
  suffix continues through ``generate.prefill_continue`` at positions
  ``prefix_len + arange(S)`` and decode proceeds normally;
- dead slots (prefix pad, suffix pad, anything beyond the cursor) are
  invisible by the slot <= position mask until overwritten in order.

The port's forward writes the cache in place, so the splice must copy:
an entry aliased into a request's cache would take that request's suffix
K/V, and the next hit would read them.  Entries stay byte-identical
across requests (``tests/test_torch_prefix_cache.py``).

Exactness contract: splice + suffix prefill + decode == ``generate()``
over the concatenated prompt, token for token.
"""

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from container_engine_accelerators_tpu_torch.models.batching import bucket_len
from container_engine_accelerators_tpu_torch.models.generate import (
    _positions,
    decode_loop,
    init_cache,
    prefill,
    prefill_continue,
    prefix_bucket_len,
    splice_prefix,
)


def generate_with_prefix(model, prefix_kv, prefix_len, suffix,
                         max_new_tokens: int, temperature=0.0,
                         generator: Optional[torch.Generator] = None,
                         suffix_len=None):
    """Generate past (cached prefix + ``suffix`` [B, S]) -> [B, S+N].

    ``prefix_kv`` is a :class:`PrefixCache` entry's block (its bucket
    length read from its shape; it is copied, never written);
    ``suffix_len`` has ``generate()``'s bucket-padding semantics.  Output
    mirrors ``generate()`` with the suffix as the prompt: positions
    ``[0, suffix_len)`` echo the suffix, ``[suffix_len, suffix_len + N)``
    are generated — the caller re-attaches the prefix ids.
    """
    if not getattr(model, "decode", False):
        raise ValueError(
            "generate_with_prefix() needs a model built with decode=True")
    b, s = suffix.shape
    if suffix_len is None:
        suffix_len = s
    total = prefix_bucket_len(prefix_kv) + s + max_new_tokens
    cache = init_cache(model, b, total, suffix.device)
    splice_prefix(cache, prefix_kv, prefix_len, b)
    end = prefix_len + suffix_len
    cache, last = prefill_continue(model, cache, suffix, prefix_len, end)
    gen = decode_loop(model, cache, last, end, max_new_tokens, temperature,
                      generator, suffix.dtype)
    out = torch.cat([suffix, torch.zeros((b, max_new_tokens),
                                         dtype=suffix.dtype,
                                         device=suffix.device)], dim=1)
    out[:, _positions(suffix_len, max_new_tokens, suffix.device).long()] = gen
    return out


class PrefixCache:
    """Host-side LRU of prefilled prefix KV blocks on ``model``'s device,
    keyed by the exact token tuple.  Thread-safe for serving handlers;
    misses build outside the lock (two racing misses on the same new
    prefix cost one redundant prefill, never a wrong entry)."""

    def __init__(self, model, max_prefix_len: int, max_entries: int = 8):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.model = model
        self.max_prefix_len = max_prefix_len
        self.max_entries = max_entries
        self._store = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _build(self, ids):
        bucket = bucket_len(len(ids), self.max_prefix_len)
        padded = torch.tensor([list(ids) + [0] * (bucket - len(ids))],
                              dtype=torch.long,
                              device=self.model.embed.device)
        with torch.inference_mode():
            return prefill(self.model, padded, len(ids), bucket)[0]

    def get_or_build(self, ids: Tuple[int, ...]):
        """-> (prefix block, prefix_len) for the exact prefix ``ids``.

        ``ids`` longer than ``max_prefix_len`` are rejected (the caller
        decides how to degrade — serve_lm concatenates instead)."""
        ids = tuple(int(t) for t in ids)
        if not ids or len(ids) > self.max_prefix_len:
            raise ValueError(f"prefix length {len(ids)} outside (0, "
                             f"{self.max_prefix_len}]")
        with self._lock:
            entry = self._store.get(ids)
            if entry is not None:
                self._store.move_to_end(ids)
                self.hits += 1
                return entry
            self.misses += 1
        entry = (self._build(ids), len(ids))
        with self._lock:
            self._store[ids] = entry
            self._store.move_to_end(ids)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)
                self.evictions += 1
        return entry

    def __len__(self):
        with self._lock:
            return len(self._store)

    def stats(self):
        with self._lock:
            return {"entries": len(self._store), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}
