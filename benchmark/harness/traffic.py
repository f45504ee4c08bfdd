"""The one traffic generator: it reads a mix's parameters and draws the
cell's inputs from the seed.

Every seed gets the same sizes in another order: lengths are the
quantiles of the mix's law at (i + 0.5) / n over a block of n requests,
shuffled by the seed, so two seeds differ in which request comes when
and in its token ids, not in how much work a block holds.  Token ids are
uniform over the vocabulary.  Decoding is greedy with no end token, so
every request emits exactly its output length.

Laws: ``{"law": "fixed", "value": n}`` and ``{"law": "log-uniform",
"low": a, "high": b}``, inclusive and rounded to whole tokens.
"""

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch


def _stream(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64), salt])


def grid(law: dict, n: int) -> np.ndarray:
    """The law's n quantiles at (i + 0.5) / n, as whole numbers."""
    q = (np.arange(n) + 0.5) / n
    if law["law"] == "fixed":
        return np.full(n, int(law["value"]))
    if law["law"] != "log-uniform":
        raise ValueError(f"unknown law {law['law']!r}")
    lo, hi = law["low"], law["high"]
    x = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def bounds(law: dict):
    if law["law"] == "fixed":
        return int(law["value"]), int(law["value"])
    return int(law["low"]), int(law["high"])


def train_batches(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """``[batches, batch, seq_len]`` int64 token ids, drawn on the
    device; every row differs."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 101) % (2 ** 63))
    return torch.randint(0, vocab, (mix["batches"], mix["batch"],
                                    mix["seq_len"]),
                         generator=g, device=device)


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_new: int


class ServeTraffic:
    """The mix's request stream, in the order requests are sent: block
    after block of ``mix["block"]`` (prompt, output) pairs, the prompt
    and output quantiles each shuffled by the seed.  With ``"fill":
    "staggered"`` the first ``clients`` requests keep a uniform share of
    their output length (at least one token), so the lanes of a full
    fleet retire spread out from the start."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab = mix, vocab
        self.block = int(mix["block"])
        self._plens = grid(mix["prompt_len"], self.block)
        self._outs = grid(mix["output_len"], self.block)
        self._order = _stream(seed, 1)
        self._ids = _stream(seed, 2)
        self._share = _stream(seed, 3)
        self._warm = _stream(seed, 4)
        self._queue: List[tuple] = []
        self.sent = 0

    def _refill(self):
        p = self._order.permutation(self._plens)
        o = self._order.permutation(self._outs)
        self._queue.extend(zip(p.tolist(), o.tolist()))

    def next(self) -> Request:
        if not self._queue:
            self._refill()
        plen, out = self._queue.pop(0)
        if (self.mix.get("fill") == "staggered"
                and self.sent < self.mix["clients"]):
            out = max(1, math.ceil(self._share.uniform(0.0, 1.0) * out))
        ids = self._ids.integers(0, self.vocab, plen).tolist()
        req = Request(self.sent, ids, int(out))
        self.sent += 1
        return req

    def prompt_of_len(self, n: int) -> List[int]:
        """A warm-up prompt of ``n`` ids (from its own stream)."""
        return self._warm.integers(0, self.vocab, n).tolist()
