"""Continuous-batching decode engine (slot-based serving) — counterpart of
``container_engine_accelerators_tpu/models/batching.py`` (``bucket_len``,
``DecodeEngine`` and ``EngineLoop``; its prefix-cache and mesh branches,
and ``SpecDecodeEngine``, come with later serving slices of the port).

Per-request ``generate()`` leaves the card idle between requests and pays
each request's decode serially.  This engine keeps one single-token step
running over a fixed fleet of ``max_slots`` decode lanes: a request joins
a free slot mid-flight (a batch-1 prefill, then its K/V lives in that
slot's lane of the fleet cache) and leaves when done.

The model hooks that make this possible (``models/transformer.py``):
``cache_index`` is a per-lane cursor, ``positions`` may be [B, T], and
flash decode takes per-lane lengths — every slot sits at its own depth in
the same step.  Inactive slots still compute (fixed shapes) but their
state is frozen and their lane is fully overwritten at the next insert,
so nothing leaks between requests.  Two rules of the port's cache keep a
frozen lane harmless: its cursor stays below ``max_len`` (a cache write
past the buffer raises, where flax clamps) and its position at or above
0 (flash decode attends ``position + 1`` keys; a length of 0 would give
NaN).

Greedy decode is token-identical to per-request ``generate()`` in f32.
The fleet's [slots, 1, D] products may round differently from
``generate()``'s [1, 1, D] ones, so in bf16 an argmax near a tie can
flip (the JAX module's own caveat).  A sampled lane draws from its own
``torch.Generator``, seeded at submit, one [1, V] ``torch.rand`` per
token, as per-request sampling does: its tokens do not depend on what
else shares the fleet.
"""

import collections
import logging
import threading
import time
from typing import Dict, List, Optional

import torch

from container_engine_accelerators_tpu_torch.models.generate import (
    _rewind_cache_index,
    init_cache,
    prefill,
    sample_token,
)

log = logging.getLogger(__name__)


def bucket_len(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped (one shape per bucket)."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _lane_put(full, one, slot):
    """Overwrite lane ``slot`` of a fleet cache with a one-lane cache, in
    place.  The slot axis is every cache leaf's second axis (the layer
    axis precedes it)."""
    for name, leaf in full.items():
        leaf[:, slot] = one[name][:, 0].to(leaf.dtype)
    return full


def _prefill_slot(model, prompt, prompt_len, max_len):
    """Batch-1 prefill of a bucket-padded prompt into a fresh one-lane
    cache -> (cache cued at ``prompt_len``, greedy first token [1])."""
    cache, last = prefill(model, prompt, prompt_len, max_len)
    return cache, last.argmax(-1)


def _prefill_slot_sampled(model, prompt, prompt_len, max_len, generator,
                          temperature):
    """As :func:`_prefill_slot`, the first token drawn from the request's
    own generator, exactly as per-request sampling draws it."""
    cache, last = prefill(model, prompt, prompt_len, max_len)
    return cache, sample_token(last, temperature, generator)


def _insert_slot(cache, pos, last_tok, active, slot_cache, tok0, slot,
                 start_pos):
    """Claim lane ``slot`` for a prefilled request (in place)."""
    _lane_put(cache, slot_cache, slot)
    pos[slot] = start_pos
    last_tok[slot] = tok0[0]
    active[slot] = True


def _fleet_step(model, cache, pos, last_tok, active, sampled):
    """One single-token decode step for the whole fleet, mixed greedy and
    sampled -> (new positions, new last tokens, this step's tokens).

    Greedy slots take the argmax.  ``sampled`` maps each active sampled
    slot to its (generator, temperature): that slot's token is drawn from
    its own generator on its own [1, V] row, so a lane's random stream
    advances only while it is sampled and active.  An all-greedy fleet
    draws nothing.
    """
    logits = model(last_tok[:, None], positions=pos[:, None], cache=cache)
    row = logits[:, 0, :]
    nxt = row.argmax(-1)
    for slot, (generator, temperature) in sampled.items():
        nxt[slot] = sample_token(row[slot:slot + 1], temperature,
                                 generator)[0]
    new_pos = torch.where(active, pos + 1, pos)
    new_tok = torch.where(active, nxt, last_tok)
    # The model advanced every lane's write cursor; re-pin each to its
    # lane's position so frozen (inactive) lanes stay frozen.  (Their
    # write this step landed inside their own lane, at their cursor,
    # which the next insert overwrites wholesale.)
    _rewind_cache_index(cache, new_pos)
    return new_pos, new_tok, nxt


class DecodeEngine:
    """Fixed-fleet continuous-batching decoder over a decode-mode
    ``TransformerLM`` (which holds its weights).

    ``max_len`` is each slot's cache length: every request needs
    ``bucket(prompt) <= max_len`` and ``prompt_len + max_new <= max_len``.
    The engine is single-threaded (:class:`EngineLoop` serializes access)
    and runs under ``torch.inference_mode``, which each method enters
    itself: grad mode is per thread.  ``steps`` counts fleet steps.
    """

    def __init__(self, model, max_slots: int, max_len: int,
                 eos_id: Optional[int] = None):
        if not getattr(model, "decode", False):
            raise ValueError("DecodeEngine needs a model with decode=True")
        self.model = model
        self.max_slots, self.max_len = max_slots, max_len
        self.eos_id = eos_id
        self.device = model.embed.device
        with torch.inference_mode():
            self.cache = init_cache(model, max_slots, max_len, self.device)
            self.pos = torch.zeros(max_slots, dtype=torch.int32,
                                   device=self.device)
            self.last_tok = torch.zeros(max_slots, dtype=torch.long,
                                        device=self.device)
            self.active = torch.zeros(max_slots, dtype=torch.bool,
                                      device=self.device)
        self.steps = 0
        self._free = list(range(max_slots))
        self._req: Dict[int, dict] = {}  # slot -> {id, tokens, remaining}
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live(self) -> int:
        """Requests in flight."""
        return len(self._req)

    @torch.inference_mode()
    def submit(self, prompt_ids: List[int], max_new: int,
               temperature: float = 0.0, seed: int = 0) -> int:
        """Claim a free slot, prefill it, emit the first token.  Returns a
        request id; raises if the fleet is full or the request does not
        fit a slot.

        ``temperature > 0`` makes this a sampled lane on its own
        ``torch.Generator`` seeded with ``seed``: its tokens equal
        per-request ``generate(..., temperature, generator)`` with a
        generator seeded alike, whatever else shares the fleet.
        """
        if not self._free:
            raise RuntimeError("no free slot — step() until one drains")
        plen = len(prompt_ids)
        bucket = bucket_len(plen, self.max_len)
        # The capacity guard is also the frozen-cursor invariant: the
        # lane's cursor ends at plen + max_new - 1 < max_len, and a
        # retired lane keeps writing at that cursor every fleet step.
        if plen > bucket or plen + max_new > self.max_len:
            raise ValueError(f"request needs {plen}+{max_new} tokens; slot "
                             f"holds {self.max_len}")
        slot = self._free.pop()
        prompt = torch.tensor([list(prompt_ids) + [0] * (bucket - plen)],
                              dtype=torch.long, device=self.device)
        sampled = bool(temperature and temperature > 0)
        generator = None
        if sampled:
            generator = torch.Generator(device=self.device).manual_seed(
                int(seed))
            slot_cache, tok0 = _prefill_slot_sampled(
                self.model, prompt, plen, self.max_len, generator,
                temperature)
        else:
            slot_cache, tok0 = _prefill_slot(self.model, prompt, plen,
                                             self.max_len)
        _insert_slot(self.cache, self.pos, self.last_tok, self.active,
                     slot_cache, tok0, slot, plen)
        rid = self._next_id
        self._next_id += 1
        first = int(tok0[0])
        self._req[slot] = {"id": rid, "tokens": [first],
                           "remaining": max_new - 1,
                           "generator": generator,
                           "temperature": temperature}
        if self._req[slot]["remaining"] <= 0 or first == self.eos_id:
            self._retire(slot)
        return rid

    def _retire(self, slot: int):
        req = self._req.pop(slot)
        self._results[req["id"]] = req["tokens"]
        self.active[slot] = False
        self._free.append(slot)

    @torch.inference_mode()
    def step(self) -> int:
        """One decode step for the whole fleet; returns live-slot count."""
        if not self._req:
            return 0
        sampled = {slot: (r["generator"], r["temperature"])
                   for slot, r in self._req.items()
                   if r["generator"] is not None}
        self.pos, self.last_tok, nxt = _fleet_step(
            self.model, self.cache, self.pos, self.last_tok, self.active,
            sampled)
        self.steps += 1
        tokens = nxt.tolist()
        for slot in list(self._req):
            req = self._req[slot]
            tok = tokens[slot]
            req["tokens"].append(tok)
            req["remaining"] -= 1
            if req["remaining"] <= 0 or tok == self.eos_id:
                self._retire(slot)
        return len(self._req)

    def run_until_drained(self, max_steps: int = 100_000):
        for _ in range(max_steps):
            if self.step() == 0:
                return
        raise RuntimeError("engine did not drain")

    def result(self, rid: int) -> Optional[List[int]]:
        """Generated tokens (first token included) once finished."""
        return self._results.get(rid)

    def take_result(self, rid: int) -> Optional[List[int]]:
        """Like :meth:`result` but removes the entry — long-running
        servers must take, not peek, or finished requests accumulate for
        the process lifetime."""
        return self._results.pop(rid, None)


class EngineLoop:
    """Thread-safe request facade + one background stepper thread for a
    :class:`DecodeEngine`.

    Handler threads call :meth:`generate` / :meth:`generate_many`, which
    queue their prompts and wait on one condition variable.  The stepper
    thread alone touches the engine: it submits queued prompts as slots
    free, steps the fleet while any lane is live, and posts each finished
    request's tokens.  The engine stays single-threaded, and the device
    work runs outside the lock, so a request joins the fleet while others
    decode (a stepper that held the lock across steps could starve the
    handlers until the fleet drained: a released lock is not handed to a
    waiter).
    """

    def __init__(self, engine: DecodeEngine):
        self.engine = engine
        self.cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._running: Dict[int, dict] = {}  # request id -> job
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-engine-loop")
        self._thread.start()

    def _loop(self):
        # Grad mode is thread-local: this thread enters its own.
        with torch.inference_mode():
            while True:
                with self.cond:
                    while not (self._queue or self._running
                               or self._closed):
                        self.cond.wait()
                    if self._closed:
                        return
                    jobs = [self._queue.popleft() for _ in range(
                        min(len(self._queue), self.engine.free_slots))]
                try:
                    done = self._advance(jobs)
                except Exception as e:  # noqa: BLE001 — reported to waiters
                    log.exception("decode engine failed")
                    with self.cond:
                        self._error = e
                        self.cond.notify_all()
                    return
                with self.cond:
                    for job, key, value in done:
                        job[key] = value
                    self.cond.notify_all()

    def _advance(self, jobs):
        """Submit ``jobs``, take one fleet step, and return the finished
        jobs as (job, "tokens", tokens) — or (job, "error", error) for a
        request the engine refused (too long for a slot), which fails
        alone."""
        done = []
        for job in jobs:
            try:
                rid = self.engine.submit(job["prompt"], job["max_new"],
                                         temperature=job["temperature"],
                                         seed=job["seed"])
            except ValueError as e:
                done.append((job, "error", e))
                continue
            self._running[rid] = job
        if self.engine.live:
            self.engine.step()
        for rid in list(self._running):
            tokens = self.engine.take_result(rid)
            if tokens is not None:
                done.append((self._running.pop(rid), "tokens", tokens))
        return done

    def generate(self, prompt_ids: List[int], max_new: int,
                 timeout: float = 300.0, temperature: float = 0.0,
                 seed: int = 0) -> List[int]:
        """Submit and block until done; returns the generated tokens."""
        return self.generate_many([prompt_ids], max_new, timeout,
                                  temperature=temperature, seeds=[seed])[0]

    def generate_many(self, prompts: List[List[int]], max_new: int,
                      timeout: float = 300.0, temperature: float = 0.0,
                      seeds=None) -> List[List[int]]:
        """Run several prompts CONCURRENTLY across the fleet and return
        their generated tokens in input order.  Each prompt joins as soon
        as a slot frees (earlier prompts keep decoding meanwhile), so k
        prompts on a k-slot engine cost about one request's wall clock,
        not k.  ``temperature > 0`` makes every prompt a sampled lane on
        its own ``seeds[i]`` generator."""
        if seeds is None:
            seeds = list(range(len(prompts)))
        jobs = [{"prompt": list(p), "max_new": max_new,
                 "temperature": temperature, "seed": s, "tokens": None}
                for p, s in zip(prompts, seeds)]
        deadline = time.monotonic() + timeout
        with self.cond:
            if self._closed:
                raise RuntimeError("engine loop is closed")
            self._queue.extend(jobs)
            self.cond.notify_all()
            while not all(j["tokens"] is not None or "error" in j
                          for j in jobs):
                if self._error is not None:
                    raise RuntimeError("decode engine failed") \
                        from self._error
                left = deadline - time.monotonic()
                if left <= 0 or not self.cond.wait(left):
                    for j in jobs:  # drop what never reached a slot
                        if j in self._queue:
                            self._queue.remove(j)
                    raise TimeoutError("generation timed out")
        for j in jobs:
            if "error" in j:
                raise j["error"]
        return [j["tokens"] for j in jobs]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the stepper thread (requests in flight are abandoned)."""
        with self.cond:
            self._closed = True
            self.cond.notify_all()
        self._thread.join(timeout)
