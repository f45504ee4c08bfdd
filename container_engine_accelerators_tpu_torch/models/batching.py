"""Continuous-batching decode engine (slot-based serving) — counterpart of
``container_engine_accelerators_tpu/models/batching.py`` (``bucket_len``,
``DecodeEngine`` with its prefix-cache branch, ``SpecDecodeEngine``,
``EngineLoop`` and the mesh branch).

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

A request may start from a cached prefix block (``submit(prefix=)``):
its lane is the block copied into a fresh lane, and its prompt ids are
the suffix.  ``SpecDecodeEngine`` runs speculative rounds over the fleet
(``models/speculative.py::spec_round``) with a parallel draft-cache
fleet.

The mesh branch (``serve_lm --tp --slots``): over a model sharded on a
(1, tp) mesh, the fleet cache holds this rank's KV heads when the model
axis divides them (``generate.init_cache``; else every head, with a
warning), and the cursor, token and live-lane vectors are whole on every
rank.  JAX drives every chip from one process; here each rank is a
process with an engine of its own, and every rank must make the same
engine calls in the same order, since each forward is a collective.
Rank 0's ``EngineLoop`` sends each batch of jobs it is about to advance
through ``on_advance`` before it submits and steps (``cmd/serve_lm.py``
broadcasts them), and each other rank repeats the same
:func:`follow_advance` on its own engine.  A submit the engine refuses
(too long for a slot) is refused on every rank alike, before any
collective, so no rank waits on a step another will not take.

An ``EngineLoop`` job that starts from a cached prefix names it by its
token ids (``prefix_ids``), and the stepper looks the block up
(``resolve_prefix``) as it submits the job, so jobs that miss the same
prefix together build it once.  On a mesh each rank looks it up in its
own prefix cache, whose entries hold its KV heads, at the same point of
the same sequence of calls, so a miss's prefill — a collective — runs
on every rank together.
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
    prefill_chunked,
    prefill_continue,
    prefix_bucket_len,
    sample_token,
    splice_prefix,
)
from container_engine_accelerators_tpu_torch.models.speculative import (
    spec_round,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import local_heads
from container_engine_accelerators_tpu_torch.utils.profile import (
    count,
    recording,
    span,
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


def _prefill_lane(model, prompt, prompt_len, max_len, prefix=None,
                  chunk=None):
    """Batch-1 prefill of a bucket-padded prompt into a fresh one-lane
    cache -> (cache cued at the request's depth, last logits [1, V]).
    With ``prefix=(block, prefix_len)`` the block is copied into the lane
    and ``prompt`` is the suffix (the one copy of the splice rule for
    lanes); else ``chunk`` prefills in pieces (``prefill_chunked``)."""
    if prefix is not None:
        block, prefix_len = prefix
        cache = init_cache(model, 1, max_len, prompt.device)
        splice_prefix(cache, block, prefix_len, 1)
        return prefill_continue(model, cache, prompt, prefix_len,
                                prefix_len + prompt_len)
    if chunk:
        return prefill_chunked(model, prompt, prompt_len, max_len, chunk)
    return prefill(model, prompt, prompt_len, max_len)


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
    ``bucket(prompt) <= max_len`` and ``prompt_len + max_new <= max_len``
    (plus the prefix's depth, and ``_margin``).  ``prefill_chunk``
    prefills a prompt without a prefix in pieces of that many tokens
    (same tokens).  The engine is single-threaded (:class:`EngineLoop`
    serializes access) and runs under ``torch.inference_mode``, which
    each method enters itself: grad mode is per thread.  ``steps``
    counts fleet steps.
    """

    # Extra tail slots a request must leave free in its lane; the
    # speculative subclass sets this to k (a final verify round may
    # write up to k positions past the last emitted token).
    _margin = 0

    def __init__(self, model, max_slots: int, max_len: int,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
        if not getattr(model, "decode", False):
            raise ValueError("DecodeEngine needs a model with decode=True")
        self.model = model
        self.max_slots, self.max_len = max_slots, max_len
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.device = model.embed.device
        mesh = model.mesh
        if mesh is not None and local_heads(mesh, model.num_kv_heads) \
                == model.num_kv_heads and mesh.size() > 1:
            # Per-rank cache memory does not shrink with tp: an operator
            # who sized slots for sharded lanes must hear about it.
            log.warning("fleet KV heads (%d) do not divide the model axis; "
                        "cache replicated on every rank",
                        model.num_kv_heads)
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
    def submit(self, prompt_ids: List[int], max_new: int, prefix=None,
               temperature: float = 0.0, seed: int = 0) -> int:
        """Claim a free slot, prefill it, emit the first token.  Returns a
        request id; raises if the fleet is full or the request does not
        fit a slot.

        ``prefix`` is an optional ``(block, prefix_len)`` entry of a
        ``PrefixCache`` on this engine's model: the lane starts from a
        copy of the block and ``prompt_ids`` are the SUFFIX — the
        per-request prefix path's tokens.

        ``temperature > 0`` makes this a sampled lane on its own
        ``torch.Generator`` seeded with ``seed``: its tokens equal
        per-request ``generate(..., temperature, generator)`` with a
        generator seeded alike, whatever else shares the fleet.
        """
        if not self._free:
            raise RuntimeError("no free slot — step() until one drains")
        plen = len(prompt_ids)
        bucket = bucket_len(plen, self.max_len)
        start = 0
        if prefix is not None:
            start = int(prefix[1])
            # The suffix block writes slots [start, start + bucket); the
            # port's cache write raises past the lane, so an over-long
            # request is refused up front.
            pfx_bucket = prefix_bucket_len(prefix[0])
            if pfx_bucket > self.max_len or start + bucket > self.max_len:
                raise ValueError(
                    f"spliced request needs prefix bucket {pfx_bucket} and "
                    f"suffix bucket slots [{start}, {start + bucket}); slot "
                    f"holds {self.max_len}")
        # The capacity guard is also the frozen-cursor invariant: the
        # lane's cursor ends below start + plen + max_new + _margin <=
        # max_len, and a retired lane keeps writing at that cursor every
        # fleet step.
        if (plen > bucket
                or start + plen + max_new + self._margin > self.max_len):
            raise ValueError(f"request needs {start}+{plen}+{max_new}+"
                             f"{self._margin} tokens; slot holds "
                             f"{self.max_len}")
        slot = self._free.pop()
        with span("lm.engine.submit"):
            with span("lm.engine.submit.prefill"):
                prompt = torch.tensor(
                    [list(prompt_ids) + [0] * (bucket - plen)],
                    dtype=torch.long, device=self.device)
                slot_cache, last = _prefill_lane(self.model, prompt, plen,
                                                 self.max_len, prefix,
                                                 self.prefill_chunk)
            count("lm.engine.prefill.prompt_tokens", plen)
            count("lm.engine.prefill.pad_tokens", bucket - plen)
            with span("lm.engine.submit.insert"):
                sampled = bool(temperature and temperature > 0)
                generator = None
                if sampled:
                    generator = torch.Generator(
                        device=self.device).manual_seed(int(seed))
                    tok0 = sample_token(last, temperature, generator)
                else:
                    tok0 = last.argmax(-1)
                _insert_slot(self.cache, self.pos, self.last_tok,
                             self.active, slot_cache, tok0, slot,
                             start + plen)
                self._insert_aux(slot, prompt, plen)
            rid = self._next_id
            self._next_id += 1
            with span("lm.engine.submit.read"):
                first = int(tok0[0])
            # ``prefilled``: the rows the prefill left in the lane; each
            # fleet step adds one.
            self._req[slot] = {"id": rid, "tokens": [first],
                               "remaining": max_new - 1,
                               "generator": generator,
                               "temperature": temperature,
                               "prefilled": start + plen}
            if self._req[slot]["remaining"] <= 0 or first == self.eos_id:
                self._retire(slot)
        return rid

    def _insert_aux(self, slot: int, prompt, plen) -> None:
        """Subclass hook: extra per-lane state for a freshly claimed slot
        (the speculative engine prefills its draft lane here)."""

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
        with span("lm.engine.step"):
            with span("lm.engine.step.dispatch"):
                sampled = {slot: (r["generator"], r["temperature"])
                           for slot, r in self._req.items()
                           if r["generator"] is not None}
                self.pos, self.last_tok, nxt = _fleet_step(
                    self.model, self.cache, self.pos, self.last_tok,
                    self.active, sampled)
            self.steps += 1
            with span("lm.engine.step.read"):
                tokens = nxt.tolist()
            if recording():
                # The rows each live lane holds once this step has
                # written its token, against the rows the fleet reserves.
                count("lm.engine.kv.used_rows",
                      sum(r["prefilled"] + len(r["tokens"])
                          for r in self._req.values()))
                count("lm.engine.kv.reserved_rows",
                      self.max_slots * self.max_len)
            with span("lm.engine.step.retire"):
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

    def drop_results(self) -> None:
        """Forget every finished request's tokens (a follower rank's
        engine, whose results nobody reads)."""
        self._results.clear()

    def take_result(self, rid: int) -> Optional[List[int]]:
        """Like :meth:`result` but removes the entry — long-running
        servers must take, not peek, or finished requests accumulate for
        the process lifetime."""
        return self._results.pop(rid, None)


class SpecDecodeEngine(DecodeEngine):
    """Speculative continuous batching: each :meth:`step` is one
    speculative round for every live slot — the draft fleet proposes
    ``k`` tokens per slot (k+1 single-token steps over a parallel
    draft-cache fleet, through flash decode on ragged lanes), the target
    verifies all slots in ONE [slots, k+1] forward, and each slot accepts
    its longest matching prefix plus the target's own token — the
    per-slot form of ``generate_speculative``'s round
    (``speculative.spec_round``), so the fleet's greedy tokens are the
    per-request path's.

    Cursor discipline: ``pos[slot]`` advances by ``m+1``; both caches'
    cursors are set to each lane's position before every round, stale
    draft/verify writes past it being dead slots.  A final round may
    write up to ``k`` positions past the last token a request keeps, so
    admission reserves ``_margin = k`` tail slots; a lane that is not
    live is parked at position 0 for the round, so its writes stay inside
    the lane (the port's cache write raises past it, where flax clamps).

    ``prefix`` in :meth:`submit` is ``(target_block, draft_block,
    prefix_len)`` — each model's own block, as in
    ``generate_speculative(prefix=)``.  Sampled lanes (``temperature >
    0``) run the rejection round on their own generators, greedy lanes
    the argmax round, in one fleet.  ``spec_rounds`` / ``spec_drafted``
    / ``spec_accepted`` accumulate the acceptance telemetry (live slots
    only).
    """

    def __init__(self, model, draft_model, max_slots: int, max_len: int,
                 k: int = 4, eos_id: Optional[int] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        if not getattr(draft_model, "decode", False):
            raise ValueError("SpecDecodeEngine needs a decode=True draft")
        self.draft_model = draft_model
        self.k = k
        self._margin = k
        self._draft_prefix = None  # a submit's (draft block, prefix_len)
        super().__init__(model, max_slots, max_len, eos_id)
        with torch.inference_mode():
            self.d_cache = init_cache(draft_model, max_slots, max_len,
                                      self.device)
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    def submit(self, prompt_ids: List[int], max_new: int, prefix=None,
               temperature: float = 0.0, seed: int = 0) -> int:
        self._draft_prefix = None
        if prefix is not None:
            t_block, d_block, prefix_len = prefix
            self._draft_prefix = (d_block, prefix_len)
            prefix = (t_block, prefix_len)
        return super().submit(prompt_ids, max_new, prefix=prefix,
                              temperature=temperature, seed=seed)

    def _insert_aux(self, slot: int, prompt, plen) -> None:
        lane, _ = _prefill_lane(self.draft_model, prompt, plen, self.max_len,
                                self._draft_prefix)
        _lane_put(self.d_cache, lane, slot)

    @torch.inference_mode()
    def step(self) -> int:
        """One speculative round for the whole fleet; returns the live
        slot count."""
        if not self._req:
            return 0
        sampled = {slot: (r["generator"], r["temperature"])
                   for slot, r in self._req.items()
                   if r["generator"] is not None}
        pos = torch.where(self.active, self.pos, torch.zeros_like(self.pos))
        _rewind_cache_index(self.cache, pos)
        _rewind_cache_index(self.d_cache, pos)
        tokens, m = spec_round(self.model, self.draft_model, self.cache,
                               self.d_cache, pos, self.last_tok, self.k,
                               sampled)
        nxt = tokens.gather(1, m[:, None])[:, 0]
        self.pos = torch.where(self.active, self.pos + m.to(self.pos.dtype)
                               + 1, self.pos)
        self.last_tok = torch.where(self.active, nxt, self.last_tok)
        self.steps += 1
        self.spec_rounds += 1
        rows, accepts = tokens.tolist(), m.tolist()
        for slot in list(self._req):
            req = self._req[slot]
            acc = accepts[slot]
            self.spec_drafted += self.k
            self.spec_accepted += acc
            for tok in rows[slot][:acc + 1]:
                req["tokens"].append(tok)
                req["remaining"] -= 1
                if req["remaining"] <= 0 or tok == self.eos_id:
                    self._retire(slot)
                    break
        return len(self._req)


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

    def __init__(self, engine: DecodeEngine, on_advance=None,
                 resolve_prefix=None):
        self.engine = engine
        # Called with each batch of jobs before it is advanced (the mesh
        # branch's broadcast to the follower ranks).
        self.on_advance = on_advance
        # A job's prefix ids -> the engine's submit ``prefix``.
        self.resolve_prefix = resolve_prefix
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
                    if self.on_advance is not None:
                        self.on_advance(jobs)
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
                rid = _submit(self.engine, job, self.resolve_prefix)
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
                 timeout: float = 300.0, prefix_ids=None,
                 temperature: float = 0.0, seed: int = 0) -> List[int]:
        """Submit and block until done; returns the generated tokens."""
        return self.generate_many([prompt_ids], max_new, timeout,
                                  prefix_ids=prefix_ids,
                                  temperature=temperature, seeds=[seed])[0]

    def generate_many(self, prompts: List[List[int]], max_new: int,
                      timeout: float = 300.0, prefix_ids=None,
                      temperature: float = 0.0,
                      seeds=None) -> List[List[int]]:
        """Run several prompts CONCURRENTLY across the fleet and return
        their generated tokens in input order.  Each prompt joins as soon
        as a slot frees (earlier prompts keep decoding meanwhile), so k
        prompts on a k-slot engine cost about one request's wall clock,
        not k.  ``prefix_ids`` starts every prompt from the cached
        prefix block of those ids, looked up through ``resolve_prefix``
        when the job is submitted, the prompts being suffixes.
        ``temperature > 0`` makes every prompt a sampled lane on its own
        ``seeds[i]`` generator."""
        if seeds is None:
            seeds = list(range(len(prompts)))
        ids = None if prefix_ids is None else tuple(prefix_ids)
        jobs = [{"prompt": list(p), "max_new": max_new, "prefix_ids": ids, "temperature": temperature, "seed": s,
                 "tokens": None}
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


def _submit(engine, job, resolve_prefix):
    """Submit one job, its prefix looked up by its ids when it names
    one."""
    prefix = (None if job["prefix_ids"] is None
              else resolve_prefix(job["prefix_ids"]))
    return engine.submit(job["prompt"], job["max_new"], prefix=prefix,
                         temperature=job["temperature"], seed=job["seed"])


def job_args(jobs) -> List[dict]:
    """What a follower rank needs of a batch of :class:`EngineLoop` jobs
    to repeat it: each job's prompt, ``max_new``, prefix ids, temperature
    and seed."""
    return [{k: j[k] for k in ("prompt", "max_new", "prefix_ids",
                                   "temperature", "seed")}
            for j in jobs]


@torch.inference_mode()
def follow_advance(engine: DecodeEngine, jobs: List[dict],
                   resolve_prefix=None) -> None:
    """A follower rank's copy of ``EngineLoop._advance`` on rank 0's
    ``job_args``: the same submits (a refused one refused alike; a prefix
    looked up by its ids in this rank's cache through
    ``resolve_prefix``), the same fleet step, the results dropped."""
    for job in jobs:
        try:
            _submit(engine, job, resolve_prefix)
        except ValueError:
            pass
    if engine.live:
        engine.step()
    engine.drop_results()
