"""The PyTorch port's continuous-batching engine (``models/batching.py``)
on the CPU, mirroring the JAX package's ``tests/test_batching.py``:
interleaved slot-based decoding is token-identical to per-request
``generate()`` (f32) — requests joining mid-flight, at other depths, with
slot reuse, change nothing about any request's output — and, on weights
converted from flax, identical to the JAX package's own ``DecodeEngine``
fed the same submits.  The same holds for lanes that start from a cached
prefix (``submit(prefix=)``) and for ``SpecDecodeEngine``'s speculative
rounds (against per-request ``generate_speculative`` and JAX's
``SpecDecodeEngine``); sampled speculative lanes equal per-request
``generate_speculative_sampled`` on the same seed.

Flash decode runs its plain version here (CPU tensors): the fleet sends
it one length per lane, the ragged batch of the ``--slots`` path.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import batching as jbatching
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.models import prefix_cache as jpc
from container_engine_accelerators_tpu_torch.models.batching import (
    DecodeEngine,
    EngineLoop,
    SpecDecodeEngine,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import (
    _rewind_cache_index,
    generate,
    init_cache,
)
from container_engine_accelerators_tpu_torch.models.prefix_cache import (
    PrefixCache,
    generate_with_prefix,
)
from container_engine_accelerators_tpu_torch.models.speculative import (
    generate_speculative,
    generate_speculative_sampled,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
)

CFG = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8,
           mlp_dim=32, num_kv_heads=2)


@pytest.fixture(scope="module")
def params():
    model = TransformerLM(**CFG, decode=True, dtype=torch.float32,
                          device="cpu")
    return init_params(model, torch.Generator().manual_seed(3))


def _model(sd, flash=False, dtype=torch.float32):
    model = TransformerLM(**CFG, decode=True, dtype=dtype,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["einsum", "flash"])
def model(request, params):
    return _model(params, flash=request.param)


def _solo(model, prompt_ids, n, temperature=0.0, seed=None):
    """Per-request generate()'s generated tokens (the reference)."""
    gen = (torch.Generator().manual_seed(seed) if seed is not None
           else None)
    with torch.inference_mode():
        out = generate(model, torch.tensor([prompt_ids]), n,
                       temperature=temperature, generator=gen)
    return out[0, len(prompt_ids):len(prompt_ids) + n].tolist()


def test_interleaved_requests_match_solo_generate(model):
    eng = DecodeEngine(model, max_slots=3, max_len=32)
    r1 = eng.submit([5, 17, 42], max_new=7)
    eng.step()
    eng.step()
    # r2 joins while r1 is mid-flight, at a different depth and bucket.
    r2 = eng.submit([88, 3], max_new=5)
    eng.step()
    r3 = eng.submit([7, 9, 11, 2, 6], max_new=4)
    eng.run_until_drained()
    assert eng.result(r1) == _solo(model, [5, 17, 42], 7)
    assert eng.result(r2) == _solo(model, [88, 3], 5)
    assert eng.result(r3) == _solo(model, [7, 9, 11, 2, 6], 4)
    assert eng.steps == 6  # r1's 6 steps carried r2's 4 and r3's 3


def test_slot_reuse_is_clean(model):
    """A retired slot's leftover cache must not leak into the next
    request that lands on it (a one-slot engine forces reuse)."""
    eng = DecodeEngine(model, max_slots=1, max_len=32)
    r1 = eng.submit([5, 17, 42], max_new=6)
    eng.run_until_drained()
    r2 = eng.submit([88, 3, 9], max_new=6)
    eng.run_until_drained()
    assert eng.result(r1) == _solo(model, [5, 17, 42], 6)
    assert eng.result(r2) == _solo(model, [88, 3, 9], 6)


def test_fleet_full_and_capacity_guards(params):
    eng = DecodeEngine(_model(params), max_slots=1, max_len=16)
    eng.submit([1, 2], max_new=3)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.submit([3], max_new=2)
    eng.run_until_drained()
    with pytest.raises(ValueError, match="slot holds"):
        eng.submit([1] * 10, max_new=10)  # 10 + 10 > 16
    with pytest.raises(ValueError, match="slot holds"):
        eng.submit([1] * 17, max_new=1)  # longer than the lane
    eng.submit([1] * 8, max_new=8)  # exactly fills the lane
    eng.run_until_drained()
    with pytest.raises(ValueError, match="decode=True"):
        DecodeEngine(TransformerLM(**CFG, device="cpu"), 1, 8)


def test_frozen_lanes_stay_frozen_and_inside_their_lane(params):
    """A retired lane keeps its position and cursor while the fleet
    steps on (the model advances every cursor; the engine re-pins
    them), so its write slot stays below max_len and its length above
    0; lanes never used sit at position 0 (length 1)."""
    eng = DecodeEngine(_model(params, flash=True), max_slots=3, max_len=12)
    short = eng.submit([4, 5, 6, 7, 8, 9], max_new=6)  # lane ends at 11
    long_ = eng.submit([1], max_new=11)
    for _ in range(4):
        eng.step()
    assert eng.result(short) is None
    eng.run_until_drained()
    assert eng.result(short) == _solo(eng.model, [4, 5, 6, 7, 8, 9], 6)
    assert eng.result(long_) == _solo(eng.model, [1], 11)
    pos = eng.pos.tolist()
    assert sorted(pos) == [0, 11, 11]
    assert (eng.cache["cache_index"] == eng.pos[None]).all()
    frozen = eng.submit([3, 3], max_new=3)
    before = eng.pos.tolist()
    eng.run_until_drained()
    after = eng.pos.tolist()
    assert [b for b, a in zip(before, after) if b != a] == [2]
    assert max(after) < eng.max_len and min(after) >= 0
    assert eng.result(frozen) == _solo(eng.model, [3, 3], 3)


def test_rewind_cache_index_takes_a_position_per_lane(params):
    model = _model(params)
    cache = init_cache(model, 3, 8)
    _rewind_cache_index(cache, torch.tensor([1, 5, 2], dtype=torch.int32))
    assert cache["cache_index"].tolist() == [[1, 5, 2]] * 2
    _rewind_cache_index(cache, 4)
    assert cache["cache_index"].tolist() == [[4, 4, 4]] * 2
    _rewind_cache_index(cache, torch.tensor(6))
    assert cache["cache_index"].tolist() == [[6, 6, 6]] * 2


def test_eos_retires_early(model):
    """With eos_id set to a token generate() emits at some step, the
    engine stops that request there."""
    solo = _solo(model, [5, 17, 42], 7)
    eos = solo[3]
    eng = DecodeEngine(model, max_slots=2, max_len=32, eos_id=eos)
    r = eng.submit([5, 17, 42], max_new=7)
    eng.run_until_drained()
    got = eng.result(r)
    assert got == solo[: got.index(eos) + 1]
    assert got[-1] == eos and len(got) <= len(solo)


def test_result_and_take_result(params):
    eng = DecodeEngine(_model(params), max_slots=1, max_len=16)
    rid = eng.submit([2, 3], max_new=1)  # retires inside submit
    assert eng.steps == 0 and eng.result(rid) == eng.take_result(rid)
    assert eng.result(rid) is None and eng.take_result(rid) is None


def test_sampled_lanes_match_per_request_generate(model):
    """A sampled request rides its own generator seeded with its seed:
    its tokens equal per-request generate() with a generator seeded
    alike, for any mix of greedy and sampled lanes, and do not depend on
    the fleet's composition."""
    eng = DecodeEngine(model, max_slots=3, max_len=32)
    r1 = eng.submit([5, 17, 42], max_new=6, temperature=0.7, seed=9)
    eng.step()
    r2 = eng.submit([88, 3], max_new=5)  # greedy joins mid-flight
    eng.step()
    r3 = eng.submit([7, 9, 11], max_new=4, temperature=1.3, seed=4)
    eng.run_until_drained()
    assert eng.result(r1) == _solo(model, [5, 17, 42], 6, 0.7, 9)
    assert eng.result(r2) == _solo(model, [88, 3], 5)
    assert eng.result(r3) == _solo(model, [7, 9, 11], 4, 1.3, 4)
    assert eng.result(r1) != _solo(model, [5, 17, 42], 6, 0.7, 10)

    alone = DecodeEngine(model, max_slots=1, max_len=32)
    ra = alone.submit([5, 17, 42], max_new=6, temperature=0.7, seed=9)
    alone.run_until_drained()
    assert alone.result(ra) == eng.result(r1)


def test_bf16_fleet_agrees_with_per_request_generate(params):
    """bf16: the fleet's products may round differently from batch 1's,
    so ties may flip; at this size every token agrees."""
    model = _model(params, flash=True, dtype=torch.bfloat16)
    eng = DecodeEngine(model, max_slots=4, max_len=32)
    prompts = [[5, 17, 42], [88, 3], [7, 9, 11, 2, 6], [1]]
    rids = [eng.submit(p, max_new=8) for p in prompts]
    eng.run_until_drained()
    for rid, p in zip(rids, prompts):
        assert eng.result(rid) == _solo(model, p, 8)


def test_engine_loop_concurrent_requests_match_solo(model):
    """More threads than slots, all blocking concurrently: every response
    equals its solo generate(), and waiting requests join as slots
    drain."""
    loop = EngineLoop(DecodeEngine(model, max_slots=2, max_len=32))
    prompts = [[5, 17, 42], [88, 3], [7, 9, 11], [2, 6]]
    results = {}

    def ask(i):
        results[i] = loop.generate(prompts[i], 5)

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len(results) == len(prompts)
        for i, p in enumerate(prompts):
            assert results[i] == _solo(model, p, 5), i
        many = loop.generate_many(prompts, 4, temperature=0.9,
                                  seeds=[11, 12, 13, 14])
        for p, got, seed in zip(prompts, many, (11, 12, 13, 14)):
            assert got == _solo(model, p, 4, 0.9, seed)
    finally:
        loop.close()
    assert not loop._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        loop.generate([1], 2)


def test_engine_loop_admits_requests_mid_flight(params):
    """Continuous batching: a short request sent while a long one
    decodes joins the fleet and finishes long before it."""
    model = _model(params)
    eng = DecodeEngine(model, max_slots=2, max_len=160)
    loop = EngineLoop(eng)
    long_done = threading.Event()

    def long_request():
        loop.generate([5, 17, 42], 150)
        long_done.set()

    t = threading.Thread(target=long_request)
    try:
        t.start()
        deadline = time.monotonic() + 60
        while eng.steps == 0:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert loop.generate([88, 3], 3) == _solo(model, [88, 3], 3)
        assert not long_done.is_set()
        t.join(timeout=120)
        assert not t.is_alive() and long_done.is_set()
    finally:
        loop.close()


def test_engine_loop_reports_refused_and_failed_requests(params):
    eng = DecodeEngine(_model(params), max_slots=2, max_len=8)
    loop = EngineLoop(eng)
    try:
        with pytest.raises(ValueError, match="slot holds"):
            loop.generate([1] * 6, 4)
        assert loop.generate([1, 2], 3) == _solo(eng.model, [1, 2], 3)

        def broken():
            raise RuntimeError("device lost")

        eng.step = broken
        with pytest.raises(RuntimeError, match="decode engine failed"):
            loop.generate([1, 2], 3, timeout=60)
    finally:
        loop.close()
    assert not loop._thread.is_alive()


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_greedy_tokens_match_the_jax_engine(flash):
    """The JAX package's DecodeEngine (CPU, f32) and the port's, on the
    same weights (converted from flax) and the same interleaved submits
    and steps, give identical greedy tokens."""
    flax_params = jtr.transformer_lm(**CFG).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))["params"]
    jmodel = jtr.transformer_lm(**CFG, decode=True, dtype=jnp.float32)
    port = _model(from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                          flax_params)),
                  flash=flash)
    engines = (jbatching.DecodeEngine(jmodel, flax_params, max_slots=3,
                                      max_len=32),
               DecodeEngine(port, max_slots=3, max_len=32))
    script = [("submit", [5, 17, 42], 9), ("step",), ("step",),
              ("submit", [88, 3], 6), ("step",),
              ("submit", [7, 9, 11, 2, 6, 1], 5), ("drain",),
              ("submit", [60, 1, 2, 3, 4, 5, 6, 7, 8], 12),
              ("submit", [33], 4), ("drain",)]
    out = []
    for eng in engines:
        rids = []
        for op in script:
            if op[0] == "submit":
                rids.append(eng.submit(op[1], max_new=op[2]))
            elif op[0] == "step":
                eng.step()
            else:
                eng.run_until_drained()
        out.append([eng.result(r) for r in rids])
    assert out[0] == out[1]
    assert [len(r) for r in out[1]] == [9, 6, 5, 12, 4]


# ---- prefix lanes, chunked prefill, speculative rounds --------------------

DRAFT = dict(CFG, num_layers=1)


@pytest.fixture(scope="module")
def flax_pair():
    """(target flax, draft flax, target sd, draft sd), converted."""
    t = jtr.transformer_lm(**CFG).init(
        jax.random.PRNGKey(15), jnp.zeros((1, 8), jnp.int32))["params"]
    d = jtr.transformer_lm(**DRAFT).init(
        jax.random.PRNGKey(16), jnp.zeros((1, 8), jnp.int32))["params"]
    return (t, d) + tuple(from_flax_params(jax.tree_util.tree_map(
        np.asarray, p)) for p in (t, d))


def _draft(sd, flash=False):
    model = TransformerLM(**DRAFT, decode=True, dtype=torch.float32,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


def _run_script(eng, script, prefix=None):
    rids = []
    for op in script:
        if op[0] == "submit":
            kw = dict(op[3]) if len(op) > 3 else {}
            rids.append(eng.submit(op[1], max_new=op[2], prefix=prefix, **kw))
        elif op[0] == "step":
            eng.step()
        else:
            eng.run_until_drained()
    return [eng.result(r) for r in rids]


SCRIPT = [("submit", [5, 17, 42], 9), ("step",), ("submit", [88, 3], 6),
          ("step",), ("submit", [7, 9, 11, 2, 6], 5), ("drain",),
          ("submit", [60, 1, 2, 3, 4, 5, 6], 8), ("submit", [33], 4),
          ("drain",)]


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_prefix_lanes_match_per_request_and_the_jax_engine(flax_pair, flash):
    """Lanes that start from a copy of one cached prefix block (bucket 4,
    three real tokens) give per-request ``generate_with_prefix``'s tokens
    and the JAX engine's on the same submits; the block is unchanged."""
    t_flax, _, t_sd, _ = flax_pair
    model = _model(t_sd, flash=flash)
    pfx = (11, 22, 33)
    block, plen = PrefixCache(model, 8).get_or_build(pfx)
    before = {k: v.clone() for k, v in block.items()}
    got = _run_script(DecodeEngine(model, 3, 8 + 8 + 12), SCRIPT,
                      (block, plen))
    for op, toks in zip([o for o in SCRIPT if o[0] == "submit"], got):
        with torch.inference_mode():
            solo = generate_with_prefix(model, block, plen,
                                        torch.tensor([op[1]]), op[2])
        assert toks == solo[0, len(op[1]):].tolist()
    assert all(torch.equal(block[k], before[k]) for k in before)
    jmodel = jtr.transformer_lm(**CFG, decode=True, dtype=jnp.float32,
                                use_flash_decode=flash)
    jentry = jpc.PrefixCache(jmodel, t_flax, 8).get_or_build(pfx)
    want = _run_script(jbatching.DecodeEngine(jmodel, t_flax, 3, 8 + 8 + 12),
                       SCRIPT, jentry)
    assert got == want


def test_prefix_lane_admission_guards(params):
    model = _model(params)
    block, plen = PrefixCache(model, 8).get_or_build((1, 2, 3, 4, 5))
    eng = DecodeEngine(model, 1, 16)
    with pytest.raises(ValueError, match="spliced request"):
        eng.submit([1] * 12, 1, prefix=(block, plen))  # suffix bucket 16
    with pytest.raises(ValueError, match="slot holds"):
        eng.submit([1, 2], 10, prefix=(block, plen))  # 5 + 2 + 10 > 16
    rid = eng.submit([1, 2], 9, prefix=(block, plen))  # fills the lane
    eng.run_until_drained()
    assert len(eng.result(rid)) == 9


@pytest.mark.parametrize("chunk", [1, 3])
def test_engine_chunked_prefill_same_tokens(params, chunk):
    model = _model(params, flash=True)
    plain = _run_script(DecodeEngine(model, 3, 24), SCRIPT)
    chunked = _run_script(DecodeEngine(model, 3, 24, prefill_chunk=chunk),
                          SCRIPT)
    assert chunked == plain


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_spec_engine_matches_per_request_and_the_jax_engine(flax_pair, flash,
                                                            prefix):
    """Greedy speculative lanes (k=3, a random 1-layer draft): the fleet
    gives per-request ``generate_speculative``'s tokens — the target's
    greedy tokens — and the JAX ``SpecDecodeEngine``'s, with the same
    acceptance telemetry, with and without a spliced prefix."""
    t_flax, d_flax, t_sd, d_sd = flax_pair
    model, draft = _model(t_sd, flash=flash), _draft(d_sd, flash)
    pfx = (11, 22, 33)
    entry = None
    if prefix:
        t_kv, plen = PrefixCache(model, 8).get_or_build(pfx)
        d_kv, _ = PrefixCache(draft, 8).get_or_build(pfx)
        entry = (t_kv, d_kv, plen)
    eng = SpecDecodeEngine(model, draft, 3, 8 + 8 + 12 + 3, k=3)
    got = _run_script(eng, SCRIPT, entry)
    for op, toks in zip([o for o in SCRIPT if o[0] == "submit"], got):
        with torch.inference_mode():
            solo, _ = generate_speculative(model, draft,
                                           torch.tensor([op[1]]), op[2], k=3,
                                           prefix=entry)
            ctx = list(pfx if prefix else ()) + op[1]
            plain = generate(model, torch.tensor([ctx]), op[2])
        assert toks == solo[0, len(op[1]):].tolist()
        assert toks == plain[0, len(ctx):].tolist()
    jmodel = jtr.transformer_lm(**CFG, decode=True, dtype=jnp.float32,
                                use_flash_decode=flash)
    jdraft = jtr.transformer_lm(**DRAFT, decode=True, dtype=jnp.float32,
                                use_flash_decode=flash)
    jentry = None
    if prefix:
        jt, jplen = jpc.PrefixCache(jmodel, t_flax, 8).get_or_build(pfx)
        jd, _ = jpc.PrefixCache(jdraft, d_flax, 8).get_or_build(pfx)
        jentry = (jt, jd, jplen)
    jeng = jbatching.SpecDecodeEngine(jmodel, t_flax, jdraft, d_flax, 3,
                                      8 + 8 + 12 + 3, k=3)
    assert got == _run_script(jeng, SCRIPT, jentry)
    assert (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted) == (
        jeng.spec_rounds, jeng.spec_drafted, jeng.spec_accepted)


def test_spec_engine_sampled_lanes_match_per_request_sampling(flax_pair):
    """Sampled lanes, mixed with greedy ones, run the rejection round on
    their own generators: each equals per-request (batch-1)
    ``generate_speculative_sampled`` on the same seed."""
    _, _, t_sd, d_sd = flax_pair
    model, draft = _model(t_sd, flash=True), _draft(d_sd, True)
    script = [("submit", [5, 17, 42], 9, dict(temperature=0.8, seed=3)),
              ("step",), ("submit", [88, 3], 6),
              ("submit", [7, 9, 11], 7, dict(temperature=1.2, seed=4)),
              ("drain",)]
    got = _run_script(SpecDecodeEngine(model, draft, 3, 32, k=3), script)
    for op, toks in zip([o for o in script if o[0] == "submit"], got):
        kw = op[3] if len(op) > 3 else {}
        with torch.inference_mode():
            if kw:
                solo, _ = generate_speculative_sampled(
                    model, draft, torch.tensor([op[1]]), op[2], k=3,
                    temperature=kw["temperature"],
                    generator=torch.Generator().manual_seed(kw["seed"]))
            else:
                solo, _ = generate_speculative(
                    model, draft, torch.tensor([op[1]]), op[2], k=3)
        assert toks == solo[0, len(op[1]):].tolist()


def test_spec_engine_margin_and_parked_lanes(flax_pair):
    """Admission reserves k tail slots; a retired lane is parked at
    position 0 for the rounds that follow, so every write stays inside
    its lane while the others run on (a self-draft accepts k a round and
    overshoots max_new by up to k)."""
    _, _, t_sd, _ = flax_pair
    model = _model(t_sd, flash=True)
    eng = SpecDecodeEngine(model, model, 2, 16, k=3)
    with pytest.raises(ValueError, match=r"\+3 tokens"):
        eng.submit([1, 2, 3], 11)  # 3 + 11 + 3 > 16
    short = eng.submit([1, 2, 3], 2)
    long_ = eng.submit([4, 5], 11)  # 2 + 11 + 3 == 16: fills the lane
    eng.run_until_drained()
    assert eng.result(short) == _solo(model, [1, 2, 3], 2)
    assert eng.result(long_) == _solo(model, [4, 5], 11)
    assert eng.spec_accepted == eng.spec_drafted
    with pytest.raises(ValueError, match="k must be"):
        SpecDecodeEngine(model, model, 1, 8, k=0)


def test_engine_loop_serves_prefix_and_spec_lanes(flax_pair):
    """Jobs name their prefix by its ids; the stepper looks each up as it
    submits it, so the three jobs build the block once (one miss in each
    model's cache, two hits)."""
    _, _, t_sd, d_sd = flax_pair
    model, draft = _model(t_sd), _draft(d_sd)
    caches = PrefixCache(model, 8), PrefixCache(draft, 8)

    def resolve(ids):
        (block, plen), (d_block, _) = (c.get_or_build(ids) for c in caches)
        return block, d_block, plen

    loop = EngineLoop(SpecDecodeEngine(model, draft, 2, 32, k=2),
                      resolve_prefix=resolve)
    try:
        outs = loop.generate_many([[1, 2], [3], [4, 5, 6]], 5,
                                  prefix_ids=(9, 9))
    finally:
        loop.close()
    for p, got in zip([[1, 2], [3], [4, 5, 6]], outs):
        assert got == _solo(model, [9, 9] + p, 5)
    for c in caches:
        assert (c.stats()["misses"], c.stats()["hits"]) == (1, 2)


# ---- the MoE-LM (drop-free routing) in the fleet ----------------------------

MOE = dict(CFG, num_experts=4)


@pytest.fixture(scope="module")
def moe_flax():
    """(MoE target flax, its dense 1-layer draft flax), and the port's."""
    t = jtr.transformer_lm(**MOE).init(
        jax.random.PRNGKey(25), jnp.zeros((1, 8), jnp.int32))["params"]
    d = jtr.transformer_lm(**DRAFT).init(
        jax.random.PRNGKey(26), jnp.zeros((1, 8), jnp.int32))["params"]
    return (t, d) + tuple(from_flax_params(jax.tree_util.tree_map(
        np.asarray, p)) for p in (t, d))


def _moe_model(sd, flash=False):
    model = TransformerLM(**MOE, decode=True, dtype=torch.float32,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


def test_moe_engine_matches_per_request_and_the_jax_engine(moe_flax):
    """Drop-free routing is per token, so a lane's tokens do not depend on
    the rest of the fleet: the MoE engine gives per-request generate()'s
    greedy tokens and the JAX ``DecodeEngine``'s on the same submits
    (flash decode, the server's path: one length per lane)."""
    t_flax, _, t_sd, _ = moe_flax
    model = _moe_model(t_sd, flash=True)
    got = _run_script(DecodeEngine(model, 3, 32), SCRIPT)
    for op, toks in zip([o for o in SCRIPT if o[0] == "submit"], got):
        assert toks == _solo(model, op[1], op[2])
    jmodel = jtr.transformer_lm(**MOE, decode=True, dtype=jnp.float32,
                                use_flash_decode=True)
    assert got == _run_script(jbatching.DecodeEngine(jmodel, t_flax, 3, 32),
                              SCRIPT)


def test_spec_engine_with_moe_target_and_dense_draft_matches_jax(moe_flax):
    """``tests/test_compose.py:255-283``'s pairing: speculative lanes over
    an MoE target with a dense draft give the target's greedy tokens and
    the JAX ``SpecDecodeEngine``'s, with the same acceptance."""
    t_flax, d_flax, t_sd, d_sd = moe_flax
    model, draft = _moe_model(t_sd), _draft(d_sd)
    eng = SpecDecodeEngine(model, draft, 3, 8 + 12 + 3, k=3)
    got = _run_script(eng, SCRIPT)
    for op, toks in zip([o for o in SCRIPT if o[0] == "submit"], got):
        assert toks == _solo(model, op[1], op[2])
    jeng = jbatching.SpecDecodeEngine(
        jtr.transformer_lm(**MOE, decode=True, dtype=jnp.float32), t_flax,
        jtr.transformer_lm(**DRAFT, decode=True, dtype=jnp.float32), d_flax,
        3, 8 + 12 + 3, k=3)
    assert got == _run_script(jeng, SCRIPT)
    assert (eng.spec_rounds, eng.spec_accepted) == (jeng.spec_rounds,
                                                    jeng.spec_accepted)
