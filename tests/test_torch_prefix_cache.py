"""The PyTorch port's prefix cache (container_engine_accelerators_tpu_torch/
models/prefix_cache.py) against the JAX package's models/prefix_cache.py,
mirroring its tests/test_prefix_cache.py.

The same flax params (f32) go to both sides, converted with
``from_flax_params``.  Greedy tokens (f32) must be identical: a stored
prefix block spliced ahead of the suffix gives ``generate()``'s tokens
over the concatenated prompt, and JAX's ``generate_with_prefix``'s.  The
port writes its caches in place, so the splice must copy: an entry stays
byte-identical across the requests that hit it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import prefix_cache as jpc
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu_torch.models.batching import bucket_len
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import (
    generate,
    init_cache,
    prefix_bucket_len,
    splice_prefix,
)
from container_engine_accelerators_tpu_torch.models.prefix_cache import (
    PrefixCache,
    generate_with_prefix,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)

BASE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8, mlp_dim=32)
CFGS = {"mha": dict(BASE), "gqa": dict(BASE, num_kv_heads=2),
        "moe": dict(BASE, num_kv_heads=2, num_experts=4)}
MAX_NEW = 6


@pytest.fixture(scope="module")
def params():
    out = {}
    for i, (name, cfg) in enumerate(CFGS.items()):
        p = jtr.transformer_lm(**cfg).init(
            jax.random.PRNGKey(20 + i), jnp.zeros((1, 8), jnp.int32))["params"]
        out[name] = (p, from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                                p)))
    return out


def _model(name, sd, flash=False):
    model = TransformerLM(**CFGS[name], dtype=torch.float32, decode=True,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


def _padded(ids, cap=16):
    b = bucket_len(len(ids), cap)
    return torch.tensor([ids + [0] * (b - len(ids))]), len(ids)


def _concat_greedy(model, prefix, suffix, n=MAX_NEW):
    x, plen = _padded(prefix + suffix)
    with torch.inference_mode():
        out = generate(model, x, n, prompt_len=plen)
    return out[0, :plen + n].tolist()


CASES = [((5, 17, 42), (7, 9)), ((1, 2, 3, 4, 5), (8,)),
         ((3, 1, 4), (1, 5, 9, 2, 6))]


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_prefix_generate_matches_concat_and_jax(params, name, flash):
    """Prefix buckets 4 and 8 with pad slots, suffix buckets 1-8 with
    pads: the dead slots never reach a real token."""
    flax_p, sd = params[name]
    model = _model(name, sd, flash)
    cache = PrefixCache(model, max_prefix_len=8)
    jmodel = jtr.transformer_lm(**CFGS[name], decode=True, dtype=jnp.float32,
                                use_flash_decode=flash)
    jcache = jpc.PrefixCache(jmodel, flax_p, max_prefix_len=8)
    for pfx, sfx in CASES:
        block, plen = cache.get_or_build(pfx)
        assert plen == len(pfx)
        assert prefix_bucket_len(block) == bucket_len(len(pfx), 8)
        x, slen = _padded(list(sfx), 8)
        with torch.inference_mode():
            out = generate_with_prefix(model, block, plen, x, MAX_NEW,
                                       suffix_len=slen)
        got = list(pfx) + out[0, :slen + MAX_NEW].tolist()
        assert got == _concat_greedy(model, list(pfx), list(sfx))
        jkv, jplen = jcache.get_or_build(pfx)
        want = np.asarray(jpc.generate_with_prefix(
            jmodel, flax_p, jkv, jplen, jnp.asarray(x.numpy(), jnp.int32),
            MAX_NEW, suffix_len=slen))
        assert got == list(pfx) + want[0, :slen + MAX_NEW].tolist()


def test_moe_prefix_generate_matches_concat_and_jax(params):
    """The MoE-LM's drop-free routing is per token: a spliced block and
    its suffix give the concatenated prompt's tokens and JAX's."""
    test_prefix_generate_matches_concat_and_jax(params, "moe", False)


def test_entry_reuse_is_byte_identical(params):
    """The splice copies: a request's suffix never lands in the stored
    block, so every later hit reads the block it was built as, and two
    requests on one entry give the same tokens."""
    model = _model("gqa", params["gqa"][1], flash=True)
    cache = PrefixCache(model, max_prefix_len=8)
    kv1, _ = cache.get_or_build((5, 17, 42))
    before = {k: v.clone() for k, v in kv1.items()}
    kv2, plen = cache.get_or_build((5, 17, 42))
    assert kv1 is kv2 and cache.stats()["hits"] == 1
    suffix = torch.tensor([[7, 9]])
    with torch.inference_mode():
        g1 = generate_with_prefix(model, kv2, plen, suffix, 6)
        g2 = generate_with_prefix(model, kv2, plen, torch.tensor([[8, 8]]), 6)
        g3 = generate_with_prefix(model, kv2, plen, suffix, 6)
    assert torch.equal(g1, g3) and not torch.equal(g1, g2)
    assert all(torch.equal(kv2[k], before[k]) for k in before)


def test_splice_copies_the_block_into_every_lane(params):
    model = _model("mha", params["mha"][1])
    block, plen = PrefixCache(model, 8).get_or_build((3, 1, 4))
    cache = init_cache(model, 2, 12)
    splice_prefix(cache, block, plen, 2)
    assert (cache["cache_index"] == 3).all()
    for k in ("cached_key", "cached_value"):
        assert torch.equal(cache[k][:, 0, :4], block[k][:, 0])
        assert torch.equal(cache[k][:, 1, :4], block[k][:, 0])
        assert cache[k].data_ptr() != block[k].data_ptr()
        cache[k].add_(1.0)
    assert not torch.equal(cache["cached_key"][:, 0, :4],
                           block["cached_key"][:, 0])


def test_sampled_prefix_matches_concat_sampling(params):
    """Seeded sampling through a spliced prefix draws the tokens that
    sampling over the concatenated prompt draws with the same seed."""
    model = _model("mha", params["mha"][1])
    block, plen = PrefixCache(model, 8).get_or_build((5, 17, 42))
    with torch.inference_mode():
        got = generate_with_prefix(
            model, block, plen, torch.tensor([[7, 9]]), MAX_NEW,
            temperature=0.8, generator=torch.Generator().manual_seed(3))
        want = generate(model, torch.tensor([[5, 17, 42, 7, 9]]), MAX_NEW,
                        temperature=0.8,
                        generator=torch.Generator().manual_seed(3))
    assert got[0].tolist() == want[0, 3:].tolist()


def test_lru_and_stats(params):
    model = _model("mha", params["mha"][1])
    cache = PrefixCache(model, max_prefix_len=8, max_entries=2)
    a, b, c = (1, 2), (3, 4), (5, 6)
    cache.get_or_build(a)
    cache.get_or_build(b)
    cache.get_or_build(a)          # refresh a: b is now LRU
    cache.get_or_build(c)          # evicts b
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 3,
                             "evictions": 1}
    assert len(cache) == 2
    cache.get_or_build(b)          # rebuilt
    assert cache.stats()["misses"] == 4
    with pytest.raises(ValueError):
        cache.get_or_build(tuple(range(9)))  # > max_prefix_len
    with pytest.raises(ValueError):
        cache.get_or_build(())
    with pytest.raises(ValueError, match="max_entries"):
        PrefixCache(model, 8, max_entries=0)
