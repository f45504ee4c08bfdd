"""The port's MoE FFN on a mesh (``ops/moe.py``: ``expert_sharding`` and
the trainer's layout) against the JAX layer, mirroring
``tests/test_moe.py:65-83``, on 2 and 4 gloo ranks.

The JAX test's widths (B 2, T 16, D 8, F 32, E 8) and flax's initial
weights; x and the loss weights w from a numpy seed.  JAX computes
``MoEFFN`` on one device (GSPMD's expert-sharded run equals it: its own
test).  The port runs it expert-parallel (``expert_sharding`` on the
model axis: two all-to-alls) on (1, 2), (1, 4) and (2, 2) meshes, and
under the trainer's rule (``shard_params``: every expert's F split over
the model axis; ``shard_params_fsdp``) on (1, 2) and (2, 2), with x
whole on every rank or split by rows over the data axis.

Tolerances, f32: outputs within 1e-5 (atol and rtol); the aux loss 1e-6
relative; the gradients of x and of every weight, router included,
within 2e-5 of the leaf's largest |g| (the same arithmetic in another
order: the rows of a chunk, partial sums over F, sums over ranks; the
MoE tests' bound).  Routing is exact: the rows JAX drops (its output
row exactly zero) are the rows the port drops, token for token, and the
drop share is JAX's.  The designed batch pushes most tokens to one
expert: its capacity is filled by the first tokens of the GLOBAL order,
all on the first ranks, so a rank that counted only its own tokens
would keep tokens JAX drops.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as H
import torch_par_helpers as P
from container_engine_accelerators_tpu_torch.ops import moe

jmoe = importlib.import_module("container_engine_accelerators_tpu.ops.moe")

B, T, D, F, E = 2, 16, 8, 32, 8
GRAD_TOL = 2e-5


def _inputs(designed):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = rng.standard_normal((B, T, D)).astype(np.float32)
    params = _jax_params()
    if designed:
        # Most tokens lean toward expert 0's router column.
        col = params["router"][:, 0]
        x = (0.3 * x + 4.0 * col / np.linalg.norm(col)).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def _jax_params():
    layer = jmoe.MoEFFN(num_experts=E, mlp_dim=F, dtype=jnp.float32)
    p = layer.init(jax.random.PRNGKey(1), jnp.zeros((B, T, D)))["params"]
    return {"router": np.asarray(p["router"]["kernel"]),
            "wi_gate": np.asarray(p["wi_gate"]),
            "wi_up": np.asarray(p["wi_up"]), "wo": np.asarray(p["wo"])}


@functools.lru_cache(maxsize=None)
def _jax(designed, cf):
    """JAX on one device -> (out, aux, grads of x and the four weights in
    the port's names), numpy."""
    x, w = _inputs(designed)
    p = _jax_params()
    layer = jmoe.MoEFFN(num_experts=E, mlp_dim=F, dtype=jnp.float32,
                        capacity_factor=cf)
    params = {"router": {"kernel": p["router"]}, "wi_gate": p["wi_gate"],
              "wi_up": p["wi_up"], "wo": p["wo"]}

    def loss(x, params):
        out, aux = layer.apply({"params": params}, x)
        return jnp.sum(out * w) + 0.3 * aux, (out, aux)

    (_, (out, aux)), (gx, gp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    grads = {"router": np.asarray(gp["router"]["kernel"]),
             **{k: np.asarray(gp[k]) for k in ("wi_gate", "wi_up", "wo")}}
    return np.asarray(out), float(aux), np.asarray(gx), grads


# (world, mesh, layout, x split by rows, designed batch, capacity factor)
CASES = [
    (2, (1, 2), "expert", False, False, 1.25),
    (2, (1, 2), "expert", False, True, 1.25),
    (2, (1, 2), "megatron", False, True, 1.25),
    (2, (2, 1), "megatron", True, True, 1.25),
    (4, (1, 4), "expert", False, True, 1.25),
    (4, (2, 2), "expert", False, False, 0.5),
    (4, (2, 2), "expert", True, True, 1.25),
    (4, (2, 2), "megatron", True, True, 1.25),
    (4, (2, 2), "fsdp", True, False, 0.5),
]


@functools.lru_cache(maxsize=None)
def _port(world, tmp):
    """Every case of ``world`` ranks in one spawn, grouped by input."""
    out = {}
    for designed in (False, True):
        x, w = _inputs(designed)
        cases = [c for c in CASES if c[0] == world and c[4] == designed]
        res = H.spawn(P.moe_ffn_cases, world, tmp,
                      [(c[1], c[2], c[3], dict(capacity_factor=c[5]))
                       for c in cases], _jax_params(), x, w)
        for i, c in enumerate(cases):
            out[c] = [r[i] for r in res]
    return out


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("moe_ep"))


def _ids(c):
    return (f"{c[0]}ranks-{c[1][0]}x{c[1][1]}-{c[2]}"
            f"{'-rows' if c[3] else ''}{'-designed' if c[4] else ''}-cf{c[5]}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_output_aux_and_drops_equal_jax(case, tmp):
    out, aux, _, _ = _jax(case[4], case[5])
    zero = np.abs(out.reshape(-1, D)).max(1) == 0
    for y, got_aux, dropped, _, _, _, _ in _port(case[0], tmp)[case]:
        np.testing.assert_allclose(y, out, rtol=1e-5, atol=1e-5)
        assert abs(got_aux - aux) <= 1e-6 * abs(aux)
        got_zero = np.abs(y.reshape(-1, D)).max(1) == 0
        assert got_zero.tolist() == zero.tolist()
        assert dropped == zero.mean()
    if case[4]:
        # The designed batch drops tokens, and some of them sit on a
        # later rank, which a rank-local queue would have kept.
        assert zero.sum() > 0 and zero[B * T // 2:].sum() > 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gradients_equal_jax(case, tmp):
    _, _, gx, grads = _jax(case[4], case[5])
    for _, _, _, got, got_x, start, _ in _port(case[0], tmp)[case]:
        for name, g in grads.items():
            np.testing.assert_allclose(got[name], g,
                                       atol=GRAD_TOL * np.abs(g).max(),
                                       rtol=0, err_msg=name)
        want_x = gx[start:start + got_x.shape[0]]
        np.testing.assert_allclose(got_x, want_x,
                                   atol=GRAD_TOL * np.abs(gx).max(), rtol=0)
        assert np.abs(got["router"]).max() > 0


@pytest.mark.parametrize("case", [c for c in CASES if c[2] != "fsdp"],
                         ids=_ids)
def test_layouts(case, tmp):
    """Expert parallelism puts wo's expert axis on the model axis; the
    trainer's rule its F axis (``mlp_dim``, JAX's largest-axis pick)."""
    want = {"expert": "S(0)", "megatron": "S(1)"}[case[2]]
    for *_, placements in _port(case[0], tmp)[case]:
        model = placements[1]
        assert model == (want if case[1][1] > 1 else "R"), placements


def test_expert_sharding_rejects_indivisible_experts():
    import torch
    from torch import nn

    class FakeMesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 3

    layer = moe.MoEFFN(D, E, F, torch.float32,
                       lambda *s, dtype: nn.Parameter(torch.empty(s)))
    with pytest.raises(ValueError, match="not divisible"):
        moe.expert_sharding(FakeMesh(), layer)
