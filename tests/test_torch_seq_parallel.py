"""The PyTorch port's sequence-parallel attention (``parallel/seq.py``)
against the JAX package's, on 2 and 4 gloo ranks on the CPU
(``tests/torch_dist_helpers.py``), and its layout helpers against JAX's.

The same numpy q, k, v and output gradient (B, T, H, D = 2, 64, 4, 16,
f32: the shape of ``tests/test_seq_parallel.py``), the sequence in
storage order (zigzag for the zigzag layout), go through JAX's
``make_sequence_parallel_attention`` on a (n, 1) mesh of the host
devices and through the port's on n ranks, each rank feeding its shard:
ring (contiguous and zigzag) and Ulysses, causal and not.  Outputs and
q/k/v gradients agree within 1e-5 (absolute and relative): both sum the
same f32 products in another order (JAX streams K chunks through an
online softmax; the port attends whole blocks through the flash op's
plain version and merges them by logsumexp), values are O(1) and the
longest sum has 64 terms (1024 in the 2048-token cases), so each order
rounds within a few 1e-7 of the larger values.  Measured on the CPU: at
most 2.9e-6 apart, in those 2048-token cases' gradients.  Ring blocks that cross
JAX's ``RING_CHUNK`` boundary (JAX at chunk 8, the case
``test_ring_chunked_path`` covers, and at its own 512 with a 1024-row
shard) hold to the same bound.

``ring_skip_stats`` and the zigzag permutation equal JAX's number for
number; the port's block plan (``ring_blocks``) makes JAX's skip
decisions, and on the CPU one block is one call of the flash op's
plain version: the launch count ``chip_smoke.py`` holds the kernels to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from torch_image_helpers import few_torch_threads  # noqa: F401 (autouse)
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu.parallel import seq as jseq
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu_torch.ops import flash_attention as fa
from container_engine_accelerators_tpu_torch.parallel import seq

B, T, HEADS, D = 2, 64, 4, 16
TOL = 1e-5
WORLDS = (2, 4)
CASES = [("ring", "contiguous", False), ("ring", "contiguous", True),
         ("ring", "zigzag", False), ("ring", "zigzag", True),
         ("ulysses", "contiguous", False), ("ulysses", "contiguous", True)]
# (ranks, layout, JAX's RING_CHUNK, shape), causal ring blocks across
# JAX's chunk boundaries: chunk 8 under the 16- and 32-row shards, and
# JAX's own 512 under a 1024-row shard.
CHUNKED = ([(n, layout, 8, (B, T, HEADS, D)) for n in WORLDS
            for layout in seq.LAYOUTS]
           + [(2, layout, 512, (1, 2048, 2, D)) for layout in seq.LAYOUTS])


def _case_id(case):
    kind, layout, causal = case
    return f"{kind}-{layout}-{'causal' if causal else 'full'}"


def _inputs(shape, seed):
    """q, k, v and the output gradient, global numpy f32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _stored(xs, layout, n):
    if layout != "zigzag":
        return xs
    perm = np.asarray(jseq.zigzag_permutation(xs[0].shape[1], n))
    return [x[:, perm] for x in xs]


def _jax(n, kind, layout, causal, q, k, v, do, ring_chunk=None):
    """JAX's output and q/k/v gradients on the stored inputs."""
    mesh = create_mesh(data=n, model=1, devices=jax.devices()[:n])
    fn = jseq.make_sequence_parallel_attention(mesh, kind=kind, causal=causal,
                                               layout=layout)
    saved = jseq.RING_CHUNK
    jseq.RING_CHUNK = ring_chunk or saved
    try:
        out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do))
        return [np.asarray(x) for x in (out, *grads)]
    finally:
        jseq.RING_CHUNK = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each world: per case of CASES, then of its CHUNKED cases, then
    Ulysses over 6 heads, the port's per-rank results and JAX's."""
    out = {}
    for n in WORLDS:
        cases, want = [], []
        for i, (kind, layout, causal) in enumerate(CASES):
            xs = _stored(_inputs((B, T, HEADS, D), i), layout, n)
            cases.append((kind, layout, causal, *xs))
            want.append(_jax(n, kind, layout, causal, *xs))
        for i, (_, layout, chunk, shape) in enumerate(_chunked(n)):
            xs = _stored(_inputs(shape, 10 + i), layout, n)
            cases.append(("ring", layout, True, *xs))
            want.append(_jax(n, "ring", layout, True, *xs, ring_chunk=chunk))
        bad = _inputs((B, T, 6, D), 20)
        cases.append(("ulysses", "contiguous", True, *bad))
        with pytest.raises(ValueError) as err:
            _jax(4, "ulysses", "contiguous", True, *bad)
        want.append(str(err.value) if n == 4 else None)
        got = H.spawn(H.seq_attention, n, tmp_path_factory.mktemp(f"seq{n}"),
                      cases)
        out[n] = (got, want)
    return out


def _chunked(n):
    return [c for c in CHUNKED if c[0] == n]


def _compare(got_ranks, want, what):
    for name, parts, w in zip(("o", "dq", "dk", "dv"), zip(*got_ranks), want):
        np.testing.assert_allclose(np.concatenate(parts, axis=1), w,
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("n", WORLDS)
def test_forward_and_grads_equal_jax(runs, n, case):
    got, want = runs[n]
    i = CASES.index(case)
    _compare([r[i] for r in got], want[i], f"n={n} {_case_id(case)}")


@pytest.mark.parametrize("case", CHUNKED,
                         ids=[f"n{c[0]}-{c[1]}-chunk{c[2]}-T{c[3][1]}"
                              for c in CHUNKED])
def test_blocks_across_jax_ring_chunks_equal_jax(runs, case):
    n = case[0]
    got, want = runs[n]
    i = len(CASES) + _chunked(n).index(case)
    _compare([r[i] for r in got], want[i], f"{case[:3]}")


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_refuses_heads_not_divisible_by_the_ranks(runs, n):
    got, want = runs[n]
    if n == 2:  # 6 heads divide by 2: it runs
        assert all(isinstance(r[-1], tuple) for r in got)
        return
    assert want[-1] == ("ulysses needs num_heads (6) divisible by the "
                        "sequence-parallel degree (4)")
    assert [r[-1] for r in got] == [want[-1]] * n


def test_every_world_of_one_is_plain_attention():
    """Without a process group (one rank) the ring is one diagonal block
    and Ulysses is dense attention: both equal ``dense_attention``."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((B, T, HEADS, D), 3))
    want = seq.dense_attention(q, k, v, causal=True)
    for layout in seq.LAYOUTS:
        got = seq.ring_attention(q, k, v, causal=True, layout=layout)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(seq.ulysses_attention(q, k, v, causal=True),
                               want, atol=0, rtol=0)


def _port_ring_bf16(n, layout, q, k, v, do):
    """The port's bf16 causal ring on stored inputs (numpy f32), every
    virtual rank's steps composed in one process (the functions a rank
    runs, on the flash op's plain version here, which rounds each block's
    o to bf16 before the f32 lse merge, as the kernels do), with
    ``ring_attention``'s casts -> o, dq, dk, dv as f32 numpy."""
    b, t, h, d = q.shape
    tq, scale = t // n, d ** -0.5
    qs, ks, vs, dos = (torch.from_numpy(x).bfloat16().split(tq, dim=1)
                       for x in (q, k, v, do))
    qs = [x * scale for x in qs]
    outs, lses = [], []
    for r in range(n):
        o = torch.zeros(b, tq, h, d)
        lse = torch.full((b * h, tq), float("-inf"))
        for s in range(n):
            src = (r - s) % n
            seq.ring_forward_step(qs[r], ks[src], vs[src], o, lse, r, src, n,
                                  layout, True, False)
        outs.append(o.bfloat16())
        lses.append(lse)
    grads = [[torch.zeros(b, tq, h, d) for _ in range(n)] for _ in range(3)]
    for r in range(n):
        for s in range(n):
            src = (r - s) % n
            seq.ring_backward_step(qs[r], dos[r], outs[r], lses[r], ks[src],
                                   vs[src], grads[0][r], grads[1][src],
                                   grads[2][src], r, src, n, layout, True,
                                   False)
    dq, dk, dv = (torch.cat(g, dim=1) for g in grads)
    return [x.bfloat16().float().numpy()
            for x in (torch.cat(outs, dim=1), dq * scale, dk, dv)]


@pytest.mark.parametrize("n,layout", [(2, "contiguous"), (4, "contiguous"),
                                      (4, "zigzag")])
def test_bf16_ring_error_within_2x_of_jaxs_bf16_ring(n, layout):
    """The port rounds each ring block's o to bf16 before the f32 lse
    merge; JAX's ring keeps an unnormalized f32 accumulator and rounds
    once (``parallel/seq.py:93-113`` of the JAX package).  Against an f64
    reference on the same inputs (B, T, H, D = 2, 256, 4, 64, causal),
    the port's bf16 o, dq, dk and dv must sit within 2x of JAX's bf16
    error, by the largest and by the root-mean-square error.  Measured on
    the CPU at these inputs: port / JAX 1.00-1.29x (largest) and
    1.02-1.11x (RMS), the final bf16 cast dominating both."""
    shape = (2, 256, 4, 64)
    xs = _stored(_inputs(shape, 30), layout, n)
    q, k, v, do = (torch.from_numpy(x).double() for x in _inputs(shape, 30))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    ref = seq.dense_attention(q, k, v, causal=True)
    ref.backward(do)
    refs = _stored([x.detach().numpy() for x in (ref, q.grad, k.grad,
                                                 v.grad)], layout, n)
    mesh = create_mesh(data=n, model=1, devices=jax.devices()[:n])
    fn = jseq.make_sequence_parallel_attention(mesh, kind="ring", causal=True,
                                               layout=layout)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x, jnp.bfloat16) for x in xs[:3]))
    jax_got = [np.asarray(x.astype(jnp.float32))
               for x in (out, *vjp(jnp.asarray(xs[3], jnp.bfloat16)))]
    port_got = _port_ring_bf16(n, layout, *xs)
    for name, p, j, r in zip(("o", "dq", "dk", "dv"), port_got, jax_got,
                             refs):
        for how, err in (("largest", lambda e: np.abs(e).max()),
                         ("rms", lambda e: np.sqrt((e ** 2).mean()))):
            pe, je = err(p - r), err(j - r)
            assert pe <= 2 * je, f"{name} {how}: port {pe} jax {je}"


# ---- layout helpers -----------------------------------------------------------


@pytest.mark.parametrize("t,n", [(64, 4), (16, 2), (2048, 8), (96, 3)])
def test_zigzag_permutation_equals_jax_and_round_trips(t, n):
    perm = seq.zigzag_permutation(t, n)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jseq.zigzag_permutation(t, n)))
    x = torch.arange(2 * t).view(2, t)
    z = seq.to_zigzag(x, n)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jseq.to_zigzag(jnp.asarray(x.numpy()), n)))
    assert torch.equal(seq.from_zigzag(z, n), x)
    xt = x.t().contiguous()
    assert torch.equal(seq.from_zigzag(seq.to_zigzag(xt, n, axis=0), n,
                                       axis=0), xt)


def test_zigzag_validation():
    with pytest.raises(ValueError, match="divisible by 2"):
        seq.zigzag_permutation(10, 4)
    x = torch.ones(1, 3, 2, 4)
    with pytest.raises(ValueError, match="even per-device shard"):
        seq.ring_attention(x, x, x, layout="zigzag")
    with pytest.raises(ValueError, match="unknown ring layout"):
        seq.ring_attention(x, x, x, layout="diagonal")
    with pytest.raises(ValueError, match="kind must be one of"):
        seq.make_sequence_parallel_attention(None, kind="tree")


@pytest.mark.parametrize("layout", seq.LAYOUTS)
@pytest.mark.parametrize("t,n", [(16384, 8), (4096, 4), (64, 2)])
def test_ring_skip_stats_equal_jax(t, n, layout):
    assert seq.ring_skip_stats(t, n, layout) == \
        jseq.ring_skip_stats(t, n, layout)


@pytest.mark.parametrize("layout", seq.LAYOUTS)
def test_ring_skip_stats_equal_jax_at_a_fine_chunk(layout):
    assert seq.ring_skip_stats(8192, 8, layout, ring_chunk=128) == \
        jseq.ring_skip_stats(8192, 8, layout, ring_chunk=128)


@pytest.mark.parametrize("layout", seq.LAYOUTS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ring_positions_equal_jax(layout, n):
    for rank in range(n):
        np.testing.assert_array_equal(
            seq.ring_positions(layout, rank, 16, n).numpy(),
            np.asarray(jseq._ring_positions(layout, rank, 16, n)))


@pytest.mark.parametrize("layout", seq.LAYOUTS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ring_blocks_make_jax_skip_decisions(layout, n):
    """Where a shard half fits in one of JAX's chunks, each (rank, step)
    the port computes exactly the (q row x k col) pairs JAX's ring does,
    and the block counts are the closed forms."""
    t = 2 * n * 256  # a half of 256 rows: one JAX chunk
    tq = t // n
    stats = jseq.ring_skip_stats(t, n, layout)
    total, per_step_max = 0, []
    for s in range(n):
        costs = [sum((r_.stop - r_.start) * (c.stop - c.start)
                     for r_, c, _ in seq.ring_blocks(r, (r - s) % n, n, tq,
                                                     layout))
                 for r in range(n)]
        total += sum(costs)
        per_step_max.append(float(max(costs)))
    assert (float(total), per_step_max) == (stats["total"],
                                            stats["per_step_max"])
    want = n * (n + 1) // 2 if layout == "contiguous" else n * (2 * n + 1)
    assert seq.count_ring_blocks(n, layout) == want
    assert seq.count_ring_blocks(n, layout, causal=False) == n * n


def test_kernel_gate_is_the_flash_ops_tile_gate_on_a_block():
    q = torch.empty(1, 256, 1, 64)
    assert seq._kernel_blocks(q, True, "contiguous")
    assert seq._kernel_blocks(q, True, "zigzag")  # halves of 128
    assert seq._kernel_blocks(q, False, "zigzag")  # whole blocks
    assert not seq._kernel_blocks(q[:, :128], True, "zigzag")  # halves of 64
    assert not seq._kernel_blocks(torch.empty(1, 256, 1, 16), True,
                                  "contiguous")


@pytest.mark.parametrize("layout", seq.LAYOUTS)
def test_composed_ranks_call_the_flash_op_once_a_block(monkeypatch, layout):
    """chip_smoke.py's seq_ring_blocks phase on the CPU: every virtual
    rank's forward and backward steps composed in one process, at a
    shape the kernel gate takes, call the flash op (its plain version
    here) once a block each way and equal whole-sequence attention."""
    n, t, d = 2, 512, 64
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_forward, fa.flash_backward

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fa, "flash_forward", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_backward", count("bwd", bwd))
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((1, t, 2, d), 5))
    scale = d ** -0.5
    stored = [seq.to_zigzag(x, n) if layout == "zigzag" else x
              for x in (q, k, v, do)]
    qs, ks, vs, dos = (x.split(t // n, dim=1) for x in stored)
    qs = [x * scale for x in qs]
    outs, lses = [], []
    for r in range(n):
        o = torch.zeros(1, t // n, 2, d)
        lse = torch.full((2, t // n), float("-inf"))
        for s in range(n):
            src = (r - s) % n
            seq.ring_forward_step(qs[r], ks[src], vs[src], o, lse, r, src, n,
                                  layout)
        outs.append(o)
        lses.append(lse)
    grads = [[torch.zeros(1, t // n, 2, d) for _ in range(n)]
             for _ in range(3)]
    for r in range(n):
        for s in range(n):
            src = (r - s) % n
            seq.ring_backward_step(qs[r], dos[r], outs[r], lses[r], ks[src],
                                   vs[src], grads[0][r], grads[1][src],
                                   grads[2][src], r, src, n, layout)
    blocks = seq.count_ring_blocks(n, layout)
    assert calls == {"fwd": blocks, "bwd": blocks}
    got = [torch.cat(x, dim=1) for x in (outs, *grads)]
    got[1] = got[1] * scale
    if layout == "zigzag":
        got = [seq.from_zigzag(x, n) for x in got]
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    want = fa.flash_attention_reference(qq, kk, vv, True)[0]
    want.backward(do)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got,
                          (want, qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL, msg=name)


def test_decode_mode_refuses_sequence_parallelism():
    with pytest.raises(ValueError, match="decode mode is single-sequence"):
        TransformerLM(vocab_size=97, num_layers=1, num_heads=2, head_dim=16,
                      mlp_dim=32, decode=True, seq_parallel="ring")
    with pytest.raises(ValueError, match="unknown seq_parallel"):
        TransformerLM(vocab_size=97, num_layers=1, num_heads=2, head_dim=16,
                      mlp_dim=32, seq_parallel="tree")


def test_bench_ring_times_both_layouts_and_predicts(tmp_path):
    """``cmd/bench_ring.py`` on 2 gloo ranks: rank 0 prints one JSON line
    with both layouts' times, the ratio and ring_skip_stats' prediction
    (4n/(2n+1) = 1.6 at n = 2); the layouts agree."""
    import json

    lines = H.spawn(H.bench_ring_line, 2, tmp_path,
                    ["--device", "cpu", "--seq", "512", "--iters", "1",
                     "--warmup", "1", "--check"])
    assert lines[1] == ""
    row = json.loads(lines[0])
    assert row["metric"] == "ring_zigzag_speedup" and row["devices"] == 2
    assert row["predicted"] == pytest.approx(1.6)
    assert row["value"] == pytest.approx(row["contiguous_ms"]
                                         / row["zigzag_ms"])
    assert row["layout_max_abs_diff"] < 1e-5
