"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions.

Every test here carries the ``cuda`` marker and skips without a card: a
CUDA kernel has no CPU mode.  The file imports no jax, so it runs on a GPU
host that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports the JAX package's
utilities, which such a host need not be able to import.)

Tolerances are the JAX kernels' own: flash decode 2e-5 in f32 (f32
accumulation in another order) and 3e-2 in bf16 (p is rounded to bf16
against a different running max, and the output is rounded to bf16);
flash attention 2e-5 / 2e-4 (forward / backward) in f32 and 2e-2 / 1e-1
in bf16; the designed cast inputs one bf16 step (2**-7 relative).
"""

import pytest
import torch
from flash_decode_inputs import bwd_cast_inputs, dq_cast_inputs, p_cast_inputs

from container_engine_accelerators_tpu_torch.models import lm_train
from container_engine_accelerators_tpu_torch.models.generate import (
    generate,
    prefill,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
)
from container_engine_accelerators_tpu_torch.ops import flash_attention as fa
from container_engine_accelerators_tpu_torch.ops import flash_decode as fd

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode); chip_smoke.py checks it on the card too")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,cache_len,kvh,h,d", [
    (1, 1056, 8, 8, 64),   # the server's decode shape: 8-CTA clusters
    (3, 1056, 2, 8, 64),   # 16 CTAs a row block
    (64, 256, 8, 8, 64),   # two CTAs a row block (512 row blocks)
    (2, 96, 1, 12, 40),    # 80-byte rows; few row blocks: one row a CTA
    (2, 96, 2, 8, 20),     # bf16: 40-byte rows, no TMA box (plain loads)
    (3, 300, 1, 6, 6),     # 12- / 24-byte rows: plain loads, padded chunks
    (1, 130, 1, 2, 255),   # the widest rows that are not whole 16-byte chunks
    (16, 256, 2, 16, 64),  # many row blocks: 8-row CTAs (f32: 16)
])
def test_flash_decode_kernel_matches_plain_version(cuda, dtype, b, cache_len,
                                                    kvh, h, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((b, h, d), (b, cache_len, kvh, d),
                         (b, cache_len, kvh, d)))
    lengths = torch.randint(1, cache_len + 1, (b,), device=cuda,
                            generator=gen, dtype=torch.int32)
    lengths[:2] = torch.tensor([1, cache_len])[:b]
    before = fd.LAUNCHES["flash_decode"]
    got = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == before + 1
    want = fd.flash_decode_reference(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_lengths_zero_past_the_cache_and_empty_ctas(cuda, dtype):
    """Length 0 gives 0/0 = NaN, as the plain version; a length past the
    cache counts as the cache; at length 1 and 17 with the widest split
    most CTAs of a cluster get no key and still reach its barriers."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((4, 8, 64), (4, 1056, 8, 64), (4, 1056, 8, 64)))
    assert fd.plan(q, k, v) == (1, 8)  # one-row CTAs: the widest cluster
    lengths = torch.tensor([0, 1056 + 9, 1, 17], dtype=torch.int32,
                           device=cuda)
    got = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    want = fd.flash_decode_reference(q, k, v, lengths)
    assert torch.isnan(got[0]).all() and torch.isnan(want[0]).all()
    torch.testing.assert_close(got[1:].float(), want[1:].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(
        got[1].float(), fd.flash_decode_reference(
            q[1:2], k[1:2], v[1:2], lengths.new_tensor([1056]))[0].float(),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_graph_replays_give_identical_output(cuda, dtype):
    """A CUDA graph of one call, replayed twice on the same inputs, gives
    the same bits as the eager call: the cluster merge keeps no state."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((2, 8, 64), (2, 1056, 2, 64), (2, 1056, 2, 64)))
    lengths = torch.tensor([731, 1056], dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = fd.flash_decode(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(q, k, v, lengths)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], eager)
    torch.testing.assert_close(
        eager.float(), fd.flash_decode_reference(q, k, v, lengths).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_decode_call_is_one_kernel_launch(cuda):
    """One call of the op is one kernel on the device: the merge runs
    inside it, and no memset or second kernel goes with it."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).bfloat16()
               for s in ((1, 8, 64), (1, 1056, 8, 64), (1, 1056, 8, 64)))
    lengths = torch.tensor([731], dtype=torch.int32, device=cuda)
    fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    before = fd.LAUNCHES["flash_decode"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fd.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "flash_decode_kernel" in names[0], names
    assert fd.LAUNCHES["flash_decode"] == before + 1


def test_flash_decode_kernel_never_computes_with_slots_past_the_length(cuda):
    """A NaN tail right after a length that is not tile-aligned: the TMA
    boxes bring some of it into shared memory, and none of it may reach
    the output."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(s, device=cuda, generator=gen)
               for s in ((1, 8, 64), (1, 1056, 2, 64), (1, 1056, 2, 64)))
    live = torch.tensor([517], dtype=torch.int32, device=cuda)
    tail = torch.arange(1056, device=cuda)[None, :, None, None] >= 517
    got = fd.flash_decode(q, k.masked_fill(tail, float("nan")),
                          v.masked_fill(tail, float("nan")), live)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fd.flash_decode_reference(q, k, v, live),
                               atol=2e-5, rtol=2e-5)


def test_flash_decode_casts_p_like_the_plain_version(cuda):
    """On inputs where rounding p to bf16 moves the output ~18%, the
    kernel agrees with the plain version to one bf16 step and the same
    math with p kept in f32 does not (tests/flash_decode_inputs.py)."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in p_cast_inputs(1, 1056, 8, 8, 64))
    lengths = torch.tensor([731], dtype=torch.int32, device=cuda)
    got = fd.flash_decode(q, k, v, lengths).float()
    torch.testing.assert_close(
        got, fd.flash_decode_reference(q, k, v, lengths).float(),
        rtol=2 ** -7, atol=0)
    p_in_f32 = fd.flash_decode_reference(q.float(), k.float(), v.float(),
                                         lengths).to(torch.bfloat16).float()
    assert not torch.allclose(got, p_in_f32, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("bad", [
    "k_shape", "lengths_dtype", "lengths_shape", "dtype_mismatch",
    "float16", "noncontiguous", "head_dim", "kv_heads", "cpu_lengths"])
def test_flash_decode_rejects_what_the_kernel_does_not_take(cuda, bad):
    """The op's TORCH_CHECKs refuse what the kernel does not take,
    before any launch."""
    dtype = torch.float16 if bad == "float16" else torch.float32
    q, k, v = (torch.zeros(s, device=cuda, dtype=dtype)
               for s in ((2, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    lengths = torch.full((2,), 3, dtype=torch.int32, device=cuda)
    if bad == "k_shape":
        k = k[:, :32]
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "lengths_shape":
        lengths = lengths[:1]
    elif bad == "dtype_mismatch":
        v = v.to(torch.bfloat16)
    elif bad == "noncontiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "head_dim":
        q = torch.zeros(2, 4, 264, device=cuda)
        k = v = torch.zeros(2, 64, 2, 264, device=cuda)
    elif bad == "kv_heads":
        k = v = torch.zeros(2, 64, 3, 16, device=cuda)
    elif bad == "cpu_lengths":
        lengths = lengths.cpu()
    before = fd.LAUNCHES["flash_decode"]
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        fd.flash_decode(q, k, v, lengths)
    assert fd.LAUNCHES["flash_decode"] == before


def test_decode_with_kernel_matches_einsum_path(cuda):
    """A small f32 model on the card: the first decode step's logits
    agree within 1e-4 and greedy tokens are identical, kernel on or off."""
    cfg = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=16,
               mlp_dim=32, num_kv_heads=2, decode=True, dtype=torch.float32)
    params = init_params(TransformerLM(**cfg, device="meta"),
                         torch.Generator().manual_seed(0))
    model = TransformerLM(**cfg, device=cuda)
    model.load_state_dict(params)
    prompt = torch.randint(1, 97, (2, 8), generator=torch.Generator()
                           .manual_seed(1)).to(cuda)
    step, toks = {}, {}
    with torch.inference_mode():
        for flash in (True, False):
            model.use_flash_decode = flash
            cache, last = prefill(model, prompt, 5, 16)
            step[flash] = model(last.argmax(-1)[:, None],
                                positions=torch.full((1,), 5,
                                                     dtype=torch.int32,
                                                     device=cuda),
                                cache=cache)
            toks[flash] = generate(model, prompt, 8, prompt_len=5)[:, :13]
    torch.testing.assert_close(step[True], step[False], atol=1e-4, rtol=1e-4)
    assert torch.equal(toks[True], toks[False])


@pytest.mark.parametrize("refused", ["batch", "kv_heads"])
def test_flash_decode_op_raises_on_a_refused_launch(cuda, refused):
    """A grid the card does not take (a batch or a count of KV heads past
    65535 CTAs on its axis) comes back from the launch as an exception."""
    op = fd.build()
    b, kvh = (65536, 1) if refused == "batch" else (1, 65536)
    q, k, v = (torch.zeros(s, device=cuda)
               for s in ((b, kvh, 4), (b, 2, kvh, 4), (b, 2, kvh, 4)))
    lengths = torch.full((b,), 2, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        op(q, k, v, lengths, 0.5)


def test_flash_decode_unaligned_cache_takes_plain_loads(cuda):
    """Caches that start off a 16-byte boundary (a view one element into
    its storage) have no TMA map; the kernel copies their tiles with plain
    loads and agrees with the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(2, 8, 64, device=cuda, generator=gen).bfloat16()
    k, v = (torch.randn(2 * 200 * 2 * 64 + 1, device=cuda, generator=gen)
            .bfloat16()[1:].view(2, 200, 2, 64) for _ in range(2))
    assert k.data_ptr() % 16 and k.is_contiguous()
    lengths = torch.tensor([57, 200], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        fd.flash_decode(q, k, v, lengths).float(),
        fd.flash_decode_reference(q, k, v, lengths).float(),
        atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])



FA_TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (2e-2, 1e-1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("b,t,h", [
    (1, 128, 1),   # causal: a single diagonal block
    (2, 384, 3),
    (2, 2048, 8),  # the training shape's T and H (B*H = 16)
    (3, 2048, 3),  # B*H = 9: 144 CTAs, a partial second wave on 132 SMs
])
def test_flash_attention_kernels_match_plain_version(cuda, dtype, d, causal,
                                                      b, t, h):
    """Forward (o, lse) and backward (dq, dk, dv), each op once: in bf16
    the forward, dQ and dK/dV run the tensor-core kernels
    (flash_attention_sm90.cu, dQ and dK/dV at D 64 and 128), in f32 the
    CUDA-core ones."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(b, t, h, d, device=cuda, generator=gen)
                   .to(dtype) for _ in range(4))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward(q, k, v, causal, d ** -0.5)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    want_o, want_lse = fa.flash_attention_reference(q, k, v, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    fwd_tol, bwd_tol = FA_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=bwd_tol,
                                   rtol=bwd_tol)


def test_flash_attention_casts_p_like_the_plain_version(cuda):
    """tests/flash_decode_inputs.py's designed inputs, every query row the
    decode query: the forward kernel agrees with the plain version to one
    bf16 step, and the same math with p kept in f32 does not."""
    q, k, v = p_cast_inputs(1, 2048, 8, 8, 64)
    q = q[:, None].repeat(2048, axis=1)
    q, k, v = (torch.from_numpy(x).to(cuda) for x in (q, k, v))
    got, _ = fa.flash_forward(*(x.bfloat16() for x in (q, k, v)), False, 0.125)
    want, _ = fa.flash_attention_reference(*(x.bfloat16() for x in (q, k, v)))
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=0)
    p_in_f32, _ = fa.flash_attention_reference(q, k, v)
    assert not torch.allclose(got.float(), p_in_f32.bfloat16().float(),
                              rtol=2 ** -7, atol=0)


def test_flash_attention_casts_p_and_ds_like_the_plain_version(cuda):
    """tests/flash_decode_inputs.py's designed backward inputs: the dK/dV
    kernel agrees with the plain version to one bf16 step on every element
    of dV and on dK's first column (its other columns are 0), and the same
    math with P and dS kept in f32 does not."""
    f32 = [torch.from_numpy(x).to(cuda)
           for x in bwd_cast_inputs(1, 2048, 8, 64)]
    q, k, v, o, lse, do = (x if i == 4 else x.bfloat16()
                           for i, x in enumerate(f32))
    dk, dv = fa.load_ops().flash_attention_bwd_dkv(q, k, v, o, do, lse,
                                                   False, 0.125)
    torch.cuda.synchronize()
    _, want_dk, want_dv = fa.flash_attention_bwd_reference(q, k, v, o, lse,
                                                           do)
    _, ctrl_dk, ctrl_dv = fa.flash_attention_bwd_reference(*f32)
    for got, want, ctrl in ((dk[..., 0], want_dk[..., 0], ctrl_dk[..., 0]),
                            (dv, want_dv, ctrl_dv)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=0)
        assert not torch.allclose(got.float(), ctrl.bfloat16().float(),
                                  rtol=2 ** -7, atol=0)
    assert not dk[..., 1:].float().any()


def test_flash_attention_casts_ds_to_k_dtype_before_dq(cuda):
    """tests/flash_decode_inputs.py's designed dQ inputs: the dQ kernel
    agrees with the plain version to one bf16 step on dQ's second column
    (its columns past the second are 0), and the same math with dS kept
    in f32 does not."""
    f32 = [torch.from_numpy(x).to(cuda)
           for x in dq_cast_inputs(1, 2048, 8, 64)]
    q, k, v, o, lse, do = (x if i == 4 else x.bfloat16()
                           for i, x in enumerate(f32))
    dq, _ = fa.load_ops().flash_attention_bwd_dq(q, k, v, o, do, lse, False,
                                                 0.125)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)[0]
    ctrl = fa.flash_attention_bwd_reference(*f32)[0]
    torch.testing.assert_close(dq[..., 1].float(), want[..., 1].float(),
                               rtol=2 ** -7, atol=0)
    assert not torch.allclose(dq[..., 1].float(),
                              ctrl[..., 1].bfloat16().float(), rtol=2 ** -7,
                              atol=0)
    assert not dq[..., 2:].float().any()


def test_bf16_backward_runs_the_delta_pre_pass_once(cuda):
    """The dQ op runs the delta pre-pass and returns delta = rowsum(dO * O)
    in f32, and the dK/dV op takes it: one pre-pass launch per backward in
    a profiler trace of ``_backward``.  On the CUDA-core route (f32) the
    dQ op returns no delta."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(2, 256, 3, 64, device=cuda, generator=gen)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, True, 0.125)
    _, delta = fa.load_ops().flash_attention_bwd_dq(q, k, v, o, do, lse,
                                                    True, 0.125)
    want = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(6, 256)
    torch.testing.assert_close(delta, want, atol=1e-5, rtol=1e-5)
    _, none = fa.load_ops().flash_attention_bwd_dq(
        *(x.float() for x in (q, k, v, o, do)), lse, True, 0.125)
    assert none is None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_backward(q, k, v, o, lse, do, True, 0.125)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("fa_bwd_delta" in n for n in names) == 1, names
    assert sum("fa_bwd_dq_sm90" in n for n in names) == 1, names
    assert sum("fa_bwd_dkv_sm90" in n for n in names) == 1, names


@pytest.mark.parametrize("op", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("bad", ["misaligned", "seq_len"])
def test_flash_attention_tensor_core_path_raises_on_refused_input(cuda, op,
                                                                   bad):
    """A bf16 call the binding refuses (TMA needs a 16-byte aligned base;
    T a multiple of 128) raises before any launch and runs no other
    kernel in its place."""
    shape = (1, 200 if bad == "seq_len" else 256, 2, 64)
    n = shape[1] * 2 * 64
    flat = [torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)
            for _ in range(5)]
    q, k, v, o, do = (x[1:] if bad == "misaligned" else x[:n]
                      for x in flat)
    q, k, v, o, do = (x.view(shape) for x in (q, k, v, o, do))
    lse = torch.zeros(2, shape[1], device=cuda)
    ops = fa.load_ops()
    before = dict(fa.LAUNCHES)
    with pytest.raises((ValueError, RuntimeError)):
        if op == "fwd":
            ops.flash_attention_fwd(q, k, v, True, 0.125)
        elif op == "bwd_dq":
            ops.flash_attention_bwd_dq(q, k, v, o, do, lse, True, 0.125)
        else:
            ops.flash_attention_bwd_dkv(q, k, v, o, do, lse, True, 0.125)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    "seq_len", "short", "head_dim", "float16", "dtype_mismatch", "shape",
    "noncontiguous", "cpu_k"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda, bad):
    shape, dtype = (1, 256, 2, 64), torch.float32
    if bad == "seq_len":
        shape = (1, 200, 2, 64)
    elif bad == "short":
        shape = (1, 64, 2, 64)
    elif bad == "head_dim":
        shape = (1, 256, 2, 96)
    elif bad == "float16":
        dtype = torch.float16
    q, k, v = (torch.zeros(shape, device=cuda, dtype=dtype)
               for _ in range(3))
    if bad == "dtype_mismatch":
        v = v.to(torch.bfloat16)
    elif bad == "shape":
        k = k[:, :128]
    elif bad == "noncontiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "cpu_k":
        k = k.cpu()
    before = dict(fa.LAUNCHES)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        fa.load_ops().flash_attention_fwd(q, k, v, True, 0.125)
    assert fa.LAUNCHES == before


def test_train_step_with_kernels_matches_dense(cuda):
    """A small f32 model on the card: loss and gradients through the
    kernels (remat on) equal dense attention's (loss 1e-5 relative,
    gradients 1e-4 of each leaf's largest |g|)."""
    cfg = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=64,
               mlp_dim=64, num_kv_heads=2, dtype=torch.float32)
    params = init_params(TransformerLM(**cfg, device="meta"),
                         torch.Generator().manual_seed(0))
    toks = torch.randint(0, 97, (2, 256), generator=torch.Generator()
                         .manual_seed(1)).to(cuda)
    labels, mask = lm_train.next_token_targets(toks)
    out = {}
    for flash in (True, False):
        model = TransformerLM(**cfg, use_flash=flash, device=cuda)
        model.load_state_dict(params)
        before = fa.LAUNCHES["flash_attention_bwd_dkv"]
        num, den = lm_train._loss(model, toks, labels, mask, None)
        (num / den).backward()
        launched = fa.LAUNCHES["flash_attention_bwd_dkv"] - before
        assert launched == (2 if flash else 0)
        out[flash] = ((num / den).item(),
                      {n: p.grad for n, p in model.named_parameters()})
    assert abs(out[True][0] - out[False][0]) <= 1e-5 * abs(out[False][0])
    for name, g in out[True][1].items():
        ref = out[False][1][name]
        assert (g - ref).abs().max() <= 1e-4 * ref.abs().max(), name
