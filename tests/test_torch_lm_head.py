"""The tied LM head's tensor-core path (``ops/lm_head.py``) on the CPU:
the exact three-way bf16 split of the logits' f32 gradient, the
autograd Function against the f32 expression it replaces, the rule that
picks the path (``models/transformer.py::head_on_tensor_cores``), and
the spans and counter it records.

On the CPU the Function's GEMMs multiply the bf16 values in f32 (exact
products), so it differs from ``x.float() @ e.float().t()`` only by the
order of f32 sums: logits within f32 summation error (D units of 2^-24
of the sum of the products' magnitudes), and dX and dE, each rounded to
bf16 as autograd rounds them, equal but for a rounding tie the other
order tips (one bf16 step).  The split kernel and cuBLAS run only on
the card (``tests/test_torch_cuda_kernels.py``).
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile

from container_engine_accelerators_tpu_torch.models import transformer
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    head_on_tensor_cores,
    init_params,
    lm_head,
)
from container_engine_accelerators_tpu_torch.ops import lm_head as lh
from container_engine_accelerators_tpu_torch.utils.profile import (
    last_window,
    recording,
)

F32_MAX = torch.finfo(torch.float32).max
BF16_MAX = torch.finfo(torch.bfloat16).max


def _parts(g):
    s = lh.split3_reference(g[None])[0].float()
    v = g.numel()
    return s[:v], s[v:2 * v], s[2 * v:]


def _dlogits(m, v, seed):
    """softmax - one-hot over m rows: the cross entropy's gradient of the
    mean loss, the law of G in training."""
    gen = torch.Generator().manual_seed(seed)
    logits = 3 * torch.randn(m, v, generator=gen)
    labels = torch.randint(0, v, (m,), generator=gen)
    return (torch.softmax(logits, -1) - F.one_hot(labels, v)) / m


def _values(case):
    gen = torch.Generator().manual_seed(7)
    u = torch.rand(4096, generator=gen)
    if case == "normal":
        return torch.randn(4096, generator=gen) * 10 ** (8 * u - 4)
    if case == "near_f32_max":
        # Rounding hi to the nearest bf16 would overflow above BF16_MAX.
        return torch.cat([F32_MAX * (1 - u[:2048] * 1e-3),
                          torch.tensor([F32_MAX, BF16_MAX,
                                        (F32_MAX + BF16_MAX) / 2])])
    if case == "near_bf16_limits":
        # f32 values whose bits lie at or above bf16's finest step 2^-133:
        # from 2^-110 up, and bf16's own values at its smallest.
        tiny = torch.tensor([2.0 ** -126, 2.0 ** -133, 2.0 ** -127,
                             3 * 2.0 ** -133, torch.finfo(torch.bfloat16).tiny])
        return torch.cat([2.0 ** -110 * (1 + u), tiny])
    if case == "zeros":
        return torch.tensor([0.0, -0.0] * 8)
    if case == "negatives":
        return -torch.rand(4096, generator=gen) * 10 ** (12 * u - 6)
    assert case == "dlogits"
    return _dlogits(64, 512, 3).flatten()


@pytest.mark.parametrize("case", ["normal", "near_f32_max", "near_bf16_limits",
                                  "zeros", "negatives", "dlogits"])
def test_split_sums_back_to_g_bit_for_bit(case):
    g = _values(case).float()
    hi, mid, lo = _parts(g)
    total = (hi + mid) + lo
    assert torch.isfinite(hi).all() and torch.isfinite(mid).all()
    nonzero = g != 0
    assert torch.equal(total[nonzero].view(torch.int32),
                       g[nonzero].view(torch.int32))
    assert (total[~nonzero] == 0).all()
    # Each part is the truncation of what is left: no part outgrows it.
    assert (hi.abs() <= g.abs()).all() and (mid.abs() <= (g - hi).abs()).all()


def test_split_below_bf16_finest_step_loses_only_those_bits():
    g = torch.cat([2.0 ** -120 * (1 + torch.rand(512)),
                   torch.tensor([1e-40, -1e-45, 2.0 ** -149])])
    hi, mid, lo = _parts(g)
    assert ((hi + mid + lo - g).abs() < 2.0 ** -133).all()


def test_split_keeps_non_finite_values_whole_in_hi():
    g = torch.tensor([float("inf"), -float("inf"), float("nan"), 1.5])
    hi, mid, lo = _parts(g)
    assert hi[0] == float("inf") and hi[1] == -float("inf")
    assert torch.isnan(hi[2]) and hi[3] == 1.5
    assert (mid == 0).all() and (lo == 0).all()


def test_split_wrapper_fills_the_callers_buffer():
    g = _dlogits(5, 12, 1)
    buf = torch.full((8, 36), 7.0, dtype=torch.bfloat16)
    out = lh.split3(g, buf[:5])
    assert out.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:5], lh.split3_reference(g))
    assert (buf[5:] == 7).all()


def _one_ulp(want):
    """One bf16 step at each value of ``want`` (bf16 values)."""
    w = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(w)) - 7)


@pytest.mark.parametrize("grad", ["dlogits", "random"])
def test_tied_head_matches_the_f32_expression(grad):
    """Blocks of 16 rows over 46: three blocks, the last ragged."""
    b, t, d, v = 2, 23, 64, 200
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(b, t, d, generator=gen).to(torch.bfloat16)
    emb = torch.randn(v, d, generator=gen) / d ** 0.5
    g = (_dlogits(b * t, v, 5).view(b, t, v) if grad == "dlogits"
         else torch.randn(b, t, v, generator=gen))

    def run(fn):
        xl = x.clone().requires_grad_()
        el = emb.clone().requires_grad_()
        out = fn(xl, el)
        out.backward(g)
        return out.detach(), xl.grad, el.grad

    want = run(lambda xl, el: xl.float() @ el.to(torch.bfloat16).float().t())
    got = run(lambda xl, el: lh.TiedHead.apply(xl, el.to(torch.bfloat16), 16))
    assert [a.dtype for a in got] == [a.dtype for a in want]
    bound = d * 2.0 ** -24 * (x.float().abs() @ emb.to(torch.bfloat16)
                              .float().abs().t())
    assert ((got[0] - want[0]).abs() <= bound).all()
    for have, ref in zip(got[1:], want[1:]):
        assert torch.equal(have.to(torch.bfloat16).float(), have.float())
        assert ((have.float() - ref.float()).abs() <= _one_ulp(ref)).all()


def test_head_grads_take_only_what_is_wanted():
    g, x = _dlogits(10, 30, 2), torch.randn(10, 8).to(torch.bfloat16)
    e = torch.randn(30, 8).to(torch.bfloat16)
    dx, de = lh.head_grads(g, x, e, 4, want_dx=False)
    assert dx is None and de.dtype == torch.float32
    dx, de = lh.head_grads(g, x, e, 4, want_de=False)
    assert de is None and dx.dtype == torch.float32
    # f32 sums of 3V exact products against V.
    bound = 3 * 30 * 2.0 ** -24 * (g.abs() @ e.float().abs())
    assert ((dx - g @ e.float()).abs() <= bound).all()


@pytest.mark.parametrize("m,v,rows", [
    (49_152, 49_152, 8192),  # smollm-1.7b, 24 x 2048 tokens: 6 blocks
    (81_920, 49_152, 8192),  # smollm-360m, 40 x 2048 tokens: 10 blocks
    (8_192, 49_152, 8192),   # one block
    (100, 49_152, 100),      # fewer rows than a tile: all of them
    (46, 200, 46),
    (300_000, 32_000, 12_544),  # 24 blocks of whole tiles
])
def test_chunk_rows_keeps_the_split_within_its_budget(m, v, rows):
    got = lh.chunk_rows(m, v)
    assert got == rows
    assert 6 * v * got <= lh.SPLIT_BYTES or got == m
    assert got == m or got % 128 == 0


class _CudaLookingDTensor(DTensor):
    """A DTensor that says it is on the card: the rule's DTensor case on
    the CPU (no mesh is built; only the type is read)."""

    is_cuda = True


def _stand_in(cuda=True, dtype=torch.bfloat16, requires_grad=True,
              dtensor=False):
    if dtensor:
        return torch.Tensor._make_subclass(
            _CudaLookingDTensor, torch.empty(2, dtype=dtype), requires_grad)
    return SimpleNamespace(is_cuda=cuda, dtype=dtype,
                           requires_grad=requires_grad)


@pytest.mark.parametrize("x,emb,grad,engages", [
    (_stand_in(), _stand_in(dtype=torch.float32), True, True),
    (_stand_in(cuda=False), _stand_in(cuda=False), True, False),
    (_stand_in(dtype=torch.float32), _stand_in(dtype=torch.float32), True,
     False),
    (_stand_in(), _stand_in(), False, False),
    (_stand_in(), _stand_in(requires_grad=False), True, False),
    (_stand_in(dtensor=True), _stand_in(), True, False),
    (_stand_in(), _stand_in(dtensor=True), True, False),
], ids=["train", "cpu", "f32", "no_grad", "decode", "dtensor_x",
        "dtensor_embedding"])
def test_only_a_plain_cuda_bf16_training_call_engages(x, emb, grad, engages):
    with torch.set_grad_enabled(grad):
        assert head_on_tensor_cores(x, emb) is engages


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_lm_head_takes_the_path_the_rule_picks_and_counts_it(monkeypatch):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 8, 32, generator=gen).to(torch.bfloat16)
    emb = torch.randn(50, 32, generator=gen)
    g = torch.randn(3, 8, 50, generator=gen)

    def run():
        xl, el = x.clone().requires_grad_(), emb.clone().requires_grad_()
        assert not recording()  # so the profile below opens a new window
        with _cpu_profile():
            out = lm_head(xl, el)
            out.backward(g)
        return out.detach(), xl.grad, el.grad, last_window()

    *want, plain = run()
    assert not any(n.startswith("lm.train.head") for n in plain["spans"])
    monkeypatch.setattr(transformer, "head_on_tensor_cores", lambda x, e: True)
    *got, window = run()
    assert {n: s["n"] for n, s in window["spans"].items()} == {
        "lm.train.head.forward": 1, "lm.train.head.backward": 1}
    for have, ref in zip(got, want):
        assert have.dtype == ref.dtype
        torch.testing.assert_close(have, ref, rtol=2 ** -7, atol=1e-6)


def test_train_mode_model_on_the_cpu_keeps_the_f32_expression():
    cfg = dict(vocab_size=97, num_layers=1, num_heads=2, head_dim=8,
               mlp_dim=32)
    m = TransformerLM(**cfg, device="cpu")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(1)))
    toks = torch.randint(0, 97, (2, 16), generator=torch.Generator()
                         .manual_seed(2))
    assert not recording()
    with _cpu_profile():
        assert recording()
        logits = m(toks)
    hidden = m(toks, project=False)
    want = hidden.float() @ m.embed.to(torch.bfloat16).float().t()
    assert torch.equal(logits, want)
    assert not any(n.startswith("lm.train.head")
                   for n in last_window()["spans"])


@pytest.mark.parametrize("k,depth,pieces", [(200, 64, 4), (200, 128, 2),
                                            (200, 512, 1), (960, 512, 2)])
def test_gemm_sums_its_depth_in_pieces(monkeypatch, k, depth, pieces):
    gen = torch.Generator().manual_seed(9)
    a = torch.randn(6, k, generator=gen).to(torch.bfloat16)
    b = torch.randn(k, 5, generator=gen).to(torch.bfloat16)
    calls = []
    for name in ("_mm", "_mm_into"):
        fn = getattr(lh, name)
        monkeypatch.setattr(lh, name, lambda *t, fn=fn: calls.append(
            t[-1].shape[0]) or fn(*t))
    acc = torch.ones(6, 5)
    got = lh.gemm(a, b, depth, acc)
    assert got is acc and len(calls) == pieces and sum(calls) == k
    assert max(calls) <= depth and (pieces == 1 or calls[0] % 64 == 0)
    bound = k * 2.0 ** -24 * (1 + a.float().abs() @ b.float().abs())
    assert ((got - 1 - a.float() @ b.float()).abs() <= bound).all()
