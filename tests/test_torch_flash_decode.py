"""The PyTorch port's flash decode against the JAX package's Pallas kernel.

On the CPU the port's ``flash_decode`` runs its plain version
(``flash_decode_reference``); the JAX side runs ``_fd_kernel`` in
interpret mode, as tests/test_flash_decode.py does.  Same inputs (numpy,
seeded) on both sides.  Tolerances are the JAX kernel's own: 2e-5 in f32
(f32 accumulation, another summation order), 3e-2 in bf16 (p is rounded
to bf16 against a different running max, output rounded to bf16).

The CUDA kernel itself runs only on the card: its tests are in
tests/test_torch_cuda_kernels.py, marked ``cuda``, and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import flash_decode as jfd
from container_engine_accelerators_tpu_torch.ops import flash_decode as fd
from flash_decode_inputs import p_cast_inputs

TOL = {"f32": 2e-5, "bf16": 3e-2}
JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _mk(b, cache_len, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d), dtype=np.float32),
            rng.standard_normal((b, cache_len, kvh, d), dtype=np.float32),
            rng.standard_normal((b, cache_len, kvh, d), dtype=np.float32))


def _jax(q, k, v, lengths, dtype="f32", block_k=fd.BLOCK_K):
    jd = JAX_DTYPE[dtype]
    out = jfd.flash_decode(jnp.asarray(q, jd), jnp.asarray(k, jd),
                           jnp.asarray(v, jd),
                           jnp.asarray(lengths, jnp.int32),
                           block_k=block_k, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, lengths, dtype="f32"):
    td = TORCH_DTYPE[dtype]
    out = fd.flash_decode(torch.from_numpy(q).to(td),
                          torch.from_numpy(k).to(td),
                          torch.from_numpy(v).to(td),
                          torch.tensor(lengths, dtype=torch.int32))
    assert out.dtype == td
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("kvh,h", [(4, 4), (2, 4), (1, 4)])
def test_matches_jax_kernel_across_groups_and_blocks(kvh, h, block_k, dtype):
    q, k, v = _mk(3, 128, h, kvh, 16)
    lengths = [1, 57, 128]  # edge, mid, full
    np.testing.assert_allclose(
        _port(q, k, v, lengths, dtype),
        _jax(q, k, v, lengths, dtype, block_k),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_nan_tail_is_never_read(dtype):
    """NaN K/V past the visible length must not reach the output.  The
    JAX kernel skips whole blocks only, so its NaN tail starts on a block
    boundary; the port never computes with a slot >= length, so a NaN
    tail starting mid-block is inert too."""
    q, k, v = _mk(1, 128, 4, 2, 16, seed=2)
    tail = np.arange(128)[None, :, None, None] >= 64
    k_nan, v_nan = np.where(tail, np.nan, k), np.where(tail, np.nan, v)
    got = _port(q, k_nan, v_nan, [64], dtype)
    np.testing.assert_allclose(
        got, _jax(q, k_nan, v_nan, [64], dtype, block_k=32),
        atol=TOL[dtype], rtol=TOL[dtype])
    mid = np.arange(128)[None, :, None, None] >= 40
    got_mid = _port(q, np.where(mid, np.nan, k), np.where(mid, np.nan, v),
                    [40], dtype)
    assert np.isfinite(got_mid).all()
    np.testing.assert_allclose(got_mid, _jax(q, k, v, [40], dtype, 32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_non_multiple_cache_length():
    q, k, v = _mk(1, 96, 4, 2, 16)  # 96 % 64 != 0 -> the JAX kernel uses 48
    np.testing.assert_allclose(_port(q, k, v, [70]),
                               _jax(q, k, v, [70], block_k=64),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cache_len,block_k,want", [
    (2176, 512, 272), (64, 48, 32), (97, 512, 97), (1056, 512, 352),
    (4096, 512, 512), (40, 512, 40)])
def test_effective_block_k_matches_jax(cache_len, block_k, want):
    assert fd.effective_block_k(cache_len, block_k) == want
    assert jfd.effective_block_k(cache_len, block_k) == want


_PLAN_SHIM = """
#include "flash_decode_plan.h"
extern "C" {
int plan_splits(int b, int h, int kvh, int d, int elem, int l, int sms) {
  return make_plan(b, h, kvh, d, elem, l, sms, (d * elem) % 16 == 0).splits;
}
int plan_rows(int b, int h, int kvh, int d, int elem, int l, int sms) {
  return make_plan(b, h, kvh, d, elem, l, sms, (d * elem) % 16 == 0).rows;
}
int group_rows(int g, int d, int elem) { return rows_per_cta(g, row_bytes(d, elem), elem); }
int plan_keys(int d, int elem) { return kPasses * 32 / lanes_per_key(row_bytes(d, elem)); }
int plan_cap(int rows) { return rows == 1 ? 8 : kMaxSplits; }
}
"""


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """The kernel's own plan (csrc/flash_decode_plan.h, plain C++), built
    with the host compiler: the one definition the launcher uses."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path

    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "no host C++ compiler"
    out = tmp_path_factory.mktemp("plan")
    (out / "shim.cpp").write_text(_PLAN_SHIM)
    csrc = Path(fd.__file__).resolve().parent / "csrc"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(csrc),
                    str(out / "shim.cpp"), "-o", str(out / "plan.so")],
                   check=True)
    return ctypes.CDLL(str(out / "plan.so"))


@pytest.mark.parametrize("b,h,kvh,cache_len", [
    (1, 8, 8, 1056), (1, 8, 8, 4096), (1, 8, 8, 40), (3, 16, 1, 1056),
    (64, 8, 8, 1056), (66, 8, 8, 1056), (1, 8, 8, 1), (2, 8, 2, 97)])
def test_split_plan_covers_the_cache_in_whole_tiles(plan, b, h, kvh,
                                                     cache_len):
    """The CTAs that share a row block's keys: about 4 a multiprocessor
    where the row blocks alone are fewer, one cluster's worth at most (8
    for one-row CTAs, else 16), never more than the cache has whole
    tiles, and one CTA a row block once the row blocks fill the card 4
    times over.  The rows a CTA: the group's (1, 4, or as many as a
    lane's accumulator holds), or one where those row blocks would leave
    SMs idle at the widest cluster, or where rows are not whole 16-byte
    chunks (no TMA: the plain-load copy is built for one row).  Head dims
    with and without whole 16-byte rows."""
    for d, itemsize in ((64, 2), (40, 2), (256, 2), (64, 4), (256, 4),
                        (20, 2), (6, 4), (255, 4)):
        splits = plan.plan_splits(b, h, kvh, d, itemsize, cache_len, 132)
        step = plan.plan_keys(d, itemsize)
        assert step in (2, 4, 8, 16)
        g = h // kvh
        rows = plan.plan_rows(b, h, kvh, d, itemsize, cache_len, 132)
        full = plan.group_rows(g, d, itemsize)
        assert full in (1, 4, 8, 16) and (full == 1) == (g == 1)
        tma = d * itemsize % 16 == 0  # else the one-row plain-load copy
        assert rows == (full if tma else 1) or rows == 1
        if rows != full and tma:  # the group's row blocks leave SMs idle
            assert b * kvh * -(-g // full) * plan.plan_cap(full) < 132
        assert 1 <= splits <= plan.plan_cap(rows) <= 16
        assert splits <= -(-cache_len // step)  # every CTA can get a tile
        groups = b * kvh * -(-g // rows)
        assert splits == 1 or groups * (splits - 1) < 4 * 132  # ~4 a SM
        if groups * 2 <= 4 * 132 and cache_len >= 2 * 16 * step:
            assert splits >= 2  # the row blocks alone would leave SMs idle
        if groups >= 4 * 132:
            assert splits == 1  # enough CTAs already: one each
    assert plan.plan_splits(1, 8, 8, 64, 2, 1056, 132) == 8  # serving
    assert plan.plan_splits(8, 8, 2, 64, 2, 4096, 132) == 16  # ragged GQA
    assert plan.plan_rows(8, 8, 2, 64, 2, 4096, 132) == 4
    assert plan.plan_rows(8, 8, 2, 20, 2, 4096, 132) == 1  # 40-byte rows
    # One KV head at batch 1: one row a CTA, 8 row blocks of 8 CTAs.
    assert plan.plan_rows(1, 8, 1, 64, 2, 4096, 132) == 1
    assert plan.plan_splits(1, 8, 1, 64, 2, 4096, 132) == 8


def test_reference_guards():
    q, k, v = _mk(1, 64, 4, 2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        _port(q[:, :3], k, v, [64])


def _cpu_inputs(dtype=torch.float32):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _mk(2, 64, 4, 2, 16))
    return q, k, v, torch.tensor([3, 64], dtype=torch.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cache_len,length", [
    (33, 1), (40, 6), (96, 65), (1056, 731)])
def test_matches_jax_kernel_at_serving_shapes(cache_len, length, dtype):
    """The server's decode shapes: batch 1, 8 heads x 64, caches of
    bucket + 32 new tokens (33: the warm-up's 1-token bucket, 1056: a
    700-token prompt), lengths from the prefill to the last step."""
    q, k, v = _mk(1, cache_len, 8, 8, 64, seed=cache_len)
    np.testing.assert_allclose(
        _port(q, k, v, [length], dtype), _jax(q, k, v, [length], dtype),
        atol=TOL[dtype], rtol=TOL[dtype])


def test_p_is_cast_to_v_dtype_like_the_jax_kernel():
    """Random inputs cannot see the p cast (it moves the output less than
    bf16 rounds it); these inputs can.  The plain version agrees with the
    JAX kernel to one bf16 step, and the same math with p kept in f32
    does not."""
    q, k, v = p_cast_inputs(1, 1056, 8, 8, 64)
    lengths = [731]
    want = _jax(q, k, v, lengths, "bf16")
    np.testing.assert_allclose(_port(q, k, v, lengths, "bf16"), want,
                               rtol=2 ** -7, atol=0)
    # The same math with p in f32 (the inputs that weigh are bf16-exact).
    p_in_f32 = torch.from_numpy(_port(q, k, v, lengths, "f32")).to(
        torch.bfloat16).float().numpy()
    assert not np.allclose(p_in_f32, want, rtol=2 ** -7, atol=0)
    assert abs(float(want.max()) - 0.00589) < 2e-4


def test_unsupported_device_raises():
    q, k, v, lengths = (t.to("meta") for t in _cpu_inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        fd.flash_decode(q, k, v, lengths)


def test_failed_build_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A kernel that cannot be built is an error on the CUDA path, never
    a silent switch to the plain version."""
    from torch.utils import cpp_extension

    from container_engine_accelerators_tpu_torch.ops import build

    monkeypatch.setattr(build, "_ops", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)  # no nvcc
    before = dict(fd.LAUNCHES)
    with pytest.raises(OSError, match="CUDA_HOME"):
        fd._flash_decode_cuda(*_cpu_inputs(), None)
    assert fd.LAUNCHES == before
    assert build._ops is None
