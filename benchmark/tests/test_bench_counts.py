"""The yardstick's counts, pinned to hand counts: the model FLOPs of a
training step of each configuration and K/V bytes a token (SmolLM's,
``arch/smollm.py``), the flash-attention bound of the kernel table's
row 1 and flash decode's byte count at its row 4."""

import json

import pytest
from conftest import BENCH

from harness import counts


def cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_train_step_flops(smollm):
    assert smollm.train_step_flops(cfg("smollm-1.7b"), 8, 2048) == \
        pytest.approx(1.781e14, rel=1e-3)
    assert smollm.train_step_flops(cfg("smollm-360m"), 16, 2048) == \
        pytest.approx(8.35e13, rel=1e-3)


def test_kv_bytes_per_token(smollm):
    assert smollm.kv_bytes_per_token(cfg("smollm-1.7b")) == 196_608
    assert smollm.kv_bytes_per_token(cfg("smollm-360m")) == 40_960


def test_flash_attention_bound_row1():
    # B 8, T 2048, H 8, D 64: forward 0.034759 ms, dQ 0.052138, dK/dV
    # 0.069518 (the kernel table's bounds).
    for kind, ms in (("fwd", 0.034759), ("dq", 0.052138),
                     ("dkv", 0.069518)):
        assert counts.flash_attention_bound_s(kind, 8, 2048, 8, 64) * 1e3 \
            == pytest.approx(ms, abs=5e-7)


def test_flash_decode_bytes_row4():
    # B 1, H = KVH = 8, D 64, 731 visible keys: 0.000448 ms at 3.35 TB/s.
    b = counts.flash_decode_bytes([731], 8, 8, 64)
    assert b == 731 * 8 * 64 * 2 * 2 + 2 * 8 * 64 * 2
    assert b / counts.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.000448,
                                                            abs=5e-7)


def test_share_over_100_raises():
    assert counts.share(1, 2, "x") == 50.0
    with pytest.raises(ValueError):
        counts.share(2, 1, "x")
