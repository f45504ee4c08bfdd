"""``correct`` catches the faults a cell can have: the tiny cells, with
the timed path broken underneath (``tools/faults.py``), run through the
harness (its look for a card skipped) and read ``correct`` false; sound
runs read it true.  The serving numbers, and the readings tool that
judges a seed's faults against one run of the reference."""

import pytest
import torch
from conftest import run_tiny

import faults
from harness import compare


@pytest.mark.parametrize("cell,seed", [("tiny.train", 11),
                                       ("tiny.train", 2 ** 31 + 12),
                                       ("tiny.serve", 13),
                                       ("tiny.serve", 2 ** 31 + 14)])
def test_sound_run_is_correct(tiny_manifest, cell, seed):
    result, _ = run_tiny(tiny_manifest, cell, seed)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and not result["failed"]


@pytest.mark.parametrize("fault,cell", [("unchanged", "tiny.train"),
                                        ("half_batch", "tiny.train"),
                                        ("token", "tiny.serve")])
def test_fault_is_caught(tiny_manifest, fault, cell):
    with faults.FAULTS[fault]():
        result, _ = run_tiny(tiny_manifest, cell, 17)
    assert not result["correct"], result["checks"]


def test_serve_numbers_widest_and_mean():
    gaps = [torch.tensor([0.0, 0.5]), torch.tensor([0.0, 0.0, 1.5])]
    got = compare.serve_numbers(gaps)
    assert got["logit_gap"] == 1.5
    assert got["mean_gap"] == pytest.approx(0.4)
    assert compare.serve_numbers([]) == {"logit_gap": 0.0, "mean_gap": 0.0}


def test_readings_judge_each_fault_against_one_reference(tiny_manifest):
    rows = faults.readings(tiny_manifest, "tiny.train", 19,
                           ["none", "half_batch"], 0.3, True, "cpu")
    by = {r["fault"]: r for r in rows}
    assert by["none"]["correct"], by["none"]["checks"]
    assert not by["half_batch"]["correct"], by["half_batch"]["checks"]
    assert not all(c["ok"] for c in by["none"]["control"].values())
    assert "control" not in by["half_batch"]


def test_readings_keep_each_token_gap(tiny_manifest):
    row, = faults.readings(tiny_manifest, "tiny.serve", 21, ["none"], 3.0,
                           False, "cpu", check_tokens=16, keep_gaps=True)
    gaps = row["gaps"]["token_gap"]
    assert row["counters"]["checked_tokens"] == len(gaps) > 0
    assert row["checks"]["mean_gap"]["value"] == pytest.approx(
        sum(gaps) / len(gaps))


def test_int8_weights_serve_through_the_harness(tiny_manifest):
    """The serving control, the program's int8 weight path, builds and
    serves: every answer comes, whole (on the card it has to read
    ``correct`` false; ``test_bench_control.py``)."""
    with faults.FAULTS["int8_weights"]():
        result, rec = run_tiny(tiny_manifest, "tiny.serve", 27)
    assert result["attempted"] > 0 and not result["failed"]
    assert rec.counters["checked_tokens"] > 0
