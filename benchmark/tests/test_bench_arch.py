"""An architecture is a set of files (``arch/<architecture>.py``,
``reference/<architecture>.py``, ``configs/<name>.json``): the harness
builds, draws and counts each configuration through its architecture's
module, found by the configuration's ``architecture``.

Pinned: SmolLM's drawn weights kind by kind with their salts and leaf
names, its counts at the cells' shapes and its sizes.  A change to a
law, a salt, the order of the kinds or a count changes what every cell
reads.  Then a copy of SmolLM's two files under another name runs the
tiny cells to the same checks, and a kind held by every other layer
stacks over just those layers."""

import hashlib
import json
import math
import shutil

import pytest
import torch
from conftest import BENCH, DATA, REPO, TINY_CELLS, tiny_spec

from harness import run_cell, serve, weights
from harness.manifest import BENCH_DIR, Manifest

SEED = 2 ** 31 + 41
TINY = json.loads((DATA / "configs" / "tiny.json").read_text())
LAYER_KINDS = ("ln_attn.scale", "attn.q", "attn.k", "attn.v", "attn.out",
               "ln_mlp.scale", "gate", "up", "down")

# Each kind of the tiny configuration drawn on the CPU in f32 from SEED:
# (name, salt, stacked shape, first 16 hex digits of the sha256 of its
# bytes).
TINY_DRAWS = [
    ("embed", 1, (512, 128), "bcbee8aca9aaec8f"),
    ("ln_f.scale", 2, (128,), "02722f124d0f1736"),
    ("blocks.{}.ln_attn.scale", 3, (2, 128), "893a106828fbdb95"),
    ("blocks.{}.attn.q", 4, (2, 128, 4, 32), "7189107ff76b4c89"),
    ("blocks.{}.attn.k", 5, (2, 128, 2, 32), "132bfa63ddd9a751"),
    ("blocks.{}.attn.v", 6, (2, 128, 2, 32), "f9f6b8067f315964"),
    ("blocks.{}.attn.out", 7, (2, 4, 32, 128), "79236d8840b65604"),
    ("blocks.{}.ln_mlp.scale", 8, (2, 128), "893a106828fbdb95"),
    ("blocks.{}.gate", 9, (2, 128, 256), "8b74729c7157096f"),
    ("blocks.{}.up", 10, (2, 128, 256), "2f561178c6aeb004"),
    ("blocks.{}.down", 11, (2, 256, 128), "1c4c2ac2bc872259"),
]

SIZES = {
    "smollm-1.7b": {"D": 2048, "H": 32, "KVH": 32, "hd": 64, "F": 8192,
                    "V": 49152, "L": 24, "eps": 1e-06, "theta": 10000.0},
    "smollm-360m": {"D": 960, "H": 15, "KVH": 5, "hd": 64, "F": 2560,
                    "V": 49152, "L": 32, "eps": 1e-06, "theta": 10000.0},
}

# (configuration, count, arguments, value): a training step at the
# training cells' batch x 2048, a serve-doc fleet's 128 prompts of 1,536
# tokens, one token seeing 2,048 keys, and K/V bytes a token.
COUNTS = [
    ("smollm-1.7b", "train_step_flops", (24, 2048), 534377146613760.0),
    ("smollm-360m", "train_step_flops", (40, 2048), 208750510080000.0),
    ("smollm-1.7b", "forward_flops", (128 * 1536, 128 * 1536 * 1537 // 2),
     702607257501696),
    ("smollm-360m", "forward_flops", (128 * 1536, 128 * 1536 * 1537 // 2),
     160815655157760),
    ("smollm-1.7b", "forward_flops", (1, 2048), 3825205248),
    ("smollm-360m", "forward_flops", (1, 2048), 975175680),
    ("smollm-1.7b", "kv_bytes_per_token", (), 196608),
    ("smollm-360m", "kv_bytes_per_token", (), 40960),
]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


def test_tiny_draws_kind_by_kind(smollm):
    got = [(kind.name, salt, tuple(stacked.shape), digest(stacked))
           for salt, (kind, stacked) in enumerate(
               weights.stacks(smollm.kinds(TINY), SEED, "cpu"), 1)]
    assert got == TINY_DRAWS


def test_tiny_leaf_names_in_order(smollm):
    names = list(weights.draw(smollm.kinds(TINY), SEED, "cpu"))
    assert names == ["embed", "ln_f.scale"] + [
        f"blocks.{i}.{k}" for k in LAYER_KINDS for i in range(2)]


@pytest.mark.parametrize("name,count,args,value", COUNTS,
                         ids=[f"{c[0]}-{c[1]}-{i}"
                              for i, c in enumerate(COUNTS)])
def test_counts_at_the_cells_shapes(smollm, name, count, args, value):
    got = getattr(smollm, count)(config(name), *args)
    assert got == value and type(got) is type(value)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sizes(smollm, name):
    assert smollm.sizes(config(name)) == SIZES[name]


class StepClock:
    """A clock that moves 10 ms a reading, so that a serving window holds
    the same iterations, and finishes the same requests, in every run."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01
        return self.t


def copied_manifest(tmp_path, name):
    """A manifest whose tiny configuration names the architecture
    ``name``, made of copies of SmolLM's two files and nothing else."""
    for sub in ("arch", "reference"):
        (tmp_path / sub).mkdir()
        shutil.copy(BENCH / sub / "smollm.py", tmp_path / sub / f"{name}.py")
    (tmp_path / "configs").mkdir()
    cfg_path = tmp_path / "configs" / "tiny.json"
    cfg_path.write_text(json.dumps(dict(TINY, architecture=name)))
    spec = tiny_spec()
    spec["configs"] = [{"name": "tiny", "file": str(cfg_path)}]
    return Manifest(spec, REPO, search=[tmp_path, DATA, BENCH_DIR])


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_an_architecture_of_new_files_only(tiny_manifest, tmp_path,
                                           monkeypatch, cell):
    copy = copied_manifest(tmp_path, "smollm_copy")
    results = []
    for manifest in (tiny_manifest, copy):
        monkeypatch.setattr(serve, "clock", StepClock())
        results.append(run_cell(manifest, cell, SEED, 2.0, False, "cpu",
                                0.0))
    (want, _), (got, rec) = results
    assert rec.arch.__file__ == str(tmp_path / "arch" / "smollm_copy.py")
    assert rec.cfg["architecture"] == "smollm_copy"
    assert want["correct"] and got["correct"]
    assert got["checks"] == want["checks"]


def test_a_kind_on_every_other_layer(tiny_manifest):
    arch = tiny_manifest.arch("every_other")
    cfg = dict(TINY, architecture="every_other", num_hidden_layers=4)
    kinds = arch.kinds(cfg)
    drawn = weights.draw(kinds, SEED, "cpu")
    assert list(drawn) == (
        ["embed"] + [f"blocks.{i}.gate" for i in range(4)]
        + ["blocks.0.up", "blocks.2.up", "blocks.1.ln.scale",
           "blocks.3.ln.scale"])
    up = kinds.index(next(k for k in kinds if k.name == "blocks.{}.up"))
    assert weights.draw_kind(kinds[up], up + 1, SEED, "cpu").shape == \
        (2, 128, 256)
    # The declared salt, the kind's place + 1, seeds the law: a normal
    # truncated to [-2, 2] by its inverse CDF, scaled to variance
    # 1/fan_in.
    g = torch.Generator().manual_seed((SEED * 1_000_003 + up + 1)
                                      % (2 ** 63))
    lo, hi = ((1 + math.erf(x / math.sqrt(2))) / 2 for x in (-2, 2))
    want = torch.empty(2, 128, 256).uniform_(2 * lo - 1, 2 * hi - 1,
                                             generator=g)
    want.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    want.mul_(math.sqrt(1.0 / 128) / weights.TRUNC_STD)
    assert torch.equal(torch.stack([drawn["blocks.0.up"],
                                    drawn["blocks.2.up"]]), want)
    assert torch.equal(drawn["blocks.3.ln.scale"], torch.ones(128))
