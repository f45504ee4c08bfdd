"""The manifest and every file it names: each cell finds its
configuration, its traffic mix, its runner, its limits and a reader for
every metric it reports, by name; and the manifest keeps its required
shape."""

import json
import re

import pytest
from conftest import BENCH, REPO

from harness.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(scope="module")
def manifest():
    return Manifest.load(REPO / "BENCHMARK.json")


def test_runner_is_the_harness_module(manifest):
    """A tool that patches ``harness.<kind>`` patches the runner a run
    uses."""
    from harness import serve, train

    assert manifest.runner("serve") is serve
    assert manifest.runner("train") is train


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(manifest, cell):
    entry = manifest.cell(cell)
    cfg = manifest.config(entry["config"])
    mix = manifest.mix(entry["traffic"])
    assert manifest.runner(mix["kind"]).run
    assert manifest.reference(cfg["architecture"]).Reference
    limits = manifest.limits(cell)
    assert any("limit" in v for v in limits.values())
    for v in limits.values():
        assert v["limit"] > 0 if "limit" in v else v["not_compared"]
    for group in ("end_to_end", "per_layer"):
        metrics = manifest.metrics_for(cell, group)
        assert metrics, (cell, group)
        for m in metrics:
            assert callable(manifest.reader(m["name"]))
    names = {m["name"] for m in manifest.metrics_for(cell, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2


def test_unknown_cell_is_refused(manifest):
    with pytest.raises(KeyError):
        manifest.cell("no-such-cell")


def test_manifest_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in SPEC["workloads"]:
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(cfg):
    data = json.loads((REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert set(data["reduced"]) <= set(data["published"])
    assert data["assumed"] and data["deployment"]
    assert data["hidden_size"] == (data["num_attention_heads"]
                                   * data["head_dim"])
