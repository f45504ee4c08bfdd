"""The traffic generator: the same seed gives the same inputs, every
seed the same sizes in another order, and every length lies in its
mix's range and fits the slots."""

import json
from collections import Counter

import pytest
from conftest import BENCH

from harness import traffic
from harness.manifest import Manifest

SERVE = ["serve-doc"]


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def draw(name, seed, n):
    s = traffic.ServeTraffic(mix(name), 49152, seed)
    return [s.next() for _ in range(n)]


@pytest.mark.parametrize("name", SERVE)
def test_same_seed_same_requests(name):
    a, b = draw(name, 2 ** 31 + 11, 40), draw(name, 2 ** 31 + 11, 40)
    assert [(r.prompt, r.max_new) for r in a] == \
        [(r.prompt, r.max_new) for r in b]
    c = draw(name, 2 ** 31 + 12, 40)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", SERVE)
def test_lengths_in_range_and_fit(name):
    m = mix(name)
    lo, hi = traffic.bounds(m["prompt_len"])
    olo, ohi = traffic.bounds(m["output_len"])
    for r in draw(name, 5, 3 * m["block"]):
        assert lo <= len(r.prompt) <= hi
        assert 1 <= r.max_new <= ohi
        if r.index >= m["clients"] or m.get("fill") != "staggered":
            assert r.max_new >= olo
        assert len(r.prompt) + r.max_new <= m["max_len"]
        assert all(0 <= t < 49152 for t in r.prompt)


@pytest.mark.parametrize("name", SERVE)
def test_every_seed_the_same_sizes(name):
    """A block of requests holds the same prompt lengths for every seed,
    in another order."""
    n = mix(name)["block"]
    a, b = (draw(name, seed, n) for seed in (1, 2))
    assert Counter(len(r.prompt) for r in a) == \
        Counter(len(r.prompt) for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_grid_laws():
    assert list(traffic.grid({"law": "fixed", "value": 3}, 4)) == [3] * 4
    g = traffic.grid({"law": "log-uniform", "low": 128, "high": 512}, 1000)
    assert g.min() >= 128 and g.max() <= 512
    assert abs(sorted(g)[500] - 256) <= 1  # the geometric middle


def test_unknown_law_refused():
    with pytest.raises(ValueError):
        traffic.grid({"law": "uniform", "low": 1, "high": 2}, 4)


def test_train_batches_deterministic():
    m = mix("train-2k-b24")
    m.update(batch=2, seq_len=16)
    a = traffic.train_batches(m, 49152, 7, "cpu")
    b = traffic.train_batches(m, 49152, 7, "cpu")
    assert a.shape == (m["batches"], 2, 16) and bool((a == b).all())
    rows = a.reshape(-1, 16)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_configs_fit_their_mixes():
    for cfg_name, mix_name in (("smollm-1.7b", "serve-doc"),):
        cfg = json.loads((BENCH / "configs" / f"{cfg_name}.json")
                         .read_text())
        assert mix(mix_name)["max_len"] <= cfg["max_position_embeddings"]
        arch = Manifest.load().arch(cfg["architecture"])
        assert arch.sizes(cfg)["V"] == 49152
