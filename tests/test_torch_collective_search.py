"""The port's sketch-guided schedule search (``collectives/search.py``)
held against the JAX package's: the sketch grammar, the ring orders
(greedy plus 2-opt), the gateway choices, each sketch's lowered steps and
the searched schedule are pure functions of the comm graph, so on the
same fleets and faults they must be equal, not close.  Also: the
searched schedule avoids the degraded spine, beats every family's
modeled cost there, stays pin-only, and every schedule the engine
lowers is hazard-free for the routed runner."""

import pytest

from container_engine_accelerators_tpu_torch.collectives import search, synth
from container_engine_accelerators_tpu_torch.collectives.runner import (
    DEFAULT_SPINE_FAULTS,
    CollectiveEngine,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from tests.torch_fleet_parity import JAX, PORT

RIGS = [
    ((4, 1), ()),
    ((4, 2), ()),
    ((5, 2), DEFAULT_SPINE_FAULTS),
    ((6, 3), ("rack:r0<->rack:r1:latency:25",)),
    ((8, 4), ("rack:r0<->rack:r2:partition",)),
]


def _steps(steps):
    return [[(t.src, t.dst, t.offset, t.nbytes, t.reduce, t.phase) for t in g]
            for g in steps]


@pytest.mark.parametrize("rig", RIGS, ids=lambda r: f"{r[0]}-{len(r[1])}")
def test_grammar_orders_and_gateways_equal(rig):
    (nodes, racks), faults = rig
    gj = JAX.graph(nodes, racks=racks, faults=faults)
    gp = PORT.graph(nodes, racks=racks, faults=faults)
    for nbytes in (4096, 65536):
        assert search._ring_orders(gp, nbytes) == \
            JAX.search._ring_orders(gj, nbytes)
        sk_p = search.sketches(gp, nbytes)
        sk_j = JAX.search.sketches(gj, nbytes)
        assert [s.label() for s in sk_p] == [s.label() for s in sk_j]
        probe = max(1, nbytes // nodes)
        racks_p = list(gp.racks().values())
        if len(racks_p) >= 2:
            assert search._gateway_choices(gp, racks_p, probe) == \
                JAX.search._gateway_choices(
                    gj, list(gj.racks().values()), probe)
        for a, b in zip(sk_p, sk_j):
            for collective in synth.COLLECTIVES:
                try:
                    want = _steps(JAX.search.lower_sketch(
                        gj, b, collective, nbytes))
                except JAX.synth.SynthesisError:
                    with pytest.raises(synth.SynthesisError):
                        search.lower_sketch(gp, a, collective, nbytes)
                    continue
                assert _steps(search.lower_sketch(
                    gp, a, collective, nbytes)) == want


@pytest.mark.parametrize("collective", synth.COLLECTIVES)
@pytest.mark.parametrize("rig", RIGS, ids=lambda r: f"{r[0]}-{len(r[1])}")
def test_search_steps_equal_and_verified(rig, collective):
    (nodes, racks), faults = rig
    gj = JAX.graph(nodes, racks=racks, faults=faults)
    gp = PORT.graph(nodes, racks=racks, faults=faults)
    steps = search.search_steps(gp, collective, 4096)
    assert _steps(steps) == _steps(
        JAX.search.search_steps(gj, collective, 4096))
    sched = synth.synthesize(gp, collective, 4096, algorithm="searched")
    inputs = synth.make_inputs(collective, sched.order, 4096, seed=3)
    out = synth.simulate(sched, inputs)
    for name, (off, ln, data) in synth.expected_outputs(
            collective, sched.order, inputs, 4096).items():
        assert bytes(out[name][off:off + ln]) == data, name


def test_searched_avoids_spine_and_beats_families():
    g = PORT.graph(5, racks=2, faults=DEFAULT_SPINE_FAULTS)
    degraded = {(a, b) for a in g.nodes() for b in g.nodes()
                if a != b and g.edge(a, b).degraded}
    assert degraded
    before = counters.get("collective.search.verified")
    searched = synth.synthesize(g, "all_reduce", 65536,
                                algorithm="searched")
    assert counters.get("collective.search.verified") == before + 1
    used = {(t.src, t.dst) for grp in searched.steps for t in grp}
    assert not used & degraded
    for algo in synth.AUTO_ALGORITHMS:
        try:
            fam = synth.synthesize(g, "all_reduce", 65536, algorithm=algo)
        except synth.SynthesisError:
            continue
        assert searched.est_cost_s < fam.est_cost_s, algo
    # Pin-only: the auto chooser never spends a search.
    assert "searched" in synth.ALGORITHMS
    assert "searched" not in synth.AUTO_ALGORITHMS
    assert synth.synthesize(g, "all_reduce", 65536).algorithm != "searched"


@pytest.mark.parametrize("collective", synth.COLLECTIVES)
@pytest.mark.parametrize("algorithm", synth.ALGORITHMS)
def test_every_lowerable_schedule_is_hazard_free(collective, algorithm):
    for shape in ((4, 1), (4, 2), (6, 2)):
        g = PORT.graph(*shape)
        try:
            sched = synth.synthesize(g, collective, 4096,
                                     algorithm=algorithm)
        except synth.SynthesisError:
            continue
        assert CollectiveEngine._hazard_free(sched), (algorithm, shape)
