"""The port's collective engine (``collectives/topo.py``, ``synth.py``,
``runner.py``) held against the JAX package's on the same fleets: equal
comm graphs, schedules and costs (exactly), simulation-correct
schedules, ``combine`` bit-equal to JAX's and to the transfer daemon's
``_combine_into``, and engine rounds over the port's in-process fleet
that move real bytes and re-synthesize on a fault and a heal."""

import json

import numpy as np
import pytest

from container_engine_accelerators_tpu_torch.collectives import synth
from container_engine_accelerators_tpu_torch.collectives.runner import (
    CollectiveConfig,
    CollectiveEngine,
)
from container_engine_accelerators_tpu_torch.fleet.controller import (
    FleetController,
)
from container_engine_accelerators_tpu_torch.fleet.xferd import _combine_into
from container_engine_accelerators_tpu_torch.metrics import counters
from tests.torch_fleet_parity import JAX, PORT

SHAPES = [(4, 1), (4, 2), (6, 3), (5, 2), (8, 4)]
FAULTS = [
    (),
    ("rack:r0<->rack:r1:latency:25",),
    ("rack:r0<->rack:r1:partition",),
    ("node:n0->node:n1:drop:3",),
]
SIZES = [3, 1000, 65536]


def _both(nodes, racks, faults=()):
    return (JAX.graph(nodes, racks=racks, faults=faults),
            PORT.graph(nodes, racks=racks, faults=faults))


def _plan(pkg, graph, collective, nbytes, algorithm):
    try:
        return pkg.synth.synthesize(graph, collective, nbytes,
                                    algorithm=algorithm).to_dict()
    except pkg.synth.SynthesisError as e:
        return ("SynthesisError", str(e))


class TestCommGraphParity:
    @pytest.mark.parametrize("faults", FAULTS)
    @pytest.mark.parametrize("shape", [(4, 2), (5, 2)])
    def test_edges_costs_signature_and_penalty_equal(self, shape, faults):
        gj, gp = _both(*shape, faults=faults)
        assert gp.nodes() == gj.nodes()
        assert gp.order() == gj.order()
        assert gp.racks() == gj.racks()
        assert gp.signature() == gj.signature()
        assert gp.node_health() == gj.node_health()
        pj, pp = gj.scheduler_link_penalty(), gp.scheduler_link_penalty()
        for a in gj.nodes():
            for b in gj.nodes():
                if a == b:
                    continue
                ej, ep = gj.edge(a, b), gp.edge(a, b)
                assert (ep.tier, ep.up, ep.degraded, ep.suspect) == \
                    (ej.tier, ej.up, ej.degraded, ej.suspect)
                for nbytes in SIZES:
                    assert gp.leg_cost_s(a, b, nbytes) == \
                        gj.leg_cost_s(a, b, nbytes)
                host = JAX.topology.topo.HOST_LABEL
                na = {"node_labels": {host: a}}
                nb = {"node_labels": {host: b}}
                assert pp(na, nb) == pj(na, nb)


    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_goodput_evidence_slow_verdict_and_plans_equal(self, seed):
        """Live goodput feeds the ``slow`` verdict and through it the
        searched schedule; on the same seeded rates (some edges idle,
        some a tenth of their tier's peak) both packages flag the same
        edges and plan the same schedules at the same costs."""
        rng = np.random.default_rng(seed)
        table = {}

        def rates(a, b):
            if (a, b) not in table:
                table[(a, b)] = float(rng.choice(
                    [0.0, 5e5, 5e6, 5e7, 5e7, 5e7]))
            return table[(a, b)]

        gj = JAX.graph(5, racks=2, faults=FAULTS[1], rates=rates)
        gp = PORT.graph(5, racks=2, faults=FAULTS[1],
                        rates=lambda a, b: table[(a, b)])
        assert any(gj.edge(a, b).slow for a in gj.nodes()
                   for b in gj.nodes() if a != b)
        for a in gj.nodes():
            for b in gj.nodes():
                if a == b:
                    continue
                ej, ep = gj.edge(a, b), gp.edge(a, b)
                assert (ep.slow, ep.goodput_bps, ep.suspect) == \
                    (ej.slow, ej.goodput_bps, ej.suspect)
                assert gp.leg_cost_s(a, b, 65536) == \
                    gj.leg_cost_s(a, b, 65536)
        assert gp.signature() == gj.signature()
        for collective in synth.COLLECTIVES:
            assert _plan(PORT, gp, collective, 65536, None) == \
                _plan(JAX, gj, collective, 65536, None)


class TestSynthesisParity:
    @pytest.mark.parametrize("algorithm", synth.ALGORITHMS + (None,))
    @pytest.mark.parametrize("collective", synth.COLLECTIVES)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_schedules_and_costs_equal(self, shape, collective, algorithm):
        for faults in FAULTS[:2] if shape[1] > 1 else [()]:
            gj, gp = _both(*shape, faults=faults)
            for nbytes in (1000, 65536):
                assert _plan(PORT, gp, collective, nbytes, algorithm) == \
                    _plan(JAX, gj, collective, nbytes, algorithm)

    @pytest.mark.parametrize("collective", synth.COLLECTIVES)
    def test_estimate_cost_equal_per_family(self, collective):
        gj, gp = _both(6, 3, faults=FAULTS[1])
        for algorithm in synth.AUTO_ALGORITHMS:
            try:
                sj = JAX.synth.synthesize(gj, collective, 65536,
                                          algorithm=algorithm)
            except JAX.synth.SynthesisError:
                continue
            sp = PORT.synth.synthesize(gp, collective, 65536,
                                       algorithm=algorithm)
            assert PORT.synth.estimate_cost_s(gp, sp.steps) == \
                JAX.synth.estimate_cost_s(gj, sj.steps)

    def test_synthesizer_resynthesizes_like_jax(self):
        out = []
        for pkg in (JAX, PORT):
            fleet = pkg.topology.FleetTopology(
                pkg.topology.build_specs(4, racks=2))
            table = pkg.links.LinkTable(fleet)
            s = pkg.synth.Synthesizer("all_reduce", 4096)
            seen = []
            for fault in (None, "rack:r0<->rack:r1:latency:25",
                          "rack:r0<->rack:r1:heal", None):
                if fault:
                    table.apply(fault)
                sched = s.schedule_for(pkg.topo.CommGraph.build(
                    fleet, links=table, rates=lambda a, b: 0.0))
                seen.append((sched.to_dict(), s.resynth_count))
            out.append(seen)
        assert out[1] == out[0]
        assert [n for _, n in out[1]] == [0, 1, 2, 2]

    def test_partition_and_make_inputs_equal(self):
        for nbytes, parts in ((1000, 4), (3, 4), (65537, 7)):
            assert PORT.synth.partition(nbytes, parts) == \
                JAX.synth.partition(nbytes, parts)
        order = ["n0", "n1", "n2", "n3"]
        for collective in synth.COLLECTIVES:
            assert PORT.synth.make_inputs(collective, order, 1000, seed=7) \
                == JAX.synth.make_inputs(collective, order, 1000, seed=7)


class TestSimulation:
    @pytest.mark.parametrize("collective", synth.COLLECTIVES)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_every_lowerable_schedule_matches_expected(self, shape,
                                                       collective):
        g = PORT.graph(*shape)
        for algorithm in synth.ALGORITHMS:
            try:
                sched = synth.synthesize(g, collective, 1000,
                                         algorithm=algorithm)
            except synth.SynthesisError:
                continue
            inputs = synth.make_inputs(collective, sched.order, 1000,
                                       seed=7)
            out = synth.simulate(sched, inputs)
            want = synth.expected_outputs(collective, sched.order, inputs,
                                          1000)
            assert want == JAX.synth.expected_outputs(
                collective, sched.order, inputs, 1000)
            for name, (off, ln, data) in want.items():
                assert bytes(out[name][off:off + ln]) == data, \
                    f"{collective}/{algorithm} wrong on {name}"


class TestCombine:
    @pytest.mark.parametrize("size", [1, 63, 64, 4097])
    def test_combine_bit_equal_to_jax_and_combine_into(self, size):
        """``combine`` (both the loop below 64 bytes and the numpy
        path), JAX's ``combine`` and the daemon's ``_combine_into``
        agree byte for byte on seeded data."""
        rng = np.random.default_rng(size)
        base = rng.integers(0, 256, size + 16, dtype=np.uint8).tobytes()
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        outs = []
        for fn in (synth.combine, JAX.synth.combine, _combine_into):
            dst = bytearray(base)
            fn(dst, 8, payload)
            outs.append(bytes(dst))
        want = bytearray(base)
        want[8:8 + size] = ((np.frombuffer(base, np.uint8)[8:8 + size]
                             .astype(np.int32)
                             + np.frombuffer(payload, np.uint8)) % 256
                            ).astype(np.uint8).tobytes()
        assert outs[0] == outs[1] == outs[2] == bytes(want)


def test_collective_config_from_scenario_equal():
    from container_engine_accelerators_tpu.collectives.runner import (
        CollectiveConfig as JConfig,
    )

    blob = {"op": "all_gather", "bytes": 1234, "definitely_a_typo": 9,
            "algorithm": "ring", "routed": True}
    port, jax_cfg = (CollectiveConfig.from_scenario(blob),
                     JConfig.from_scenario(blob))
    assert CollectiveConfig._FIELDS == JConfig._FIELDS
    assert {f: getattr(port, f) for f in port._FIELDS} == \
        {f: getattr(jax_cfg, f) for f in jax_cfg._FIELDS}
    assert CollectiveConfig.from_scenario(None).op == "all_reduce"


class TestRunner:
    def _fleet(self, nodes=3, racks=1):
        return FleetController({
            "name": "engine-test", "nodes": nodes, "racks": racks,
            "chips": 2, "topology": "1x2x1", "rounds": 0,
            "metrics": False,
        }).boot()

    @pytest.mark.parametrize("collective", synth.COLLECTIVES)
    def test_round_verifies_on_the_wire_and_accounts(self, collective):
        ctl = self._fleet()
        try:
            engine = CollectiveEngine(
                ctl.nodes, ctl.topology, links=ctl.links,
                cfg=CollectiveConfig(op=collective, bytes=4096))
            try:
                before = counters.get("collective.transfers")
                entry = engine.run_round(0)
                assert entry["ok"], entry
                assert entry["collective"] == collective
                assert entry["busbw_bps"] > 0 and entry["time_ms"] > 0
                assert counters.get("collective.transfers") == \
                    before + entry["transfers"]
                assert sum(l["bytes"] for l
                           in ctl.links.report().values()) > 0
                order = engine.synth.current().order
                inputs = JAX.synth.make_inputs(collective, order, 4096,
                                               seed=0)
                want = JAX.synth.expected_outputs(collective, order,
                                                  inputs, 4096)
                assert sorted(engine.last_outputs) == sorted(want)
                for name, (off, ln, data) in want.items():
                    assert bytes(engine.last_outputs[name][off:off + ln]) \
                        == data
            finally:
                engine.close()
        finally:
            ctl.close()

    def test_last_outputs_cleared_by_a_routed_round(self):
        ctl = self._fleet()
        try:
            engine = CollectiveEngine(
                ctl.nodes, ctl.topology, links=ctl.links,
                cfg=CollectiveConfig(op="all_reduce", bytes=4096))
            try:
                assert engine.run_round(0)["ok"]
                assert engine.last_outputs is not None
                engine.cfg.routed = True
                routed = engine.run_round(1)
                assert routed["ok"] and routed["routed"]["forward_legs"] > 0
                assert engine.last_outputs is None
            finally:
                engine.close()
        finally:
            ctl.close()

    def test_fault_resynthesizes_heal_recovers_partition_fails(self):
        ctl = self._fleet(nodes=4, racks=2)
        try:
            engine = CollectiveEngine(
                ctl.nodes, ctl.topology, links=ctl.links,
                cfg=CollectiveConfig(op="all_reduce", bytes=8192,
                                     leg_attempts=1, leg_deadline_s=2.0,
                                     land_timeout_s=0.5))
            try:
                healthy = engine.run_round(0)
                assert healthy["ok"] and healthy["resynth"] == 0
                ctl.links.apply("rack:r0<->rack:r1:latency:25")
                degraded = engine.run_round(1)
                assert degraded["ok"] and degraded["resynth"] == 1
                ctl.links.apply("rack:r0<->rack:r1:heal")
                recovered = engine.run_round(2)
                assert recovered["ok"] and recovered["resynth"] == 1
                assert engine.synth.resynth_count == 2
                ctl.links.apply("rack:r0<->rack:r1:partition")
                failed = engine.run_round(3)
                assert not failed["ok"] and failed["error"]
                assert failed["busbw_bps"] == 0.0
                assert engine.last_outputs is None
                ctl.links.apply("rack:r0<->rack:r1:heal")
                assert engine.run_round(4)["ok"]
                assert json.dumps(engine.synth.current().to_dict())
            finally:
                engine.close()
        finally:
            ctl.close()
