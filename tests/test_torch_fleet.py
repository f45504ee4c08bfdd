"""The port's in-process fleet (``fleet/topology.py``, ``links.py``,
``node.py``, ``controller.py``) held against the JAX package's: the
link-fault grammar and link table, the fleet topology and its tiers, and
the same scenario through both controllers — every built-in and every
``scenarios/*.json`` without ``proc`` — with the report's deterministic
fields equal (chip names ``accel<i>`` map to ``nvidia<i>``).  Also the
two divergences kept on purpose (a shared ``slice`` is never ``"ici"``;
``nvidia0`` is the default chip) and the GPU node stack under the fleet
(Xid faults, MIG partitions, the external fault file, per-node metric
servers)."""

import json
import os
import urllib.request

import pytest

from container_engine_accelerators_tpu_torch.fleet.controller import (
    DEFAULT_SCENARIO,
    FleetController,
    _scenario_specs,
    run_scenario,
)
from container_engine_accelerators_tpu_torch.fleet.links import (
    LinkTable,
    parse_link_fault,
)
from container_engine_accelerators_tpu_torch.fleet.node import EmulatedNode
from container_engine_accelerators_tpu_torch.fleet.topology import (
    DEFAULT_CHIP,
    TIER_CROSS_RACK,
    TIER_INTRA_RACK,
    FleetTopology,
    NodeSpec,
    build_specs,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.scheduler import (
    topology as sched_topo,
)
from tests.torch_fleet_parity import (
    JAX,
    PORT,
    SCENARIOS,
    deterministic,
    non_proc_scenario_files,
    plan_on_fault_state,
    to_port_names,
)

LINK_SPECS = [
    "rack:r0<->rack:r1:partition", "node:n0->node:n2:latency:5",
    "*->rack:r1:drop:3", "node:a->node:b:latency:7", "*<->*:drop:2",
    "rack:r0<->rack:r1:heal", "node:n0->node:n1:latency:5000",
    # malformed: logged and skipped in both
    "garbage", "rack:r0:partition", "rack:r0<->rack:r1:frobnicate",
    "rack:r0<->rack:r1:latency:-1", "rack:r0<->rack:r1:drop:0",
    "<->:partition", "node:n0->node:n1:partition:5",
]


def _fault_view(f):
    if f is None:
        return None
    inv = f.inverse()
    return (f.sel_a, f.sel_b, f.bidirectional, f.action, f.param, f.spec(),
            None if inv is None else inv.spec())


@pytest.mark.parametrize("spec", LINK_SPECS)
def test_link_fault_grammar_equal(spec):
    assert _fault_view(parse_link_fault(spec)) == \
        _fault_view(JAX.links.parse_link_fault(spec))


def test_link_table_state_and_report_equal():
    faults = ["rack:r0<->rack:r1:partition", "node:n0->node:n2:latency:2",
              "node:n0->node:n2:drop:2", "node:n0->node:n2:drop:1",
              "not a spec", "rack:r0<->rack:r1:heal",
              "node:n3->node:n1:partition"]
    tables = [LinkTable(FleetTopology(build_specs(4, racks=2))),
              JAX.links.LinkTable(JAX.topology.FleetTopology(
                  JAX.topology.build_specs(4, racks=2)))]
    for f in faults:
        armed = [t.apply(f) for t in tables]
        assert armed[0] == armed[1], f
        assert tables[0].report() == tables[1].report(), f
    assert tables[0].state("n0", "n2").drop_next == 3


def test_topology_selectors_and_tiers_equal():
    fp = FleetTopology(build_specs(6, racks=3))
    fj = JAX.topology.FleetTopology(JAX.topology.build_specs(6, racks=3))
    for sel in ("*", "node:n2", "rack:r1", "rack:nope", "zone:z1"):
        assert fp.select(sel) == fj.select(sel)
    for a in fp.names():
        for b in fp.names():
            if a != b:
                assert fp.tier(a, b) == fj.tier(a, b)
    assert fp.tier("n0", "n3") == TIER_INTRA_RACK
    assert fp.tier("n0", "n1") == TIER_CROSS_RACK


def test_labels_are_the_four_dcn_labels():
    spec = NodeSpec(name="h0", rack="r3", slice_id="s", coords="1,0,0")
    assert set(spec.labels()) == set(sched_topo.DCN_LABELS)
    assert spec.labels()[sched_topo.HOST_LABEL] == "h0"
    assert spec.labels()[sched_topo.RACK_LABEL] == "r3"


def test_shared_slice_is_never_ici():
    """Divergence kept on purpose: the port's scheduler has no ICI tier,
    so two hosts that share a ``slice`` stay a DCN pair (the JAX package
    calls them ``"ici"``)."""
    nodes = [{"name": "h0", "slice": "s0", "coords": "0,0,0"},
             {"name": "h1", "slice": "s0", "coords": "1,0,0"},
             {"name": "h2", "rack": "r1"}]
    fp = FleetTopology(_scenario_specs({"nodes": nodes}))
    fj = JAX.topology.FleetTopology(
        JAX.controller._scenario_specs({"nodes": nodes}))
    assert fj.tier("h0", "h1") == "ici"
    assert fp.tier("h0", "h1") == TIER_INTRA_RACK
    assert fp.distance("h0", "h1") >= sched_topo.DCN_MIN
    assert fp.specs["h1"].slice_id == "s0"
    assert fp.specs["h1"].coords == "1,0,0"
    assert fp.tier("h0", "h2") == fj.tier("h0", "h2") == TIER_CROSS_RACK


def test_nvidia0_is_the_default_chip(tmp_path):
    """Divergence kept on purpose: a chip fault that names no chip (and
    the built-in scenarios' chip faults) hit ``nvidia0``, the port's
    first GPU, where the JAX package's hit ``accel0``."""
    assert DEFAULT_CHIP == "nvidia0"
    chips = [f.get("chip") for f in DEFAULT_SCENARIO["faults"]
             if f.get("action") == "chip_fault"]
    assert chips == ["nvidia0"]
    ctl = FleetController({"name": "default-chip", "nodes": 2, "racks": 1,
                           "chips": 2, "rounds": 0},
                          workdir=str(tmp_path)).boot()
    try:
        record = ctl._apply_fault(0, {"action": "chip_fault", "node": "n1"})
        assert record["applied"] == 1
        assert ctl.nodes["n1"].device_health() == {"nvidia0": "Unhealthy",
                                                   "nvidia1": "Healthy"}
    finally:
        ctl.close()


def _builtin(name):
    return getattr(JAX.controller, name)


SCENARIO_CASES = (
    [("builtin", n) for n in ("DEFAULT_SCENARIO", "DEFAULT_SERVING_SCENARIO",
                              "DEFAULT_COLLECTIVE_SCENARIO")]
    + [("file", f) for f in non_proc_scenario_files()])


@pytest.mark.parametrize("kind,name", SCENARIO_CASES,
                         ids=[n for _, n in SCENARIO_CASES])
def test_same_scenario_through_both_controllers(kind, name, monkeypatch):
    monkeypatch.delenv("TPU_FAULT_SPEC", raising=False)
    plan_on_fault_state(monkeypatch)
    if kind == "builtin":
        jax_sc = _builtin(name)
        port_sc = getattr(PORT.controller, name)
        assert port_sc == to_port_names(jax_sc)
    else:
        jax_sc = JAX.controller.load_scenario(os.path.join(SCENARIOS, name))
        port_sc = to_port_names(jax_sc)
    jax_report = JAX.controller.run_scenario(json.loads(json.dumps(jax_sc)))
    port_report = run_scenario(json.loads(json.dumps(port_sc)))
    want = to_port_names(deterministic(jax_report))
    got = deterministic(port_report)
    assert got == want, _mismatch(got, want, jax_report, port_report)
    assert got["converged"]


def _mismatch(got, want, jax_report, port_report):
    """The differing fields and both packages' round logs, so a
    mismatch says which rounds and legs went apart."""
    diff = {k: {"jax": want.get(k), "port": got.get(k)}
            for k in sorted(set(got) | set(want)) if got.get(k) != want.get(k)}

    def rounds(report):
        return [{k: r.get(k) for k in ("round", "ok", "faults", "collective",
                                       "legs")}
                for r in report["rounds"]]

    return json.dumps({"diff": diff, "jax_rounds": rounds(jax_report),
                       "port_rounds": rounds(port_report)}, default=str)


def test_pipelined_partition_and_socket_lane_knob():
    report = run_scenario({
        "name": "pipelined-partition", "nodes": 3, "racks": 3,
        "rounds": 4, "payload_bytes": 32768, "pipelined": True,
        "tuned": False, "chunk_bytes": 8192, "stripes": 2,
        "faults": [{"round": 1, "link": "rack:r0<->rack:r1:partition",
                    "for": 2}],
    })
    assert report["converged"]
    assert any(not leg.get("ok", False)
               for leg in report["rounds"][1]["legs"])
    delta = report["agent_events_delta"]
    assert delta.get("dcn.pipeline.transfers", 0) > 0
    assert delta.get("dcn.shm.transfers", 0) > 0
    report = run_scenario({
        "name": "pipelined-socket", "nodes": 2, "racks": 2, "rounds": 2,
        "payload_bytes": 16384, "pipelined": True, "tuned": False,
        "chunk_bytes": 8192, "stripes": 2, "shm": False, "faults": [],
    })
    assert report["converged"]
    assert report["agent_events_delta"].get("dcn.shm.transfers", 0) == 0


def test_node_kill_survivors_reconverge_and_lossy_link():
    report = run_scenario({
        "name": "node-churn", "nodes": 4, "racks": 2, "rounds": 4,
        "payload_bytes": 1024, "land_timeout_s": 0.5,
        "faults": [{"round": 1, "action": "kill", "node": "n2", "for": 2},
                   {"round": 1, "link": "node:n0->node:n1:drop:1"},
                   {"round": 1, "link": "node:n3->node:n0:latency:2"}],
    })
    assert report["converged"], report["rounds"][-1]
    skipped = [leg for leg in report["rounds"][1]["legs"]
               if "skipped" in leg]
    assert len(skipped) == 2
    assert report["nodes"]["n2"]["daemon_generation"] == 2
    assert report["links"]["n0->n1"]["drops"] == 1
    assert report["links"]["n3->n0"]["latency_injected_ms"] > 0


class TestGpuNode:
    def test_xid_fault_recovers_through_the_health_checker(self, tmp_path):
        node = EmulatedNode(NodeSpec(name="g", chips=8), str(tmp_path))
        try:
            assert sorted(node.device_health()) == \
                [f"nvidia{i}" for i in range(8)]
            h0 = counters.get("health.recovered")
            node.inject_chip_fault("nvidia3")
            assert node.device_health()["nvidia3"] == "Unhealthy"
            assert not node.all_healthy()
            assert node.force_recover() == 1
            assert node.all_healthy()
            assert counters.get("health.recovered") == h0 + 1
            snap = node.snapshot()
            assert (snap["healthy"], snap["total"]) == (8, 8)
        finally:
            node.close()

    def test_mig_profile_partitions_the_node(self, tmp_path):
        node = EmulatedNode(NodeSpec(name="m", chips=2,
                                     partition_size="3g.40gb"),
                            str(tmp_path))
        try:
            health = node.device_health()
            assert len(health) == 4
            assert all(d.startswith(("nvidia0/gi", "nvidia1/gi"))
                       for d in health)
            node.inject_chip_fault("nvidia1")
            assert sorted(d for d, h in node.device_health().items()
                          if h == "Unhealthy") == \
                sorted(d for d in health if d.startswith("nvidia1/"))
            node.force_recover()
            assert node.all_healthy()
        finally:
            node.close()

    def test_external_fault_file_reaches_the_node(self, tmp_path,
                                                  monkeypatch):
        path = tmp_path / "chip_faults"
        monkeypatch.setenv("TPU_CHIP_FAULT_FILE", str(path))
        node = EmulatedNode(NodeSpec(name="f", chips=2), str(tmp_path / "n"))
        try:
            path.write_text("fault nvidia0 48\n")
            node.recover()
            assert node.device_health()["nvidia0"] == "Unhealthy"
            with open(path, "a") as f:
                f.write("clear nvidia0\n")
            node.recover()
            assert node.all_healthy()
        finally:
            node.close()

    def test_per_node_metric_servers(self, tmp_path):
        ctl = FleetController({"name": "metrics", "nodes": 2, "racks": 1,
                               "chips": 2, "rounds": 1,
                               "payload_bytes": 512, "metrics": True,
                               "faults": []}, workdir=str(tmp_path))
        try:
            report = ctl.run()
            assert report["converged"]
            for name, node in ctl.nodes.items():
                port = report["nodes"][name]["metrics_port"]
                node.metrics.collect_once()
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10
                ).read().decode()
                assert 'agent_events{event="xferd.frames.landed"}' in body
                assert "memory_total" in body
        finally:
            ctl.close()
