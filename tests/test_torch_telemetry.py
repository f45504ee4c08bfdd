"""The port's fleet telemetry (``fleet/telemetry.py``) held against the
JAX package's, in both directions: each package's ``FleetTelemetry``
scrapes the other's node ``MetricServer`` (``/metrics``, ``/spans`` and
``/profile``) into the same round entry, the Prometheus text parses to
the same values in both, and the SLO section judges the same inputs
the same way."""

import os
import time

import pytest

import container_engine_accelerators_tpu.fleet.links as j_links
import container_engine_accelerators_tpu.fleet.node as j_node
import container_engine_accelerators_tpu.fleet.telemetry as j_tel
import container_engine_accelerators_tpu.fleet.topology as j_topology
import container_engine_accelerators_tpu.metrics.counters as j_counters
import container_engine_accelerators_tpu.obs.profiler as j_profiler
import container_engine_accelerators_tpu_torch.fleet.links as p_links
import container_engine_accelerators_tpu_torch.fleet.node as p_node
import container_engine_accelerators_tpu_torch.fleet.telemetry as p_tel
import container_engine_accelerators_tpu_torch.fleet.topology as p_topology
import container_engine_accelerators_tpu_torch.metrics.counters as p_counters
import container_engine_accelerators_tpu_torch.obs.profiler as p_profiler
from container_engine_accelerators_tpu_torch.parallel import dcn

PKGS = {
    "jax": (j_topology, j_links, j_node, j_tel, j_counters),
    "port": (p_topology, p_links, p_node, p_tel, p_counters),
}
PAYLOAD = bytes(range(256)) * 16


class _Scraped:
    """What a scrape-mode ``FleetTelemetry`` reads of a node: its
    MetricServer port, its daemon incarnation and its liveness."""

    def __init__(self, node):
        self.metrics_port = node.metrics.port
        self.daemon = node.daemon
        self.down = False


def _fleet_with_traffic(pkg, tmp_path):
    """Two in-process nodes of ``pkg`` with metric servers, one
    transfer n0 -> n1 through the link table, and each server's
    registry republished.  No sampler runs (an earlier test in this
    process may have left one), so ``/profile`` reads the same twice."""
    j_profiler.reset()
    p_profiler.reset()
    topology, links, node, _, _ = PKGS[pkg]
    specs = [topology.NodeSpec(name=n, chips=2) for n in ("n0", "n1")]
    fleet = topology.FleetTopology(specs)
    net = links.FleetNet(links.LinkTable(fleet))
    nodes = {s.name: node.EmulatedNode(
        s, str(tmp_path / pkg / s.name), net=net, metrics=True,
        metrics_interval_s=3600) for s in specs}
    a, b = nodes["n0"], nodes["n1"]
    flow = f"tel-{pkg}"
    a.client.register_flow(flow, bytes=len(PAYLOAD))
    b.client.register_flow(flow, bytes=len(PAYLOAD))
    a.client.put(flow, PAYLOAD)
    a.client.send(flow, "127.0.0.1", b.daemon.data_port)
    dcn.wait_flow_rx(b.client, flow, len(PAYLOAD), timeout_s=10)
    for n in nodes.values():
        n.metrics.collect_once()
    return nodes


@pytest.mark.parametrize("reader,server", [("port", "jax"),
                                           ("jax", "port")])
def test_each_package_scrapes_the_others_worker(reader, server, tmp_path):
    nodes = _fleet_with_traffic(server, tmp_path)
    try:
        tel_mod = PKGS[reader][3]
        t = tel_mod.FleetTelemetry(
            {n: _Scraped(node) for n, node in nodes.items()}, None, None,
            scrape=True, scrape_timeout_s=5.0)
        sample = t.sample_round(0)
        for name in ("n0", "n1"):
            entry = sample["nodes"][name]
            assert entry["stale"] is False, (name, entry)
            assert entry["spans_stale"] is False
            assert entry["profile_stale"] is False
        assert sample["nodes"]["n1"]["transferred"] >= len(PAYLOAD)
        # The landed-frame counter crossed the package boundary.
        assert t._accum_total("frames") >= 1
        # Both packages' parsers read the same exposition identically.
        port = nodes["n1"].metrics.port
        sj = j_tel.scrape_metric_server(port, 5.0)
        sp = p_tel.scrape_metric_server(port, 5.0)
        for family, labels in (
                ("agent_events", {"event": "xferd.frames.landed"}),
                ("agent_gauge", {"name": "xferd.total_transferred"}),
                ("agent_gauge", {"name": "xferd.active_flows"})):
            assert sp.value(family, **labels) == sj.value(family, **labels)
        assert sp.value("agent_events", event="xferd.frames.landed") >= 1
        spans_p = p_tel.scrape_spans(port, 0)
        spans_j = j_tel.scrape_spans(port, 0)
        assert spans_p[1:] == spans_j[1:]
        assert [s["name"] for s in spans_p[0]] == \
            [s["name"] for s in spans_j[0]]
        assert p_tel.scrape_profile(port, 0)[1] == \
            j_tel.scrape_profile(port, 0)[1]
    finally:
        for n in nodes.values():
            n.close()


def test_unreachable_node_is_stale_in_both():
    from tests.mp_runner import free_port

    dead = free_port()

    class _Dead:
        metrics_port = dead
        down = False

    out = []
    for pkg in ("jax", "port"):
        tel_mod, counters = PKGS[pkg][3], PKGS[pkg][4]
        s0 = counters.get("fleet.scrape.stale")
        t = tel_mod.FleetTelemetry({"nx": _Dead()}, None, None,
                                   scrape=True, scrape_timeout_s=0.5)
        out.append((t.sample_round(0)["nodes"]["nx"],
                    counters.get("fleet.scrape.stale") - s0))
    assert out[1] == out[0] == (
        {"goodput_bps": 0.0, "down": False, "stale": True}, 1)


BODY = (
    '# HELP agent_goodput landed bytes\n'
    '# TYPE agent_goodput gauge\n'
    'agent_goodput{scope="node",name="n0"} 1234.5\n'
    'agent_gauge{name="xferd.active_flows"} 2.0\n'
    'agent_events{event="dcn.frames.deduped"} 3.0\n'
    'agent_latency{op="fleet.leg",bucket="128"} 4.0\n'
    'agent_latency{op="fleet.leg",bucket="+Inf"} 5.0\n'
    'agent_gauge{name="quote\\"d\\\\"} 7.0\n'
    'not a sample line\n'
)


def test_prometheus_text_parses_the_same():
    sj, sp = j_tel.parse_prometheus_text(BODY), p_tel.parse_prometheus_text(
        BODY)
    for family, labels in (("agent_goodput", {"scope": "node",
                                              "name": "n0"}),
                           ("agent_gauge", {"name": "xferd.active_flows"}),
                           ("agent_events", {"event": "dcn.frames.deduped"}),
                           ("agent_gauge", {"name": 'quote"d\\'}),
                           ("agent_events", {"event": "nope"}),
                           ("no_such_family", {})):
        assert sp.value(family, **labels) == sj.value(family, **labels)
    assert sp.buckets("agent_latency", op="fleet.leg") == \
        sj.buckets("agent_latency", op="fleet.leg") == \
        {"128": 4.0, "+Inf": 5.0}


SLO_SPECS = [
    {"min_goodput_bps": 1e12, "max_retransmit_ratio": 0.49,
     "max_dedup_ratio": 0.2},
    {"max_dedup_ratio": 1.0, "p99_leg_ms": 100},
    {"not_a_key": 1, "min_goodput_bps": "x", "max_retransmit_ratio": 0.6},
    None,
    ["not", "a", "mapping"],
]


class _Links:
    def __init__(self, report):
        self._report = report

    def report(self):
        return self._report


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_slo_spec_and_verdicts_equal(spec):
    assert p_tel.parse_slo_spec(spec) == j_tel.parse_slo_spec(spec)
    links = {"a->b": {"bytes": 1 << 20, "frames": 10, "drops": 4,
                      "dups": 1, "blocked": 0, "tier": "intra-rack",
                      "up": True}}
    out = []
    for tel_mod in (j_tel, p_tel):
        t = tel_mod.FleetTelemetry({}, _Links(links), spec)
        t.history = [{"round": 0, "nodes": {
            "n0": {"goodput_bps": 100.0, "stale": False}},
            "links_goodput_bps": {}}]
        section = t.evaluate(links)
        out.append(([(c["slo"], c["kind"], c["limit"], c["ok"])
                     for c in section["checks"]], section["ok"],
                    sorted(section["measured"])))
    assert out[1] == out[0]


def test_slo_keys_equal():
    assert p_tel.SLO_KEYS == j_tel.SLO_KEYS


def test_lossy_scenario_converges_but_breaches_goodput_slo():
    from container_engine_accelerators_tpu_torch.fleet.controller import (
        run_scenario,
    )

    env_spec = os.environ.pop("TPU_FAULT_SPEC", None)
    try:
        t0 = time.monotonic()
        report = run_scenario({
            "name": "lossy-but-alive", "nodes": 2, "racks": 1,
            "chips": 2, "topology": "1x2x1", "rounds": 3,
            "payload_bytes": 2048, "land_timeout_s": 0.4,
            "faults": [{"round": 1, "link": "node:n0->node:n1:drop:1"}],
            "slo": {"min_goodput_bps": 1e12, "max_dedup_ratio": 1.0},
        })
        assert time.monotonic() - t0 < 60
    finally:
        if env_spec is not None:
            os.environ["TPU_FAULT_SPEC"] = env_spec
    assert report["converged"]
    by_key = {c["slo"]: c for c in report["slo"]["checks"]}
    assert by_key["min_goodput_bps"]["ok"] is False
    assert by_key["max_dedup_ratio"]["ok"] is True
    assert report["slo"]["ok"] is False
    assert len(report["telemetry"]["rounds"]) == 3
