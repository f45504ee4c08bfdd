"""Shared helpers of the fleet parity tests (``tests/test_torch_fleet*.py``,
``test_torch_serving.py``, ``test_torch_collective_*.py``): the two
packages' fleet modules side by side, the JAX device names mapped onto
the port's, and the deterministic fields of a fleet report."""

import json
import os

import container_engine_accelerators_tpu.collectives.runner as j_runner
import container_engine_accelerators_tpu.collectives.search as j_search
import container_engine_accelerators_tpu.collectives.synth as j_synth
import container_engine_accelerators_tpu.collectives.topo as j_topo
import container_engine_accelerators_tpu.fleet.controller as j_controller
import container_engine_accelerators_tpu.fleet.links as j_links
import container_engine_accelerators_tpu.fleet.topology as j_topology
import container_engine_accelerators_tpu_torch.collectives.runner as p_runner
import container_engine_accelerators_tpu_torch.collectives.search as p_search
import container_engine_accelerators_tpu_torch.collectives.synth as p_synth
import container_engine_accelerators_tpu_torch.collectives.topo as p_topo
import container_engine_accelerators_tpu_torch.fleet.controller as p_controller
import container_engine_accelerators_tpu_torch.fleet.links as p_links
import container_engine_accelerators_tpu_torch.fleet.topology as p_topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(REPO, "scenarios")


class Pkg:
    """One package's fleet modules under common names."""

    def __init__(self, topology, links, topo, synth, search, controller):
        self.topology = topology
        self.links = links
        self.topo = topo
        self.synth = synth
        self.search = search
        self.controller = controller

    def graph(self, nodes=4, racks=2, faults=(), specs=None, rates=None):
        """A comm graph over a built fleet; ``rates(src, dst)`` is the
        goodput evidence (none by default)."""
        fleet = self.topology.FleetTopology(
            specs or self.topology.build_specs(nodes, racks=racks))
        table = self.links.LinkTable(fleet)
        for f in faults:
            assert table.apply(f), f"fault {f!r} armed nothing"
        return self.topo.CommGraph.build(
            fleet, links=table, rates=rates or (lambda a, b: 0.0))


JAX = Pkg(j_topology, j_links, j_topo, j_synth, j_search, j_controller)
PORT = Pkg(p_topology, p_links, p_topo, p_synth, p_search, p_controller)


def to_port_names(obj):
    """A JSON-able value with the JAX package's chip names
    (``accel<i>``) renamed to the port's (``nvidia<i>``)."""
    return json.loads(json.dumps(obj).replace('"accel', '"nvidia'))


def non_proc_scenario_files():
    out = []
    for f in sorted(os.listdir(SCENARIOS)):
        if f.endswith(".json"):
            with open(os.path.join(SCENARIOS, f)) as fh:
                if not json.load(fh).get("proc"):
                    out.append(f)
    return out


def plan_on_fault_state(monkeypatch):
    """Make both packages' collective engines plan from the link
    table's fault state alone.  Left live, the comm graph also reads
    each link's windowed goodput, whose ``slow`` verdict moves the
    searched schedule's costs with the host's load, run by run; the
    rate-driven verdict is held equal on seeded rates in
    ``test_torch_collective_engine.py``."""
    for runner, topo in ((j_runner, j_topo), (p_runner, p_topo)):
        def graph(self, topo=topo):
            return topo.CommGraph.build(self.topology, links=self.links,
                                        rates=lambda a, b: 0.0)

        monkeypatch.setattr(runner.CollectiveEngine, "graph", graph)


def _fault_key(f):
    return f.get("action") or f.get("link") if isinstance(f, dict) else f


def deterministic(report):
    """The fields of a fleet report that do not depend on timing: the
    verdict, the round log's actions, per-node health and restarts,
    per-link tiers, the report's key set and the SLO verdicts; for the
    ring and collective workloads also per-node legs and per-link
    frame accounting.  A serving round's dispatch follows its batching
    and hedge timers, so there only the per-round request totals
    count."""
    serving = report.get("workload") == "serving"
    out = {
        "converged": report["converged"],
        "keys": sorted(report),
        "workload": report.get("workload"),
        "actions": [[_fault_key(f) for f in r["faults"]]
                    for r in report["rounds"]],
        "nodes": {
            n: {k: s.get(k) for k in ("healthy", "total", "restarts",
                                      "down", "daemon_generation",
                                      "permanently_down")}
            for n, s in report["nodes"].items()},
        "tiers": {l: v["tier"] for l, v in report["links"].items()},
        "slo": [[c["slo"], c["ok"]] for c in report["slo"]["checks"]],
        "slo_ok": report["slo"]["ok"],
    }
    if serving:
        out["requests"] = [[[leg.get("requests"), leg.get("lost")]
                            for leg in r["legs"]] for r in report["rounds"]]
    else:
        for n, s in report["nodes"].items():
            out["nodes"][n].update(legs_ok=s["legs_ok"],
                                   legs_failed=s["legs_failed"])
        out["links"] = {
            l: {k: v[k] for k in ("frames", "bytes", "drops", "dups",
                                  "blocked", "up")}
            for l, v in report["links"].items()}
    return out
