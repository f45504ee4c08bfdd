"""The port's process-mode fleet (``fleet/proc.py``): every node its own
OS process running the port's GPU node stack, real SIGKILL, supervised
respawn under the restart budget, the ``FLEET_PROC_HANG`` handshake
hook, the SIGTERM flight dump, the external chip-fault file, the
scraped counters' restart-aware accumulation (equal to the JAX
package's), and the built-in SIGKILL scenario with HTTP-scraped
telemetry."""

import json
import os
import signal
import tempfile
import time

import pytest

import container_engine_accelerators_tpu.fleet.telemetry as j_tel
from container_engine_accelerators_tpu_torch.fleet import telemetry as p_tel
from container_engine_accelerators_tpu_torch.fleet.controller import (
    DEFAULT_PROC_SCENARIO,
    FleetController,
    run_scenario,
)
from container_engine_accelerators_tpu_torch.fleet.proc import (
    HANG_ENV,
    ProcHandshakeError,
    ProcNode,
)
from container_engine_accelerators_tpu_torch.fleet.topology import NodeSpec
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.parallel import dcn
from tests.torch_fleet_parity import JAX, to_port_names

PAYLOAD = bytes(range(256)) * 16  # 4 KiB
N = len(PAYLOAD)


def _env(**extra):
    env = dict(os.environ)
    env.pop("TPU_FAULT_SPEC", None)
    env.update(extra)
    return env


def _node(tmp_path, name, **kw):
    kw.setdefault("handshake_timeout_s", 60.0)
    kw.setdefault("env", _env())
    return ProcNode(NodeSpec(name=name, chips=2, topology="1x2x1"),
                    str(tmp_path / name), **kw)


def _send(a, b, flow):
    b.client.register_flow(flow, bytes=N)
    a.client.register_flow(flow, bytes=N)
    a.client.put(flow, PAYLOAD)
    dcn.wait_flow_rx(a.client, flow, N, timeout_s=10)
    a.client.send(flow, "127.0.0.1", b.daemon.data_port, N)
    dcn.wait_flow_rx(b.client, flow, N, timeout_s=10)
    assert b.client.read(flow, N) == PAYLOAD


def test_spawn_transfer_fault_sigkill_respawn_and_reap(tmp_path):
    """Two worker processes: a transfer across them, an Xid fault on
    nvidia0 through the RPC pipe, stray stdout on both halves of the
    pipe, a SIGKILL and a supervised respawn on the same UDS path (the
    coordinator's client heals), and teardown reaps every process."""
    a = _node(tmp_path, "na")
    b = _node(tmp_path, "nb")
    procs = [a.proc, b.proc]
    try:
        assert a.pid != os.getpid() and a.pid != b.pid
        snap = a.snapshot()
        assert snap["proc"] is True
        assert snap["healthy"] == snap["total"] == 2
        assert sorted(snap["devices"]) == ["nvidia0", "nvidia1"]
        _send(a, b, "f0")

        a.inject_chip_fault("nvidia0")
        assert a.device_health()["nvidia0"] == "Unhealthy"
        assert a.force_recover() == 1 and a.all_healthy()

        a._q.put("null\n")
        a._q.put("42\n")
        a.proc.stdin.write("null\n17\n")
        a.proc.stdin.flush()
        assert a.snapshot()["healthy"] == 2

        r0 = counters.get("fleet.node.restarts")
        old_pid = b.pid
        b.kill_daemon()
        assert b.down
        assert b.restart_daemon()
        procs.append(b.proc)
        assert b.pid != old_pid
        with pytest.raises(ProcessLookupError):
            os.kill(old_pid, 0)
        assert b.snapshot()["daemon_generation"] == 2
        assert counters.get("fleet.node.restarts") == r0 + 1
        b.client.ping()
        _send(a, b, "f1")
    finally:
        a.close()
        b.close()
    for p in procs:
        assert p.returncode is not None
        with pytest.raises(ProcessLookupError):
            os.kill(p.pid, 0)


def test_handshake_timeout_raises_and_reaps(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(ProcHandshakeError, match="no handshake"):
        ProcNode(NodeSpec(name="nh", chips=2), str(tmp_path / "nh"),
                 env=_env(**{HANG_ENV: "1"}), handshake_timeout_s=2.0)
    assert time.monotonic() - t0 < 30


def test_sigterm_dumps_flight_recorder_and_fault_file_reaches_worker(
        tmp_path):
    """The worker polls the coordinator's TPU_CHIP_FAULT_FILE on its
    recovery sweep; the supervisor's SIGTERM makes it dump its flight
    recorder before a clean exit."""
    fault_path = str(tmp_path / "chip_faults")
    with tempfile.TemporaryFile(mode="w+") as err:
        a = _node(tmp_path, "nf", stderr=err,
                  env=_env(TPU_CHIP_FAULT_FILE=fault_path))
        try:
            with open(fault_path, "w") as f:
                f.write("fault nvidia0 48\n")
            a.recover()
            snap = a.snapshot()
            assert snap["devices"]["nvidia0"] == "Unhealthy"
            with open(fault_path, "a") as f:
                f.write("clear nvidia0\n")
            a.recover()
            assert a.all_healthy()
            a.proc.send_signal(signal.SIGTERM)
            a.proc.wait(timeout=15)
            assert a.proc.returncode == 0
            err.seek(0)
            stderr = err.read()
        finally:
            a.close()
    blob = json.loads(next(l for l in stderr.splitlines()
                           if l.startswith("TPU_FLIGHT_RECORDER "))
                      .split(" ", 1)[1])
    assert "SIGTERM" in blob["reason"] and blob["pid"] == a.pid


def test_dark_node_fault_and_refused_restart_are_skipped():
    class _DarkNode:
        name = "n0"

        def inject_chip_fault(self, chip, code):
            raise OSError("node n0 worker is down")

        def restart_daemon(self):
            return False

    ctl = FleetController({"proc": True, "nodes": 1, "rounds": 1})
    ctl.nodes["n0"] = _DarkNode()
    record = ctl._apply_fault(1, {"action": "chip_fault", "node": "n0"})
    assert record["applied"] == 0 and "down" in record["skipped"]
    record = ctl._apply_fault(2, {"action": "restart", "node": "n0"})
    assert record["applied"] == 0 and "refused" in record["skipped"]


@pytest.mark.parametrize("calls", [
    [(10.0, None), (14.0, None), (3.0, None), (5.0, None)],
    [(10.0, 1), (14.0, 1), (20.0, 2), (22.0, 2)],
    [(10.0, 1), (0.0, 1), (14.0, 1)],
])
def test_restart_aware_accumulation_equals_jax(calls):
    totals = []
    for tel in (p_tel, j_tel):
        t = tel.FleetTelemetry({}, None, None, scrape=True)
        for value, gen in calls:
            t._accumulate("n0", "frames", value, gen=gen)
        totals.append(t._accum_total("frames"))
    assert totals[0] == totals[1]


def test_restart_budget_exhaustion_marks_non_converged(tmp_path):
    b0 = counters.get("fleet.node.budget_exhausted")
    report = run_scenario({
        "name": "budget-exhausted", "proc": True, "nodes": 2, "racks": 1,
        "chips": 2, "topology": "1x2x1", "rounds": 2,
        "payload_bytes": 2048, "restart_budget": 0,
        "faults": [{"round": 0, "action": "kill", "node": "n1", "for": 1}],
    }, workdir=str(tmp_path))
    assert not report["converged"]
    n1 = report["nodes"]["n1"]
    assert n1["permanently_down"] and n1["down"] and n1["restarts"] == 0
    assert counters.get("fleet.node.budget_exhausted") == b0 + 1


def test_sigkill_scenario_converges_with_scraped_telemetry(monkeypatch):
    """The built-in process-mode scenario: the same fault schedule and
    report schema as the JAX package's (the schedule and built-in are
    held equal in ``test_torch_fleet.py``; JAX's own workers import jax,
    seconds each, so its run is not repeated here).  The SIGKILLed node
    came back on generation 2, its dark round's legs were skipped, its
    dark rounds scraped stale, and every live worker contributed profile
    stacks."""
    monkeypatch.delenv("TPU_FAULT_SPEC", raising=False)
    slo = {"min_goodput_bps": 1.0, "max_dedup_ratio": 1.0}
    assert DEFAULT_PROC_SCENARIO == to_port_names(
        JAX.controller.DEFAULT_PROC_SCENARIO)
    report = run_scenario(dict(DEFAULT_PROC_SCENARIO, slo=slo))
    assert any("skipped" in leg for leg in report["rounds"][1]["legs"])
    assert all(leg["ok"] for leg in report["rounds"][-1]["legs"])
    assert all(n["legs_failed"] == 0 and n["healthy"] == n["total"]
               for n in report["nodes"].values())
    assert report["proc"] is True and report["converged"]
    n1 = report["nodes"]["n1"]
    assert n1["daemon_generation"] == 2 and n1["restarts"] == 1
    rounds = report["telemetry"]["rounds"]
    assert any(s["nodes"]["n1"].get("stale") for s in rounds)
    assert all(s["links_goodput_bps"] == {} for s in rounds)
    assert report["slo"]["ok"]
    assert report["slo"]["measured"]["stale_entries_skipped"] >= 1
    prof = report["profile"]
    assert prof["fleet"]["samples"] > 0
    assert {"n0", "n1", "n2"} <= set(prof["nodes"])
