"""The port's ``cmd/fleet_sim.py`` held against the JAX package's CLI: the
same flags give the same exit codes — 0 when clean, 2 when the fleet
did not converge (or a worker never handshakes), 3 on an SLO breach, 1
on a trend regression under ``--trend-gate`` — and the same keys in the
last JSON report line."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from container_engine_accelerators_tpu_torch.cmd import fleet_sim
from container_engine_accelerators_tpu_torch.fleet.proc import HANG_ENV
from container_engine_accelerators_tpu_torch.obs import history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_sim", os.path.join(REPO, "cmd", "fleet_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    monkeypatch.delenv("TPU_FAULT_SPEC", raising=False)
    monkeypatch.setenv("TPU_HISTORY_DIR", str(tmp_path / "history"))


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.err


def _partition_forever(tmp_path):
    path = str(tmp_path / "partition.json")
    with open(path, "w") as f:
        json.dump({"name": "partition-forever", "nodes": 2, "racks": 2,
                   "chips": 2, "rounds": 2, "payload_bytes": 1024,
                   "land_timeout_s": 0.3,
                   "faults": [{"round": 0,
                               "link": "rack:r0<->rack:r1:partition"}]},
                  f)
    return path


CASES = {
    "clean": (["--rounds", "5"], 0),
    "slo_breach": (["--slo", "min_goodput_bps=1e12"], 3),
    "collective": (["--workload", "collective", "--rounds", "3"], 0),
    "serving": (["--workload", "serving", "--rounds", "2"], 0),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["no_convergence"])
def test_exit_codes_and_report_keys_equal_jax(case, tmp_path, capsys):
    if case == "no_convergence":
        argv, want_rc = ["--scenario", _partition_forever(tmp_path)], 2
    else:
        argv, want_rc = CASES[case]
    rc_j, rep_j, _ = _run(_jax_cli().main, argv, capsys)
    rc_p, rep_p, err = _run(fleet_sim.main, argv, capsys)
    assert rc_j == want_rc
    assert rc_p == want_rc, err[-2000:]
    assert f"scenario: {rep_p['scenario']}" in err
    assert sorted(rep_p) == sorted(rep_j)
    assert sorted(rep_p["slo"]) == sorted(rep_j["slo"])
    assert sorted(rep_p["slo"]["measured"]) == \
        sorted(rep_j["slo"]["measured"])
    for name in rep_j["nodes"]:
        assert sorted(rep_p["nodes"][name]) == sorted(rep_j["nodes"][name])
    assert rep_p["converged"] == rep_j["converged"]


def test_typoed_slo_key_and_hanging_worker_exit_2(tmp_path, capsys,
                                                  monkeypatch):
    assert fleet_sim.main(["--slo", "min_goodput=1"]) == 2
    assert "bad --slo" in capsys.readouterr().err
    path = str(tmp_path / "hang.json")
    with open(path, "w") as f:
        json.dump({"name": "hang", "proc": True, "nodes": 1, "rounds": 1,
                   "handshake_timeout_s": 2.0, "faults": []}, f)
    monkeypatch.setenv(HANG_ENV, "1")
    assert fleet_sim.main(["--scenario", path]) == 2
    assert "fleet boot failed" in capsys.readouterr().err


def test_trend_gate_regression_exits_1(capsys):
    argv = ["--trend-gate"]
    rc, report, _ = _run(fleet_sim.main, argv, capsys)
    assert rc == 0
    ledger = history.RunLedger()
    rec = ledger.records(kind="fleet_sim")[-1]
    assert rec["run_id"] == report["run_id"]
    better = dict(rec["metrics"],
                  min_goodput_bps=rec["metrics"]["min_goodput_bps"] * 1e3)
    for _ in range(history.MIN_BASELINE_RUNS):
        ledger.record("fleet_sim", rec["config_key"], better)
    rc, report, err = _run(fleet_sim.main, argv, capsys)
    assert rc == 1, err[-2000:]
    assert report["trend"]["ok"] is False
    assert "trend:" in err


def test_module_entry_runs_with_trace_file(tmp_path):
    """``python -m ...cmd.fleet_sim`` as a user runs it: exit 0, the
    last stdout line is the JSON report, the span JSONL is written."""
    trace_path = str(tmp_path / "fleet.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "TPU_FAULT_SPEC"}
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.fleet_sim",
         "--trace-file", trace_path],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["converged"] and len(report["nodes"]) == 4
    with open(trace_path) as f:
        names = {json.loads(line).get("name") for line in f if line.strip()}
    assert "fleet.leg" in names
