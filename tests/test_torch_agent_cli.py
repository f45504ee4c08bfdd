"""The port's ``agent_*`` tools against the JAX package's root scripts:
each pair, run as a user runs it (``python -m
container_engine_accelerators_tpu_torch.cmd.agent_X`` beside ``python
cmd/agent_X.py``) on the same input, prints the same standard output and
exits with the same code.  The inputs: a span JSONL (the summary, one
trace's tree, ``--exemplar`` and ``--critical-path``), a profile report
(``agent_prof --folded``, the table, ``--subsystem``), a history ledger
directory (``agent_trend``), and a canned scrape (``agent_top --once``).
Then the file formats cross: JAX's ``agent_trace`` reads a JSONL the
port wrote, and the port's reads one JAX wrote.
"""

import http.server
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from container_engine_accelerators_tpu.obs import trace as jax_trace
from container_engine_accelerators_tpu_torch.obs import history, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "container_engine_accelerators_tpu_torch"
TOOLS = ("agent_trace", "agent_prof", "agent_trend", "agent_top")


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_")}
    env["PYTHONPATH"] = REPO
    return env


def run_tool(side, tool, args):
    cmd = ([sys.executable, os.path.join(REPO, "cmd", f"{tool}.py")]
           if side == "jax" else
           [sys.executable, "-m", f"{PKG}.cmd.{tool}"])
    proc = subprocess.run(cmd + list(args), cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout, proc.stderr


# agent_top stamps its header with the wall-clock time of the scrape.
_CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")


def same_output(tool, args):
    """Run both; equal exit codes and standard output (clock stamps
    masked), returned."""
    jax = run_tool("jax", tool, args)
    port = run_tool("port", tool, args)
    assert port[0] == jax[0], (port[2], jax[2])
    assert _CLOCK.sub("HH:MM:SS", port[1]) == _CLOCK.sub("HH:MM:SS", jax[1])
    return port


@pytest.fixture(autouse=True)
def clean_trace():
    trace.reset()
    jax_trace.reset()
    yield
    trace.reset()
    jax_trace.reset()


def _span(name, ts, dur_us, trace_id, span_id, parent=None, status="ok",
          **attrs):
    return {"trace": trace_id, "span": span_id, "parent": parent,
            "name": name, "ts": ts, "dur_us": dur_us, "status": status,
            "thread": "T", "attrs": attrs}


def write_span_jsonl(path, seed=0):
    """A seeded node-agent span log: Allocates, a fault's trace from the
    fault-file line to the recovery, a retried registration, a torn
    last line."""
    rng = np.random.default_rng(seed)
    spans = []
    t = 1_700_000_000.0
    for i in range(60):
        tid = f"{i:08x}aaaaaaaa"
        dur = float(np.round(rng.lognormal(5, 0.6), 1))
        spans.append(_span("plugin.allocate", t, dur, tid, f"a{i:07x}",
                           devices=int(rng.integers(1, 3))))
        t += 0.01
    fault = "feedfacefeedface"
    spans += [
        _span("health.fault_file", t, 0.0, fault, "f0000001", kind="fault",
              device="nvidia1", code=48),
        _span("health.event", t + 0.0001, 45.2, fault, "f0000002",
              parent="f0000001", code=48, device="nvidia1"),
        _span("plugin.health_announce", t + 0.001, 80.1, fault, "f0000003",
              device="nvidia1", health="Unhealthy"),
        _span("health.recover", t + 30.0, 0.0, fault, "f0000004",
              device="nvidia1", outage_s=30.0, window_s=30.0),
    ]
    reg = "0123456789abcdef"
    spans += [
        _span("kubelet.register", t + 1, 1200.0, reg, "r0000001",
              status="error", attempt=0, endpoint="e",
              fault="kubelet.register", fault_mode="fail",
              error="FaultInjectedError('x')"),
        _span("kubelet.register", t + 2, 900.0, reg, "r0000002",
              attempt=1, endpoint="e"),
        _span("dcn.pipeline", t + 3, 10e6, "c0ffee00c0ffee00", "p1"),
        _span("dcn.chunk.wait", t + 3.1, 9.8e6, "c0ffee00c0ffee00", "p2",
              parent="p1"),
        _span("dcn.chunk.send", t + 3.2, 8e6, "c0ffee00c0ffee00", "p3",
              parent="p2"),
        _span("dcn.chunk.stage", t + 3.2, 2e6, "c0ffee00c0ffee00", "p4",
              parent="p2"),
    ]
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s) + "\n")
        f.write('{"trace": "torn", "span": "x", "na')
    return spans


@pytest.mark.parametrize("args", [
    [], ["--top", "3", "--slowest", "2"], ["--trace", "feedfacefeedface"],
    ["--trace", "feedface"], ["--exemplar", "plugin.allocate"],
    ["--exemplar", "0123456789"], ["--critical-path", "dcn.pipeline"],
    ["--critical-path", "c0ffee00"], ["--critical-path", "no.such.op"],
    ["--exemplar", "no.such.op"],
], ids=["summary", "top", "trace", "trace-prefix", "exemplar-op",
        "exemplar-trace", "critical-path-op", "critical-path-trace",
        "critical-path-miss", "exemplar-miss"])
def test_agent_trace_prints_what_jax_prints(tmp_path, args):
    path = str(tmp_path / "agent.jsonl")
    write_span_jsonl(path)
    rc, out, err = same_output("agent_trace", [path] + args)
    if "miss" not in " ".join(args) and "no.such" not in " ".join(args):
        assert rc == 0 and out.strip()
        assert "skipped 1 malformed line" in err


def test_agent_trace_merges_several_files(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    write_span_jsonl(a, seed=1)
    write_span_jsonl(b, seed=2)
    rc, out, _ = same_output("agent_trace", [a, b, "--top", "5"])
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["spans"]


def drive_node_spans(mod):
    """The node daemon's span shapes, live through one package."""
    for i in range(20):
        with mod.span("plugin.allocate", histogram="plugin.allocate",
                      devices=1):
            pass
    with mod.span("health.event", histogram="health.event", code=48,
                  device="nvidia1"):
        mod.event("health.fault_file", kind="fault", device="nvidia1",
                  code=48)
    try:
        with mod.span("kubelet.register", histogram="kubelet.register",
                      attempt=0, endpoint="e"):
            mod.annotate(fault="kubelet.register", fault_mode="fail")
            raise OSError("injected")
    except OSError:
        pass


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_agent_trace_reads_the_others_jsonl(tmp_path, writer):
    """A JSONL written live by one package's trace sink reads the same in
    both packages' ``agent_trace``."""
    mod = trace if writer == "port" else jax_trace
    path = str(tmp_path / f"{writer}.jsonl")
    mod.configure(path)
    drive_node_spans(mod)
    mod.configure(None)
    rc, out, err = same_output("agent_trace", [path])
    summary = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and summary["spans"] == 23
    assert summary["fault_injections"] == {"kubelet.register": 1}
    assert "plugin.allocate" in err
    fault_trace = next(json.loads(line)["trace"] for line in open(path)
                       if '"health.event"' in line)
    rc, _, err = same_output("agent_trace", [path, "--trace", fault_trace])
    assert rc == 0 and "health.fault_file" in err


PROFILE_REPORT = {
    "profile": {
        "nodes": {
            "n0": {"samples": 12, "dropped": 1,
                   "subsystems": {"other": 7, "idle": 5},
                   "top": [{"stack": "threading.run;deviceplugin.service."
                                     "DevicePluginService.Allocate",
                            "subsystem": "other", "count": 7},
                           {"stack": "threading.run;threading.wait",
                            "subsystem": "idle", "count": 5}]},
            "n1": {"samples": 4, "dropped": 0,
                   "subsystems": {"serving": 4},
                   "top": [{"stack": "serving.frontend._dispatch",
                            "subsystem": "serving", "count": 4}]},
        },
        "fleet": {"samples": 16, "dropped": 1,
                  "subsystems": {"other": 7, "idle": 5, "serving": 4},
                  "top": [{"stack": "threading.run;deviceplugin.service."
                                    "DevicePluginService.Allocate",
                           "subsystem": "other", "count": 7},
                          {"stack": "threading.run;threading.wait",
                           "subsystem": "idle", "count": 5},
                          {"stack": "serving.frontend._dispatch",
                           "subsystem": "serving", "count": 4}]},
    },
}


@pytest.mark.parametrize("args", [
    ["--folded"], [], ["--subsystem"], ["--node", "n1"],
    ["--node", "n0", "--folded"], ["--node", "nope"], ["--top", "1"],
], ids=["folded", "table", "subsystem", "node", "node-folded", "bad-node",
        "top"])
def test_agent_prof_prints_what_jax_prints(tmp_path, args):
    path = str(tmp_path / "report.json")
    with open(path, "w") as f:
        json.dump(PROFILE_REPORT, f)
    body = str(tmp_path / "body.json")
    with open(body, "w") as f:
        json.dump(dict(PROFILE_REPORT["profile"]["nodes"]["n1"],
                       stacks=PROFILE_REPORT["profile"]["nodes"]["n1"]["top"],
                       cursor=4), f)
    rc, out, _ = same_output("agent_prof", [path] + args)
    if "nope" not in args:
        assert rc == 0 and out
    same_output("agent_prof", [path, body, "--folded"])


def seed_ledger(root, seed):
    """Quiet runs then, for some series, a regressed last run."""
    rng = np.random.default_rng(seed)
    led = history.RunLedger(str(root))
    for key in ("fleet-serving:n4", "dcn_bench:shm:4096"):
        for i in range(6):
            last = i == 5 and key.startswith("fleet")
            led.record(
                key.split(":")[0].replace("-", "_"), key,
                {"p99_e2e_ms": (80.0 if last else
                                float(40 + rng.normal(0, 0.5))),
                 "sustained_qps": float(900 + rng.normal(0, 3))},
                run_id=f"{key}-{i}",
                cpu_attr=({"serving": 0.45, "shm-staging": 0.38,
                           "dcn_pipeline": 0.17} if last else
                          {"serving": 0.6, "shm-staging": 0.2,
                           "dcn_pipeline": 0.2}),
                dominant_phase="dcn.chunk.stage" if last else "serve.batch")


@pytest.mark.parametrize("args", [
    [], ["--attribute"], ["--kind", "dcn_bench"], ["--metric",
                                                   "sustained_qps"],
    ["--min-runs", "1", "--last", "3"], ["--k", "10"],
], ids=["all", "attribute", "kind", "metric", "min-runs", "k"])
@pytest.mark.parametrize("seed", [0, 1])
def test_agent_trend_prints_what_jax_prints(tmp_path, args, seed):
    seed_ledger(tmp_path, seed)
    rc, out, _ = same_output("agent_trend", ["--dir", str(tmp_path)] + args)
    assert json.loads(out.strip().splitlines()[-1])["series"]


def test_agent_trend_exit_codes_match(tmp_path):
    assert same_output("agent_trend", [])[0] == 2
    os.mkdir(tmp_path / history.LEDGER_NAME)
    assert same_output("agent_trend", ["--dir", str(tmp_path)])[0] == 2


CANNED_METRICS = """# HELP agent_events Cumulative recovery events
# TYPE agent_events gauge
agent_events{event="health.unhealthy"} 3.0
agent_events{event="kubelet.register.failed"} 1.0
agent_events{event="anomaly.confirmed"} 1.0
agent_latency{bucket="128",op="plugin.allocate"} 40.0
agent_latency{bucket="256",op="plugin.allocate"} 97.0
agent_latency{bucket="2048",op="plugin.allocate"} 100.0
agent_latency{bucket="+Inf",op="plugin.allocate"} 100.0
agent_latency{bucket="64",op="dcn.chunk.stage"} 4.0
agent_latency{bucket="+Inf",op="dcn.chunk.stage"} 4.0
agent_latency{bucket="4096",op="dcn.chunk.send"} 4.0
agent_latency{bucket="+Inf",op="dcn.chunk.send"} 4.0
agent_latency{bucket="33554432",op="health.recovery"} 2.0
agent_latency{bucket="+Inf",op="health.recovery"} 2.0
agent_exemplar{bucket="2048",op="plugin.allocate",trace="feedfacefeedface"} 1812.5
agent_exemplar{bucket="256",op="plugin.allocate",trace="00000000aaaaaaaa"} 200.1
agent_rate{event="health.unhealthy"} 0.3
agent_rate{event="xferd.rx.bytes"} 629145.6
agent_rate{event="serving.requests"} 4.0
agent_rate{event="serving.ok"} 3.8
agent_goodput{name="n0->n1",scope="link"} 419430.4
agent_goodput{name="demo.ring",scope="flow"} 209715.2
agent_gauge{name="prof.overhead_ratio"} 0.0042
agent_gauge{name="slo.min_qps.ok"} 1.0
agent_gauge{name="slo.min_qps.value"} 38.0
agent_gauge{name="dcn.exposed_ratio"} 0.42
agent_gauge{name="anomaly.score.n2"} 7.4
agent_gauge{name="anomaly.state.n2"} 2.0
duty_cycle_gpu_node{accelerator_id="nvidia0",make="nvidia",model="H100"} 78.0
"""

CANNED_PROFILE = {
    "cursor": 120, "samples": 120, "dropped": 0, "hz": 67.0,
    "running": True, "overhead_ratio": 0.0042,
    "subsystems": {"other": 40, "idle": 80},
    "stacks": [{"stack": "threading.run;deviceplugin.service."
                         "DevicePluginService.Allocate",
                "subsystem": "other", "count": 40},
               {"stack": "threading.run;threading.wait",
                "subsystem": "idle", "count": 80}],
}


@pytest.fixture
def canned_server():
    """A scrape surface that answers the same bytes every time."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/profile"):
                body = json.dumps(CANNED_PROFILE).encode()
                ctype = "application/json"
            else:
                body = CANNED_METRICS.encode()
                ctype = "text/plain; version=0.0.4"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("args", [[], ["--top", "2"]], ids=["default",
                                                             "top2"])
def test_agent_top_once_prints_what_jax_prints(canned_server, args):
    rc, out, _ = same_output(
        "agent_top", ["--once", "--port", str(canned_server)] + args)
    assert rc == 0
    assert "plugin.allocate" in out and "feedface" in out


def test_agent_top_url_and_failure_match(canned_server):
    url = f"http://127.0.0.1:{canned_server}/metrics"
    assert same_output("agent_top", ["--once", "--url", url])[0] == 0
    assert same_output("agent_top", ["--once", "--url",
                                     "http://127.0.0.1:1/metrics"])[0] == 1


def test_agent_top_demo_runs_on_the_ports_server():
    rc, out, err = run_tool("port", "agent_top", ["--demo", "--once"])
    assert rc == 0, err
    assert "dcn.send" in out and "suspicion (grey-failure)" in out


@pytest.mark.parametrize("tool", TOOLS)
def test_help_runs(tool):
    rc, out, _ = run_tool("port", tool, ["--help"])
    assert rc == 0 and "usage" in out
