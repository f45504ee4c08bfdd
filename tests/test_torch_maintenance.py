"""The port's maintenance watcher (health/maintenance.py) against the JAX
package's: the seven cases of tests/test_maintenance.py, each run through
both ``reconcile`` functions against the same FakeApi script, which must
give the same sequence of taint lists (the taint key mapped) and post the
same events; and the watcher's entry point against local stubs of the
metadata server and the API server."""

import copy
import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from container_engine_accelerators_tpu.deviceplugin.manager import TpuManager
from container_engine_accelerators_tpu.health import TpuHealthChecker
from container_engine_accelerators_tpu.health import maintenance as tpu_mw
from container_engine_accelerators_tpu.scheduler.k8s import (
    ApiException as TpuApiException,
)
from container_engine_accelerators_tpu.tpulib import SysfsTpuLib
from container_engine_accelerators_tpu.tpulib import (
    write_fixture as write_tpu_fixture,
)
from container_engine_accelerators_tpu.utils.config import TPUConfig
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    GpuManager,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    write_fixture,
)
from container_engine_accelerators_tpu_torch.health import GpuHealthChecker
from container_engine_accelerators_tpu_torch.health import maintenance as mw
from container_engine_accelerators_tpu_torch.scheduler.k8s import ApiException
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERMINATE = "TERMINATE_ON_HOST_MAINTENANCE"
MIGRATE = "MIGRATE_ON_HOST_MAINTENANCE"


class FakeApi:
    """Honours resourceVersion as the API server does: a patch built from
    a stale read gets a 409 (``exc``, each package's own ApiException),
    and spec.taints is replaced whole."""

    def __init__(self, exc, taints=None):
        self.exc = exc
        self.node = {"metadata": {"name": "n0", "resourceVersion": "1"},
                     "spec": {"taints": copy.deepcopy(taints or [])}}
        self.patches = []
        self.reads = 0

    def read_node(self, name):
        assert name == "n0"
        self.reads += 1
        return copy.deepcopy(self.node)

    def mutate_concurrently(self, taint):
        """Another controller adds a taint: resourceVersion advances."""
        self.node["spec"]["taints"].append(taint)
        self._bump()

    def _bump(self):
        md = self.node["metadata"]
        md["resourceVersion"] = str(int(md["resourceVersion"]) + 1)

    def patch_node_taints(self, name, taints, resource_version=None):
        if (resource_version is not None
                and resource_version != self.node["metadata"][
                    "resourceVersion"]):
            raise self.exc(409, "Conflict")
        self.patches.append(copy.deepcopy(taints))
        self.node["spec"]["taints"] = taints
        self._bump()
        return self.node


def fetcher(value):
    return lambda path: value if path == mw.METADATA_PATH else None


def jax_taints(patches):
    """The port's taint lists with the JAX package's key."""
    return [[dict(t, key=tpu_mw.TAINT_KEY) if t["key"] == mw.TAINT_KEY else t
             for t in taints] for taints in patches]


def port_key(taints):
    return [dict(t, key=mw.TAINT_KEY) if t["key"] == tpu_mw.TAINT_KEY else t
            for t in taints]


class Both:
    """One FakeApi script run through both reconcile functions."""

    def __init__(self, tmp_path, taints=None):
        self.gpu = FakeApi(ApiException, port_key(taints or []))
        self.tpu = FakeApi(TpuApiException, taints)
        self.fault_file = str(tmp_path / "faults")
        self.events_dir = str(tmp_path / "events")

    def reconcile(self, fetch):
        got = mw.reconcile(self.gpu, "n0", fetch, self.fault_file)
        want = tpu_mw.reconcile(self.tpu, "n0", fetch,
                                events_dir=self.events_dir)
        assert got == want
        assert jax_taints(self.gpu.patches) == self.tpu.patches
        assert self.gpu.reads == self.tpu.reads
        assert len(self.lines()) == len(self.event_files())
        return got

    def lines(self):
        if not os.path.exists(self.fault_file):
            return []
        with open(self.fault_file) as f:
            return f.read().splitlines()

    def event_files(self):
        if not os.path.exists(self.events_dir):
            return []
        return [json.load(open(os.path.join(self.events_dir, n)))
                for n in sorted(os.listdir(self.events_dir))]


def test_terminate_event_taints_and_posts(tmp_path):
    both = Both(tmp_path)
    assert both.reconcile(fetcher(TERMINATE)) == TERMINATE
    (taints,) = both.gpu.patches
    assert taints == [{"key": "nvidia.com/gpu-maintenance",
                       "value": TERMINATE, "effect": "NoSchedule"}]
    (line,) = both.lines()
    assert line == (f"fault * {mw.MAINTENANCE_XID} # host maintenance "
                    f"imminent: {TERMINATE}")
    assert both.event_files()[0]["device"] is None  # JAX: the whole node


def test_event_posted_once_while_pending(tmp_path):
    both = Both(tmp_path)
    both.reconcile(fetcher(TERMINATE))
    both.reconcile(fetcher(TERMINATE))  # still pending
    assert len(both.gpu.patches) == 1
    assert len(both.lines()) == 1


def test_concurrent_taint_survives_via_conflict_retry(tmp_path):
    """spec.taints is atomic: a taint another controller adds between the
    read and the patch must survive, through a 409 and a second read."""
    not_ready = {"key": "node.kubernetes.io/not-ready", "value": "",
                 "effect": "NoExecute"}
    both = Both(tmp_path)
    for api in (both.gpu, both.tpu):
        read = api.read_node

        def racing_read(name, api=api, read=read):
            node = read(name)
            if api.reads == 1:  # lands after the first read
                api.mutate_concurrently(dict(not_ready))
            return node

        api.read_node = racing_read
    both.reconcile(fetcher(TERMINATE))
    final = both.gpu.node["spec"]["taints"]
    assert not_ready in final
    assert any(t["key"] == mw.TAINT_KEY for t in final)
    assert both.gpu.reads == 2


def test_escalation_updates_taint_and_reposts(tmp_path):
    both = Both(tmp_path)
    both.reconcile(fetcher(MIGRATE))
    both.reconcile(fetcher(TERMINATE))
    assert len(both.gpu.patches) == 2
    assert both.gpu.patches[-1][-1]["value"] == TERMINATE
    assert len(both.lines()) == 2
    assert both.lines()[-1].endswith(TERMINATE)


def test_clear_event_removes_taint_keeps_others(tmp_path):
    other = {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}
    both = Both(tmp_path, taints=[other, {"key": tpu_mw.TAINT_KEY,
                                          "value": "x",
                                          "effect": "NoSchedule"}])
    assert both.reconcile(fetcher("NONE")) is None
    assert both.gpu.patches == [[other]]


def test_none_and_unreadable_are_noops(tmp_path):
    both = Both(tmp_path)
    assert both.reconcile(fetcher("NONE")) is None
    assert both.reconcile(lambda path: None) is None
    assert both.gpu.patches == []
    assert not os.path.exists(both.fault_file)


def test_maintenance_code_flows_through_health_checker_when_configured(
        tmp_path):
    """With the maintenance code in the critical set, the posted event
    takes every device Unhealthy (no device: the whole node), as JAX's
    code 80 does; without it the event is informational."""
    both = Both(tmp_path)
    both.reconcile(fetcher(TERMINATE))

    root = str(tmp_path / "gpu")
    write_fixture(root, 2)
    cfg = GPUConfig.from_json({})
    cfg.add_defaults_and_validate()
    manager = GpuManager(os.path.join(root, "dev"), [], cfg,
                         lib=FakeGpuLib(root))
    manager.start()
    quiet = GpuHealthChecker(manager, manager.lib,
                             fault_file=both.fault_file)
    assert quiet.poll_fault_file() == 1
    assert manager.health_events.empty()
    checker = GpuHealthChecker(manager, manager.lib,
                               critical_xid=[mw.MAINTENANCE_XID],
                               fault_file=both.fault_file)
    assert checker.poll_fault_file() == 1
    got = drain(manager)

    troot = str(tmp_path / "tpu")
    write_tpu_fixture(troot, 2)
    tcfg = TPUConfig.from_json({})
    tcfg.add_defaults_and_validate()
    lib = SysfsTpuLib(troot)
    tmanager = TpuManager(os.path.join(troot, "dev"), [], tcfg, lib=lib)
    tmanager.start()
    tpu_mw.reconcile(FakeApi(TpuApiException), "n0", fetcher(TERMINATE),
                     events_dir=os.path.join(troot, "var/run/tpu/events"))
    event = lib.wait_for_event(timeout_s=1.0)
    TpuHealthChecker(tmanager, lib, critical_codes=[tpu_mw.MAINTENANCE_CODE]
                     ).catch_error(event)
    want = drain(tmanager)
    assert got == {"nvidia0", "nvidia1"}
    assert {d.replace("accel", "nvidia") for d in want} == got


def drain(manager):
    ids = set()
    while not manager.health_events.empty():
        d = manager.health_events.get_nowait()
        assert d.health == "Unhealthy"
        ids.add(d.id)
    return ids


# ---- the entry point, against local stubs --------------------------------------


class Stubs:
    """A metadata server and an API server (one node, one foreign taint)
    on localhost."""

    def __init__(self, event):
        self.event = event
        self.node = {"metadata": {"name": "n0", "resourceVersion": "7"},
                     "spec": {"taints": [{"key": "dedicated", "value": "ml",
                                          "effect": "NoSchedule"}]}}
        self.patches = []
        stubs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, body):
                data = (json.dumps(body) if isinstance(body, dict)
                        else body).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path.endswith(mw.METADATA_PATH):
                    assert self.headers["Metadata-Flavor"] == "Google"
                    return self._send(200, stubs.event)
                if self.path == "/api/v1/nodes/n0":
                    return self._send(200, stubs.node)
                self._send(404, {})

            def do_PATCH(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                rv = body.get("metadata", {}).get("resourceVersion")
                if rv != stubs.node["metadata"]["resourceVersion"]:
                    return self._send(409, {"reason": "Conflict"})
                stubs.patches.append(body["spec"]["taints"])
                stubs.node["spec"]["taints"] = body["spec"]["taints"]
                stubs.node["metadata"]["resourceVersion"] = str(int(rv) + 1)
                self._send(200, stubs.node)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def stubs():
    s = Stubs(TERMINATE)
    yield s
    s.close()


def watcher(stubs, fault_file, *extra, env=None):
    env = dict({k: v for k, v in os.environ.items()
                if k not in ("GPU_FAULT_FILE", "NODE_NAME",
                             "TPU_FAULT_SPEC")}, **(env or {}))
    return subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.maintenance_watcher",
         "--api-host", stubs.url, "--metadata-base", stubs.url,
         "--fault-file", fault_file, "--once", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)


def test_watcher_once_taints_rides_a_conflict_and_clears(stubs, tmp_path):
    fault_file = str(tmp_path / "faults")
    proc = watcher(stubs, fault_file, env={
        "NODE_NAME": "n0", "TPU_FAULT_SPEC": "k8s.patch:conflict@1"})
    assert proc.returncode == 0, proc.stderr
    assert f"maintenance event: {TERMINATE}" in proc.stdout
    assert stubs.patches == [[
        {"key": "dedicated", "value": "ml", "effect": "NoSchedule"},
        {"key": mw.TAINT_KEY, "value": TERMINATE, "effect": "NoSchedule"}]]
    assert "fault injection: k8s.patch conflict" in proc.stderr
    assert open(fault_file).read().startswith(f"fault * {mw.MAINTENANCE_XID}")
    stubs.event = "NONE"
    proc = watcher(stubs, fault_file, "--node-name", "n0")
    assert proc.returncode == 0, proc.stderr
    assert stubs.node["spec"]["taints"] == [
        {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}]


def test_watcher_needs_a_node_and_a_fault_file(stubs, tmp_path):
    proc = watcher(stubs, str(tmp_path / "f"))
    assert proc.returncode == 2 and "NODE_NAME" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.maintenance_watcher",
         "--node-name", "n0", "--once"], cwd=REPO,
        env={k: v for k, v in os.environ.items() if k != "GPU_FAULT_FILE"},
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "GPU_FAULT_FILE" in proc.stderr
