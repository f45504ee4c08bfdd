"""End-to-end tests of the port's device-plugin daemon,
``python -m container_engine_accelerators_tpu_torch.cmd.gpu_device_plugin``,
as a subprocess on a fake GPU node (``--fake-gpu-fixture``) with a kubelet
stub: register, watch, a posted Xid 48 makes a device Unhealthy, a kubelet
restart leads to a new registration, /metrics is served, and a node
without NVML or with a config of the next slice exits non-zero (the JAX
package's tests/test_plugin_daemon.py with GPU names)."""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import grpc
import pytest

from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    post_event,
    write_fixture,
)
from tests.torch_node_helpers import (
    KubeletStub,
    PodResourcesStub,
    make_pod_resources,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAEMON = ["-m", "container_engine_accelerators_tpu_torch.cmd.gpu_device_plugin"]
# The daemon with an NVML library name that names no file: it cannot load
# NVML on any host, one with a GPU driver included.
DAEMON_WITHOUT_NVML = ["-c", "\n".join([
    "import sys",
    "from container_engine_accelerators_tpu_torch.gpulib import nvml",
    "nvml.LIBRARY = 'libnvidia-ml-absent.so.1'",
    "from container_engine_accelerators_tpu_torch.cmd.gpu_device_plugin "
    "import main",
    "sys.exit(main())",
])]


def run_daemon(args, env=None, daemon=DAEMON):
    env = dict({k: v for k, v in os.environ.items()
                if k not in ("XID_CONFIG", "GPU_FAULT_FILE")}, **(env or {}))
    return subprocess.Popen([sys.executable] + daemon + args, cwd=REPO,
                            env=env, stderr=subprocess.PIPE, text=True)


@contextlib.contextmanager
def daemon_rig(tmp_path, extra_args, config=None, env=None):
    root = str(tmp_path)
    write_fixture(root, 4, minors=[3, 0, 1, 2])
    plugdir = os.path.join(root, "p")  # unix socket paths are short
    os.makedirs(plugdir)
    cfg = os.path.join(root, "gpu_config.json")
    with open(cfg, "w") as f:
        json.dump(config or {}, f)
    stub = KubeletStub(os.path.join(plugdir, api.KUBELET_SOCKET))
    stub.start()
    proc = run_daemon(["--plugin-directory", plugdir,
                       "--dev-directory", os.path.join(root, "dev"),
                       "--fake-gpu-fixture", root,
                       "--gpu-config", cfg] + extra_args, env=env)
    try:
        yield root, plugdir, stub, proc
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        stub.stop()


@contextlib.contextmanager
def dial(plugdir, endpoint):
    channel = grpc.insecure_channel(f"unix://{os.path.join(plugdir, endpoint)}")
    try:
        yield api.DevicePluginClient(channel)
    finally:
        channel.close()


def test_daemon_register_watch_xid_unhealthy_and_recover(tmp_path):
    with daemon_rig(tmp_path, ["--enable-health-monitoring",
                               "--health-recovery-window", "1"]) as rig:
        root, plugdir, stub, proc = rig
        reg = stub.requests.get(timeout=30)
        assert reg.resource_name == "nvidia.com/gpu"
        assert reg.endpoint.startswith("nvidiaGPU-")
        with dial(plugdir, reg.endpoint) as client:
            stream = client.list_and_watch(pb.Empty(), timeout=60)
            first = next(stream)
            assert {d.ID for d in first.devices} == {
                f"nvidia{i}" for i in range(4)}
            assert all(d.health == "Healthy" for d in first.devices)

            post_event(root, 13, "nvidia3", "not critical by default")
            post_event(root, 48, "nvidia3", "double-bit ECC")
            health = {d.ID: d.health for d in next(stream).devices}
            assert health == {"nvidia0": "Healthy", "nvidia1": "Healthy",
                              "nvidia2": "Healthy", "nvidia3": "Unhealthy"}
            req = pb.AllocateRequest()
            req.container_requests.add().devicesIDs.append("nvidia3")
            with pytest.raises(grpc.RpcError) as e:
                client.allocate(req, timeout=10)
            assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            # --health-recovery-window 1: back after a quiet second.
            health = {d.ID: d.health for d in next(stream).devices}
            assert health["nvidia3"] == "Healthy"


def test_daemon_critical_xid_from_env(tmp_path):
    with daemon_rig(tmp_path, ["--enable-health-monitoring"],
                    env={"XID_CONFIG": "79"}) as rig:
        root, plugdir, stub, proc = rig
        reg = stub.requests.get(timeout=30)
        with dial(plugdir, reg.endpoint) as client:
            stream = client.list_and_watch(pb.Empty(), timeout=60)
            next(stream)
            post_event(root, 79, None, "fallen off the bus")
            health = {}
            for _ in range(4):  # one update per device
                health = {d.ID: d.health for d in next(stream).devices}
            assert set(health.values()) == {"Unhealthy"}


def test_daemon_reregisters_after_kubelet_restart(tmp_path):
    with daemon_rig(tmp_path, ["--enable-health-monitoring"]) as rig:
        root, plugdir, stub, proc = rig
        reg1 = stub.requests.get(timeout=30)
        sock1 = os.path.join(plugdir, reg1.endpoint)
        assert os.path.exists(sock1)
        os.unlink(sock1)
        reg2 = stub.requests.get(timeout=30)
        assert reg2.resource_name == "nvidia.com/gpu"
        with dial(plugdir, reg2.endpoint) as client:
            assert len(next(client.list_and_watch(pb.Empty(),
                                                  timeout=30)).devices) == 4


def test_daemon_serves_prometheus_metrics(tmp_path):
    pr_sock = os.path.join(str(tmp_path), "pr.sock")
    pr = PodResourcesStub(pr_sock, make_pod_resources())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        with daemon_rig(tmp_path, [
            "--enable-container-gpu-metrics",
            "--gpu-metrics-port", str(port),
            "--gpu-metrics-collection-interval", "0.2",
            "--pod-resources-socket", pr_sock,
        ]) as (root, plugdir, stub, proc):
            stub.requests.get(timeout=30)
            deadline, text = time.time() + 30, ""
            while time.time() < deadline:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=5) as resp:
                        text = resp.read().decode()
                    if "duty_cycle{" in text:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
    finally:
        pr.stop()
    assert "duty_cycle{" in text, text[-1500:]
    assert 'pod="train-job-0"' in text and 'accelerator_id="nvidia1"' in text
    assert "memory_total_gpu_node" in text and 'make="nvidia"' in text
    assert 'pod="shared-pod"' not in text


def test_daemon_without_nvml_exits_nonzero(tmp_path):
    """No --fake-gpu-fixture and NVML cannot load: the daemon stops; it
    never falls back to anything."""
    proc = run_daemon(["--plugin-directory", str(tmp_path),
                       "--gpu-config", str(tmp_path / "none.json")],
                      daemon=DAEMON_WITHOUT_NVML)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 1
    assert "cannot open NVML" in err


@pytest.mark.parametrize("config", [
    {"GPUPartitionSize": "1g.10gb"},
    {"GPUSharingConfig": {"GPUSharingStrategy": "mps",
                          "MaxSharedClientsPerGPU": 2}},
], ids=["mig", "mps"])
def test_daemon_refuses_the_next_slice_config(tmp_path, config):
    with daemon_rig(tmp_path, [], config=config) as (root, plugdir, stub,
                                                     proc):
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 2
        assert "next node slice" in err
