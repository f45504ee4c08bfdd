"""End-to-end tests of the port's device-plugin daemon,
``python -m container_engine_accelerators_tpu_torch.cmd.gpu_device_plugin``,
as a subprocess on a fake GPU node (``--fake-gpu-fixture``) with a kubelet
stub: register, watch, a posted Xid 48 makes a device Unhealthy, a kubelet
restart leads to a new registration, /metrics is served, a node without
NVML exits non-zero, MIG partitions and MPS vGPUs are advertised, and a
MIG or MPS config the node cannot serve advertises nothing (the JAX
package's tests/test_plugin_daemon.py with GPU names)."""

import contextlib
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import grpc
import pytest

from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    H100_MEMORY,
    cap_minor,
    post_event,
    write_fixture,
    write_mig_fixture,
)
from tests.torch_node_helpers import (
    KubeletStub,
    PodResourcesStub,
    make_pod_resources,
    set_mps_daemon,
    write_fake_mps_control,
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
def daemon_rig(tmp_path, extra_args, config=None, env=None, num_gpus=4,
               mig=0):
    root = str(tmp_path)
    write_fixture(root, num_gpus, minors=[3, 0, 1, 2][:num_gpus])
    if mig:
        write_mig_fixture(root, mig)
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


def stderr_lines(proc):
    """The daemon's stderr lines as they come, on a queue (a thread
    reads them, so a test can wait with a deadline)."""
    lines = queue.Queue()

    def pump():
        for line in proc.stderr:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    return lines


def wait_for_line(lines, needle, timeout=30.0):
    deadline, seen = time.monotonic() + timeout, []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=0.2)
        except queue.Empty:
            continue
        seen.append(line)
        if needle in line:
            return line
    pytest.fail(f"{needle!r} not logged; daemon said: {''.join(seen[-20:])}")


MPS = {"GPUSharingConfig": {"GPUSharingStrategy": "mps",
                            "MaxSharedClientsPerGPU": 2}}


@pytest.mark.parametrize("config", [
    {"GPUPartitionSize": "1g.10gb"}, MPS], ids=["mig", "mps"])
def test_daemon_refuses_the_next_slice_config(tmp_path, config):
    """MIG partitions that are not there, or an MPS daemon that does not
    answer: the daemon logs why, advertises nothing and keeps retrying
    (no fallback to whole GPUs)."""
    env = {"CUDA_MPS_PIPE_DIRECTORY": str(tmp_path / "mps")}
    with daemon_rig(tmp_path, ["--host-path", str(tmp_path / "driver")],
                    config=config, env=env) as (root, plugdir, stub, proc):
        lines = stderr_lines(proc)
        line = wait_for_line(lines, "failed to start the GPU manager")
        if "GPUPartitionSize" in config:
            assert "nvidia0: no MIG partition under " + os.path.join(
                root, "proc", "driver/nvidia/capabilities/gpu0/mig") in line
        else:
            assert "nvidia-cuda-mps-control under the driver install" in line
        assert proc.poll() is None  # retrying, not exited
        with pytest.raises(queue.Empty):
            stub.requests.get(timeout=1.0)


def test_daemon_advertises_mig_partitions(tmp_path):
    root = str(tmp_path)
    with daemon_rig(tmp_path, [], config={"GPUPartitionSize": "2g.20gb"},
                    mig=3) as (root, plugdir, stub, proc):
        reg = stub.requests.get(timeout=30)
        with dial(plugdir, reg.endpoint) as client:
            got = {d.ID for d in next(client.list_and_watch(
                pb.Empty(), timeout=30)).devices}
            req = pb.AllocateRequest()
            req.container_requests.add().devicesIDs.append("nvidia1/gi4")
            cresp = client.allocate(req, timeout=10).container_responses[0]
    assert got == {f"nvidia{m}/gi{g}" for m in range(4) for g in (3, 4, 5)}
    assert [d.host_path for d in cresp.devices][:3] == [
        os.path.join(root, "dev", "nvidia1"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(1, 4)}"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(1, 4, 0)}")]


def test_daemon_mps_allocate_sets_the_client_limits(tmp_path):
    """mps with an MPS daemon that answers: vGPUs advertised, Allocate
    gives the thread share, the memory limit and the pipe directory;
    once the daemon is gone Allocate is refused."""
    pipe = str(tmp_path / "mps")
    write_fake_mps_control(tmp_path / "driver")
    set_mps_daemon(pipe)
    with daemon_rig(tmp_path, ["--host-path", str(tmp_path / "driver")],
                    config=MPS, env={"CUDA_MPS_PIPE_DIRECTORY": pipe},
                    num_gpus=1) as (root, plugdir, stub, proc):
        reg = stub.requests.get(timeout=30)
        with dial(plugdir, reg.endpoint) as client:
            got = {d.ID for d in next(client.list_and_watch(
                pb.Empty(), timeout=30)).devices}
            req = pb.AllocateRequest()
            req.container_requests.add().devicesIDs.extend(
                ["nvidia3/vgpu0", "nvidia3/vgpu1"])
            cresp = client.allocate(req, timeout=10).container_responses[0]
            set_mps_daemon(pipe, up=False)
            with pytest.raises(grpc.RpcError) as e:
                client.allocate(req, timeout=10)
    assert got == {"nvidia3/vgpu0", "nvidia3/vgpu1"}
    assert dict(cresp.envs) == {
        "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE": "100",
        "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT": f"0={H100_MEMORY // 2**20}M",
        "CUDA_MPS_PIPE_DIRECTORY": pipe}
    assert (pipe, pipe, False) in [(m.host_path, m.container_path,
                                    m.read_only) for m in cresp.mounts]
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "not answering" in e.value.details()
