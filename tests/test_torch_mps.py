"""The port's MPS gate and ``mps`` strategy against the JAX package's
core-sharing gate: the cases of tests/test_sharing_gate.py against a fake
``nvidia-cuda-mps-control`` (missing, exits 1, hangs past its timeout,
answers other than a number, dies after verify), each beside the JAX
gate's outcome on its own counterpart; the client limits against the JAX
manager's core-sharing envs for every n and max clients; and Allocate
gated on the live daemon through the gRPC service."""

import os
import threading

import grpc
import pytest

from container_engine_accelerators_tpu.deviceplugin.manager import (
    CORE_PERCENTAGE_ENV,
    HBM_LIMIT_ENV,
    TpuManager,
)
from container_engine_accelerators_tpu.sharing.gate import (
    VISIBILITY_ENV_MARKER,
    CoreSharingGate,
    CoreSharingGateError,
)
from container_engine_accelerators_tpu.utils.config import TPUConfig
from container_engine_accelerators_tpu.utils.device import Mount as TpuMount
from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    MPS_PINNED_MEMORY_ENV,
    MPS_THREAD_PERCENTAGE_ENV,
    GpuManager,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    H100_MEMORY,
    FakeGpuLib,
    write_fixture,
)
from container_engine_accelerators_tpu_torch.sharing import (
    SharingStrategy,
    validate_request,
)
from container_engine_accelerators_tpu_torch.sharing import gate as gate_mod
from container_engine_accelerators_tpu_torch.sharing.gate import (
    MpsGate,
    MpsGateError,
)
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig
from container_engine_accelerators_tpu_torch.utils.device import Mount
from tests.torch_node_helpers import (
    KubeletStub,
    set_mps_daemon,
    write_fake_mps_control,
)

MPS = {"GPUSharingConfig": {"GPUSharingStrategy": "mps",
                            "MaxSharedClientsPerGPU": 2}}


# ---- the gate, beside the JAX gate ---------------------------------------------


class Rig:
    """The fake MPS control binary under a driver mount, its daemon's
    pipe directory; and the JAX gate's libtpu under its own mount."""

    def __init__(self, tmp_path):
        self.driver = tmp_path / "nvidia"
        self.driver.mkdir()
        self.pipe = str(tmp_path / "mps")
        self.libtpu = tmp_path / "tpu" / "lib64" / "libtpu.so"
        self.libtpu.parent.mkdir(parents=True)
        self.gate = MpsGate([Mount(str(self.driver), "/usr/local/nvidia",
                                   True)], self.pipe)
        self.tpu_gate = CoreSharingGate(
            [TpuMount(str(tmp_path / "tpu"), "/usr/local/tpu", True)])

    def install(self, up=True):
        write_fake_mps_control(self.driver)
        set_mps_daemon(self.pipe, up=up)
        self.libtpu.write_bytes(b"\x7fELF" + VISIBILITY_ENV_MARKER)

    def outcome(self, step):
        """(port, JAX): "ok" or the exception's class name."""
        got = []
        for fn in step(self):
            try:
                fn()
                got.append("ok")
            except (MpsGateError, CoreSharingGateError):
                got.append("gate error")
            except ValueError:
                got.append("refused")
        return tuple(got)


def verify(r):
    return r.gate.verify, r.tpu_gate.verify


def allocatable(r):
    return r.gate.check_allocatable, r.tpu_gate.check_allocatable


def test_missing_binary_refused_as_missing_libtpu(tmp_path):
    r = Rig(tmp_path)
    assert r.outcome(verify) == ("gate error", "gate error")
    with pytest.raises(MpsGateError, match="under the driver install"):
        r.gate.verify()


def test_no_daemon_refused_as_markerless_libtpu(tmp_path):
    """The real binary's answer without a daemon: exit 1."""
    r = Rig(tmp_path)
    r.install(up=False)
    r.libtpu.write_bytes(b"\x7fELF no sharing support here")
    assert r.outcome(verify) == ("gate error", "gate error")
    with pytest.raises(MpsGateError,
                       match="exited 1.*Cannot find MPS control daemon"):
        r.gate.verify()


def test_a_hang_past_the_timeout_is_refused(tmp_path, monkeypatch):
    r = Rig(tmp_path)
    r.install()
    open(os.path.join(r.pipe, "hang"), "w").close()
    monkeypatch.setattr(gate_mod, "VERIFY_TIMEOUT_S", 0.5)
    with pytest.raises(MpsGateError, match="did not answer"):
        r.gate.verify()


def test_an_answer_that_is_not_a_number_is_refused(tmp_path):
    r = Rig(tmp_path)
    r.install()
    with open(os.path.join(r.pipe, "answer"), "w") as f:
        f.write("Cannot find MPS control daemon process\n")
    with pytest.raises(MpsGateError, match="not a number"):
        r.gate.verify()


def test_daemon_answers_as_the_marker_is_found(tmp_path):
    r = Rig(tmp_path)
    r.install()
    assert r.outcome(verify) == ("ok", "ok")
    assert r.gate.verify() == 100.0
    assert r.outcome(allocatable) == ("ok", "ok")
    with open(os.path.join(r.pipe, "queries")) as f:
        assert f.read().split() == ["get_default_active_thread_percentage"] * 3


def test_daemon_gone_after_verify_refused_as_a_wiped_install(tmp_path):
    """The daemon dies (the install is wiped): Allocate is refused; it
    comes back (re-delivered): Allocate is allowed again."""
    r = Rig(tmp_path)
    r.install()
    assert r.outcome(verify) == ("ok", "ok")
    set_mps_daemon(r.pipe, up=False)
    r.libtpu.unlink()
    assert r.outcome(allocatable) == ("refused", "refused")
    with pytest.raises(ValueError, match="not answering"):
        r.gate.check_allocatable()
    r.install()
    assert r.outcome(allocatable) == ("ok", "ok")


def test_a_swapped_answer_after_verify_is_refused(tmp_path):
    r = Rig(tmp_path)
    r.install()
    assert r.outcome(verify) == ("ok", "ok")
    with open(os.path.join(r.pipe, "answer"), "w") as f:
        f.write("unknown command\n")
    r.libtpu.write_bytes(b"\x7fELF downgraded build, no visibility")
    assert r.outcome(allocatable) == ("refused", "refused")


def test_check_before_verify_runs_the_full_verify(tmp_path):
    r = Rig(tmp_path)
    r.install()
    r.gate.check_allocatable()
    assert r.gate.find_control() == os.path.join(
        str(r.driver), "bin", "nvidia-cuda-mps-control")


# ---- the client limits against the JAX core-sharing envs ----------------------


def managers(max_clients, total):
    tcfg = TPUConfig.from_json({"TPUSharingConfig": {
        "TPUSharingStrategy": "core-sharing",
        "MaxSharedClientsPerTPU": max_clients}})
    tcfg.add_defaults_and_validate()
    tpu = TpuManager("/nonexistent", [], tcfg)
    tpu.total_hbm_per_chip = total
    cfg = GPUConfig.from_json({"GPUSharingConfig": {
        "GPUSharingStrategy": "mps", "MaxSharedClientsPerGPU": max_clients}})
    cfg.add_defaults_and_validate()
    gpu = GpuManager("/nonexistent", [], cfg, mps_pipe_directory="/p")
    gpu.total_memory_per_gpu = total
    return tpu, gpu


@pytest.mark.parametrize("max_clients", range(2, 49))
def test_envs_arithmetic_equals_jax(max_clients):
    for total in (H100_MEMORY, 85_520_809_984, 40 << 30):
        tpu, gpu = managers(max_clients, total)
        for n in range(1, max_clients + 1):
            want = tpu.envs([f"accel0/vtpu{i}" for i in range(n)])
            got = gpu.envs([f"nvidia0/vgpu{i}" for i in range(n)])
            assert got[MPS_THREAD_PERCENTAGE_ENV] == want[CORE_PERCENTAGE_ENV]
            assert got[MPS_PINNED_MEMORY_ENV] == (
                f"0={int(want[HBM_LIMIT_ENV]) // 2**20}M")
            assert got["CUDA_MPS_PIPE_DIRECTORY"] == "/p"


def test_no_envs_without_mps():
    cfg = GPUConfig.from_json({"GPUSharingConfig": {
        "GPUSharingStrategy": "time-sharing", "MaxSharedClientsPerGPU": 2}})
    cfg.add_defaults_and_validate()
    gpu = GpuManager("/nonexistent", [], cfg)
    gpu.total_memory_per_gpu = H100_MEMORY
    assert gpu.envs(["nvidia0/vgpu0"]) == {}


# ---- the manager and the service ---------------------------------------------


def mps_manager(tmp_path, num_gpus=1, up=True):
    root = str(tmp_path / "root")
    write_fixture(root, num_gpus)
    driver = tmp_path / "driver"
    write_fake_mps_control(driver)
    pipe = str(tmp_path / "mps")
    set_mps_daemon(pipe, up=up)
    cfg = GPUConfig.from_json(MPS)
    cfg.add_defaults_and_validate()
    return GpuManager(os.path.join(root, "dev"),
                      [Mount(str(driver), "/usr/local/nvidia", True)], cfg,
                      lib=FakeGpuLib(root), mps_pipe_directory=pipe,
                      socket_check_interval_s=0.1), pipe


def test_manager_start_refuses_without_a_daemon(tmp_path):
    manager, pipe = mps_manager(tmp_path, up=False)
    with pytest.raises(MpsGateError, match="Cannot find MPS control daemon"):
        manager.start()
    assert manager.mps_gate is None
    assert all(m.host_path != pipe for m in manager.mount_paths)


def test_manager_start_twice_mounts_the_pipe_once(tmp_path):
    manager, pipe = mps_manager(tmp_path)
    manager.start()
    manager.start()  # a hotplug restart
    assert [m.host_path for m in manager.mount_paths].count(pipe) == 1
    assert manager.total_memory_per_gpu == H100_MEMORY


def test_manager_gate_absent_without_mps(tmp_path):
    root = str(tmp_path / "root")
    write_fixture(root, 1)
    cfg = GPUConfig.from_json({})
    cfg.add_defaults_and_validate()
    manager = GpuManager(os.path.join(root, "dev"), [], cfg,
                         lib=FakeGpuLib(root))
    manager.start()
    assert manager.mps_gate is None
    manager.verify_allocatable()  # a no-op


def test_allocate_gated_on_live_daemon(tmp_path):
    manager, pipe = mps_manager(tmp_path)
    plugdir = str(tmp_path / "p")
    os.makedirs(plugdir)
    stub = KubeletStub(os.path.join(plugdir, api.KUBELET_SOCKET))
    stub.start()
    manager.start()
    t = threading.Thread(target=manager.serve, args=(plugdir,),
                         kwargs={"plugin_endpoint": "gpu.sock"}, daemon=True)
    t.start()
    channel = None
    try:
        stub.requests.get(timeout=10)
        channel = grpc.insecure_channel(
            f"unix:{os.path.join(plugdir, 'gpu.sock')}")
        client = api.DevicePluginClient(channel)
        devices = {d.ID for d in next(client.list_and_watch(
            pb.Empty(), timeout=10)).devices}
        req = pb.AllocateRequest()
        req.container_requests.add().devicesIDs.append("nvidia0/vgpu1")
        cresp = client.allocate(req, timeout=5).container_responses[0]
        set_mps_daemon(pipe, up=False)  # the daemon dies mid-flight
        with pytest.raises(grpc.RpcError) as e:
            client.allocate(req, timeout=5)
        set_mps_daemon(pipe)
        again = client.allocate(req, timeout=5).container_responses[0]
    finally:
        if channel is not None:
            channel.close()
        manager.stop()
        t.join(timeout=10)
        stub.stop()
    assert not t.is_alive()
    assert devices == {"nvidia0/vgpu0", "nvidia0/vgpu1"}
    assert dict(cresp.envs) == {
        MPS_THREAD_PERCENTAGE_ENV: "50",
        MPS_PINNED_MEMORY_ENV: f"0={H100_MEMORY // 2 // 2**20}M",
        "CUDA_MPS_PIPE_DIRECTORY": pipe}
    assert [(m.host_path, m.container_path, m.read_only)
            for m in cresp.mounts] == [
        (str(tmp_path / "driver"), "/usr/local/nvidia", True),
        (pipe, pipe, False)]
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "not answering" in e.value.details()
    assert dict(again.envs) == dict(cresp.envs)


def test_several_vgpus_only_on_a_single_gpu_node(tmp_path):
    manager, _ = mps_manager(tmp_path, num_gpus=2)
    manager.start()
    assert set(manager.list_devices()) == {
        f"nvidia{i}/vgpu{j}" for i in range(2) for j in range(2)}
    with pytest.raises(ValueError, match="multi-GPU"):
        validate_request(["nvidia0/vgpu0", "nvidia0/vgpu1"], 2,
                         SharingStrategy.MPS)
