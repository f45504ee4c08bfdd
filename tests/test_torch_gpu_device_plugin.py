"""The port's device plugin in process (GpuManager's serve loop, the gRPC
service) on a fake 4-GPU node against a kubelet stub: the cases of the JAX
package's tests/test_device_plugin.py with GPU paths, the NVIDIA parts
(control nodes, the driver mount, minor numbers, NVML's view of /dev), and
one script run against both the port and the JAX TpuManager, which must
see the same device sets, health sequence and re-registrations."""

import os
import threading
import time

import grpc
import pytest

from container_engine_accelerators_tpu.deviceplugin import api as tpu_api
from container_engine_accelerators_tpu.deviceplugin import (
    deviceplugin_v1beta1_pb2 as tpu_pb,
)
from container_engine_accelerators_tpu.deviceplugin import (
    preferred as tpu_preferred,
)
from container_engine_accelerators_tpu.deviceplugin.manager import TpuManager
from container_engine_accelerators_tpu.tpulib import SysfsTpuLib
from container_engine_accelerators_tpu.tpulib import (
    write_fixture as write_tpu_fixture,
)
from container_engine_accelerators_tpu.utils.config import TPUConfig
from container_engine_accelerators_tpu.utils.device import (
    Device as TpuDevice,
)
from container_engine_accelerators_tpu.utils.device import Mount as TpuMount
from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.deviceplugin import preferred
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    GpuManager,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    add_gpu,
    cap_minor,
    write_fixture,
    write_mig_fixture,
)
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    UNHEALTHY,
    Device,
    Mount,
)
from tests.kubelet_stub import KubeletStub as TpuKubeletStub
from tests.torch_node_helpers import (
    KubeletStub,
    set_mps_daemon,
    write_fake_mps_control,
)

PLUGIN_ENDPOINT = "gpu.sock"
NUM_GPUS = 4
DRIVER = Mount(host_path="/home/kubernetes/bin/nvidia",
               container_path="/usr/local/nvidia", read_only=True)
TIME_SHARING = {"GPUSharingConfig": {"GPUSharingStrategy": "time-sharing",
                                     "MaxSharedClientsPerGPU": 2}}
MPS = {"GPUSharingConfig": {"GPUSharingStrategy": "mps",
                            "MaxSharedClientsPerGPU": 2}}


def make_manager(root, config_json=None, num_gpus=NUM_GPUS, **fixture):
    write_fixture(root, num_gpus, **fixture)
    cfg = GPUConfig.from_json(config_json or {})
    cfg.add_defaults_and_validate()
    return GpuManager(os.path.join(root, "dev"), [DRIVER], cfg,
                      lib=FakeGpuLib(root), device_check_interval_s=0.3,
                      socket_check_interval_s=0.1,
                      proc_root=os.path.join(root, "proc"))


class PluginHarness:
    """The real serve loop in a thread next to a kubelet stub."""

    def __init__(self, tmp_path, manager=None, side="gpu", **kw):
        self.root = str(tmp_path / "root")
        os.makedirs(self.root, exist_ok=True)
        self.plugin_dir = str(tmp_path / "dp")  # unix socket paths are short
        os.makedirs(self.plugin_dir)
        self.side = side
        if side == "gpu":
            self.manager = manager or make_manager(self.root, **kw)
            self.pb, self.api, stub = pb, api, KubeletStub
        else:
            write_tpu_fixture(self.root, NUM_GPUS, topology="2x2x1")
            cfg = TPUConfig.from_json({})
            cfg.add_defaults_and_validate()
            self.manager = TpuManager(
                os.path.join(self.root, "dev"),
                [TpuMount("/home/kubernetes/bin/tpu", "/usr/local/tpu", True)],
                cfg, lib=SysfsTpuLib(self.root), device_check_interval_s=0.3,
                socket_check_interval_s=0.1)
            self.pb, self.api, stub = tpu_pb, tpu_api, TpuKubeletStub
        self.stub = stub(os.path.join(self.plugin_dir, api.KUBELET_SOCKET))
        self.channel = None

    def __enter__(self):
        self.stub.start()
        self.manager.start()
        self.thread = threading.Thread(
            target=self.manager.serve, args=(self.plugin_dir,),
            kwargs={"plugin_endpoint": PLUGIN_ENDPOINT}, daemon=True)
        self.thread.start()
        self.register_request = self.stub.requests.get(timeout=10)
        self.client = self.dial()
        return self

    def dial(self):
        if self.channel is not None:
            self.channel.close()
        self.channel = grpc.insecure_channel(
            f"unix:{os.path.join(self.plugin_dir, PLUGIN_ENDPOINT)}")
        grpc.channel_ready_future(self.channel).result(timeout=10)
        return self.api.DevicePluginClient(self.channel)

    def __exit__(self, *exc):
        if self.channel is not None:
            self.channel.close()
        self.manager.stop()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        self.stub.stop()
        return False

    def watch(self):
        return self.client.list_and_watch(self.pb.Empty(), timeout=20)

    def allocate(self, ids):
        req = self.pb.AllocateRequest()
        req.container_requests.add().devicesIDs.extend(ids)
        return self.client.allocate(req, timeout=5)


def device_map(stream):
    return {d.ID: d.health for d in next(stream).devices}


def control_nodes(root, optional=("nvidia-uvm-tools", "nvidia-modeset")):
    return [os.path.join(root, "dev", d)
            for d in ("nvidiactl", "nvidia-uvm") + tuple(optional)]


# ---- registration, ListAndWatch, Allocate ----------------------------------


def test_registers_with_kubelet(tmp_path):
    with PluginHarness(tmp_path) as h:
        r = h.register_request
        assert r.resource_name == "nvidia.com/gpu"
        assert r.version == "v1beta1"
        assert r.endpoint == PLUGIN_ENDPOINT
        assert r.options.get_preferred_allocation_available


def test_list_and_watch_plain(tmp_path):
    with PluginHarness(tmp_path) as h:
        assert device_map(h.watch()) == {
            f"nvidia{i}": HEALTHY for i in range(NUM_GPUS)}


def test_allocate_one_gpu_gives_five_device_specs(tmp_path):
    """The reference's test: one GPU, its node, nvidiactl, nvidia-uvm,
    nvidia-uvm-tools and nvidia-modeset, and the driver mount."""
    with PluginHarness(tmp_path) as h:
        cresp = h.allocate(["nvidia2"]).container_responses[0]
        assert [d.host_path for d in cresp.devices] == [
            os.path.join(h.root, "dev", "nvidia2")] + control_nodes(h.root)
        for d in cresp.devices:
            assert d.container_path == d.host_path
            assert d.permissions == "mrw"
        assert [(m.host_path, m.container_path, m.read_only)
                for m in cresp.mounts] == [
            ("/home/kubernetes/bin/nvidia", "/usr/local/nvidia", True)]
        assert dict(cresp.envs) == {}


def test_allocate_two_gpus(tmp_path):
    with PluginHarness(tmp_path) as h:
        cresp = h.allocate(["nvidia1", "nvidia3"]).container_responses[0]
        assert [d.host_path for d in cresp.devices][:2] == [
            os.path.join(h.root, "dev", "nvidia1"),
            os.path.join(h.root, "dev", "nvidia3")]
        assert len(cresp.devices) == 6


def test_optional_nodes_only_where_present(tmp_path):
    h = PluginHarness(tmp_path, manager=make_manager(
        str(tmp_path / "root"), extra_nodes=("nvidia-uvm-tools",)))
    with h:
        cresp = h.allocate(["nvidia0"]).container_responses[0]
        assert [d.host_path for d in cresp.devices] == [
            os.path.join(h.root, "dev", "nvidia0")] + control_nodes(
            h.root, ("nvidia-uvm-tools",))


@pytest.mark.parametrize("bad", [["nvidia9"], ["nvidia0", "nvidia9"],
                                 ["accel0"], ["nvidia0/vgpu0"]])
def test_allocate_unknown_device_rejected(tmp_path, bad):
    with PluginHarness(tmp_path) as h:
        with pytest.raises(grpc.RpcError) as exc_info:
            h.allocate(bad)
        assert exc_info.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_unhealthy_device_flow(tmp_path):
    with PluginHarness(tmp_path) as h:
        stream = h.watch()
        assert device_map(stream)["nvidia0"] == HEALTHY
        h.manager.health_events.put(Device(id="nvidia0", health=UNHEALTHY))
        devices = device_map(stream)
        assert devices["nvidia0"] == UNHEALTHY
        assert devices["nvidia1"] == HEALTHY
        with pytest.raises(grpc.RpcError) as exc_info:
            h.allocate(["nvidia0"])
        assert "unhealthy" in exc_info.value.details()
        h.manager.health_events.put(Device(id="nvidia0", health=HEALTHY))
        assert device_map(stream)["nvidia0"] == HEALTHY
        assert h.allocate(["nvidia0"]).container_responses


def test_hotplug_restarts_server(tmp_path):
    h = PluginHarness(tmp_path, manager=make_manager(str(tmp_path / "root"),
                                                     num_gpus=2))
    with h:
        add_gpu(h.root, 2)
        second = h.stub.requests.get(timeout=10)
        assert second.resource_name == "nvidia.com/gpu"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                if "nvidia2" in device_map(h.dial().list_and_watch(
                        pb.Empty(), timeout=5)):
                    return
            except grpc.RpcError:
                pass
            time.sleep(0.2)
        pytest.fail("hotplugged nvidia2 never advertised")


def test_socket_deletion_triggers_reregistration(tmp_path):
    with PluginHarness(tmp_path) as h:
        os.unlink(os.path.join(h.plugin_dir, PLUGIN_ENDPOINT))
        assert h.stub.requests.get(timeout=10).endpoint == PLUGIN_ENDPOINT


def test_preferred_allocation_rpc(tmp_path):
    with PluginHarness(tmp_path) as h:
        req = pb.PreferredAllocationRequest()
        creq = req.container_requests.add()
        creq.available_deviceIDs.extend(["nvidia3", "nvidia10", "nvidia2",
                                         "nvidia0"])
        creq.must_include_deviceIDs.extend(["nvidia3"])
        creq.allocation_size = 2
        resp = h.client.get_preferred_allocation(req, timeout=5)
        assert list(resp.container_responses[0].deviceIDs) == [
            "nvidia0", "nvidia3"]
        opts = h.client.get_device_plugin_options(pb.Empty(), timeout=5)
        assert opts.get_preferred_allocation_available


# ---- time-sharing ------------------------------------------------------------


def test_list_and_watch_time_sharing(tmp_path):
    with PluginHarness(tmp_path, config_json=TIME_SHARING) as h:
        assert set(device_map(h.watch())) == {
            f"nvidia{i}/vgpu{j}" for i in range(NUM_GPUS) for j in range(2)}


def test_allocate_time_sharing(tmp_path):
    with PluginHarness(tmp_path, config_json=TIME_SHARING) as h:
        cresp = h.allocate(["nvidia1/vgpu0"]).container_responses[0]
        assert [d.host_path for d in cresp.devices] == [
            os.path.join(h.root, "dev", "nvidia1")] + control_nodes(h.root)
        with pytest.raises(grpc.RpcError) as exc_info:
            h.allocate(["nvidia1/vgpu0", "nvidia1/vgpu1"])
        assert exc_info.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_time_sharing_inherits_health(tmp_path):
    with PluginHarness(tmp_path, config_json=TIME_SHARING) as h:
        stream = h.watch()
        device_map(stream)
        h.manager.health_events.put(Device(id="nvidia0", health=UNHEALTHY))
        devices = device_map(stream)
        assert devices["nvidia0/vgpu0"] == UNHEALTHY
        assert devices["nvidia0/vgpu1"] == UNHEALTHY
        assert devices["nvidia1/vgpu0"] == HEALTHY


# ---- NVIDIA specifics: minors, NVML's view, the handshake, refusals --------


def test_devices_are_named_by_minor_not_index(tmp_path):
    """NVML index 0 is /dev/nvidia5 here: advertised, allocated and
    health-flipped as nvidia5."""
    h = PluginHarness(tmp_path, manager=make_manager(
        str(tmp_path / "root"), num_gpus=2, minors=[5, 2]))
    with h:
        stream = h.watch()
        assert device_map(stream) == {"nvidia5": HEALTHY, "nvidia2": HEALTHY}
        cresp = h.allocate(["nvidia5"]).container_responses[0]
        assert cresp.devices[0].host_path == os.path.join(
            h.root, "dev", "nvidia5")
        with pytest.raises(grpc.RpcError):
            h.allocate(["nvidia0"])


def test_dev_nodes_nvml_does_not_report_are_not_advertised(tmp_path):
    root = str(tmp_path / "root")
    manager = make_manager(root, num_gpus=2)
    open(os.path.join(root, "dev", "nvidia7"), "w").close()  # not in NVML
    os.unlink(os.path.join(root, "dev", "nvidia1"))  # NVML-only
    manager.start()
    assert set(manager.list_devices()) == {"nvidia0"}
    assert not manager.has_additional_gpus_installed()


def test_installer_handshake_waits_for_control_nodes(tmp_path):
    root = str(tmp_path / "root")
    manager = make_manager(root, num_gpus=1)
    assert manager.check_device_paths()
    os.unlink(os.path.join(root, "dev", "nvidia-uvm"))
    assert not manager.check_device_paths()


def test_mig_starts_from_a_fixture_tree(tmp_path):
    """GPUPartitionSize: the partitions under the fixture's /proc are the
    devices, each with its GPU's node and two capability nodes."""
    root = str(tmp_path / "root")
    manager = make_manager(root, config_json={"GPUPartitionSize": "3g.40gb"})
    ids = write_mig_fixture(root, 2)
    manager.start()
    assert sorted(manager.list_devices()) == sorted(ids)
    assert len(ids) == 2 * NUM_GPUS
    specs = manager.device_spec("nvidia2/gi1")
    assert [d.host_path for d in specs] == [
        os.path.join(root, "dev", "nvidia2"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(2, 1)}"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(2, 1, 0)}")]


def test_mps_starts_with_a_live_gate(tmp_path):
    """mps: the start asks the MPS daemon, then mounts its pipe
    directory and advertises the virtual devices."""
    root = str(tmp_path / "root")
    driver = tmp_path / "driver"
    write_fake_mps_control(driver)
    pipe = str(tmp_path / "mps")
    set_mps_daemon(pipe)
    write_fixture(root, NUM_GPUS)
    cfg = GPUConfig.from_json(MPS)
    cfg.add_defaults_and_validate()
    manager = GpuManager(os.path.join(root, "dev"),
                         [Mount(str(driver), "/usr/local/nvidia", True)], cfg,
                         lib=FakeGpuLib(root), mps_pipe_directory=pipe)
    manager.start()
    assert set(manager.list_devices()) == {
        f"nvidia{i}/vgpu{j}" for i in range(NUM_GPUS) for j in range(2)}
    assert manager.mount_paths[-1] == Mount(pipe, pipe, False)
    assert manager.envs(["nvidia0/vgpu1"])[
        "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"] == "50"
    assert open(os.path.join(pipe, "queries")).read().split() == [
        "get_default_active_thread_percentage"]


@pytest.mark.parametrize("available,must,size", [
    (["accel3", "accel10", "accel2", "accel0"], ["accel3"], 2),
    (["accel0", "accel1", "accel2", "accel3"], [], 3),
    (["accel0", "accel1"], ["accel1"], 1),
    (["accel0", "accel1"], [], 0),
    (["accel0", "accel1"], [], 5),
    (["accel1/vtpu1", "accel1/vtpu0", "accel0/vtpu10", "accel0/vtpu2"],
     ["accel0/vtpu10"], 2),
])
def test_preferred_matches_jax_without_topology(available, must, size):
    def gpu(ids):
        return [i.replace("accel", "nvidia").replace("vtpu", "vgpu")
                for i in ids]

    want = tpu_preferred.choose_preferred(available, must, size, None)
    assert preferred.choose_preferred(gpu(available), gpu(must), size) == (
        gpu(want))


# ---- one script, both packages -----------------------------------------------


def run_script(h, new_device):
    """Register, watch, fail and heal one device, lose the socket, hotplug
    one more: the device sets, health and registrations seen at each
    step, with names made generic."""
    name = "nvidia1" if h.side == "gpu" else "accel1"
    device = Device if h.side == "gpu" else TpuDevice

    def generic(devices):
        return {k.replace("nvidia", "dev").replace("accel", "dev"): v
                for k, v in devices.items()}

    trace, registrations = [], 1
    stream = h.watch()
    trace.append(("start", generic(device_map(stream)), registrations))
    h.manager.health_events.put(device(id=name, health=UNHEALTHY))
    trace.append(("fault", generic(device_map(stream)), registrations))
    with pytest.raises(grpc.RpcError) as exc_info:
        h.allocate([name])
    trace.append(("refused", exc_info.value.code().name, registrations))
    h.manager.health_events.put(device(id=name, health=HEALTHY))
    trace.append(("heal", generic(device_map(stream)), registrations))
    os.unlink(os.path.join(h.plugin_dir, PLUGIN_ENDPOINT))
    h.stub.requests.get(timeout=10)
    registrations += 1
    trace.append(("socket", generic(device_map(h.dial().list_and_watch(
        h.pb.Empty(), timeout=10))), registrations))
    new_device()
    h.stub.requests.get(timeout=10)
    registrations += 1
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            devices = device_map(h.dial().list_and_watch(h.pb.Empty(),
                                                         timeout=5))
            if len(devices) == NUM_GPUS + 1:
                break
        except grpc.RpcError:
            pass
        time.sleep(0.1)
    trace.append(("hotplug", generic(devices), registrations))
    time.sleep(0.5)  # no further registration after the hotplug
    trace.append(("settled", h.stub.requests.qsize(), registrations))
    return trace


def test_script_matches_jax_manager(tmp_path):
    with PluginHarness(tmp_path / "t", side="tpu") as h:
        root = h.root
        tpu = run_script(h, lambda: open(os.path.join(
            root, "dev", f"accel{NUM_GPUS}"), "w").close())
    with PluginHarness(tmp_path / "g") as h:
        root = h.root
        gpu = run_script(h, lambda: add_gpu(root, NUM_GPUS))
    assert gpu == tpu
    assert gpu[1][1]["dev1"] == UNHEALTHY
    assert gpu[-2][2] == 3
