"""The port's MIG partitions (partition/mig.py and the manager's MIG
branch): fixture /proc trees for every H100 80GB size and A100 ones, the
three-node specs, unknown and unhealthy partitions refused, a GPU
without partitions raising, and an Xid routed to every partition of its
GPU and back, held against the JAX sub-slice manager's routing; then
ListAndWatch and Allocate through the gRPC service, with time-sharing on
top."""

import logging
import os
import threading

import grpc
import pytest

from container_engine_accelerators_tpu.deviceplugin.manager import TpuManager
from container_engine_accelerators_tpu.health import TpuHealthChecker
from container_engine_accelerators_tpu.tpulib import SysfsTpuLib
from container_engine_accelerators_tpu.tpulib import (
    write_fixture as write_tpu_fixture,
)
from container_engine_accelerators_tpu.tpulib.types import (
    TpuErrorEvent as TpuEvent,
)
from container_engine_accelerators_tpu.utils.config import TPUConfig
from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    GpuManager,
)
from container_engine_accelerators_tpu_torch.deviceplugin.preferred import (
    natural_key,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    cap_minor,
    write_fixture,
    write_mig_fixture,
)
from container_engine_accelerators_tpu_torch.gpulib.types import XidEvent
from container_engine_accelerators_tpu_torch.health import GpuHealthChecker
from container_engine_accelerators_tpu_torch.partition.mig import (
    PARTITION_MAX_COUNT,
    MigDeviceManager,
    read_minor,
)
from container_engine_accelerators_tpu_torch.utils.config import (
    VALID_PARTITION_SIZES,
    GPUConfig,
)
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    UNHEALTHY,
)
from tests.torch_node_helpers import KubeletStub

H100_SIZES = {"1g.10gb": 7, "1g.20gb": 4, "2g.20gb": 3, "3g.40gb": 2,
              "4g.40gb": 1, "7g.80gb": 1}
A100_40GB_SIZES = {"1g.5gb": 7, "2g.10gb": 3, "3g.20gb": 2, "4g.20gb": 1,
                   "7g.40gb": 1}


def mig_manager(root, size, num_gpus=2, minors=None, count=None,
                extra=None, write=True):
    write_fixture(root, len(minors) if minors else num_gpus, minors=minors)
    if write:
        write_mig_fixture(root, count or PARTITION_MAX_COUNT[size])
    cfg = GPUConfig.from_json(dict({"GPUPartitionSize": size}, **(extra or {})))
    cfg.add_defaults_and_validate()
    return GpuManager(os.path.join(root, "dev"), [], cfg,
                      lib=FakeGpuLib(root), proc_root=os.path.join(root, "proc"),
                      socket_check_interval_s=0.1)


def test_the_table_covers_every_valid_size():
    assert set(PARTITION_MAX_COUNT) == set(VALID_PARTITION_SIZES)
    assert {s: PARTITION_MAX_COUNT[s] for s in H100_SIZES} == H100_SIZES
    assert {s: PARTITION_MAX_COUNT[s] for s in A100_40GB_SIZES} == (
        A100_40GB_SIZES)


@pytest.mark.parametrize("size", list(H100_SIZES) + ["1g.5gb", "3g.20gb"])
def test_every_size_advertises_its_partitions(tmp_path, size, caplog):
    root = str(tmp_path)
    manager = mig_manager(root, size, minors=[4, 1])
    with caplog.at_level(logging.WARNING):
        manager.start()
    devices = manager.list_devices()
    count = PARTITION_MAX_COUNT[size]
    assert len(devices) == 2 * count
    assert all(d.health == HEALTHY for d in devices.values())
    assert sorted(devices, key=natural_key)[0].startswith("nvidia1/gi")
    assert "maximum" not in caplog.text
    for device_id in devices:
        gpu, gi = device_id.split("/gi")
        minor = int(gpu[len("nvidia"):])
        specs = manager.device_spec(device_id)
        assert [s.host_path for s in specs] == [
            os.path.join(root, "dev", gpu),
            os.path.join(root, "dev", "nvidia-caps",
                         f"nvidia-cap{cap_minor(minor, int(gi))}"),
            os.path.join(root, "dev", "nvidia-caps",
                         f"nvidia-cap{cap_minor(minor, int(gi), 0)}")]
        assert all(s.container_path == s.host_path and s.permissions == "mrw"
                   for s in specs)


def test_a_count_other_than_the_maximum_is_logged(tmp_path, caplog):
    manager = mig_manager(str(tmp_path), "1g.10gb", count=3)
    with caplog.at_level(logging.WARNING):
        manager.start()
    assert len(manager.list_devices()) == 6
    assert "nvidia0 has 3 partitions of 1g.10gb; the size's maximum is 7" in (
        caplog.text)


def test_access_files_give_the_capability_minors(tmp_path):
    root = str(tmp_path)
    mig_manager(root, "3g.40gb", minors=[6])
    access = os.path.join(root, "proc/driver/nvidia/capabilities/gpu6/mig/"
                          "gi2/ci0/access")
    assert read_minor(access) == cap_minor(6, 2, 0) == 3 + 6 * 135 + 18 + 1
    with open(access, "w") as f:
        f.write("DeviceFileMode: 292\n")
    with pytest.raises(ValueError, match="DeviceFileMinor"):
        read_minor(access)


@pytest.mark.parametrize("bad", ["nvidia0/gi99", "nvidia7/gi1", "nvidia0",
                                 "slice0"])
def test_unknown_partition_refused(tmp_path, bad):
    manager = mig_manager(str(tmp_path), "3g.40gb")
    manager.start()
    with pytest.raises(ValueError, match="non-existing"):
        manager.device_spec(bad)


def test_unhealthy_partition_refused(tmp_path):
    manager = mig_manager(str(tmp_path), "3g.40gb")
    manager.start()
    manager.set_device_health("nvidia1/gi2", UNHEALTHY)
    with pytest.raises(ValueError, match="unhealthy"):
        manager.device_spec("nvidia1/gi2")
    assert manager.device_spec("nvidia1/gi1")


def test_no_partitions_raises_naming_the_gpu_and_path(tmp_path):
    root = str(tmp_path)
    manager = mig_manager(root, "1g.10gb", write=False)
    with pytest.raises(FileNotFoundError) as e:
        manager.start()
    assert str(e.value).startswith(
        "nvidia0: no MIG partition under " + os.path.join(
            root, "proc/driver/nvidia/capabilities/gpu0/mig"))


def test_a_gpu_left_unpartitioned_raises(tmp_path):
    root = str(tmp_path)
    write_fixture(root, 2)
    write_mig_fixture(root, 2, minors=[0])
    cfg = GPUConfig.from_json({"GPUPartitionSize": "3g.40gb"})
    cfg.add_defaults_and_validate()
    manager = GpuManager(os.path.join(root, "dev"), [], cfg,
                         lib=FakeGpuLib(root),
                         proc_root=os.path.join(root, "proc"))
    with pytest.raises(FileNotFoundError, match="nvidia1: no MIG partition"):
        manager.start()


def test_a_missing_capability_node_raises(tmp_path):
    root = str(tmp_path)
    write_fixture(root, 1)
    write_mig_fixture(root, 1, caps_nodes=False)
    m = MigDeviceManager(os.path.join(root, "dev"), os.path.join(root, "proc"))
    with pytest.raises(FileNotFoundError, match="nvidia0/gi0: device node"):
        m.start("7g.80gb", ["nvidia0"])


def test_an_invalid_size_is_refused(tmp_path):
    m = MigDeviceManager(str(tmp_path), str(tmp_path))
    with pytest.raises(ValueError, match="invalid GPUPartitionSize"):
        m.start("2g.40gb", [])


def test_tables_are_swapped_whole_on_restart(tmp_path):
    root = str(tmp_path)
    manager = mig_manager(root, "3g.40gb", num_gpus=1)
    manager.start()
    before = manager.mig.devices
    manager.start()
    assert manager.mig.devices is not before
    assert manager.mig.devices == before


# ---- health: an Xid takes a GPU's partitions, recovery brings them back ------


def apply(manager):
    """Drain the health queue into device state, as ListAndWatch does."""
    while not manager.health_events.empty():
        d = manager.health_events.get_nowait()
        manager.set_device_health(d.id, d.health)


def health_vector(manager):
    devices = manager.list_physical_devices()
    return [devices[k].health for k in sorted(devices, key=natural_key)]


def test_xid_takes_every_partition_of_its_gpu(tmp_path):
    manager = mig_manager(str(tmp_path), "2g.20gb", num_gpus=2)
    manager.start()
    checker = GpuHealthChecker(manager, manager.lib, recovery_window_s=None)
    checker.catch_error(XidEvent(code=48, device="nvidia1"))
    apply(manager)
    devices = manager.list_physical_devices()
    assert {k for k, d in devices.items() if d.health == UNHEALTHY} == {
        "nvidia1/gi3", "nvidia1/gi4", "nvidia1/gi5"}
    with pytest.raises(ValueError, match="unhealthy"):
        manager.device_spec("nvidia1/gi4")
    manager.health_events.put(type(devices["nvidia0/gi3"])(
        id="nvidia1", health=HEALTHY))  # the checker's recovery
    apply(manager)
    assert set(health_vector(manager)) == {HEALTHY}


def test_whole_node_xid_takes_every_partition(tmp_path):
    manager = mig_manager(str(tmp_path), "3g.40gb", num_gpus=2)
    manager.start()
    GpuHealthChecker(manager, manager.lib, critical_xid=[79]).catch_error(
        XidEvent(code=79, device=None))
    apply(manager)
    assert health_vector(manager) == [UNHEALTHY] * 4


def test_routing_matches_the_jax_sub_slices(tmp_path):
    """One partition a GPU against JAX's one-chip sub-slices: the same
    fault, clear and recovery script gives the same partition health."""
    gpu = mig_manager(str(tmp_path / "g"), "7g.80gb", num_gpus=4)
    gpu.start()
    troot = str(tmp_path / "t")
    write_tpu_fixture(troot, 4, topology="2x2x1")
    tcfg = TPUConfig.from_json({"tpuPartitionSize": "1x1"})
    tcfg.add_defaults_and_validate()
    tpu = TpuManager(os.path.join(troot, "dev"), [], tcfg,
                     lib=SysfsTpuLib(troot))
    tpu.start()
    gcheck = GpuHealthChecker(gpu, gpu.lib, recovery_window_s=100.0)
    tcheck = TpuHealthChecker(tpu, tpu.lib, recovery_window_s=100.0)
    script = [("fault", 1), ("fault", 3), ("clear", 1), ("fault", 0),
              ("clear", 3), ("clear", 0)]
    got, want = [], []
    for op, i in script:
        if op == "fault":
            gcheck.catch_error(XidEvent(code=48, device=f"nvidia{i}"))
            tcheck.catch_error(TpuEvent(code=48, device=f"accel{i}"))
        else:
            gcheck.clear_device(f"nvidia{i}")
            tcheck.clear_device(f"accel{i}")
        apply(gpu)
        apply(tpu)
        got.append(health_vector(gpu))
        want.append(health_vector(tpu))
    assert got == want
    assert got[1] == [HEALTHY, UNHEALTHY, HEALTHY, UNHEALTHY]


# ---- through the gRPC service ------------------------------------------------


class Served:
    def __init__(self, tmp_path, manager):
        self.manager = manager
        self.plugdir = str(tmp_path / "p")
        os.makedirs(self.plugdir)
        self.stub = KubeletStub(os.path.join(self.plugdir, api.KUBELET_SOCKET))

    def __enter__(self):
        self.stub.start()
        self.manager.start()
        self.thread = threading.Thread(
            target=self.manager.serve, args=(self.plugdir,),
            kwargs={"plugin_endpoint": "gpu.sock"}, daemon=True)
        self.thread.start()
        self.stub.requests.get(timeout=10)
        self.channel = grpc.insecure_channel(
            f"unix:{os.path.join(self.plugdir, 'gpu.sock')}")
        self.client = api.DevicePluginClient(self.channel)
        return self

    def __exit__(self, *exc):
        self.channel.close()
        self.manager.stop()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        self.stub.stop()

    def allocate(self, ids):
        req = pb.AllocateRequest()
        req.container_requests.add().devicesIDs.extend(ids)
        return self.client.allocate(req, timeout=5).container_responses[0]


def test_list_and_watch_and_allocate_partitions(tmp_path):
    root = str(tmp_path / "root")
    with Served(tmp_path, mig_manager(root, "3g.40gb")) as s:
        stream = s.client.list_and_watch(pb.Empty(), timeout=20)
        first = {d.ID: d.health for d in next(stream).devices}
        cresp = s.allocate(["nvidia0/gi2"])
        s.manager.health_events.put(type(s.manager.devices["nvidia0"])(
            id="nvidia0", health=UNHEALTHY))
        second = {d.ID: d.health for d in next(stream).devices}
        with pytest.raises(grpc.RpcError) as e:
            s.allocate(["nvidia0/gi1"])
    assert first == {f"nvidia{m}/gi{g}": HEALTHY for m in (0, 1)
                     for g in (1, 2)}
    assert [d.host_path for d in cresp.devices] == [
        os.path.join(root, "dev", "nvidia0"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(0, 2)}"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(0, 2, 0)}")] + [
        os.path.join(root, "dev", n) for n in (
            "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset")]
    assert dict(cresp.envs) == {}
    assert second == dict(first, **{"nvidia0/gi1": UNHEALTHY,
                                    "nvidia0/gi2": UNHEALTHY})
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_time_sharing_on_partitions(tmp_path):
    root = str(tmp_path / "root")
    manager = mig_manager(root, "4g.40gb", num_gpus=1, extra={
        "GPUSharingConfig": {"GPUSharingStrategy": "time-sharing",
                             "MaxSharedClientsPerGPU": 2}})
    with Served(tmp_path, manager) as s:
        ids = {d.ID for d in next(s.client.list_and_watch(
            pb.Empty(), timeout=20)).devices}
        cresp = s.allocate(["nvidia0/gi0/vgpu1"])
    assert ids == {"nvidia0/gi0/vgpu0", "nvidia0/gi0/vgpu1"}
    assert [d.host_path for d in cresp.devices][:3] == [
        os.path.join(root, "dev", "nvidia0"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(0, 0)}"),
        os.path.join(root, "dev", "nvidia-caps",
                     f"nvidia-cap{cap_minor(0, 0, 0)}")]
