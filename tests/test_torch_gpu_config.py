"""The port's node config, sharing rules and device names against the JAX
package's: the same JSON (TPU keys mapped to the reference's GPU keys)
and the same env strings give the same strategy, clients, partition,
errors and critical codes; the same requests (``accelN/vtpuM`` mapped to
``nvidiaN/vgpuM``) give the same virtual IDs and the same refusals; the
same paths (``/dev/accelN`` mapped to ``/dev/nvidiaN``) the same names."""

import json

import pytest

from container_engine_accelerators_tpu import sharing as tpu_sharing
from container_engine_accelerators_tpu.utils import devname as tpu_devname
from container_engine_accelerators_tpu.utils.config import TPUConfig
from container_engine_accelerators_tpu_torch import sharing as gpu_sharing
from container_engine_accelerators_tpu_torch.utils import config as gpu_config
from container_engine_accelerators_tpu_torch.utils import devname as gpu_devname
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig

KEYS = {
    "tpuPartitionSize": "GPUPartitionSize",
    "TPUPartitionSize": "gpuPartitionSize",
    "tpuSharingConfig": "GPUSharingConfig",
    "TPUSharingConfig": "gpuSharingConfig",
    "tpuSharingStrategy": "GPUSharingStrategy",
    "TPUSharingStrategy": "gpuSharingStrategy",
    "maxSharedClientsPerTpu": "MaxSharedClientsPerGPU",
    "MaxSharedClientsPerTPU": "maxSharedClientsPerGpu",
    "maxTimeSharedClientsPerTpu": "MaxTimeSharedClientsPerGPU",
    "MaxTimeSharedClientsPerTPU": "maxTimeSharedClientsPerGpu",
    "healthCriticalCodes": "HealthCriticalXid",
    "HealthCriticalCodes": "healthCriticalXid",
}
# TPU sub-slice sizes -> MIG profiles, valid to valid, invalid to invalid.
PARTITIONS = {"2x2": "1g.10gb", "2x1": "3g.40gb", "3x3": "3g.30gb", "": ""}
STRATEGIES = {"time-sharing": "time-sharing", "core-sharing": "mps",
              "mps": "mps", "bogus": "bogus", "": ""}


def to_gpu(obj):
    out = {}
    for k, v in obj.items():
        key = KEYS[k]
        if isinstance(v, dict):
            v = to_gpu(v)
        elif "PartitionSize" in k:
            v = PARTITIONS[v]
        elif "Strategy" in k:
            v = STRATEGIES[v]
        out[key] = v
    return out


CONFIGS = [
    {},
    {"tpuPartitionSize": "2x2",
     "tpuSharingConfig": {"tpuSharingStrategy": "time-sharing",
                          "maxSharedClientsPerTpu": 4},
     "healthCriticalCodes": [48, 31]},
    {"TPUPartitionSize": "2x1",
     "TPUSharingConfig": {"TPUSharingStrategy": "core-sharing",
                          "MaxSharedClientsPerTPU": 2},
     "HealthCriticalCodes": [79]},
    {"maxTimeSharedClientsPerTpu": 3,
     "tpuSharingConfig": {"tpuSharingStrategy": "core-sharing",
                          "maxSharedClientsPerTpu": 2}},
    {"MaxTimeSharedClientsPerTPU": 5},
    {"tpuSharingConfig": {"tpuSharingStrategy": "time-sharing"}},
    {"tpuSharingConfig": {"tpuSharingStrategy": "core-sharing",
                          "maxSharedClientsPerTpu": 0}},
    {"tpuSharingConfig": {"maxSharedClientsPerTpu": 2}},
    {"tpuPartitionSize": "3x3"},
    {"tpuSharingConfig": {"tpuSharingStrategy": "bogus",
                          "maxSharedClientsPerTpu": 2}},
    {"tpuSharingConfig": {"tpuSharingStrategy": "mps",
                          "maxSharedClientsPerTpu": 2}},
]
STRATEGY_MAP = {"": "", "time-sharing": "time-sharing", "core-sharing": "mps"}


def outcome(cls, obj):
    try:
        cfg = cls.from_json(obj)
        cfg.add_defaults_and_validate()
    except ValueError:
        return "ValueError"
    return cfg


@pytest.mark.parametrize("obj", CONFIGS, ids=lambda o: json.dumps(o)[:60])
def test_config_matches_jax(obj):
    tpu = outcome(TPUConfig, obj)
    gpu = outcome(GPUConfig, to_gpu(obj))
    if tpu == "ValueError":
        assert gpu == "ValueError"
        return
    assert gpu != "ValueError"
    assert gpu.sharing.strategy.value == STRATEGY_MAP[tpu.sharing.strategy.value]
    assert (gpu.sharing.max_shared_clients_per_gpu
            == tpu.sharing.max_shared_clients_per_tpu)
    assert (gpu.max_time_shared_clients_per_gpu
            == tpu.max_time_shared_clients_per_tpu)
    assert gpu.partition_size == PARTITIONS[tpu.partition_size]
    assert gpu.health_critical_xid == tpu.health_critical_codes


@pytest.mark.parametrize("obj", CONFIGS[:3], ids=["empty", "lower", "go"])
def test_config_file_matches_jax(tmp_path, obj):
    tpu_path, gpu_path = tmp_path / "tpu.json", tmp_path / "gpu.json"
    tpu_path.write_text(json.dumps(obj))
    gpu_path.write_text(json.dumps(to_gpu(obj)))
    tpu, gpu = TPUConfig.from_file(str(tpu_path)), GPUConfig.from_file(str(gpu_path))
    assert gpu.health_critical_xid == tpu.health_critical_codes
    assert gpu.sharing.max_shared_clients_per_gpu == (
        tpu.sharing.max_shared_clients_per_tpu)


def test_missing_and_empty_file_give_empty_config(tmp_path):
    assert GPUConfig.from_file(str(tmp_path / "absent.json")) == GPUConfig()
    (tmp_path / "empty.json").write_text("  \n")
    assert GPUConfig.from_file(str(tmp_path / "empty.json")) == GPUConfig()
    assert gpu_config.CONFIG_PATH == "/etc/nvidia/gpu_config.json"


@pytest.mark.parametrize("raw", [None, "", "31,43", " 13 , 79 ", "31,x,43",
                                 "x,y", ",,", "48"])
def test_xid_env_matches_jax(raw):
    file_codes = [48, 63]
    tpu = TPUConfig(health_critical_codes=list(file_codes))
    gpu = GPUConfig(health_critical_xid=list(file_codes))
    tpu.add_health_critical_codes({} if raw is None else {"TPU_ERR_CONFIG": raw})
    gpu.add_health_critical_xid({} if raw is None else {"XID_CONFIG": raw})
    assert gpu.health_critical_xid == tpu.health_critical_codes


def test_xid_env_read_from_process_env(monkeypatch):
    monkeypatch.setenv("XID_CONFIG", "31,13,43")
    cfg = GPUConfig()
    cfg.add_health_critical_xid()
    assert cfg.health_critical_xid == [31, 13, 43]


# ---- sharing -----------------------------------------------------------------


def gpu_id(tpu_id):
    return tpu_id.replace("accel", "nvidia").replace("vtpu", "vgpu")


@pytest.mark.parametrize("device_id", [
    "accel0/vtpu0", "accel12/vtpu345", "accel0", "accel0/vtpu",
    "xaccel0/vtpu1", "accel0/vtpu1/extra", "accel/vtpu1"])
def test_is_virtual_matches_jax(device_id):
    assert (gpu_sharing.is_virtual_device_id(gpu_id(device_id))
            is tpu_sharing.is_virtual_device_id(device_id))


@pytest.mark.parametrize("device_id", ["accel0/vtpu0", "accel3/vtpu17",
                                       "accel0", "foo/vtpu1"])
def test_virtual_to_physical_matches_jax(device_id):
    try:
        want = gpu_id(tpu_sharing.virtual_to_physical_device_id(device_id))
    except ValueError:
        with pytest.raises(ValueError):
            gpu_sharing.virtual_to_physical_device_id(gpu_id(device_id))
        return
    assert gpu_sharing.virtual_to_physical_device_id(gpu_id(device_id)) == want


@pytest.mark.parametrize("n", [0, 1, 3])
def test_virtual_device_ids_match_jax(n):
    assert gpu_sharing.virtual_device_ids("nvidia1", n) == [
        gpu_id(v) for v in tpu_sharing.virtual_device_ids("accel1", n)]


SHARING = [(tpu_sharing.SharingStrategy.TIME_SHARING,
            gpu_sharing.SharingStrategy.TIME_SHARING),
           (tpu_sharing.SharingStrategy.CORE_SHARING,
            gpu_sharing.SharingStrategy.MPS),
           (tpu_sharing.SharingStrategy.UNDEFINED,
            gpu_sharing.SharingStrategy.UNDEFINED),
           (None, None)]
REQUESTS = [["accel0/vtpu1"], ["accel0/vtpu1", "accel0/vtpu2"],
            ["accel0", "accel1"], [], ["accel2"]]


@pytest.mark.parametrize("count", [1, 4])
@pytest.mark.parametrize("ids", REQUESTS, ids=lambda r: "+".join(r) or "none")
@pytest.mark.parametrize("strategies", SHARING, ids=lambda s: str(s[1]))
def test_validate_request_matches_jax(strategies, ids, count):
    tpu_strategy, gpu_strategy = strategies
    try:
        tpu_sharing.validate_request(ids, count, tpu_strategy)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        gpu_sharing.validate_request([gpu_id(i) for i in ids], count,
                                     gpu_strategy)
        got = None
    except ValueError as e:
        got = str(e)
    assert (got is None) == (want is None), (got, want)
    if got is not None:
        assert "nvidia.com/gpu" in got and gpu_strategy.value in got


def test_strategy_parse():
    assert gpu_sharing.SharingStrategy.parse("mps").value == "mps"
    assert (gpu_sharing.SharingStrategy.parse("time-sharing")
            is gpu_sharing.SharingStrategy.TIME_SHARING)
    with pytest.raises(ValueError, match="time-sharing or mps"):
        gpu_sharing.SharingStrategy.parse("core-sharing")


# ---- device names --------------------------------------------------------------


@pytest.mark.parametrize("path", ["/dev/accel0", "/dev/accel15", "/dev/accel",
                                  "accel0", "/dev/accel0x", "/dev/vfio/3",
                                  "/dev/accelctl"])
def test_device_names_match_jax(path):
    gpu_path = path.replace("accel", "nvidia")
    try:
        want = tpu_devname.device_name_from_path(path)
    except ValueError:
        with pytest.raises(ValueError):
            gpu_devname.device_name_from_path(gpu_path)
        return
    got = gpu_devname.device_name_from_path(gpu_path)
    assert got == want.replace("accel", "nvidia")
    assert gpu_devname.device_path_from_name(got) == gpu_path
    assert gpu_devname.device_minor(got) == tpu_devname.device_index(want)


@pytest.mark.parametrize("name", ["nvidiactl", "nvidia-uvm",
                                  "nvidia-uvm-tools", "nvidia-modeset",
                                  "nvidia", "accel0"])
def test_control_nodes_are_not_gpus(name):
    assert not gpu_devname.DEVICE_RE.match(name)
    with pytest.raises(ValueError):
        gpu_devname.device_minor(name)
    with pytest.raises(ValueError):
        gpu_devname.device_path_from_name(name)
