"""The PyTorch port stands alone: no module of
container_engine_accelerators_tpu_torch, and not chip_smoke.py, imports
jax or anything of the JAX package (not even its jax-free modules)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "container_engine_accelerators_tpu_torch"


def _port_modules():
    mods = []
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _run(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    mods = _port_modules()
    slices = {"ops.flash_decode", "cmd.serve_lm", "ops.build",
              "ops.flash_attention", "parallel.seq", "models.train",
              "models.lm_train", "data.tokens", "data.loader",
              "utils.preempt", "cmd.train_lm", "utils.retry", "utils.faults",
              "models.checkpoint", "models.batching", "cmd.trace_summary",
              "models.quant", "models.prefix_cache", "models.speculative",
              "models.resnet", "models.inception", "data.arrays",
              "cmd.train_resnet", "cmd.serve_resnet", "entry",
              "utils.profile", "ops.moe", "utils.devname", "utils.config",
              "sharing.sharing", "gpulib", "gpulib.types", "gpulib.nvml",
              "gpulib.fake", "deviceplugin.deviceplugin_v1beta1_pb2",
              "deviceplugin.api", "deviceplugin.preferred",
              "deviceplugin.manager", "deviceplugin.service",
              "health.health_checker", "metrics.counters",
              "metrics.podresources_v1_pb2", "metrics.devices",
              "metrics.metrics", "cmd.gpu_device_plugin", "sharing.gate",
              "partition", "partition.mig", "scheduler", "scheduler.k8s",
              "scheduler.labeler", "health.maintenance",
              "cmd.partition_gpu", "cmd.maintenance_watcher",
              "parallel", "parallel.dcn", "parallel.mesh",
              "parallel.launch", "cmd.bench_ring", "parallel.pipeline",
              "utils.netio", "nri", "nri.ttrpc_pb2", "nri.nri_v1alpha1_pb2",
              "nri.ttrpc", "nri.mux", "nri.injector", "nri.plugin",
              "cmd.nri_device_injector", "scheduler.quantity",
              "scheduler.topology", "scheduler.daemon",
              "cmd.topology_scheduler", "cmd.label_nodes", "collectives",
              "collectives.synth", "collectives.bench", "obs",
              "obs.trace", "obs.histo", "obs.timeseries", "obs.promtext",
              "obs.flight", "obs.profiler", "obs.critpath", "obs.history",
              "obs.anomaly", "cmd.agent_trace", "cmd.agent_prof",
              "cmd.agent_trend", "cmd.agent_top"}
    assert {f"{PKG}.{m}" for m in slices} <= set(mods)
    code = f"""
import importlib, importlib.util, sys
sys.modules["jax"] = None  # any import of jax -> ImportError
for m in {mods!r}:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "container_engine_accelerators_tpu"
             or m.startswith("container_engine_accelerators_tpu.")
             or m == "flax" or m.startswith("flax."))
assert not bad, bad
print("OK", len({mods!r}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails as well."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_node_layer_imports_without_torch():
    """The node modules (gpulib, deviceplugin, health, metrics, sharing,
    partition, scheduler, nri, obs, the daemons and tools) need no torch:
    a node agent image carries none."""
    node = [m for m in _port_modules()
            if m.split(".")[1:2] in (["gpulib"], ["deviceplugin"],
                                     ["health"], ["metrics"], ["sharing"],
                                     ["partition"], ["scheduler"], ["nri"],
                                     ["obs"])
            or m.endswith((".cmd.gpu_device_plugin", ".cmd.partition_gpu",
                           ".cmd.maintenance_watcher", ".utils.config",
                           ".utils.devname", ".utils.device", ".utils.faults",
                           ".utils.retry", ".utils.netio",
                           ".cmd.nri_device_injector",
                           ".cmd.topology_scheduler", ".cmd.label_nodes",
                           ".cmd.agent_trace", ".cmd.agent_prof",
                           ".cmd.agent_trend", ".cmd.agent_top"))]
    assert len(node) >= 46
    code = f"""
import importlib, sys
sys.modules["torch"] = None
sys.modules["jax"] = None
for m in {node!r}:
    importlib.import_module(m)
print("OK", len({node!r}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
