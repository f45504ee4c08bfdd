"""The port's ResNet roofline tools (``container_engine_accelerators_tpu_
torch/cmd/roofline_{resnet,check}.py``) against the root JAX tools, on
the CPU.

- ``_analytic_bytes``' activation and parameter element counts equal the
  JAX tool's exactly (ResNet-18 and ResNet-50, 32x32, batch 2; the JAX
  side through ``jax.eval_shape``): the same quirk of the reference, only
  the blocks' own convolutions counted (flax's auto-named ``Conv_*``),
  not the stem, the shortcuts or the head.
- The analytic forward FLOPs, 2 x the multiply-adds of every convolution
  and dense layer, are counted the same way on both models and equal;
  ResNet-50's lands within 3% of the published ~4.1 GMACs at 224x224.
- ``roofline_check``'s tensor-core classifier and its verdict on a
  synthetic ``torch.profiler`` trace; both tools' CPU runs and their
  JSON field names; ``--out`` is the only file either writes.
"""

import importlib
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch.cmd import roofline_check as rc
from container_engine_accelerators_tpu_torch.cmd import roofline_resnet as rr
from container_engine_accelerators_tpu_torch.cmd import trace_summary
from torch_image_helpers import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED_RESNET50_GMACS = 4.1  # 224x224, one image
# The JAX package's models/__init__ re-exports the function ``resnet``
# under the module's name.
jresnet = importlib.import_module(
    "container_engine_accelerators_tpu.models.resnet")


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "cmd", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_state(depth, x):
    """The JAX model and a state of abstract leaves (``params``,
    ``batch_stats``), from ``jax.eval_shape`` of its init."""
    model = jresnet.resnet(depth)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    state = type("State", (), {"params": variables["params"],
                               "batch_stats": variables["batch_stats"]})
    return model, state


def _jax_forward_flops(model, state, x):
    """2 x the multiply-adds of every module with a ``kernel`` (every
    convolution and the head), from the captured outputs' shapes and the
    kernels' fan-in (HWI of HWIO, I of a dense [I, O])."""
    def fwd(params, batch_stats, x):
        return model.apply({"params": params, "batch_stats": batch_stats},
                           x, mutable=["batch_stats", "intermediates"],
                           capture_intermediates=True)

    _, mutated = jax.eval_shape(fwd, state.params, state.batch_stats, x)
    flops = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            mutated["intermediates"]):
        keys = [k.key for k in path if hasattr(k, "key")]
        node = state.params
        for k in keys[:-1]:  # the module path, without "__call__"
            node = node.get(k, {}) if hasattr(node, "get") else {}
        if "kernel" in node:
            fan_in = int(np.prod(node["kernel"].shape[:-1]))
            flops += 2 * int(np.prod(leaf.shape)) * fan_in
    return flops


@pytest.fixture(scope="module")
def jax_roofline():
    return _load_jax_tool("roofline_resnet")


@pytest.mark.parametrize("depth", [18, 50])
def test_analytic_counts_equal_jax(depth, jax_roofline):
    x_jax = jnp.zeros((2, 32, 32, 3), jnp.float32)
    model, state = _jax_state(depth, x_jax)
    jax_bytes, jax_act, jax_p = jax_roofline._analytic_bytes(model, state,
                                                             x_jax)
    port = rr.build_state(depth, torch.device("cpu"))
    x = torch.zeros(2, 32, 32, 3).permute(0, 3, 1, 2)
    port_bytes, act, p = rr._analytic_bytes(port.model, x)
    assert (act, p, port_bytes) == (jax_act, jax_p, jax_bytes)
    # The quirk held: the stem, the shortcuts and the head stay out.
    whole = {}

    def grab(module, args, output):
        whole[module] = output.numel()

    hooks = [m.register_forward_hook(grab) for m in port.model.modules()
             if isinstance(m, (type(port.model.conv_init),
                               type(port.model.head)))]
    with torch.inference_mode():
        port.model.eval()(x)
    for h in hooks:
        h.remove()
    assert sum(whole.values()) > act
    left_out = (port.model.conv_init, port.model.head)
    assert sum(whole[m] for m in whole if m not in left_out
               and "conv_proj" not in _name_of(port.model, m)) == act
    fwd_flops, _, _ = rr.analytic_counts(port.model, x)
    assert fwd_flops == _jax_forward_flops(model, state, x_jax)


def _name_of(model, module):
    return next(n for n, m in model.named_modules() if m is module)


def test_resnet50_forward_flops_near_published():
    port = rr.build_state(50, torch.device("cpu"))
    x = torch.zeros(1, 3, 224, 224)
    fwd_flops, act, p = rr.analytic_counts(port.model, x)
    gmacs = fwd_flops / 2e9
    assert abs(gmacs / PUBLISHED_RESNET50_GMACS - 1) <= 0.03, gmacs
    assert p == 25_557_032  # ResNet-50's trainable parameters


def _kernel_event(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


# Kernel names as a traced ResNet-50 step on the H100 shows them.
TC_NAMES = (
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
    "__5x_cudnn",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_on_"
    "kernel__5x_cudnn",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
    "optimized_bf16_256x64_32x4_nhwc_align8>(...)",
    "nvjet_tst_256x128_64x4_1x2_h_ssched_bz_coopA_TNT",
    "void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_64x128_64x4_"
    "nt_align8>(...)",
)
OTHER_NAMES = (
    "void at::native::batch_norm_collect_statistics_channels_last_kernel"
    "<at::native::Var, c10::BFloat16, float, 4>(...)",
    "void at::native::vectorized_elementwise_kernel<8, at::native::"
    "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(...)",
    "void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_"
    "kernel<xmma__5x_cudnn::implicit_gemm::wgrad_indexed::...>(...)",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16>"
    "(...)",
    "void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true>"
    "(...)",
    "void sgemm_largek_lds64<true, false, 5, 5, 4, 4, 4, 34>(...)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x128x8_stage3_"
    "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "Memset (Device)",
)


def test_classifier_and_verdict_on_a_synthetic_trace(tmp_path):
    events = [{"ph": "X", "cat": "user_annotation", "name": f"ProfilerStep#{s}",
               "ts": 1000 * s, "dur": 1000} for s in range(2)]
    ts = 0
    for name in TC_NAMES:  # 5 x 20 us of tensor-core work
        events.append(_kernel_event(name, ts, 20))
        ts += 20
    for name in OTHER_NAMES:  # 8 x 50 us of everything else
        events.append(_kernel_event(name, ts, 50))
        ts += 50
    events[-1]["cat"] = "gpu_memset"
    path = tmp_path / "synthetic.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = trace_summary.summarize(str(path), top=100_000)
    for name in TC_NAMES:
        assert rc.is_tensor_core(name), name
    for name in OTHER_NAMES:
        assert not rc.is_tensor_core(name), name
    tc_ms, other_ms = rc.split_device_time(trace["ops"])
    assert math.isclose(tc_ms, 0.1) and math.isclose(other_ms, 0.4)
    assert rc.verdict_of(10.0, 0.25) == "model-confirmed-headroom"
    assert rc.verdict_of(10.0, 0.8) == "mxu-bound-headroom"
    assert rc.verdict_of(1.2, 0.25) == "model-refuted-near-ceiling"
    # The JAX tool's thresholds.
    jax_src = open(os.path.join(REPO, "cmd", "roofline_check.py")).read()
    assert "ratio < 1.25" in jax_src and "mxu_frac < 0.75" in jax_src
    assert (rc.RATIO_NEAR_CEILING, rc.TENSOR_CORE_DOMINANT) == (1.25, 0.75)


ROOFLINE_RESNET_KEYS = {"batch", "image_size", "flops_per_step_T",
                        "bytes_per_step_G", "bytes_model",
                        "activation_melems", "param_melems", "bound",
                        "arith_intensity", "mfu_ceiling"}
ROOFLINE_CHECK_KEYS = {"metric", "value", "unit", "vs_baseline",
                       "roofline_verdict", "batch", "image_size", "steps",
                       "profiled_steps", "profiled_wall_s",
                       "flops_per_step_T", "model_bytes_G", "t_floor_ms",
                       "t_compute_ms", "t_memory_ms", "device_total_ms",
                       "mxu_ms", "other_ms", "mxu_frac", "top_ops",
                       "final_loss", "peak_source", "nonce"}


def test_jax_key_lists_come_from_the_jax_sources():
    for name, keys in (("roofline_resnet", ROOFLINE_RESNET_KEYS),
                       ("roofline_check", ROOFLINE_CHECK_KEYS)):
        src = open(os.path.join(REPO, "cmd", f"{name}.py")).read()
        for key in keys:
            assert f'"{key}"' in src, (name, key)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_roofline_resnet_cpu_rows(capsys):
    assert rr.main(["--device", "cpu", "--depth", "18", "--batches", "2,4",
                    "--image-size", "32", "--analytic"]) == 0
    rows = _lines(capsys)
    assert [r["batch"] for r in rows] == [2, 4]
    for r in rows:
        assert ROOFLINE_RESNET_KEYS <= set(r)
        assert r["bytes_model"] == "analytic-optimistic"
        assert r["flops_model"].startswith("analytic: 3 x forward")
        assert 0 < r["mfu_ceiling"] <= 1
        assert "mfu" not in r  # no timed steps off the card
    # Activations scale with the batch, parameters do not.
    assert rows[1]["activation_melems"] == pytest.approx(
        2 * rows[0]["activation_melems"], abs=0.01)
    assert rows[0]["param_melems"] == rows[1]["param_melems"]


def test_roofline_check_cpu_run_writes_only_out(capsys, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--batch", "2", "--image-size", "32",
            "--steps", "1", "--profile-steps", "1"]
    assert rc.main(argv) == 0
    assert os.listdir(tmp_path) == []
    (row,) = _lines(capsys)
    assert ROOFLINE_CHECK_KEYS <= set(row)
    assert row["traced_steps"] == 1 and row["mxu_frac"] == 0.0
    assert row["roofline_verdict"] in ("model-confirmed-headroom",
                                       "mxu-bound-headroom",
                                       "model-refuted-near-ceiling")
    out = tmp_path / "sub" / "check.json"
    out.parent.mkdir()
    assert rc.main(argv + ["--out", str(out)]) == 0
    assert json.loads(out.read_text())["metric"] == \
        "roofline_check_resnet50_step_ms"
    assert sorted(os.listdir(tmp_path)) == ["sub"]
