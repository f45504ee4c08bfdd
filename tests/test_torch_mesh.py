"""The PyTorch port's mesh layer (``parallel/mesh.py``, ``parallel/dcn.py``,
``parallel/launch.py``) against the JAX package's ``parallel/``.

The layout rule: for every leaf of the LM's and ResNet-18's flax trees,
the port's spec for the tensor that holds the leaf (its own layout mapped
through ``FLAX_AXES``) equals the JAX ``_param_spec`` /
``_param_spec_fsdp``, for model 1, 2 and 4 and data 1, 2 and 4.  The
JAX LM scans its blocks, so each block leaf carries a leading layer axis
that the port's per-layer tensors do not; the comparison drops it.  JAX's
rule may put a mesh axis on that layer axis (under fsdp, the data axis on
a stacked norm scale [L, D] once L divides and L >= 2 dp): the port then
keeps that leaf replicated on the axis, and
``test_layer_axis_divergence_is_the_norm_scales`` names those leaves.

The process group: ``resolve_cluster`` returns what the JAX function
returns on its K8s env cases, plus torchrun's variables; ``initialize``
makes a world-size-1 gloo group when a mesh is asked for.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from container_engine_accelerators_tpu.models import lm_train as jlt
from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import dcn as jdcn
from container_engine_accelerators_tpu.parallel import mesh as jmesh
from container_engine_accelerators_tpu_torch.models import resnet as presnet
from container_engine_accelerators_tpu_torch.models.convert import (
    resnet_to_flax,
    to_flax_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu_torch.parallel import dcn
from container_engine_accelerators_tpu_torch.parallel import mesh as pmesh
from container_engine_accelerators_tpu_torch.parallel.launch import (
    stop_agreed,
    wants_mesh,
)
from torch_image_helpers import few_torch_threads  # noqa: F401 (autouse)

LM = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=16, mlp_dim=32,
          num_kv_heads=2)
SIZES = [(d, m) for d in (1, 2, 4) for m in (1, 2, 4)]


def _ids_state(model):
    """Each parameter filled with its own index (1-based), so a flax leaf
    names the port tensor it came from."""
    names = [n for n, _ in model.named_parameters()]
    state = {n: torch.full(t.shape, float(names.index(n) + 1))
             if n in names else t.clone()
             for n, t in model.state_dict().items()}
    return names, state


def _port_specs(model, data, model_size, fsdp):
    """name -> the port's spec of that parameter, over the flax axes."""
    mods = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        module = mods[mod_name]
        out[name] = pmesh.flax_spec(module, leaf, tuple(p.shape), data,
                                    model_size, fsdp)
    return out


def _jax_spec(shape, data, model, fsdp):
    spec = (jmesh._param_spec_fsdp(shape, data, model) if fsdp
            else jmesh._param_spec(shape, model))
    return tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))


def _compare(flax_tree, names, jax_shapes, specs, data, model, fsdp,
             stacked):
    """Assert the port's spec of each leaf equals JAX's; return the leaves
    where JAX shards a stacked layer axis (per-layer tensors cannot)."""
    diverged = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(flax_tree):
        key = jax.tree_util.keystr(path)
        assert leaf.shape == jax_shapes[key], key
        name = names[int(np.asarray(leaf).flat[0]) - 1]
        want = _jax_spec(leaf.shape, data, model, fsdp)
        got = specs[name]
        if stacked(key):
            if want[0] is not None and (data if want[0] == "data"
                                        else model) > 1:
                diverged.append(key)
                want = (None,) + want[1:]
            want = want[1:]
        size = {"data": data, "model": model}
        # An axis over a mesh dimension of size 1 shards nothing.
        norm = [tuple(a if a is not None and size[a] > 1 else None
                      for a in s) for s in (got, want)]
        got_n, want_n = (tuple(s) + (None,) * (len(want) - len(s))
                         for s in norm)
        assert got_n == want_n, (key, name, got, want)
    return diverged


@pytest.fixture(scope="module")
def lm_tree():
    model = jtr.transformer_lm(**LM, use_flash=False)
    state = jlt.create_lm_train_state(model, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))
    return {jax.tree_util.keystr(p): np.shape(x) for p, x in
            jax.tree_util.tree_leaves_with_path(state.params)}


@pytest.mark.parametrize("fsdp", [False, True], ids=["megatron", "fsdp"])
@pytest.mark.parametrize("data,model", SIZES)
def test_lm_spec_rule_equals_jax_on_every_leaf(lm_tree, data, model, fsdp):
    port = TransformerLM(**LM, dtype=torch.float32, device="cpu")
    names, state = _ids_state(port)
    port.load_state_dict(state)
    flax = to_flax_params(port.state_dict())
    specs = _port_specs(port, data, model, fsdp)
    # A stacked leaf's first element names layer 0's tensor; the other
    # layers' have its shape and so its spec.
    diverged = _compare(flax, names, lm_tree, specs, data, model, fsdp,
                        stacked=lambda key: key.startswith("['blocks']"))
    assert diverged == [], diverged


def test_layer_axis_divergence_is_the_norm_scales():
    """At the trainer's 12 layers under fsdp on (2, 2), JAX puts the data
    axis on the layer axis of the stacked norm scales [12, 512] only:
    every other stacked leaf keeps a larger axis to shard."""
    cfg = dict(LM, num_layers=12, num_heads=8, head_dim=64, mlp_dim=2048,
               num_kv_heads=None)
    shapes = {"q": (12, 512, 8, 64), "k": (12, 512, 8, 64),
              "out": (12, 8, 64, 512), "gate": (12, 512, 2048),
              "down": (12, 2048, 512), "scale": (12, 512)}
    on_layer = {k for k, s in shapes.items()
                if _jax_spec(s, 2, 2, True)[0] is not None}
    assert on_layer == {"scale"}
    port = TransformerLM(**cfg, device="meta")
    mods = dict(port.named_modules())
    assert pmesh.flax_spec(mods["blocks.0.ln_attn"], "scale", (512,), 2, 2,
                           True) == ("model",)


def _resnet18():
    return presnet.resnet(18, num_classes=64, num_filters=16,
                          small_inputs=True, dtype=torch.float32)


@pytest.fixture(scope="module")
def resnet_tree():
    model = jresnet(depth=18, num_classes=64, num_filters=16,
                    small_inputs=True)
    state = jtrain.create_train_state(model, jax.random.PRNGKey(0),
                                      jnp.ones((1, 32, 32, 3)))
    return {jax.tree_util.keystr(p): np.shape(x) for p, x in
            jax.tree_util.tree_leaves_with_path(state.params)}


@pytest.mark.parametrize("fsdp", [False, True], ids=["megatron", "fsdp"])
@pytest.mark.parametrize("data,model", SIZES)
def test_resnet18_spec_rule_equals_jax_on_every_leaf(resnet_tree, data,
                                                     model, fsdp):
    port = _resnet18()
    names, state = _ids_state(port)
    port.load_state_dict(state)
    params, _ = resnet_to_flax(port)
    specs = _port_specs(port, data, model, fsdp)
    assert _compare(params, names, resnet_tree, specs, data, model, fsdp,
                    stacked=lambda key: False) == []


def test_conv_and_dense_axes_map_to_the_port_layout():
    """A conv's flax HWIO output axis is the port's OIHW axis 0; a
    dense's flax [in, out] input axis the port's [out, in] axis 1."""
    conv = presnet.Conv(16, 64, (3, 3), device="meta")
    dense = presnet.Dense(512, 10, device="meta")
    assert pmesh.flax_spec(conv, "weight", (64, 16, 3, 3), 1, 2) == (
        None, None, None, "model")
    assert pmesh.flax_axes(conv, "weight", 4) == (3, 2, 0, 1)
    assert pmesh.flax_spec(dense, "weight", (10, 512), 1, 2) == (
        "model", None)
    assert pmesh.flax_axes(dense, "weight", 2) == (1, 0)


@pytest.mark.parametrize("shape,size", [
    ((256, 512), 2), ((512, 512), 4), ((3, 5), 2), ((8,), 8), ((16,), 8),
    ((4, 6, 8), 2), ((), 2)])
def test_largest_divisible_axis_equals_jax(shape, size):
    for taken in ((), (0,)):
        for trailing in (True, False):
            assert pmesh._largest_divisible_axis(
                shape, size, taken, trailing) == \
                jmesh._largest_divisible_axis(shape, size, taken, trailing)


# ---- resolve_cluster / initialize -----------------------------------------

K8S_CASES = [
    {},
    {"TPU_WORKER_COUNT": "4", "TPU_WORKER_ID": "2",
     "TPU_COORDINATOR_ADDR": "host0:9999"},
    {"TPU_WORKER_COUNT": "2", "TPU_WORKER_ID": "0",
     "TPU_COORDINATOR_ADDR": "host0"},
    {"TPU_WORKER_COUNT": "2", "JOB_COMPLETION_INDEX": "1",
     "JOB_NAME": "allreduce"},
    {"NUM_TPU_WORKERS": "3", "JOB_COMPLETION_INDEX": "2",
     "JOB_NAME": "train", "TPU_SERVICE_NAME": "headless"},
    {"TPU_WORKER_COUNT": "1", "TPU_WORKER_ID": "0"},
]


@pytest.mark.parametrize("env", K8S_CASES)
def test_resolve_cluster_equals_jax(env):
    assert dcn.resolve_cluster(env) == jdcn.resolve_cluster(env)


@pytest.mark.parametrize("env,match", [
    ({"TPU_WORKER_COUNT": "2"}, "TPU_WORKER_ID"),
    ({"TPU_WORKER_COUNT": "2", "TPU_WORKER_ID": "5"}, "outside"),
    ({"TPU_WORKER_COUNT": "2", "TPU_WORKER_ID": "0"}, "JOB_NAME"),
])
def test_resolve_cluster_rejects_as_jax(env, match):
    for fn in (dcn.resolve_cluster, jdcn.resolve_cluster):
        with pytest.raises(ValueError, match=match):
            fn(env)


def test_torchrun_variables_win():
    env = {"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1",
           "MASTER_ADDR": "job-0.svc", "MASTER_PORT": "29500",
           "TPU_WORKER_COUNT": "2", "TPU_WORKER_ID": "1"}
    assert dcn.resolve_cluster(env) == ("job-0.svc:29500", 8, 5)
    # One rank under a launcher still asks for a group.
    assert dcn.resolve_cluster({"WORLD_SIZE": "1"}) == (
        "localhost:8476", 1, 0)
    with pytest.raises(ValueError, match="RANK 3 outside"):
        dcn.resolve_cluster({"WORLD_SIZE": "2", "RANK": "3"})


def test_local_device_never_falls_back():
    assert dcn.local_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            dcn.local_device(None, {"LOCAL_RANK": "0"})


def test_initialize_single_process_and_forced_group(monkeypatch):
    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert dcn.initialize(device="cpu") == (1, 0)
    assert not dist.is_initialized()
    try:
        assert dcn.initialize(device="cpu", force=True) == (1, 0)
        assert dist.get_backend() == "gloo"
        # A second call reuses the group.
        assert dcn.initialize(device="cpu", force=True) == (1, 0)
        mesh = pmesh.create_mesh(1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert pmesh.batch_rows(mesh, 6) == (0, 6)
        with pytest.raises(ValueError, match="!= 1 ranks"):
            pmesh.create_mesh(2, 1)
        hybrid = pmesh.create_hybrid_mesh(1, 1, num_slices=1)
        assert hybrid.mesh_dim_names == ("data", "model")
        assert stop_agreed(True, mesh) and not stop_agreed(False, mesh)
    finally:
        dcn.shutdown()
    assert not dist.is_initialized()


def test_wants_mesh(monkeypatch):
    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    assert not wants_mesh(1, "megatron")
    assert wants_mesh(2) and wants_mesh(1, "fsdp")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not wants_mesh(1, "megatron")  # one rank: the plain path
    assert wants_mesh(2) and wants_mesh(1, "fsdp")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert wants_mesh(1, "megatron")


def test_shard_params_on_one_rank_keeps_values(monkeypatch):
    """On a world-size-1 group the DTensor model computes what the plain
    one does, bit for bit (the layouts differ only in name)."""
    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    from container_engine_accelerators_tpu_torch.models.transformer import (
        init_params,
    )

    dcn.initialize(device="cpu", force=True)
    try:
        weights = init_params(TransformerLM(**LM, device="meta"),
                              torch.Generator().manual_seed(0))
        plain = TransformerLM(**LM, dtype=torch.float32, device="cpu")
        plain.load_state_dict(weights)
        sharded = TransformerLM(**LM, dtype=torch.float32, device="cpu")
        sharded.load_state_dict(weights)
        pmesh.shard_params_fsdp(sharded, pmesh.create_mesh(1, 1))
        assert sharded.mesh is not None
        toks = torch.randint(0, 97, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            assert torch.equal(pmesh.full(sharded(toks)), plain(toks))
        assert sum(p.to_local().nbytes for p in sharded.parameters()) == \
            sum(p.nbytes for p in plain.parameters())
        with pytest.raises(ValueError, match="sharded already"):
            pmesh.shard_params(sharded, pmesh.create_mesh(1, 1))
    finally:
        dcn.shutdown()


@pytest.mark.parametrize("count", [2, 4])
def test_token_loader_shards_union_is_the_global_batch(tmp_path, count):
    """Each data-parallel rank reads its own rows (``shard=``); stacked,
    they are the JAX loader's global batch."""
    from container_engine_accelerators_tpu.data import loader as jloader
    from container_engine_accelerators_tpu.data import tokens as jtokens
    from container_engine_accelerators_tpu_torch.data import (
        TokenBatchLoader,
        TokenShardReader,
    )

    rng = np.random.default_rng(2)
    jtokens.write_token_shards(str(tmp_path), [rng.integers(0, 97, n)
                                               for n in (500, 64, 333)])
    ref = jloader.TokenBatchLoader(jtokens.TokenShardReader(str(tmp_path)),
                                   4, 24, vocab_size=97)
    shards = [TokenBatchLoader(TokenShardReader(str(tmp_path)), 4, 24,
                               vocab_size=97, shard=(i, count))
              for i in range(count)]
    for step in (0, 3, 17):
        got = [s.batch_at(step) for s in shards]
        for k, want in enumerate(ref.batch_at(step)):
            assert np.array_equal(np.concatenate([g[k] for g in got]), want)
    with pytest.raises(ValueError, match="invalid"):
        TokenBatchLoader(TokenShardReader(str(tmp_path)), 4, 24,
                         shard=(0, 3))


def test_data_dir_trains_alike_on_a_one_rank_mesh(tmp_path, monkeypatch):
    """``--param-sharding fsdp`` on one rank (the (1, 1) mesh) reads the
    dataset through its shard and trains the plain trainer's losses."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.data import (
        write_token_shards,
    )

    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(1)
    write_token_shards(str(tmp_path), [rng.integers(0, 61, n)
                                       for n in (700, 300)])
    tiny = ["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
            "--mlp-dim", "64", "--vocab-size", "97", "--seq-len", "32",
            "--train-batch-size", "2", "--train-steps", "3", "--data-dir",
            str(tmp_path)]
    plain = train_lm.main(tiny)
    assert train_lm.main(tiny + ["--param-sharding", "fsdp"]) == plain
    assert not dist.is_initialized()


def test_train_resnet_under_a_one_rank_launcher_stays_plain(monkeypatch):
    """``cmd/train_resnet.py`` started by a launcher at one rank
    (``WORLD_SIZE=1``) without ``--model-par`` is the single-device
    trainer: no process group, the plain trainer's losses exactly."""
    from container_engine_accelerators_tpu_torch.cmd import train_resnet

    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    tiny = ["--device", "cpu", "--resnet-depth", "18", "--image-size", "32",
            "--num-classes", "10", "--train-batch-size", "4",
            "--train-steps", "3"]
    plain = train_resnet.main(tiny)
    monkeypatch.setenv("WORLD_SIZE", "1")
    groups = []
    launched = train_resnet.main(
        tiny, on_step=lambda *a: groups.append(dist.is_initialized()))
    assert launched == plain
    assert groups == [False] * 3


def test_moe_lm_under_a_one_rank_launcher_trains(monkeypatch):
    """``torchrun --nproc-per-node 1 ... train_lm --num-experts E`` trains
    the MoE-LM on the single-device path: no process group, the losses
    of a run without the launcher.  With ``--param-sharding fsdp`` it
    takes the (1, 1) mesh, whose one rank computes the plain step's
    operations (the losses bit-equal to plain's), and destroys the group
    it made.  (Several ranks:
    ``tests/test_torch_dist_moe_lm.py``.)"""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    tiny = ["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
            "--mlp-dim", "64", "--vocab-size", "97", "--seq-len", "32",
            "--train-batch-size", "2", "--train-steps", "2",
            "--num-experts", "2"]
    plain = train_lm.main(tiny)
    monkeypatch.setenv("WORLD_SIZE", "1")
    groups = []
    launched = train_lm.main(
        tiny, on_step=lambda *a: groups.append(dist.is_initialized()))
    assert launched == plain
    assert groups == [False] * 2
    groups = []
    meshed = train_lm.main(tiny + ["--param-sharding", "fsdp"],
                           on_step=lambda *a: groups.append(
                               dist.is_initialized()))
    assert groups == [True] * 2
    assert meshed == plain
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv", [["--model-par", "2"], []])
def test_inception_at_one_rank_is_plain_or_wants_ranks(monkeypatch, argv):
    """Inception-v3 at one rank: without ``--model-par`` it is the
    single-device trainer (no process group); ``--model-par 2`` exits for
    want of ranks, with ``train_lm``'s message, before any group is
    joined.  (On a mesh of 2 ranks: ``tests/test_torch_dist_inception.py``.)"""
    from container_engine_accelerators_tpu_torch.cmd import train_resnet
    from container_engine_accelerators_tpu_torch.parallel import dcn

    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    joined = []
    initialize = dcn.initialize
    monkeypatch.setattr(dcn, "initialize", lambda *a, **k: joined.append(
        1) or initialize(*a, **k))
    tiny = ["--device", "cpu", "--model", "inception-v3", "--image-size",
            "35", "--num-classes", "10", "--train-batch-size", "2",
            "--train-steps", "2"] + argv
    if argv:
        with pytest.raises(SystemExit, match="--model-par 2 needs a multiple "
                                             "of 2 ranks .* has 1"):
            train_resnet.main(tiny)
    else:
        groups = []
        losses = train_resnet.main(tiny, on_step=lambda *a: groups.append(
            dist.is_initialized()))
        assert groups == [False] * 2 and len(losses) == 2
        assert all(math.isfinite(x) for x in losses)
    assert joined == [] and not dist.is_initialized()


def test_serving_mesh_only_for_tp_or_several_ranks(monkeypatch):
    """``serve_lm`` takes a mesh only with ``--tp > 1`` (or a launcher of
    several ranks, which must then be ``--tp``): one rank at ``--tp 1``
    serves the plain path, launcher or not, so int8, MoE, speculative and
    prefix-cache servers are never put on DTensor weights there."""
    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    for k in ("WORLD_SIZE", "TPU_WORKER_COUNT", "NUM_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    flags = [["--weights", "int8"], ["--num-experts", "2"],
             ["--speculative", "2"], ["--prefix-cache", "2"], []]
    for world in (None, "1"):
        if world:
            monkeypatch.setenv("WORLD_SIZE", world)
        for extra in flags:
            args = serve_lm.parse_args(["--device", "cpu"] + extra)
            serve_lm.validate_args(args)
            assert serve_lm.serving_mesh(args) is None
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    # With --tp 2, int8, MoE and the prefix cache are taken (as in the
    # JAX server); speculation exits, as it does there.
    for extra in flags[:4]:
        args = serve_lm.parse_args(["--device", "cpu", "--tp", "2"] + extra)
        if extra[0] == "--speculative":
            with pytest.raises(SystemExit, match="mutually exclusive"):
                serve_lm.validate_args(args)
        else:
            serve_lm.validate_args(args)
