"""Entry point of the PyTorch port — counterpart of ``__graft_entry__.py``:
``entry()``, a forward step of the flagship model, for compile and
launch checks on one card, and ``dryrun_multichip(n)``, the JAX dry
run's sharding regimes over n ranks.

``dryrun_multichip`` runs the regimes of
``__graft_entry__._dryrun_multichip_impl`` in its order and at its
shapes, each in a function of its own (:data:`REGIMES`), each printing
JAX's "dryrun_multichip OK (...)" line from rank 0:

1. ``resnet`` — one ResNet-18 step (CIFAR stem, 64 classes, 16 filters,
   batch 2n of 32x32 ones, labels 0) over an (n/2, 2) mesh ((n, 1) for
   odd n);
2. ``ring`` — one LM step (vocab 128, 1 layer, 4 heads x 8, mlp 32, SGD
   0.1) with the sequence (8n zeros, batch 2) split over n ranks, ring
   attention;
3. ``pipeline`` — one SGD step of 8 stacked ``tanh(h @ w + b)`` layers
   (D 16) through the GPipe schedule over a (pp, n/pp) mesh, pp the
   first of 4, 2, 1 dividing n, 4 microbatches;
4. ``moe_ep`` — one SGD step of a Switch MoE FFN (n experts, mlp 32,
   f32, x [4, 16, 16]) expert-sharded over the model axis of an (n/2, 2)
   mesh ((n, 1) for odd n);
5. ``ulysses`` — regime 2 with Ulysses attention and max(n, 2) heads;
6. ``tp_decode`` — greedy KV-cache generation (6 new tokens after a
   4-token prompt; vocab 128, 1 layer, max(n, 2) heads x 8, mlp 4n) of
   the model sharded over a (1, n) mesh equals the unsharded model's;
7. ``tp_slots`` (JAX's 6b) — the continuous-batching engine over the
   sharded model, a second request joining mid-flight, gives the same
   tokens;
8. ``fsdp`` — one AdamW step (lr 1e-2) of a 2-layer f32 LM (mlp 16n) on
   n rows of 16 tokens: the fsdp step's loss equals the data-parallel
   step's within 1e-4;
9. ``tp_prefix`` (JAX's 8) — a prefix block built by the sharded
   model's prefill, spliced into a fresh cache, continues to the
   unsharded model's tokens, which equal the plain run's.

The JAX run draws its weights and inputs from ``jax.random``; the port
draws them from seeded ``torch.Generator``s by the same laws, and
``inputs`` hands a regime given values instead (the tests pass JAX's).
Inside an n-rank process group every rank calls ``dryrun_multichip``;
otherwise it starts the n ranks itself (``torch.multiprocessing``), one
a GPU or gloo ranks with ``device="cpu"``, each capped at ``threads``
torch threads, and kills them all and raises if they have not finished
within ``timeout`` seconds.
"""

import os
import pickle
import tempfile
import time

import torch

DRYRUN_TIMEOUT_S = 600


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(model, images)`` is the bf16
    ResNet-50 eval forward (f32 logits) and ``example_args`` the model,
    weights from seed 0, with a batch of ones, ``GRAFT_BATCH`` images
    (default 8) of ``GRAFT_IMAGE_SIZE`` pixels (default 224) as
    ``channels_last`` NCHW, on ``device`` (the card unless
    ``device="cpu"``)."""
    from container_engine_accelerators_tpu_torch.models.resnet import (
        init_params,
        resnet,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(device)
    batch = int(os.environ.get("GRAFT_BATCH", "8"))
    image_size = int(os.environ.get("GRAFT_IMAGE_SIZE", "224"))
    model = resnet(depth=50, device=dev)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    model.eval()
    x = torch.ones(batch, 3, image_size, image_size, device=dev).to(
        memory_format=torch.channels_last)

    def forward(model, x):
        with torch.inference_mode():
            return model(x)

    return forward, (model, x)


# ---- the regimes, each on this rank of an n-rank process group --------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _say(line):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK{line}", flush=True)


def _finite(name, x):
    if not torch.isfinite(torch.as_tensor(x)).all():
        raise RuntimeError(f"non-finite {name} {x}")
    return x


def regime_resnet(n, dev, given):
    """Regime 1: one ResNet-18 step over an (n/2, 2) mesh -> its loss."""
    from container_engine_accelerators_tpu_torch.models.resnet import (
        init_params,
        resnet,
    )
    from container_engine_accelerators_tpu_torch.models.train import (
        create_train_state,
        make_sharded_train_step,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    model_par = 2 if n % 2 == 0 else 1
    mesh = create_mesh(data=n // model_par, model=model_par)
    model = resnet(depth=18, num_classes=64, num_filters=16,
                   small_inputs=True, device=dev)
    model.load_state_dict(given.get("params")
                          or init_params(model, _gen(0)))
    batch = 2 * n
    x = torch.ones(batch, 3, 32, 32, device=dev)
    labels = torch.zeros(batch, dtype=torch.long, device=dev)
    step_fn, placed = make_sharded_train_step(mesh, create_train_state(model))
    _, metrics = step_fn(placed, x, labels)
    loss = _finite("loss", float(metrics["loss"]))
    _say(f": mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
         f"batch={batch} loss={loss:.4f}")
    return loss


def _seq_lm_step(n, dev, given, kind, heads):
    """One SGD(0.1) step of the 1-layer LM (vocab 128, ``heads`` x 8, mlp
    32) on a batch of 2 x 8n zeros, the sequence split over n ranks with
    ``kind`` attention -> the loss."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
        make_lm_train_step,
        prepare_seq_parallel_batch,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    mesh = create_mesh(data=n, model=1)
    lm = TransformerLM(vocab_size=128, num_layers=1, num_heads=heads,
                       head_dim=8, mlp_dim=32, seq_parallel=kind,
                       device=dev)
    if "params" in given:
        lm.load_state_dict(given["params"])
    state = create_lm_train_state(
        lm, None if "params" in given else _gen(0),
        torch.optim.SGD(lm.parameters(), lr=0.1))
    step, state = make_lm_train_step(mesh, state, kind)
    toks = torch.zeros(2, 8 * n, dtype=torch.long, device=dev)
    batch = prepare_seq_parallel_batch(toks, kind, n)
    width, rank = 8, dist.get_rank()
    cols = slice(rank * width, (rank + 1) * width)
    _, metrics = step(state, *(x[:, cols].contiguous() for x in batch))
    return _finite("LM loss", float(metrics["loss"]))


def regime_ring(n, dev, given):
    """Regime 2: ring attention over the sequence -> the loss."""
    loss = _seq_lm_step(n, dev, given, "ring", 4)
    _say(f" (ring LM): seq={8 * n} over {n} devices, loss={loss:.4f}")
    return loss


def _tanh_layer(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def regime_pipeline(n, dev, given):
    """Regime 3: one SGD step through the GPipe schedule -> the loss."""
    from container_engine_accelerators_tpu_torch.parallel.pipeline import (
        create_pipeline_mesh,
        make_pipeline_apply,
        place_staged,
        stage_params,
    )

    pp = next(s for s in (4, 2, 1) if n % s == 0)
    dp = n // pp
    mesh = create_pipeline_mesh(pp, dp)
    d_feat, n_layers, mb = 16, 8, 4
    g = _gen(0)
    w = given.get("w", 0.3 * torch.randn(n_layers, d_feat, d_feat,
                                         generator=g))
    b = given.get("b", torch.zeros(n_layers, d_feat))
    # Each microbatch must split over the data axis: batch = mb * dp.
    xb = given.get("x", torch.randn(mb * dp, d_feat, generator=g))
    tgt = given.get("target", torch.randn(mb * dp, d_feat, generator=g))
    staged = place_staged(mesh, stage_params(
        {"w": w.to(dev), "b": b.to(dev)}, pp))
    apply = make_pipeline_apply(_tanh_layer, mesh, mb)
    loss = ((apply(staged, xb.to(dev)) - tgt.to(dev)) ** 2).mean()
    loss.backward()
    with torch.no_grad():
        for p in staged.values():
            _finite("pipeline weights", (p - 0.1 * p.grad.redistribute(
                p.device_mesh, p.placements)).full_tensor())
    loss = _finite("pp loss", loss.item())
    _say(f" (pipeline): {pp} stages x {dp} dp, {n_layers} layers, "
         f"loss={loss:.4f}")
    return loss


def regime_moe_ep(n, dev, given):
    """Regime 4: one SGD step of the expert-sharded MoE FFN -> the
    loss."""
    from torch import nn

    from container_engine_accelerators_tpu_torch.models.transformer import (
        init_params,
    )
    from container_engine_accelerators_tpu_torch.ops.moe import (
        MoEFFN,
        expert_sharding,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    ep_model = 2 if n % 2 == 0 else 1
    mesh = create_mesh(data=n // ep_model, model=ep_model)
    moe = MoEFFN(16, n, 32, torch.float32, lambda *shape, dtype: nn.Parameter(
        torch.empty(*shape, dtype=dtype, device=dev)))
    moe.load_state_dict(given.get("params") or init_params(moe, _gen(8)))
    x = given.get("x", torch.randn(4, 16, 16, generator=_gen(7))).to(dev)
    expert_sharding(mesh, moe)
    out, aux, _ = moe(x)
    loss = (out ** 2).mean() + 0.01 * aux
    loss.backward()
    with torch.no_grad():
        for p in moe.parameters():
            _finite("MoE weights", (p - 0.1 * p.grad.redistribute(
                p.device_mesh, p.placements)).full_tensor())
    loss = _finite("ep loss", loss.item())
    _say(f" (MoE ep): {n} experts sharded over model axis, "
         f"loss={loss:.4f}")
    return loss


def regime_ulysses(n, dev, given):
    """Regime 5: Ulysses attention over the sequence -> the loss."""
    loss = _seq_lm_step(n, dev, given, "ulysses", max(n, 2))
    _say(f" (Ulysses LM): seq={8 * n} all-to-all over {n} devices, "
         f"loss={loss:.4f}")
    return loss


_MAX_NEW = 6


def _decode_models(n, dev, given):
    """Regimes 6-8's decode model (vocab 128, 1 layer, max(n, 2) heads x
    8, mlp 4n), unsharded and sharded over a (1, n) mesh, its 4-token
    prompt, and the unsharded greedy tokens -> (plain, sharded, prompt,
    reference rows)."""
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
        shard_params,
    )

    cfg = dict(vocab_size=128, num_layers=1, num_heads=max(n, 2),
               head_dim=8, mlp_dim=4 * n, decode=True,
               dtype=given.get("dtype", torch.bfloat16))
    params = given.get("params") or init_params(
        TransformerLM(**cfg, device="meta"), _gen(4))
    prompt = given.get("prompt", torch.randint(0, 128, (1, 4),
                                               generator=_gen(3))).to(dev)
    models = []
    for _ in range(2):
        m = TransformerLM(**cfg, device=dev)
        m.load_state_dict(params)
        models.append(m)
    shard_params(models[1], create_mesh(data=1, model=n))
    with torch.inference_mode():
        ref = generate(models[0], prompt, _MAX_NEW)
    return models[0], models[1], prompt, ref


def regime_tp_decode(n, dev, given):
    """Regime 6: the sharded model's greedy tokens -> the token rows."""
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )

    _, tp, prompt, ref = _decode_models(n, dev, given)
    with torch.inference_mode():
        got = generate(tp, prompt, _MAX_NEW)
    if not torch.equal(got, ref):
        raise RuntimeError(f"tp decode diverged from single-device greedy:"
                           f"\ntp={got.tolist()}\nref={ref.tolist()}")
    _say(f" (tp decode): {n}-way tensor parallel KV-cache generation == "
         f"single-device greedy ({_MAX_NEW} new tokens)")
    return got.tolist()


def regime_tp_slots(n, dev, given):
    """Regime 6b: the engine over the sharded model, a request joining
    mid-flight -> (first request's tokens, joiner's tokens)."""
    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )

    plain, tp, prompt, ref = _decode_models(n, dev, given)
    eng = DecodeEngine(tp, max_slots=2, max_len=4 + _MAX_NEW + 2)
    rid = eng.submit(prompt[0].tolist(), _MAX_NEW)
    eng.step()
    rid2 = eng.submit([1, 2], 3)  # joins mid-flight, different depth
    eng.run_until_drained()
    want = ref[0, 4:4 + _MAX_NEW].tolist()
    if eng.result(rid) != want:
        raise RuntimeError(f"tp slots diverged from single-device greedy:"
                           f"\nengine={eng.result(rid)}\nref={want}")
    # The joiner's tokens are pinned too, not only its length.
    with torch.inference_mode():
        ref2 = generate(plain, torch.tensor([[1, 2]], device=dev), 3)
    if eng.result(rid2) != ref2[0, 2:5].tolist():
        raise RuntimeError(f"tp slots mid-flight joiner diverged: "
                           f"{eng.result(rid2)} vs {ref2[0, 2:5].tolist()}")
    _say(f" (tp slots): {n}-way tensor-parallel continuous batching == "
         f"single-device greedy")
    return eng.result(rid), eng.result(rid2)


def regime_fsdp(n, dev, given):
    """Regime 7: one AdamW step under fsdp and under plain data
    parallelism on an (n, 1) mesh -> (dp loss, fsdp loss)."""
    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
        make_lm_train_step,
        next_token_targets,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    mesh = create_mesh(data=n, model=1)
    cfg = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=8,
               mlp_dim=16 * n,
               dtype=torch.float32)  # f32 so the layout check is tight
    toks = given.get("tokens", torch.randint(0, 128, (n, 16),
                                             generator=_gen(5))).to(dev)
    labels, mask = next_token_targets(toks)
    params = given.get("params") or init_params(
        TransformerLM(**cfg, device="meta"), _gen(6))
    losses = []
    for sharding in ("megatron", "fsdp"):
        model = TransformerLM(**cfg, device=dev)
        model.load_state_dict(params)
        # optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8, decay 1e-4.
        state = create_lm_train_state(model, optimizer=torch.optim.AdamW(
            model.parameters(), lr=1e-2, weight_decay=1e-4))
        step, state = make_lm_train_step(mesh, state,
                                         param_sharding=sharding)
        _, metrics = step(state, toks, labels, mask)
        losses.append(float(metrics["loss"]))
    dp_loss, fs_loss = losses
    if not abs(dp_loss - fs_loss) < 1e-4:
        raise RuntimeError(f"fsdp loss {fs_loss} != dp loss {dp_loss}")
    _say(f" (fsdp): params+Adam moments sharded over {n} data ranks, "
         f"loss == dp ({fs_loss:.4f})")
    return dp_loss, fs_loss


def regime_tp_prefix(n, dev, given):
    """Regime 8: a prefix block from the sharded prefill, spliced, and the
    suffix continued -> the spliced rows."""
    from container_engine_accelerators_tpu_torch.models.prefix_cache import (
        PrefixCache,
        generate_with_prefix,
    )

    plain, tp, prompt, ref = _decode_models(n, dev, given)
    suffix = prompt[:, 2:]
    prefix_ids = tuple(prompt[0, :2].tolist())

    def spliced(model):
        kv, plen = PrefixCache(model, max_prefix_len=2).get_or_build(
            prefix_ids)
        with torch.inference_mode():
            return generate_with_prefix(model, kv, plen, suffix, _MAX_NEW)

    ref_pfx, tp_pfx = spliced(plain), spliced(tp)
    n_cmp = suffix.shape[1] + _MAX_NEW
    if not torch.equal(tp_pfx[:, :n_cmp], ref_pfx[:, :n_cmp]):
        raise RuntimeError(f"tp prefix-splice diverged:\n"
                           f"tp={tp_pfx.tolist()}\nref={ref_pfx.tolist()}")
    # And the spliced continuation equals the plain concatenated run.
    if ref_pfx[0, :n_cmp].tolist() != ref[0, 2:2 + n_cmp].tolist():
        raise RuntimeError(f"spliced {ref_pfx.tolist()} vs plain "
                           f"{ref.tolist()}")
    _say(f" (tp prefix): spliced prefix KV + suffix continuation under "
         f"{n}-way tensor parallelism == single-device greedy")
    return tp_pfx[:, :n_cmp].tolist()


REGIMES = {
    "resnet": regime_resnet,
    "ring": regime_ring,
    "pipeline": regime_pipeline,
    "moe_ep": regime_moe_ep,
    "ulysses": regime_ulysses,
    "tp_decode": regime_tp_decode,
    "tp_slots": regime_tp_slots,
    "fsdp": regime_fsdp,
    "tp_prefix": regime_tp_prefix,
}


def _dryrun_rank(n_devices, device, regimes, inputs):
    """The regimes on this rank of an initialized n-rank process group
    -> {name: its value}."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel.dcn import (
        local_device,
    )

    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the process group has "
                           f"{dist.get_world_size()}")
    dev = local_device(device)
    return {name: REGIMES[name](n_devices, dev, inputs.get(name, {}))
            for name in regimes}


def _dryrun_entry(rank, n_devices, tmp, device, regimes, inputs, threads):
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn

    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(tmp, "store"), n_devices)
    dcn.initialize(env={"WORLD_SIZE": str(n_devices), "RANK": str(rank),
                        "LOCAL_RANK": str(rank)},
                   device=device, store=store)
    try:
        out = _dryrun_rank(n_devices, device, regimes, inputs)
        if rank == 0:
            with open(os.path.join(tmp, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dcn.shutdown()


def dryrun_multichip(n_devices: int, device=None, regimes=None, inputs=None,
                     threads=None, timeout=DRYRUN_TIMEOUT_S) -> dict:
    """JAX's dry-run regimes over ``n_devices`` ranks -> {regime name:
    its value} (rank 0's).  ``regimes`` picks names of :data:`REGIMES`
    (default all, in JAX's order); ``inputs`` maps a regime name to the
    values it is given (see each regime).  Inside an n-rank process
    group (torchrun) every rank calls it; otherwise it starts the n ranks
    itself: one a GPU, or gloo ranks with ``device="cpu"``, each running
    ``threads`` torch threads (default: the caller's count), all killed
    and a ``TimeoutError`` raised after ``timeout`` seconds."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    regimes = list(REGIMES if regimes is None else regimes)
    inputs = inputs or {}
    if dist.is_initialized():
        return _dryrun_rank(n_devices, device, regimes, inputs)
    threads = torch.get_num_threads() if threads is None else threads
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _dryrun_entry, args=(n_devices, tmp, device, regimes, inputs,
                                 threads),
            nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip({n_devices}) did "
                                       f"not finish in {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        with open(os.path.join(tmp, "out.pkl"), "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry OK: logits {tuple(out.shape)} {out.dtype}")
