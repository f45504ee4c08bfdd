"""Rank workers for the PyTorch port's multi-rank tests, run under gloo
on the CPU.  No jax here: a spawned child re-imports its function's
module, so the JAX references are computed in the parent and handed in
as numpy.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(rendezvous through a ``FileStore`` in a new directory of its own under
the test's, so no port and no store file is shared between spawns),
runs ``fn(rank, world, *args)`` in each, joins them all within a time
limit and returns each rank's return value.  Every worker destroys its
process group before it returns.

Gloo's ranks meet over TCP on 127.0.0.1: each listens on an ephemeral
port, and a connection from another process to that port during the
full-mesh connect (another test's client dialling a port it picked, or
one whose server is gone) breaks the group with "Gloo connectFullMesh
failed ... Connection closed by peer".  Under the suite's parallel
workers that happens now and then, to no fault of the code under test,
so :func:`rendezvous_retried` runs such a spawn again, at most
``SPAWN_ATTEMPTS`` times; any other failure, or the same one on the last
attempt, is raised.
"""

import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

TORCH_THREADS = 1
SPAWN_TIMEOUT_S = 600  # a hung collective fails the test, not the run
SPAWN_ATTEMPTS = 3
RENDEZVOUS_BROKEN = "Gloo connectFullMesh failed"


def _entry(rank, world, tmp, fn, args):
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn

    torch.set_num_threads(TORCH_THREADS)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dcn.initialize(env={"WORLD_SIZE": str(world), "RANK": str(rank)},
                   device="cpu", store=store)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dcn.shutdown()


def rendezvous_retried(start, *args, **kwargs):
    """``start(*args, **kwargs)``, a call that spawns gloo ranks, made
    again when a rank failed because a stray connection broke the group's
    rendezvous (see the module docstring)."""
    for attempt in range(1, SPAWN_ATTEMPTS + 1):
        try:
            return start(*args, **kwargs)
        except mp.ProcessRaisedException as e:
            if RENDEZVOUS_BROKEN not in str(e) or attempt == SPAWN_ATTEMPTS:
                raise
            print(f"{getattr(start, '__name__', start)}: gloo rendezvous "
                  f"broken on attempt {attempt}; starting the ranks again",
                  file=sys.stderr, flush=True)


def spawn(fn, world, tmp, *args, timeout=SPAWN_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; return the
    list of their results (picklable values).  Ranks still running after
    ``timeout`` seconds are killed and the call raises ``TimeoutError``.
    A rendezvous broken by a stray connection starts the ranks again."""
    return rendezvous_retried(_spawn_once, fn, world, tmp, *args,
                              timeout=timeout)


def _spawn_once(fn, world, tmp, *args, timeout):
    os.makedirs(str(tmp), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="spawn_", dir=str(tmp))
    ctx = mp.start_processes(_entry, args=(world, tmp, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks did not "
                                   f"finish in {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t):
    return t.detach().cpu().numpy()


# ---- LM training ---------------------------------------------------------


def lm_train(rank, world, cfg, params, batches, mesh_shape, shardings,
             lr=3e-4):
    """For each layout of ``shardings``: train the port's f32 LM from
    ``params`` (a port state dict of numpy arrays) on ``batches``
    [(tokens, labels, mask)] over a ``mesh_shape`` mesh, each rank
    feeding its own rows -> {sharding: {"losses", "params" (whole,
    numpy), "local" (local numel of each parameter), "adam_local" (of its
    two AdamW moments), "numel"}}; on 4 ranks also "hybrid": a (2 slices,
    1, 2) hybrid mesh's axis names, batch rows and batch placements."""
    from container_engine_accelerators_tpu_torch.models import lm_train as lt
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh(*mesh_shape)
    start, rows = pm.batch_rows(mesh, batches[0][0].shape[0])
    out = {}
    for sharding in shardings:
        model = TransformerLM(**cfg, dtype=torch.float32, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               params.items()})
        state = lt.create_lm_train_state(model, optimizer=torch.optim.AdamW(
            model.parameters(), lr=lr, weight_decay=0.1))
        step, state = lt.make_lm_train_step(mesh, state,
                                            param_sharding=sharding)
        losses = []
        for batch in batches:
            toks, labels, mask = (torch.from_numpy(np.ascontiguousarray(
                x[start:start + rows])) for x in batch)
            state, m = step(state, *(pm.from_local_batch(x, mesh) for x in
                                     (toks.long(), labels.long(), mask)))
            losses.append(float(m["loss"]))
        names = dict(state.model.named_parameters())
        opt = state.optimizer.state
        out[sharding] = {
            "losses": losses,
            "params": {n: _np(pm.full(p)) for n, p in names.items()},
            "local": {n: p.to_local().numel() for n, p in names.items()},
            "adam_local": {n: [opt[p][k].to_local().numel()
                               for k in ("exp_avg", "exp_avg_sq")]
                           for n, p in names.items()},
            "numel": {n: p.numel() for n, p in names.items()},
        }
    if world == 4:
        hybrid = pm.create_hybrid_mesh(1, 2, num_slices=2)
        out["hybrid"] = {"names": hybrid.mesh_dim_names,
                         "rows": pm.batch_rows(hybrid, 8),
                         "placements": [str(p) for p in
                                        pm.batch_sharding(hybrid)]}
    return out


def lm_checkpoints(rank, world, cfg, params, batches, save_after,
                   restore_from, save_to):
    """Both directions of a layout-free checkpoint on 2 ranks: restore
    the newest step under ``restore_from`` (a single-device save) onto a
    (1, 2) mesh under megatron and train the rest of ``batches``; then,
    from ``params``, train ``save_after`` steps on a (2, 1) mesh under
    fsdp and save under ``save_to`` -> (resumed losses, losses before the
    save)."""
    from container_engine_accelerators_tpu_torch.models import lm_train as lt
    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        TrainCheckpointer,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    def run(mesh_shape, sharding, todo, restore=None, save=None):
        model = TransformerLM(**cfg, dtype=torch.float32, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               params.items()})
        step, state = lt.make_lm_train_step(
            pm.create_mesh(*mesh_shape), lt.create_lm_train_state(model),
            param_sharding=sharding)
        if restore is not None:
            state, restored = TrainCheckpointer(restore).restore_latest(state)
            assert restored == save_after, restored
        losses = []
        for toks, labels, mask in todo:
            state, m = step(state, torch.from_numpy(toks).long(),
                            torch.from_numpy(labels).long(),
                            torch.from_numpy(mask))
            losses.append(float(m["loss"]))
        if save is not None:
            TrainCheckpointer(save).save(state)
        return losses

    return (run((1, 2), "megatron", batches[save_after:],
                restore=restore_from),
            run((2, 1), "fsdp", batches[:save_after], save=save_to))


# ---- ResNet --------------------------------------------------------------


def resnet_step(rank, world, kw, state_dict, batches, mesh_shape, tx):
    """The sharded ResNet-18 step in f64 from ``state_dict`` (numpy) with
    ``cosine_sgd(**tx)``, on ``batches`` [(images NHWC, labels)] ->
    {"losses", "accuracy", "state" (whole parameters and BatchNorm
    statistics), "momentum" (whole, by parameter name)}, numpy."""
    from container_engine_accelerators_tpu_torch.models.resnet import resnet
    from container_engine_accelerators_tpu_torch.models.train import (
        cosine_sgd,
        create_train_state,
        make_sharded_train_step,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh(*mesh_shape)
    model = resnet(18, dtype=torch.float64, device="cpu", **kw).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict.items()})
    step, state = make_sharded_train_step(
        mesh, create_train_state(model, None, cosine_sgd(**tx)))
    start, rows = pm.batch_rows(mesh, batches[0][0].shape[0])
    losses, accuracy = [], []
    for x, y in batches:
        x = torch.from_numpy(x[start:start + rows]).double().permute(
            0, 3, 1, 2)
        y = torch.from_numpy(y[start:start + rows]).long()
        state, m = step(state, pm.from_local_batch(x, mesh),
                        pm.from_local_batch(y, mesh))
        losses.append(float(m["loss"]))
        accuracy.append(float(m["accuracy"]))
    params = dict(state.model.named_parameters())
    return {"losses": losses, "accuracy": accuracy,
            "state": {n: _np(pm.full(t))
                      for n, t in state.model.state_dict().items()},
            "momentum": {n: _np(pm.full(
                state.optimizer.state[p]["momentum_buffer"]))
                for n, p in params.items()}}


# ---- serving ---------------------------------------------------------------


def _f32_models():
    """Build every ``TransformerLM`` of this process in f32 unless told
    otherwise: the server's models compute in bf16, and f32 is what
    greedy tokens are held to JAX's in."""
    from container_engine_accelerators_tpu_torch.models import transformer

    init = transformer.TransformerLM.__init__

    def f32_init(self, *args, **kw):
        kw.setdefault("dtype", torch.float32)
        init(self, *args, **kw)

    transformer.TransformerLM.__init__ = f32_init


def tp_generate(rank, world, cfg, params, prompts, n_new):
    """Greedy f32 tokens of the TP-sharded decode model on a (1, world)
    mesh through ``generate`` (each prompt padded to its serving bucket)
    -> (token rows, KV heads this rank's cache holds)."""
    from container_engine_accelerators_tpu_torch.models.batching import (
        bucket_len,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
        init_cache,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh(1, world)
    model = TransformerLM(**cfg, dtype=torch.float32, decode=True,
                          device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           params.items()})
    pm.shard_params(model, mesh)
    heads = init_cache(model, 1, 4)["cached_key"].shape[3]
    rows = []
    with torch.inference_mode():
        for p in prompts:
            bucket = bucket_len(len(p), 16)
            out = generate(model, torch.tensor([p + [0] * (bucket - len(p))]),
                           n_new, prompt_len=len(p))
            rows.append(out[0, :len(p) + n_new].tolist())
    return rows, heads


def tp_serve(rank, world, configs):
    """``cmd/serve_lm.py`` on ``world`` ranks, once for each ``(argv,
    sequential, concurrent)`` of ``configs`` (``argv`` with ``--tp
    world``), its models in f32: rank 0 serves HTTP on an ephemeral port
    and posts the ``sequential`` bodies one by one, then the
    ``concurrent`` ones at once, and returns their tokens; the other
    ranks follow.  Each rank also returns its cache's KV heads."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from container_engine_accelerators_tpu_torch.cmd import serve_lm
    from container_engine_accelerators_tpu_torch.models.generate import (
        init_cache,
    )

    _f32_models()
    results = []
    for argv, sequential, concurrent in configs:
        args = serve_lm.parse_args(argv)
        serve_lm.validate_args(args)
        run = serve_lm.build_generate(args, serve_lm.serving_mesh(args))
        kv_heads = init_cache(run.model, 1, 1)["cached_key"].shape[3]
        engine_loop = serve_lm.start_engine(run, args)
        if rank:
            serve_lm.follow(run, engine_loop)
            results.append({"kv_heads": kv_heads})
            continue
        server = ThreadingHTTPServer(
            ("127.0.0.1", 0), serve_lm.make_handler(run, args, engine_loop))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        try:
            seq = [post(b)["tokens"] for b in sequential]
            conc = [None] * len(concurrent)

            def one(i, body):
                conc[i] = post(body)["tokens"]

            threads = [threading.Thread(target=one, args=(i, b))
                       for i, b in enumerate(concurrent)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            results.append({"sequential": seq, "concurrent": conc,
                            "kv_heads": kv_heads})
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
            serve_lm.stop_followers(run, engine_loop)
    return results


# ---- the command-line trainers ---------------------------------------------


def trainers(rank, world, lm_argv, resnet_argv):
    """``cmd/train_lm.py`` and ``cmd/train_resnet.py``'s ``main`` on every
    rank, under the launcher env torchrun would set -> (LM losses, ResNet
    losses)."""
    import os

    from container_engine_accelerators_tpu_torch.cmd import (
        train_lm,
        train_resnet,
    )

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    return train_lm.main(lm_argv), train_resnet.main(resnet_argv)


# ---- sequence parallelism ----------------------------------------------------


def _columns(x, rank, world):
    """This rank's sequence shard (axis 1) of a global numpy array."""
    width = x.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(
        x[:, rank * width:(rank + 1) * width]))


def seq_attention(rank, world, cases):
    """Each case ``(kind, layout, causal, q, k, v, do)`` — global numpy
    arrays, the sequence in storage order (zigzag for layout "zigzag") —
    through the port's ``make_sequence_parallel_attention`` over a
    (world, 1) mesh on this rank's shards, ``do`` the output gradient ->
    per case the shards' (o, dq, dk, dv), or the message of the
    ``ValueError`` it raised."""
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm
    from container_engine_accelerators_tpu_torch.parallel import seq

    mesh = pm.create_mesh(world, 1)
    out = []
    for kind, layout, causal, q, k, v, do in cases:
        fn = seq.make_sequence_parallel_attention(mesh, kind, causal,
                                                  layout=layout)
        q, k, v = (_columns(x, rank, world).requires_grad_()
                   for x in (q, k, v))
        try:
            o = fn(q, k, v)
        except ValueError as e:
            out.append(str(e))
            continue
        o.backward(_columns(do, rank, world))
        out.append(tuple(_np(t) for t in (o, q.grad, k.grad, v.grad)))
    return out


def lm_seq_step(rank, world, configs, lr=3e-4):
    """For each ``(name, cfg, seq_parallel, params, batches)`` of
    ``configs``: the port's f32 LM built with ``seq_parallel`` from
    ``params`` (a port state dict of numpy arrays), trained by
    ``make_lm_train_step`` on a (world, 1) mesh over ``batches`` — whole
    (tokens, labels, mask) in the scheme's storage order, of which each
    rank feeds its columns -> {name: {"losses", "params" (numpy)}, and
    "refused": the messages of the step's refusals that need a mesh}."""
    from container_engine_accelerators_tpu_torch.models import lm_train as lt
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh(world, 1)
    out = {}
    for name, cfg, kind, params, batches in configs:
        model = TransformerLM(**cfg, dtype=torch.float32, seq_parallel=kind,
                              device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               params.items()})
        state = lt.create_lm_train_state(model, optimizer=torch.optim.AdamW(
            model.parameters(), lr=lr, weight_decay=0.1))
        step, state = lt.make_lm_train_step(mesh, state, kind)
        losses = []
        for toks, labels, mask in batches:
            state, m = step(state, _columns(toks, rank, world).long(),
                            _columns(labels, rank, world).long(),
                            _columns(mask, rank, world))
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses,
                     "params": {n: _np(p) for n, p in
                                state.model.named_parameters()}}
    # The step's refusals that need a mesh: a model axis, and a model
    # built for another scheme.
    refused = []
    for shape, built in (((world // 2, 2), "ring"), ((world, 1), "ulysses")):
        model = TransformerLM(**configs[0][1], dtype=torch.float32,
                              seq_parallel=built, device="cpu")
        try:
            lt.make_lm_train_step(pm.create_mesh(*shape),
                                  lt.create_lm_train_state(model), "ring")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def lm_trainer_runs(rank, world, argvs):
    """``cmd/train_lm.py``'s ``main`` on every rank for each of ``argvs``
    in turn, under the launcher env torchrun would set -> each run's
    losses."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    return [train_lm.main(argv) for argv in argvs]


def bench_ring_line(rank, world, argv):
    """``cmd/bench_ring.py``'s ``main(argv)`` on every rank -> what it
    printed on stdout."""
    import contextlib
    import io

    from container_engine_accelerators_tpu_torch.cmd import bench_ring

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_ring.main(argv) == 0
    return out.getvalue()
