"""Entry point of the PyTorch port — counterpart of ``__graft_entry__.py``:
``entry()``, a forward step of the flagship model, for compile and
launch checks on one card, and ``dryrun_multichip(n)``, one sharded
train step over n ranks.

``dryrun_multichip`` ports the first sharding regime of
``__graft_entry__._dryrun_multichip_impl``: one ResNet-18 step with the
CIFAR stem (64 classes, 16 filters, batch 2n of 32x32 ones, labels 0)
over an (n/2, 2) mesh (n odd: (n, 1)).  Its other regimes (ring
attention, pipeline, the tp decode) come with the next multi-GPU slice.
"""

import os
import pickle
import tempfile

import torch


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


def _dryrun_rank(n_devices: int, device=None, params=None) -> float:
    """Regime 1 on this rank of an initialized n-rank process group;
    returns the step's (global) loss."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.models.resnet import (
        init_params,
        resnet,
    )
    from container_engine_accelerators_tpu_torch.models.train import (
        create_train_state,
        make_sharded_train_step,
    )
    from container_engine_accelerators_tpu_torch.parallel.dcn import (
        local_device,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the process group has "
                           f"{dist.get_world_size()}")
    model_par = 2 if n_devices % 2 == 0 else 1
    mesh = create_mesh(data=n_devices // model_par, model=model_par)
    dev = local_device(device)
    model = resnet(depth=18, num_classes=64, num_filters=16,
                   small_inputs=True, device=dev)
    model.load_state_dict(params if params is not None else
                          init_params(model, torch.Generator().manual_seed(0)))
    batch = 2 * n_devices
    x = torch.ones(batch, 3, 32, 32, device=dev)
    labels = torch.zeros(batch, dtype=torch.long, device=dev)
    step_fn, placed = make_sharded_train_step(mesh, create_train_state(model))
    _, metrics = step_fn(placed, x, labels)
    loss = float(metrics["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"non-finite loss {loss}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"batch={batch} loss={loss:.4f}", flush=True)
    return loss


def _dryrun_entry(rank, n_devices, tmp, device, params):
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn

    store = dist.FileStore(os.path.join(tmp, "store"), n_devices)
    dcn.initialize(env={"WORLD_SIZE": str(n_devices), "RANK": str(rank),
                        "LOCAL_RANK": str(rank)},
                   device=device, store=store)
    try:
        loss = _dryrun_rank(n_devices, device, params)
        if rank == 0:
            with open(os.path.join(tmp, "loss.pkl"), "wb") as f:
                pickle.dump(loss, f)
    finally:
        dcn.shutdown()


def dryrun_multichip(n_devices: int, device=None, params=None) -> float:
    """One sharded ResNet-18 train step over ``n_devices`` ranks (regime
    1 of the JAX dry run); returns its loss.  Inside an n-rank process
    group (torchrun) every rank calls it; otherwise it starts the n
    ranks itself (``torch.multiprocessing``): one a GPU, or gloo ranks
    with ``device="cpu"``.  ``params`` (a ResNet-18 state dict) replaces
    the seed-0 weights."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    if dist.is_initialized():
        return _dryrun_rank(n_devices, device, params)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_entry,
                           args=(n_devices, tmp, device, params),
                           nprocs=n_devices, join=True, start_method="spawn")
        with open(os.path.join(tmp, "loss.pkl"), "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry OK: logits {tuple(out.shape)} {out.dtype}")
