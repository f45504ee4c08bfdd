"""What the port's trainers share to run over a mesh: when to take the mesh
path, the mesh itself, and the one decision every rank must agree on.

``cmd/train_lm.py`` and ``cmd/train_resnet.py`` take the mesh path when a
launcher (torchrun, or the K8s env of ``parallel/dcn.py``) started more
than one rank, or when a flag shards the weights (``--model-par > 1``,
``--param-sharding fsdp``, also on one rank: the (1, 1) mesh).  One rank
with neither is the single-device trainer, launcher or not: it computes
what the (1, 1) mesh computes, without DTensor's dispatch.
``cmd/train_lm.py --seq-parallel`` always takes a (world, 1) mesh
(:func:`seq_mesh`), one rank included.
"""

import logging

import torch

log = logging.getLogger(__name__)


def wants_mesh(model_par: int, param_sharding: str = "megatron") -> bool:
    """The mesh path: a launcher started more than one rank, or a flag
    shards the weights."""
    from container_engine_accelerators_tpu_torch.parallel.dcn import (
        resolve_cluster,
    )

    return (model_par > 1 or param_sharding == "fsdp"
            or resolve_cluster()[1] > 1)


def trainer_mesh(device, model_par: int, batch: int):
    """(mesh, rank, this rank's device): the process group joined (a
    world-size-1 one without a launcher) and a (world / model_par,
    model_par) mesh over it, whose data axis must divide ``batch``."""
    from container_engine_accelerators_tpu_torch.parallel import dcn
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_size,
        create_mesh,
    )

    import torch.distributed as dist

    # Checked before any group is joined: the launcher's world size.
    world = (dist.get_world_size() if dist.is_initialized()
             else dcn.resolve_cluster()[1])
    if world % model_par:
        raise SystemExit(f"--model-par {model_par} needs a multiple of "
                         f"{model_par} ranks (one a GPU); the process group "
                         f"has {world}")
    world, rank = dcn.initialize(device=device, force=True)
    mesh = create_mesh(model=model_par)
    dp = axis_size(mesh, DATA_AXIS)
    if batch % dp:
        raise SystemExit(f"--train-batch-size {batch} not divisible by "
                         f"{dp} data-parallel ranks")
    log.info("rank %d/%d, mesh data=%d model=%d", rank, world, dp,
             model_par)
    return mesh, rank, dcn.local_device(device)


def seq_mesh(device, seq_len: int):
    """(mesh, rank, this rank's device) for ``--seq-parallel``: the
    process group joined (a world-size-1 one without a launcher) and a
    (world, 1) mesh whose data axis carries the sequence shards, which
    must divide ``seq_len``."""
    from container_engine_accelerators_tpu_torch.parallel import dcn
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    world, rank = dcn.initialize(device=device, force=True)
    if seq_len % world:
        raise SystemExit(f"--seq-len {seq_len} not divisible by {world} "
                         f"devices")
    log.info("rank %d/%d, mesh data=%d model=1 (sequence shards)", rank,
             world, world)
    return create_mesh(model=1), rank, dcn.local_device(device)


def stop_agreed(stop: bool, mesh) -> bool:
    """Whether to checkpoint and exit after this step: on a mesh of
    several ranks, whether any rank was told to (a save is a collective
    every rank must enter at the same step)."""
    if mesh is None or mesh.size() == 1:
        return stop
    import torch.distributed as dist

    flag = torch.tensor([int(stop)], device=mesh.device_type)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())
