"""Multi-GPU layer of the PyTorch port: the process group from the K8s
or torchrun env (``dcn.py``), the (data, model) ``DeviceMesh`` and the
JAX package's layout rules as DTensor placements (``mesh.py``), what the
trainers share to run on it (``launch.py``), and attention over a
sequence split across the ranks — ring, ring-zigzag and Ulysses — beside
the single-device dense attention of train mode (``seq.py``)."""
from container_engine_accelerators_tpu_torch.parallel import dcn
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    create_hybrid_mesh,
    create_mesh,
    replicated,
    shard_params,
    shard_params_fsdp,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "create_hybrid_mesh",
    "create_mesh",
    "dcn",
    "replicated",
    "shard_params",
    "shard_params_fsdp",
]
