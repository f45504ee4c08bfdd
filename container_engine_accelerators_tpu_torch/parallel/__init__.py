"""Multi-GPU layer of the PyTorch port: the process group from the K8s
or torchrun env and the dcnxferd transfer leg (``dcn.py``), the (data,
model) ``DeviceMesh`` and the JAX package's layout rules as DTensor
placements (``mesh.py``), what the trainers share to run on it
(``launch.py``), attention over a sequence split across the ranks —
ring, ring-zigzag and Ulysses — beside the single-device dense
attention of train mode (``seq.py``), and the DCN transfer plane's
client, lanes and tuner (``dcn_client.py``, ``dcn_shm.py``,
``dcn_pipeline.py``, ``dcn_tune.py``).

Names resolve lazily: the transfer plane is host code that node daemons
import, and ``mesh.py`` imports torch, so importing a ``dcn*`` module
must not load the mesh."""

import importlib

_MESH_NAMES = (
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "create_hybrid_mesh",
    "create_mesh",
    "replicated",
    "shard_params",
    "shard_params_fsdp",
)

__all__ = sorted(_MESH_NAMES + ("dcn",))


def __getattr__(name):
    if name in _MESH_NAMES:
        mesh = importlib.import_module(f"{__name__}.mesh")
        return getattr(mesh, name)
    if name == "dcn":
        return importlib.import_module(f"{__name__}.dcn")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
