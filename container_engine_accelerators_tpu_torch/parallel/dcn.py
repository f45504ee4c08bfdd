"""Multi-process start-up inside Kubernetes — PyTorch counterpart of
``container_engine_accelerators_tpu/parallel/dcn.py`` (its
``resolve_cluster`` and ``initialize``; the dcnxferd client stays in the
JAX package).

JAX runs one process per host and sees every chip of it.  PyTorch runs
one process per GPU, each a rank of one ``torch.distributed`` group:
``initialize`` calls ``init_process_group`` (NCCL on the card, gloo on
the CPU) and pins the process to ``cuda:<LOCAL_RANK>``.

Env contract, read in this order:

- torchrun (several GPUs a pod, or a bare host): ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Its
  presence makes :func:`initialize` create a group even at
  ``WORLD_SIZE=1``; the trainers and the server call it only when they
  take a mesh (``parallel/launch.py``).
- the K8s indexed Job of the JAX package (one process a pod):
  ``TPU_WORKER_COUNT`` (or ``NUM_TPU_WORKERS``), ``TPU_WORKER_ID`` (or
  ``JOB_COMPLETION_INDEX``) and ``TPU_COORDINATOR_ADDR``, which when
  unset is ``<JOB_NAME>-0.<TPU_SERVICE_NAME>:8476``, pod 0 of the Job's
  headless Service.
"""

import logging
import os
from typing import Optional, Tuple

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476

# Whether this module created the process group (and so destroys it).
_OWNED = False


def resolve_cluster(env=None) -> Tuple[Optional[str], int, int]:
    """Return (coordinator ``host:port``, number of processes, this
    process's rank) from the env: (None, 1, 0) for a single process no
    launcher described."""
    env = env if env is not None else os.environ
    if "WORLD_SIZE" in env:
        num, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
        if not 0 <= rank < num:
            raise ValueError(f"RANK {rank} outside [0, {num})")
        host = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", str(DEFAULT_COORDINATOR_PORT))
        return f"{host}:{port}", num, rank
    num = int(env.get("TPU_WORKER_COUNT", env.get("NUM_TPU_WORKERS", "1")))
    if num <= 1:
        return None, 1, 0
    pid_raw = env.get("TPU_WORKER_ID", env.get("JOB_COMPLETION_INDEX"))
    if pid_raw is None:
        raise ValueError(
            "TPU_WORKER_COUNT > 1 but neither TPU_WORKER_ID nor "
            "JOB_COMPLETION_INDEX is set")
    process_id = int(pid_raw)
    if not 0 <= process_id < num:
        raise ValueError(f"process id {process_id} outside [0, {num})")
    addr = env.get("TPU_COORDINATOR_ADDR")
    if not addr:
        job = env.get("JOB_NAME")
        service = env.get("TPU_SERVICE_NAME", job)
        if not job:
            raise ValueError(
                "multi-host run needs TPU_COORDINATOR_ADDR or JOB_NAME to "
                "derive the coordinator from headless-service DNS")
        # Indexed Jobs give pod 0 the stable DNS name <job>-0.<service>.
        addr = f"{job}-0.{service}:{DEFAULT_COORDINATOR_PORT}"
    elif ":" not in addr:
        addr = f"{addr}:{DEFAULT_COORDINATOR_PORT}"
    return addr, num, process_id


def local_device(device=None, env=None) -> "torch.device":  # noqa: F821
    """This rank's device: ``cpu`` when asked for, else
    ``cuda:<LOCAL_RANK>``.  A rank that finds no GPU exits with a
    message; it never falls back to the CPU."""
    import torch

    env = env if env is not None else os.environ
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(env.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise SystemExit(
            f"rank needs cuda:{local} but "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" GPU(s) are visible; pass --device cpu to run on the CPU")
    return torch.device("cuda", local)


def initialize(env=None, device=None, force: bool = False,
               store=None) -> Tuple[int, int]:
    """Join (or create) the default process group from the env contract;
    return (world size, rank).

    Without a launcher's env (one process), nothing happens and (1, 0)
    returns, unless ``force``: a mesh was asked for, so a world-size-1
    group is made (an in-process store, nothing to dial).  ``device`` is
    ``cpu`` for gloo, else the rank's GPU for NCCL.  ``store`` (tests:
    a ``FileStore``) replaces the TCP rendezvous.  A group that already
    exists is reused."""
    import torch.distributed as dist

    global _OWNED
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    addr, num, rank = resolve_cluster(env)
    if addr is None and not force and store is None:
        return 1, 0
    dev = local_device(device, env)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, world_size=num, rank=rank)
    if store is not None:
        kwargs["store"] = store
    elif num == 1:
        # No peer to meet: nothing to dial or listen on.
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = f"tcp://{addr}"
    log.info("init_process_group(%s, world_size=%d, rank=%d, %s)", backend,
             num, rank, "in-process store" if num == 1 else addr)
    dist.init_process_group(**kwargs)
    _OWNED = True
    return num, rank


def shutdown() -> None:
    """Destroy the process group if :func:`initialize` created it."""
    import torch.distributed as dist

    global _OWNED
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False
