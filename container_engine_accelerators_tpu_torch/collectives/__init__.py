"""The collectives rig of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/collectives/``: the NCCL bandwidth
sweep (``bench.py``, nccl-tests' loop and accounting) and the
topology-aware schedule engine over the emulated fleet (``topo.py``,
``synth.py``, ``search.py``, ``runner.py``; host code, no torch).
Names resolve lazily, so ``python -m ...collectives.bench`` runs the
module once and importing the engine loads no torch.
"""

__all__ = ["CollectiveResult", "run_sweep"]


def __getattr__(name):
    if name in __all__:
        from container_engine_accelerators_tpu_torch.collectives import bench

        return getattr(bench, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
