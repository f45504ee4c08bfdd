"""The collectives rig of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/collectives/``: the NCCL bandwidth
sweep (``bench.py``, nccl-tests' loop and accounting) and, of the
schedule engine, the bus-bandwidth factor it shares (``synth.py``).
The sweep's names resolve lazily, so ``python -m ...collectives.bench``
runs the module once.
"""

__all__ = ["CollectiveResult", "run_sweep"]


def __getattr__(name):
    if name in __all__:
        from container_engine_accelerators_tpu_torch.collectives import bench

        return getattr(bench, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
