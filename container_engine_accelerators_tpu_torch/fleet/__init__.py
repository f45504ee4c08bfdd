"""The fleet layer of the PyTorch port.  Ported so far: ``fleet.xferd``,
PyXferd, the protocol-faithful Python transfer daemon with a real data
plane (per-flow frame sequencing, receiver-side dedup, trace-context
propagation, the shm lanes and the descriptor-ring completer).  Host
code: nothing here imports torch.  The name resolves lazily, so
importing the package loads nothing else.
"""

__all__ = ["PyXferd"]


def __getattr__(name):
    if name in __all__:
        from container_engine_accelerators_tpu_torch.fleet import xferd

        return getattr(xferd, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
