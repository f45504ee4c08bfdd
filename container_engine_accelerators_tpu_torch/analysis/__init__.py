"""Concurrency checks of the port: the stack's ``-race`` analog.

- ``lockwatch`` — the dynamic lock-order race detector, the port's copy
  of the JAX package's: instrumented ``threading.Lock``/``RLock``
  wrappers armed by ``TPU_LOCKWATCH=1`` (no code changes in the modules
  it watches) that build a cross-thread lock-order graph and report
  order cycles and blocking calls made under a lock.  ``python -m
  container_engine_accelerators_tpu_torch.analysis.lockwatch --check
  REPORT`` is its gate.

The name resolves lazily, so ``python -m`` runs the module once.
"""

__all__ = ["lockwatch"]


def __getattr__(name):
    if name == "lockwatch":
        import importlib

        return importlib.import_module(f"{__name__}.lockwatch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
