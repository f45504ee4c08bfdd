"""Concurrency and invariant checks of the port: the stack's ``-race``
analog and its lint gate.

- ``lockwatch`` — the dynamic lock-order race detector, the port's copy
  of the JAX package's: instrumented ``threading.Lock``/``RLock``
  wrappers armed by ``TPU_LOCKWATCH=1`` (no code changes in the modules
  it watches) that build a cross-thread lock-order graph and report
  order cycles and blocking calls made under a lock.  ``python -m
  container_engine_accelerators_tpu_torch.analysis.lockwatch --check
  REPORT`` is its gate.
- ``lint`` — the AST invariant engine, the port's copy of the JAX
  package's (stdlib only): hardened sends only (``utils/netio``),
  injectable clocks in clock-sensitive modules, no bare or broad
  swallowed excepts, an explicit ``daemon=`` on every thread, no
  fire-and-forget non-daemon spawns, and no counter, gauge, histogram,
  series or span name missing from the README.  ``python -m
  container_engine_accelerators_tpu_torch.cmd.agent_lint`` gates on
  zero findings; an inline ``# lint: disable=<rule>`` must name its
  rule.

The names resolve lazily, so ``python -m`` runs a module once.
"""

__all__ = ["lint", "lockwatch"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
