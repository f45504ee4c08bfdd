"""Serving under chaos: the fleet-facing request frontend of the PyTorch
port — counterpart of ``container_engine_accelerators_tpu/serving/``
(host code: nothing here imports torch).

- ``serving.frontend``  ServingFrontend: bounded admission with load
                        shedding, a max-wait/max-size batch cutter,
                        hedged retries with first-response-wins and
                        exactly-once dedup by request id, and bounded
                        failover, over per-node resilient DCN clients;
- ``serving.breaker``   NodeBreaker: the per-node circuit breaker.

The fleet integration (``workload: serving`` scenarios and the serving
SLOs) lives in ``fleet/controller.py`` and ``fleet/telemetry.py``; run
it with ``python -m container_engine_accelerators_tpu_torch.cmd.
fleet_sim --workload serving``.  Names resolve lazily.
"""

import importlib

_EXPORTS = {
    "NodeBreaker": "breaker",
    "Request": "frontend",
    "RequestShed": "frontend",
    "ServingConfig": "frontend",
    "ServingFrontend": "frontend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
