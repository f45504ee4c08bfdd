"""The fleet layer of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/fleet/``: N emulated GPU nodes,
link-level faults and fleet observability (host code: nothing here
imports torch).

- ``fleet.topology``   NodeSpec / FleetTopology: hosts and racks with
                       the scheduler's DCN labels, so link tiers come
                       from the production distance function;
- ``fleet.links``      the link table every inter-node DCN frame routes
                       through, and its fault grammar (partition / heal
                       / latency / drop);
- ``fleet.xferd``      PyXferd, the protocol-faithful transfer daemon;
- ``fleet.node``       EmulatedNode: GpuManager + health checker +
                       PyXferd + resilient client (+ MetricServer);
- ``fleet.proc``       process mode: each node its own OS process, real
                       SIGKILL and supervised respawn;
- ``fleet.telemetry``  windowed goodput per {node, link}, SLOs, scrapes;
- ``fleet.controller`` FleetController: declarative scenarios and the
                       per-node / per-link report;
- ``fleet.soak``       SoakWorld: every workload at once under a seeded
                       fault schedule, judged by invariant sentinels.

Drive it with ``python -m container_engine_accelerators_tpu_torch.cmd.
fleet_sim`` (``cmd.fleet_soak`` for the soak world).  Names resolve lazily, so importing the package loads
nothing else.
"""

import importlib

_EXPORTS = {
    "DEFAULT_PROC_SCENARIO": "controller",
    "DEFAULT_SCENARIO": "controller",
    "EmulatedNode": "node",
    "FleetController": "controller",
    "FleetNet": "links",
    "FleetTopology": "topology",
    "LinkPartitioned": "links",
    "LinkTable": "links",
    "NodeSpec": "topology",
    "ProcHandshakeError": "proc",
    "ProcNode": "proc",
    "PyXferd": "xferd",
    "SoakSchedule": "soak",
    "SoakWorld": "soak",
    "load_scenario": "controller",
    "run_soak": "soak",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
