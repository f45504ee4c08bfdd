"""Node-agent observability: spans, latency histograms, flight recorder.

Everything here is stdlib-only by contract — utils/, parallel/, and
health/ sit on these modules, and they must stay importable in
containers without prometheus_client or grpc (the MetricServer is the
one that imports *us*, exporting histograms as ``agent_latency`` next
to the ``agent_events`` counters).  tests/test_torch_obs.py enforces
the contract with a blocked-import subprocess (no torch either: the node
DaemonSet's image carries none).  The port's own copy of the JAX
package's ``obs/``: the same span JSONL, ``TPU_TRACE_CONTEXT`` format,
flight blob and ``/spans`` / ``/profile`` bodies, and the same ``TPU_*``
variables, so each package's tools read the other's files.

- ``obs.trace``       spans: trace/span ids, thread-local context,
                      JSONL sink (``TPU_TRACE_FILE``) + ring buffer
- ``obs.critpath``    critical-path engine: span-tree reconstruction,
                      per-phase self time, exposed-communication math
- ``obs.histo``       log2-bucket latency histograms with percentiles
                      and per-bucket trace exemplars
- ``obs.timeseries``  windowed ring-bucket rates + explicit gauges
                      (goodput, in-flight, SLO status)
- ``obs.flight``      flight recorder: SIGUSR1 / terminal-failure dumps
- ``obs.profiler``    continuous stack-sampling profiler: folded
                      stacks keyed by subsystem, ``/profile`` scrape
- ``obs.history``     persistent run ledger (``TPU_HISTORY_DIR``) +
                      median/MAD trend engine with attributed
                      regression verdicts
- ``obs.promtext``    the one Prometheus text-exposition parser every
                      scrape surface (agent_top, fleet telemetry) uses
- ``obs.anomaly``     the peer-relative grey-failure detector (imported
                      on its own: ``cmd/agent_top.py`` reads its states)
"""

from container_engine_accelerators_tpu_torch.obs import (
    critpath,
    flight,
    histo,
    history,
    profiler,
    promtext,
    timeseries,
    trace,
)

__all__ = ["critpath", "flight", "histo", "history", "profiler",
           "promtext", "timeseries", "trace"]
