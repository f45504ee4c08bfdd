"""Flight recorder: dump the last N spans + counters on demand or death.

A node agent that goes terminal (DCN retry budget exhausted, resilient
client latched) usually gets its pod deleted before anyone attaches a
debugger — the evidence of *why* dies with it.  The flight recorder
closes that gap: on SIGUSR1, or whenever a terminal-failure hook fires,
it emits ONE self-contained JSON blob holding

- the tail of the span ring buffer (obs/trace.py),
- the full robustness counter snapshot (metrics/counters.py),
- every latency histogram (obs/histo.py),
- the windowed-rate/gauge snapshot (obs/timeseries.py) and the SLO
  verdict gauges (``slo.*``) — what the node was *doing* when it died,
  not just its lifetime totals,
- the continuous profiler's top folded stacks (obs/profiler.py) —
  where every thread was stuck or spinning, so a hung worker's
  postmortem shows the code, not just the open spans,

to stderr (always — `kubectl logs` is the collection path that needs no
infrastructure) and appended to ``TPU_FLIGHT_FILE`` when set.

Hooked today: ``utils/retry.py`` on budget exhaustion.  Agents arm
the signal path with ``install()`` (cmd/gpu_device_plugin.py does).  The SIGUSR1 handler hands the dump to
a short-lived thread: the handler itself runs between bytecodes on the
main thread, which may be holding the very locks the dump needs.

Stdlib-only; a dump failure is swallowed (the recorder must never turn
a bad day into a worse one).
"""

import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import (
    histo,
    profiler,
    timeseries,
    trace,
)

log = logging.getLogger(__name__)

FLIGHT_FILE_ENV = "TPU_FLIGHT_FILE"
FLIGHT_SPANS_ENV = "TPU_FLIGHT_SPANS"
DEFAULT_SPANS = 64
STDERR_MARKER = "TPU_FLIGHT_RECORDER"


def snapshot(reason: str) -> dict:
    """Assemble the dump blob without emitting it."""
    n = trace._env_int(FLIGHT_SPANS_ENV, DEFAULT_SPANS)
    rates = timeseries.snapshot()
    return {
        "flight_recorder": 1,  # schema tag for offline tooling
        "reason": reason,
        "ts": round(time.time(), 3),
        "pid": os.getpid(),
        "spans": trace.tail(n),
        "counters": counters.snapshot(),
        "histograms": histo.snapshot(),
        # What the node was DOING at death, not just lifetime totals:
        # windowed per-second rates, live gauges, and any SLO verdict
        # gauges the fleet aggregator (fleet/telemetry.py) published.
        "rates": rates,
        "slo": {name: value for name, value in rates["gauges"].items()
                if name.startswith("slo.")},
        # Where every thread was STUCK, not just which spans were
        # open: the continuous profiler's top folded stacks — a hung
        # worker's postmortem names the code burning (or parking) its
        # threads.
        "profile": profiler.summary(),
    }


def dump(reason: str, file: Optional[str] = None) -> Optional[dict]:
    """Emit one flight-recorder blob; returns it (None if assembly
    itself failed — nothing useful to return, nothing to raise)."""
    try:
        blob = snapshot(reason)
        line = json.dumps(blob)
    except Exception as e:  # noqa: BLE001 — recorder never raises
        log.error("flight-recorder snapshot failed: %s", e)
        return None
    counters.inc("flight.dumps")
    path = file or os.environ.get(FLIGHT_FILE_ENV)
    if path:
        try:
            with open(path, "a") as f:
                f.write(line + "\n")
        except OSError as e:
            log.error("flight-recorder file %s unwritable: %s", path, e)
    try:
        sys.stderr.write(f"{STDERR_MARKER} {line}\n")
        sys.stderr.flush()
    except (OSError, ValueError):
        pass  # stderr redirected to a closed pipe: file copy stands
    return blob


def on_terminal(reason: str) -> None:
    """The hook terminal-failure paths call (retry exhaustion, the
    resilient DCN client latching terminal)."""
    dump(f"terminal: {reason}")


def _handler(signum: int, frame) -> None:
    # Detach from the interrupted main thread: it may hold the ring /
    # counter locks the dump reads.
    threading.Thread(
        target=dump, args=(f"signal {signum}",),
        name="flight-recorder", daemon=True,
    ).start()


def install(signum: int = signal.SIGUSR1) -> bool:
    """Arm the on-demand dump signal; False when not on the main
    thread (signal handlers are main-thread-only in CPython)."""
    try:
        signal.signal(signum, _handler)
        return True
    except ValueError:
        log.warning("flight recorder: not on main thread; signal %d "
                    "not armed", signum)
        return False
