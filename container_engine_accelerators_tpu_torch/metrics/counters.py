"""Process-wide counters of the node agent's recovery behaviour: health
transitions, kubelet registration retries and re-registrations, metrics
port retries.  The metrics server exports them as
``agent_events{event=...}`` beside the GPU gauges, so a node that
silently re-registers forty times a minute does not look green.

Names are dotted ``<component>.<event>``: ``health.unhealthy``,
``health.recovered``, ``health.flap_backoff``,
``kubelet.register.retried``, ``kubelet.register.failed``,
``kubelet.reregister``, ``metrics.rebind``, the NRI plugin's
``nri.reconnect`` and ``nri.reconnect.failed``, and
``fault.fired.<site>`` for every injected fault (``utils/faults.py``).

Every increment also feeds the windowed series of ``obs/timeseries.py``,
so each counter has a per-second rate over the trailing window, exported
as ``agent_rate{event=...}``: the cumulative value says how many since
boot, the rate whether it is happening now.  Stdlib only, like
``obs/``.
"""

import threading
from typing import Dict

from container_engine_accelerators_tpu_torch.obs import timeseries

_lock = threading.Lock()
_counters: Dict[str, int] = {}


def inc(name: str, n: int = 1) -> int:
    """Add ``n`` to counter ``name`` (created at 0); returns the new value."""
    timeseries.record(name, n)
    with _lock:
        value = _counters.get(name, 0) + n
        _counters[name] = value
        return value


def get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Zero everything (tests only: the agent's counters are cumulative)."""
    with _lock:
        _counters.clear()
