"""NodeBreaker: per-node circuit breaker for the serving dispatch set.

The port's copy of ``container_engine_accelerators_tpu/serving/breaker.py``
(host code: no torch): the same names, counters and spans byte for byte.

A node that fails every request it is handed must stop being handed
requests — retrying into a black hole burns the hedge budget and the
client retry deadlines of every request routed there, which is how one
dead node degrades a whole frontend.  The breaker is the standard
three-state machine, per node:

- **closed**: requests flow; each success clears the consecutive
  failure count, each failure bumps it.  ``failures`` consecutive
  failures trip the breaker (``serving.breaker.open``).
- **open**: the node is ejected from dispatch for ``cooldown_s`` —
  ``allow`` answers False without touching the node.
- **half-open**: after the cooldown, exactly ONE caller is let
  through as a probe (``serving.breaker.probe``); its success closes
  the breaker (``serving.breaker.close``), its failure re-opens it
  for another cooldown.  Concurrent callers during a probe stay
  rejected, so a recovering node sees one request, not a stampede.

The clock is injectable (``clock=``) so the state machine unit-tests
without sleeping; the frontend passes real ``time.monotonic``.  The
number of currently-open breakers is published as the
``serving.breaker.open_nodes`` gauge so ``agent_top`` shows ejections
live.
"""

import threading
import time
from typing import Callable, Dict, Optional

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries

DEFAULT_FAILURES = 3
DEFAULT_COOLDOWN_S = 1.0

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half-open"


class _State:
    __slots__ = ("state", "fails", "opened_at", "probing")

    def __init__(self):
        self.state = _CLOSED
        self.fails = 0
        self.opened_at = 0.0
        self.probing = False


class NodeBreaker:
    def __init__(self, failures: int = DEFAULT_FAILURES,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock: Optional[Callable[[], float]] = None):
        self.failures = max(1, int(failures))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._nodes: Dict[str, _State] = {}

    def _publish_locked(self) -> None:
        timeseries.gauge(
            "serving.breaker.open_nodes",
            float(sum(1 for s in self._nodes.values()
                      if s.state != _CLOSED)))

    def allow(self, node: str) -> bool:
        """May a request be dispatched to ``node`` right now?  An open
        breaker past its cooldown grants exactly one probe."""
        with self._lock:
            st = self._nodes.get(node)
            if st is None or st.state == _CLOSED:
                return True
            if (st.state == _OPEN
                    and self._clock() - st.opened_at
                    >= self.cooldown_s):
                st.state = _HALF_OPEN
                st.probing = True
                counters.inc("serving.breaker.probe")
                return True
            if st.state == _HALF_OPEN and not st.probing:
                # The previous probe was abandoned (its attempt lost
                # the hedge race before reaching the node): grant a
                # fresh one instead of wedging half-open forever.
                st.probing = True
                counters.inc("serving.breaker.probe")
                return True
            return False  # open inside cooldown, or a probe in flight

    def release_probe(self, node: str) -> None:
        """The probe's attempt was cancelled before it could judge the
        node (hedge-race loser, frontend shutdown): give the probe
        slot back without recording a verdict."""
        with self._lock:
            st = self._nodes.get(node)
            if st is not None and st.state == _HALF_OPEN:
                st.probing = False

    def record_success(self, node: str) -> None:
        with self._lock:
            st = self._nodes.get(node)
            if st is None:
                return
            if st.state == _HALF_OPEN:
                counters.inc("serving.breaker.close")
            st.state = _CLOSED
            st.fails = 0
            st.probing = False
            self._publish_locked()

    def record_failure(self, node: str) -> None:
        with self._lock:
            st = self._nodes.setdefault(node, _State())
            if st.state == _HALF_OPEN:
                # The probe failed: straight back to open, fresh
                # cooldown — no stampede through a flapping node.
                st.state = _OPEN
                st.opened_at = self._clock()
                st.probing = False
                counters.inc("serving.breaker.open")
                self._publish_locked()
                return
            st.fails += 1
            if st.state == _CLOSED and st.fails >= self.failures:
                st.state = _OPEN
                st.opened_at = self._clock()
                counters.inc("serving.breaker.open")
                self._publish_locked()

    def state(self, node: str) -> str:
        with self._lock:
            st = self._nodes.get(node)
            return _CLOSED if st is None else st.state

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {"state": st.state, "fails": st.fails}
                for name, st in self._nodes.items()
            }
