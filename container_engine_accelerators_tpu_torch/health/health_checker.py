"""GPU health checker: NVML's critical Xid stream -> Unhealthy devices
(ref: pkg/gpu/nvidia/health_check/health_checker.go:31-245; the state
machine of the JAX package's ``health/health_checker.py``):

- only *critical* Xids flip a device to Unhealthy: the default set (48,
  a double-bit ECC error) plus the node config's ``HealthCriticalXid`` or
  ``XID_CONFIG`` (health_checker.go:40-62);
- an event with no device marks ALL devices Unhealthy
  (health_checker.go:192-201);
- NVML names the device by handle; gpulib maps it to ``nvidia<minor>``,
  the name the manager advertises, never the NVML index;
- a device whose driver answers NOT_SUPPORTED to the Xid registration is
  logged and stays Healthy (health_checker.go:116-118);
- transitions go into the manager's health queue, which ListAndWatch
  drains and announces to the kubelet (beta_plugin.go:39-54);
- recovery (the JAX package's; the reference has no way back to Healthy):
  a device with no further critical event for ``recovery_window_s`` is
  announced Healthy again.  Every critical event restarts its quiet
  window, and a device that faults again soon after a recovery doubles its
  next window (flap backoff), so one that breaks only under load decays
  toward staying out.  Transitions count in ``metrics/counters.py``
  (``health.unhealthy``, ``health.recovered``, ``health.flap_backoff``).

An external fault file (``GPU_FAULT_FILE``) feeds the same machine from
outside the process, one event a line; text after ``#`` is the event's
message, and malformed lines are logged and skipped:

    fault <device> [xid]     # xid defaults to 48
    fault * [xid]            # no device: the whole node (the maintenance
                             # watcher's notice, health/maintenance.py)
    clear <device>           # recover now

Fault site ``health.stream`` fires before each event wait; the wait's
own back-off and the ``health.stream.errors`` count absorb it.
"""

import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Set

from container_engine_accelerators_tpu_torch.gpulib.types import GpuLib, XidEvent
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import histo, trace
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    UNHEALTHY,
    Device,
)

log = logging.getLogger(__name__)

DEFAULT_CRITICAL_XID = frozenset({48})
EVENT_WAIT_TIMEOUT_S = 5.0  # nvml.WaitForEvent(5000)
# Quiet time before an Unhealthy device is announced Healthy again: far
# above the event stream's latency, and long enough for crash-looping
# workloads on the sick GPU to drain.
DEFAULT_RECOVERY_WINDOW_S = 300.0
# A fault within FLAP_RESET_FACTOR windows of a recovery is a flap and
# doubles the next window, up to 2**MAX_FLAP_DOUBLINGS (64x).
FLAP_RESET_FACTOR = 4
MAX_FLAP_DOUBLINGS = 6
FAULT_FILE_ENV = "GPU_FAULT_FILE"
FAULT_FILE_DEFAULT_XID = 48


class GpuHealthChecker:
    def __init__(
        self,
        manager,
        lib: GpuLib,
        critical_xid: Optional[Iterable[int]] = None,
        recovery_window_s: Optional[float] = DEFAULT_RECOVERY_WINDOW_S,
        event_wait_timeout_s: float = EVENT_WAIT_TIMEOUT_S,
        fault_file: Optional[str] = None,
    ):
        self.manager = manager
        self.lib = lib
        self.critical_xid: Set[int] = set(DEFAULT_CRITICAL_XID)
        self.critical_xid.update(critical_xid or [])
        self.event_wait_timeout_s = event_wait_timeout_s
        self.fault_file = (fault_file if fault_file is not None
                           else os.environ.get(FAULT_FILE_ENV) or None)
        self._fault_file_pos = 0
        # None (or 0) disables recovery: Unhealthy is forever, as in the
        # reference.
        self.recovery_window_s = recovery_window_s
        self.registered: List[str] = []
        self._unhealthy_since: Dict[str, float] = {}
        # First fault of the current Unhealthy episode (a repeat fault
        # does not move it): the recovery histogram measures the whole
        # outage, not only the last quiet window.
        self._unhealthy_first: Dict[str, float] = {}
        self._recovered_at: Dict[str, float] = {}
        self._flaps: Dict[str, int] = {}
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Subscribe to Xid events on every device (an NVML error other
        than NOT_SUPPORTED raises), then listen on a thread."""
        self.registered = self.lib.register_xid_events()
        log.info("starting GPU health checker; critical Xids %s; watching %s",
                 sorted(self.critical_xid), self.registered)
        self._thread = threading.Thread(
            target=self._listen_to_events, name="gpu-health", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.event_wait_timeout_s)

    # -- event loop ----------------------------------------------------------

    def _listen_to_events(self) -> None:
        while not self._stop.is_set():
            event = None
            try:
                faults.check("health.stream")
                event = self.lib.wait_for_event(self.event_wait_timeout_s)
            except Exception as e:
                # Keep monitoring across backend errors, but back off so a
                # persistent one cannot spin the CPU.
                log.error("Xid event wait failed: %s; backing off", e)
                counters.inc("health.stream.errors")
                self._stop.wait(self.event_wait_timeout_s)
            if event is not None:
                self.catch_error(event)
            # The fault file and recovery keep working while the event
            # stream is down: an outage of the detector must not pin
            # devices Unhealthy.
            self.poll_fault_file()
            self.maybe_recover()

    def catch_error(self, event: XidEvent) -> None:
        """Decide which devices an event takes down
        (ref: health_checker.go:179-226).  The decision is one span,
        ``health.event`` (a histogram of the same name): the time from
        the event to the transitions being queued."""
        with trace.span("health.event", histogram="health.event",
                        code=event.code, device=event.device):
            self._catch_error(event)

    def _catch_error(self, event: XidEvent) -> None:
        if event.code not in self.critical_xid:
            log.info("Xid %d is not critical; skipping (device=%s, %s)",
                     event.code, event.device, event.message)
            return
        if event.device is None:
            log.error("critical Xid %d with no device: marking ALL devices "
                      "unhealthy (%s)", event.code, event.message)
            for name in list(self.manager.devices):
                self._mark_unhealthy(name)
            return
        if event.device not in self.manager.devices:
            log.warning("critical Xid %d on unknown device %r; ignoring",
                        event.code, event.device)
            return
        log.error("critical Xid %d on %s: %s", event.code, event.device,
                  event.message)
        self._mark_unhealthy(event.device)

    def _mark_unhealthy(self, name: str) -> None:
        now = time.monotonic()
        with self._mu:
            # Every critical event pushes the quiet window out.
            self._unhealthy_since[name] = now
            self._unhealthy_first.setdefault(name, now)
            recovered_at = self._recovered_at.pop(name, None)
            if recovered_at is not None and self.recovery_window_s:
                if now - recovered_at < FLAP_RESET_FACTOR * self._window_for(name):
                    self._flaps[name] = min(self._flaps.get(name, 0) + 1,
                                            MAX_FLAP_DOUBLINGS)
                    counters.inc("health.flap_backoff")
                else:
                    self._flaps.pop(name, None)  # stayed good: forgiven
        counters.inc("health.unhealthy")
        self.manager.health_events.put(Device(id=name, health=UNHEALTHY))

    def _window_for(self, name: str) -> float:
        """The quiet window, doubled per recorded flap."""
        return self.recovery_window_s * (2 ** self._flaps.get(name, 0))

    # -- external fault file -------------------------------------------------

    def poll_fault_file(self) -> int:
        """Apply the fault file's new complete lines; returns how many were
        applied.  A missing file is no injector yet; a file that shrank was
        truncated or rotated and is read again from the top."""
        path = self.fault_file
        if not path:
            return 0
        try:
            size = os.stat(path).st_size
        except OSError:
            return 0
        if size < self._fault_file_pos:
            self._fault_file_pos = 0
        if size == self._fault_file_pos:
            return 0
        try:
            with open(path, "rb") as f:
                f.seek(self._fault_file_pos)
                blob = f.read(size - self._fault_file_pos)
        except OSError as e:
            log.error("fault file %s unreadable: %s", path, e)
            return 0
        # A line caught mid-write waits for its newline.
        consumed = blob.rfind(b"\n") + 1
        if consumed == 0:
            return 0
        self._fault_file_pos += consumed
        return sum(self._apply_fault_line(raw.strip()) for raw in
                   blob[:consumed].decode("utf-8", "replace").splitlines())

    def _apply_fault_line(self, line: str) -> bool:
        line, _, comment = line.partition("#")
        tokens = line.split()
        if not tokens:
            return False
        kind = tokens[0].lower()
        try:
            if kind == "fault" and 2 <= len(tokens) <= 3:
                code = (int(tokens[2]) if len(tokens) == 3
                        else FAULT_FILE_DEFAULT_XID)
                device = None if tokens[1] == "*" else tokens[1]
                counters.inc("health.fault_file.events")
                trace.event("health.fault_file", kind="fault",
                            device=tokens[1], code=code)
                self.catch_error(XidEvent(
                    code=code, device=device,
                    message=comment.strip() or "injected via fault file"))
                return True
            if kind == "clear" and len(tokens) == 2:
                counters.inc("health.fault_file.events")
                trace.event("health.fault_file", kind="clear",
                            device=tokens[1])
                self.clear_device(tokens[1])
                return True
            raise ValueError("want 'fault <dev>|* [xid]' or 'clear <dev>'")
        except ValueError as e:
            counters.inc("health.fault_file.malformed")
            log.error("ignoring malformed fault line %r: %s", line, e)
            return False

    def clear_device(self, name: str) -> int:
        """External all-clear: expire the device's window now and forgive
        its flaps, then run the normal recovery.  Returns devices
        recovered."""
        with self._mu:
            if name not in self._unhealthy_since:
                return 0
            self._unhealthy_since[name] = float("-inf")
            self._flaps.pop(name, None)
        if not self.recovery_window_s:
            log.warning("fault-file clear for %s ignored: recovery is "
                        "disabled", name)
            return 0
        return self.maybe_recover()

    # -- recovery ------------------------------------------------------------

    def maybe_recover(self, now: Optional[float] = None) -> int:
        """Announce Healthy the devices whose quiet window has passed;
        returns how many."""
        if not self.recovery_window_s:
            return 0
        now = time.monotonic() if now is None else now
        recovered = []
        with self._mu:
            for name, since in list(self._unhealthy_since.items()):
                window = self._window_for(name)
                if now - since < window:
                    continue
                del self._unhealthy_since[name]
                first = self._unhealthy_first.pop(name, since)
                self._recovered_at[name] = now
                recovered.append((name, window, now - first))
        announced = 0
        for name, window, outage_s in recovered:
            if name not in self.manager.devices:
                log.info("device %s vanished while unhealthy; dropping", name)
                continue
            log.warning("device %s quiet for %.0fs after a critical Xid: "
                        "announcing Healthy", name, window)
            counters.inc("health.recovered")
            # The whole outage, first fault to announcement; the marker
            # span places it in the trace.
            histo.observe("health.recovery", outage_s)
            trace.event("health.recover", device=name,
                        outage_s=round(outage_s, 3), window_s=window)
            self.manager.health_events.put(Device(id=name, health=HEALTHY))
            announced += 1
        return announced
