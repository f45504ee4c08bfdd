"""Host-maintenance watcher: drain a GPU node before its host goes away
(the JAX package's ``health/maintenance.py`` with a GPU taint and the
GPU health checker's fault file).

GCE publishes upcoming host maintenance on the metadata server
(``/instance/maintenance-event``: ``NONE``, ``MIGRATE_ON_HOST_MAINTENANCE``
or ``TERMINATE_ON_HOST_MAINTENANCE``).  A VM with GPUs attached cannot
live-migrate, so a notice means every card on the node will go.  The
watcher turns the notice into a drain ahead of the window:

1. taint the node ``nvidia.com/gpu-maintenance=<event>:NoSchedule``, so
   the scheduler stops placing new GPU pods on it;
2. append ``fault * <MAINTENANCE_XID>`` to the device plugin's
   ``GPU_FAULT_FILE``: a device-less event, which the checker applies to
   every GPU of the node.  The code is informational unless
   ``XID_CONFIG`` lists it; listed, the node's GPUs turn Unhealthy ahead
   of the window (a full drain).

When the event clears back to ``NONE`` the taint is removed, so a window
that needed no drain heals without an operator.
"""

import logging
import os
import time
from typing import Callable, List, Optional

from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.scheduler.k8s import ApiException
from container_engine_accelerators_tpu_torch.utils import faults

log = logging.getLogger(__name__)

# NVIDIA's Xid catalogue numbers the driver's faults from 1 into the low
# hundreds, and JAX's maintenance code, 80, is one of them.  999 lies
# outside the catalogue, so no driver event can be taken for a
# maintenance notice, or the reverse.
MAINTENANCE_XID = 999
TAINT_KEY = "nvidia.com/gpu-maintenance"
METADATA_PATH = "/instance/maintenance-event"
DEFAULT_INTERVAL_S = 60.0

Fetcher = Callable[[str], Optional[str]]

_CONFLICT_RETRIES = 3


def current_event(fetch: Fetcher) -> Optional[str]:
    """The pending maintenance event, or None when NONE or unreadable."""
    raw = fetch(METADATA_PATH)
    if raw is None:
        return None
    value = raw.strip()
    return value if value and value != "NONE" else None


def _with_taint(taints: List[dict], event: str) -> List[dict]:
    out = [t for t in taints if t.get("key") != TAINT_KEY]
    out.append({"key": TAINT_KEY, "value": event, "effect": "NoSchedule"})
    return out


def _without_taint(taints: List[dict]) -> List[dict]:
    return [t for t in taints if t.get("key") != TAINT_KEY]


def post_event(fault_file: str, event: str) -> None:
    """Append the node-wide maintenance line to the checker's fault file
    (one write of one whole line: the checker reads complete lines)."""
    line = (f"fault * {MAINTENANCE_XID} # host maintenance imminent: "
            f"{event}\n").encode()
    fd = os.open(fault_file, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, line)
    finally:
        os.close(fd)


def reconcile(api, node_name: str, fetch: Fetcher,
              fault_file: str) -> Optional[str]:
    """One pass: read the metadata, converge the node's taint, post the
    event.  Returns the active maintenance event (None when clear).

    The taint update is a read-modify-write of the FULL taint list
    (``spec.taints`` is atomic under strategic merge), so each write
    carries the read's ``resourceVersion`` and a 409 Conflict re-reads and
    tries again, up to 3 times: a taint another controller added between
    the read and the patch stays.  Fault site ``k8s.patch`` fires before
    each patch; its ``conflict`` mode drives this retry.
    """
    event = current_event(fetch)
    for attempt in range(_CONFLICT_RETRIES):
        node = api.read_node(node_name)
        taints = (node.get("spec") or {}).get("taints") or []
        rv = (node.get("metadata") or {}).get("resourceVersion")
        current = next((t.get("value") for t in taints
                        if t.get("key") == TAINT_KEY), None)
        try:
            if event and current != event:
                # A new notice, or an escalation (MIGRATE -> TERMINATE)
                # while tainted: converge the value and post again, so a
                # consumer keyed on TERMINATE sees it.
                with trace.span("k8s.patch", histogram="k8s.patch",
                                node=node_name, attempt=attempt):
                    faults.check("k8s.patch")
                    api.patch_node_taints(node_name,
                                          _with_taint(taints, event),
                                          resource_version=rv)
                post_event(fault_file, event)
                log.warning("maintenance %s: tainted node %s and posted "
                            "Xid %d", event, node_name, MAINTENANCE_XID)
            elif not event and current is not None:
                with trace.span("k8s.patch", histogram="k8s.patch",
                                node=node_name, attempt=attempt):
                    faults.check("k8s.patch")
                    api.patch_node_taints(node_name, _without_taint(taints),
                                          resource_version=rv)
                log.info("maintenance cleared: untainted node %s", node_name)
        except (ApiException, faults.FaultInjectedError) as e:
            # An injected conflict carries status 409 as a real stale
            # resourceVersion does; both retry here.
            if (getattr(e, "status", None) == 409
                    and attempt < _CONFLICT_RETRIES - 1):
                log.info("taint update conflicted (409); reading the node "
                         "again")
                continue
            raise
        break
    return event


def run_forever(api, node_name: str, fetch: Fetcher, fault_file: str,
                interval_s: float = DEFAULT_INTERVAL_S) -> None:
    while True:
        try:
            reconcile(api, node_name, fetch, fault_file)
        except Exception as e:  # noqa: BLE001 - the watcher keeps watching
            log.error("maintenance reconcile failed: %s", e)
        time.sleep(interval_s)
