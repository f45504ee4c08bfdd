"""Node label daemon: GCE metadata -> DCN topology labels (the JAX
package's ``scheduler/labeler.py`` without its TPU slice labels).

The reference daemon reads the ``physical_host`` instance attribute
(``/<cluster>/<rack>/<host>``) and stamps ``topology.gke.io/{cluster,
rack,host}`` (ref: gpudirect-tcpxo/topology-scheduler/
label-nodes-daemon.py:24-55), which the scheduler's distance reads
(``topology.py``).  A GPU node has no ``tpu-env`` attribute and no slice
to label, so this labeler reads none.

The metadata fetcher is a seam for tests; the real one asks the GCE
metadata server with the ``Metadata-Flavor: Google`` header.
"""

import logging
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

from container_engine_accelerators_tpu_torch.scheduler.k8s import CoreV1
from container_engine_accelerators_tpu_torch.scheduler.topology import (
    CLUSTER_LABEL,
    HOST_LABEL,
    RACK_LABEL,
)

log = logging.getLogger(__name__)

METADATA_BASE = "http://metadata.google.internal/computeMetadata/v1"
UPDATE_INTERVAL_S = 600.0

Fetcher = Callable[[str], Optional[str]]


def metadata_fetcher(base: str = METADATA_BASE) -> Fetcher:
    """fetch(path) -> the metadata server's answer, or None when it does
    not answer."""

    def fetch(path: str) -> Optional[str]:
        req = urllib.request.Request(base + path,
                                     headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.read().decode()
        except (urllib.error.URLError, OSError) as e:
            log.warning("metadata fetch %s failed: %s", path, e)
            return None

    return fetch


def compute_labels(fetch: Fetcher) -> Optional[Dict[str, str]]:
    """The cluster, rack and host labels of ``physical_host``; None when
    the attribute is missing or has fewer than three parts."""
    physical_host = fetch("/instance/attributes/physical_host")
    if physical_host is None:
        log.warning("physical host not found")
        return None
    parts = physical_host.strip().split("/")[1:]
    if len(parts) < 3:
        log.warning("malformed physical_host %r", physical_host)
        return None
    cluster, rack, host = parts[:3]
    return {CLUSTER_LABEL: cluster, RACK_LABEL: rack, HOST_LABEL: host}


def update_node_labels(api: CoreV1, fetch: Fetcher) -> Optional[Dict[str, str]]:
    """PATCH this node's labels (the node named by ``/instance/name``);
    return them, or None when the metadata gives no name or labels."""
    node_name = fetch("/instance/name")
    if node_name is None:
        log.warning("node name not found")
        return None
    labels = compute_labels(fetch)
    if labels is None:
        return None
    api.patch_node_labels(node_name.strip(), labels)
    log.info("updated labels on node %s: %s", node_name.strip(), labels)
    return labels


def run_forever(api: CoreV1, fetch: Optional[Fetcher] = None):
    fetch = fetch or metadata_fetcher()
    while True:
        log.info("starting node label update")
        update_node_labels(api, fetch)
        time.sleep(UPDATE_INTERVAL_S)
