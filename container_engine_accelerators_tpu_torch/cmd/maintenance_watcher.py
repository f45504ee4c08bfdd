"""Host-maintenance watcher for GPU nodes (a DaemonSet; the JAX package's
root ``cmd/maintenance_watcher.py``).

Polls the GCE metadata server's ``/instance/maintenance-event`` and
drains the node ahead of the window: a ``nvidia.com/gpu-maintenance``
taint and a node-wide line in the device plugin's fault file
(``health/maintenance.py``).

    python -m container_engine_accelerators_tpu_torch.cmd.maintenance_watcher \\
        --fault-file /var/run/nvidia/faults --once

``--fault-file`` defaults to ``GPU_FAULT_FILE``, the file the device
plugin's health checker reads.
"""

import argparse
import logging
import os
import sys

from container_engine_accelerators_tpu_torch.health import maintenance
from container_engine_accelerators_tpu_torch.health.health_checker import (
    FAULT_FILE_ENV,
)
from container_engine_accelerators_tpu_torch.scheduler import labeler
from container_engine_accelerators_tpu_torch.scheduler.k8s import (
    CoreV1,
    in_cluster_transport,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="maintenance-watcher")
    parser.add_argument("--api-host", default=None,
                        help="API server URL (default: in-cluster)")
    parser.add_argument("--metadata-base", default=labeler.METADATA_BASE,
                        help="metadata server base URL")
    parser.add_argument("--node-name", default=os.environ.get("NODE_NAME"),
                        help="this node's name (default: the NODE_NAME env, "
                             "the downward API's)")
    parser.add_argument("--fault-file", default=os.environ.get(FAULT_FILE_ENV),
                        help="the device plugin's fault file (default: the "
                             f"{FAULT_FILE_ENV} env)")
    parser.add_argument("--interval", type=float,
                        default=maintenance.DEFAULT_INTERVAL_S)
    parser.add_argument("--once", action="store_true",
                        help="one reconcile pass, then exit")
    args = parser.parse_args(argv)
    if not args.node_name:
        parser.error("--node-name or the NODE_NAME env is required")
    if not args.fault_file:
        parser.error(f"--fault-file or the {FAULT_FILE_ENV} env is required")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    api = CoreV1(in_cluster_transport(host=args.api_host))
    fetch = labeler.metadata_fetcher(args.metadata_base)
    if args.once:
        event = maintenance.reconcile(api, args.node_name, fetch,
                                      args.fault_file)
        print(f"maintenance event: {event}", flush=True)
        return 0
    maintenance.run_forever(api, args.node_name, fetch, args.fault_file,
                            args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
