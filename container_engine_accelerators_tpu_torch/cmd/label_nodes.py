"""The node topology-label daemon (a DaemonSet; the JAX package's root
``cmd/label_nodes.py``).

As the reference's label-nodes-daemon
(ref: gpudirect-tcpxo/topology-scheduler/label-nodes-daemon.py:58-67):
every 600 s, read the GCE metadata's ``physical_host`` and patch this
node's cluster, rack and host labels (``scheduler/labeler.py``).

    python -m container_engine_accelerators_tpu_torch.cmd.label_nodes \\
        --once --api-host http://127.0.0.1:8001 \\
        --metadata-base http://127.0.0.1:8002/computeMetadata/v1
"""

import argparse
import logging
import sys

from container_engine_accelerators_tpu_torch.scheduler import labeler
from container_engine_accelerators_tpu_torch.scheduler.k8s import (
    CoreV1,
    in_cluster_transport,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="label-nodes")
    parser.add_argument("--api-host", default=None,
                        help="API server URL (default: in-cluster)")
    parser.add_argument("--metadata-base", default=labeler.METADATA_BASE,
                        help="metadata server base URL")
    parser.add_argument("--once", action="store_true",
                        help="one label update, then exit")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    api = CoreV1(in_cluster_transport(host=args.api_host))
    fetch = labeler.metadata_fetcher(args.metadata_base)
    if args.once:
        labels = labeler.update_node_labels(api, fetch)
        print(f"labels: {labels}", flush=True)
        return 0
    labeler.run_forever(api, fetch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
