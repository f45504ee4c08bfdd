"""The topology-aware scheduler daemon for ``nvidia.com/gpu`` (the JAX
package's root ``cmd/topology_scheduler.py``).

As the reference's schedule-daemon
(ref: gpudirect-tcpxo/topology-scheduler/schedule-daemon.py:402-423):
in-cluster credentials, a pass a second, the gate prefix and the
ignored namespaces from flags.

    python -m container_engine_accelerators_tpu_torch.cmd.topology_scheduler \\
        --once --settle-seconds 0 --api-host http://127.0.0.1:8001
"""

import argparse
import logging
import sys

from container_engine_accelerators_tpu_torch.scheduler.daemon import (
    DEFAULT_GATE_PREFIX,
    SchedulerDaemon,
)
from container_engine_accelerators_tpu_torch.scheduler.k8s import (
    CoreV1,
    in_cluster_transport,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="topology-scheduler")
    parser.add_argument("-g", "--gate", default=DEFAULT_GATE_PREFIX,
                        help="scheduling-gate name prefix to own")
    parser.add_argument("-i", "--interval", type=float, default=1.0,
                        help="seconds between scheduling passes")
    parser.add_argument("--ignored-namespace", nargs="*", default=[])
    parser.add_argument("--api-host", default=None,
                        help="API server URL (default: in-cluster, from "
                             "KUBERNETES_SERVICE_HOST)")
    parser.add_argument("--once", action="store_true",
                        help="one scheduling pass, then exit")
    parser.add_argument("--settle-seconds", type=float, default=5.0,
                        help="job-atomicity settle delay before each pass")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    api = CoreV1(in_cluster_transport(host=args.api_host))
    daemon = SchedulerDaemon(
        api,
        gate_prefix=args.gate,
        interval_s=args.interval,
        ignored_namespaces=args.ignored_namespace,
        settle_s=args.settle_seconds,
    )
    if args.once:
        bound = daemon.run_once()
        print(f"bound {bound} pods", flush=True)
        return 0
    daemon.run_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
