"""The topology-aware scheduler for ``nvidia.com/gpu`` (the JAX
package's ``scheduler/``, without its TPU slice tier): a label daemon
stamps nodes with their DCN topology (cluster, rack, host;
``labeler.py``), and a scheduling daemon places scheduling-gated job
pods to minimise their summed topology distance (``daemon.py``,
``topology.py``), over a small Kubernetes client (``k8s.py``).  Copied
so that the port imports nothing of the JAX package.
"""

from container_engine_accelerators_tpu_torch.scheduler.daemon import (
    SchedulerDaemon,
    calculate_pods_assignment,
    find_pod_gates,
    find_schedulable_nodes,
    find_schedulable_pods,
)
from container_engine_accelerators_tpu_torch.scheduler.topology import (
    node_topology_distance,
    node_topology_key,
)

__all__ = [
    "SchedulerDaemon",
    "calculate_pods_assignment",
    "find_pod_gates",
    "find_schedulable_nodes",
    "find_schedulable_pods",
    "node_topology_distance",
    "node_topology_key",
]
