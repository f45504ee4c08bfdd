"""Topology keys and distances for GPU placement (the JAX package's
``scheduler/topology.py`` without its ICI tier).

The reference orders nodes by their (placement-group, cluster, rack,
host) labels and scores an assignment by a hierarchical label-prefix
distance (ref: gpudirect-tcpxo/topology-scheduler/schedule-daemon.py:63-91).
On an H100 node the NVLink domain is the host itself (eight GPUs under
NVSwitch), so the JAX package's tier inside a TPU slice — slice ids, ICI
coordinates, torus hops — has no counterpart here: every pair of nodes
is scored by the DCN hierarchy alone.  On nodes without the TPU labels
``node_topology_key`` and ``node_topology_distance`` give the JAX
package's values.

Node labels read (stamped by ``labeler.py``):
  cloud.google.com/gke-placement-group   opaque placement group id
  topology.gke.io/cluster|rack|host      the DCN hierarchy
"""

# A mismatch at the outermost level costs DCN_FAR; each matching level
# divides it by DCN_LEVEL_FACTOR (the reference's envelope,
# schedule-daemon.py:66-70).  Every distance carries the DCN_MIN floor,
# as in the JAX package, where it keeps a hop between TPU slices dearer
# than any ICI path; here it shifts every pair alike.
DCN_FAR = 1_000_000.0
DCN_LEVEL_FACTOR = 100.0
DCN_MIN = 1_000.0

PLACEMENT_GROUP_LABEL = "cloud.google.com/gke-placement-group"
CLUSTER_LABEL = "topology.gke.io/cluster"
RACK_LABEL = "topology.gke.io/rack"
HOST_LABEL = "topology.gke.io/host"
DCN_LABELS = (PLACEMENT_GROUP_LABEL, CLUSTER_LABEL, RACK_LABEL, HOST_LABEL)


def node_topology_key(node_info: dict) -> tuple:
    """Sort key: the DCN hierarchy.  A node missing one of its labels
    sorts as an empty key (the reference filters such nodes out earlier,
    schedule-daemon.py:74-91)."""
    labels = node_info["node_labels"]
    if not all(k in labels for k in DCN_LABELS):
        return ()
    return tuple(labels[k] for k in DCN_LABELS)


def node_topology_distance(node1: dict, node2: dict) -> float:
    """Distance between two nodes for the assignment objective: the
    DCN_MIN floor plus DCN_FAR at the first differing level of
    (placement-group, cluster, rack, host), divided by DCN_LEVEL_FACTOR
    for each matching level before it; bare DCN_MIN when all four match.
    """
    k1, k2 = node_topology_key(node1), node_topology_key(node2)
    result = DCN_FAR
    for i in range(min(len(k1), len(k2))):
        if k1[i] != k2[i]:
            return DCN_MIN + result
        result /= DCN_LEVEL_FACTOR
    return DCN_MIN + (0.0 if k1 and k1 == k2 else result)
