"""Fleet topology model: hosts and racks, scheduler labels reused.

The port's copy of ``container_engine_accelerators_tpu/fleet/
topology.py`` (host code: no torch).  A simulated fleet node carries
the SAME label set the node labeler stamps and the topology scheduler
sorts on (``scheduler/topology.py``), so the simulator and the
production placement logic agree about what is "near": two nodes in one
rack are one DCN tier apart, two racks are two, and the classification
below is computed with the production ``node_topology_distance`` — not
re-derived ad hoc.

An H100 node's NVLink domain is the host itself, so the port's
scheduler has no ICI tier: every pair of nodes is at least ``DCN_MIN``
apart and :meth:`FleetTopology.tier` never answers ``"ici"``.  A
scenario's ``slice`` / ``coords`` / ``topology`` fields are accepted
and carried into the report; they move no distance.
"""

import dataclasses
from typing import Dict, List, Optional

from container_engine_accelerators_tpu_torch.scheduler import topology as topo

# Link tiers, from the production distance function's point of view.
# TIER_ICI stays for the collective engine's cost tables and for
# reports read by both packages; the port's distance never yields it.
TIER_ICI = "ici"
TIER_INTRA_RACK = "intra-rack"  # same rack: one DCN tier
TIER_CROSS_RACK = "cross-rack"  # different rack: the expensive links

# The chip a scenario's chip fault names when it names none: the first
# GPU (the JAX package's default is its first TPU chip, "accel0").
DEFAULT_CHIP = "nvidia0"


@dataclasses.dataclass
class NodeSpec:
    """One simulated host: identity, placement, and its GPUs."""

    name: str
    rack: str = "r0"
    cluster: str = "c0"
    placement_group: str = "pg0"
    slice_id: Optional[str] = None  # carried; no effect on distance
    chips: int = 4  # GPUs on the node
    topology: str = "2x2x1"  # carried into the report; no effect
    partition_size: str = ""  # a MIG profile, e.g. "3g.40gb"
    coords: str = "0,0,0"  # carried; no effect on distance

    def labels(self) -> Dict[str, str]:
        """The label set label_nodes.py would stamp on this host."""
        return {
            topo.PLACEMENT_GROUP_LABEL: self.placement_group,
            topo.CLUSTER_LABEL: self.cluster,
            topo.RACK_LABEL: self.rack,
            topo.HOST_LABEL: self.name,
        }

    def node_info(self) -> dict:
        """The shape scheduler.topology functions consume."""
        return {"node_labels": self.labels()}


class FleetTopology:
    """The fleet's node set plus selector and distance queries."""

    def __init__(self, specs: List[NodeSpec]):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in fleet: {names}")
        self.specs: Dict[str, NodeSpec] = {s.name: s for s in specs}

    def __contains__(self, name: str) -> bool:
        return name in self.specs

    def names(self) -> List[str]:
        return list(self.specs)

    def select(self, selector: str) -> List[str]:
        """Resolve a fleet selector to node names.

        ``*`` = every node, ``node:<name>`` = that node,
        ``rack:<name>`` = every node in the rack.  Unknown selectors
        resolve empty (a scenario naming a missing rack should produce
        an empty fault, not a crash mid-run).
        """
        if selector == "*":
            return self.names()
        kind, _, value = selector.partition(":")
        if kind == "node":
            return [value] if value in self.specs else []
        if kind == "rack":
            return [n for n, s in self.specs.items() if s.rack == value]
        return []

    def distance(self, a: str, b: str) -> float:
        """Production scheduler distance between two fleet nodes."""
        return topo.node_topology_distance(
            self.specs[a].node_info(), self.specs[b].node_info()
        )

    def tier(self, a: str, b: str) -> str:
        """Classify the (a, b) link by the production distance: below
        the DCN floor would be ICI (the port's distance never is);
        same-rack labels are one tier, cross-rack the other."""
        if self.distance(a, b) < topo.DCN_MIN:
            return TIER_ICI
        if self.specs[a].rack == self.specs[b].rack:
            return TIER_INTRA_RACK
        return TIER_CROSS_RACK


def build_specs(
    num_nodes: int,
    racks: int = 1,
    chips: int = 4,
    topology: str = "2x2x1",
    partition_size: str = "",
) -> List[NodeSpec]:
    """Round-robin ``num_nodes`` hosts over ``racks`` racks — the quick
    path for scenario specs that give counts instead of explicit node
    lists."""
    if num_nodes < 1 or racks < 1:
        raise ValueError("need at least one node and one rack")
    return [
        NodeSpec(
            name=f"n{i}",
            rack=f"r{i % racks}",
            chips=chips,
            topology=topology,
            partition_size=partition_size,
        )
        for i in range(num_nodes)
    ]
