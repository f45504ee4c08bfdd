"""The fleet link table: every inter-node DCN frame routes through here.

The port's copy of ``container_engine_accelerators_tpu/fleet/links.py``
(host code: no torch): the same names, counters and spans byte for byte.

The chaos framework so far injects *endpoint* faults — a daemon dies, a
socket drops (utils/faults.py).  Link-level faults are a different
animal: a partitioned rack rejects traffic in BOTH directions while
every endpoint stays healthy; asymmetric loss eats one direction of an
exchange; injected latency stretches a collective without failing it
(TACCL's observation, PAPERS.md).  The :class:`LinkTable` models the
fleet's directed links as explicit state (up/latency/drop-budget) plus
per-link accounting, and :class:`FleetNet` is the delivery fabric the
emulated daemons hand frames to — so EVERY cross-node byte in the rig
passes one inspectable, faultable point.

Link-fault spec grammar (scenario ``link:`` entries)::

    <sel><-><sel>:<action>[:<param>]     both directions
    <sel>-><sel>:<action>[:<param>]      one direction (asymmetric)

    sel     = * | node:<name> | rack:<name>
    action  = partition | heal | latency:<ms> | drop:<k>

    rack:r0<->rack:r1:partition    # rack pair falls off the network
    node:n0->node:n2:latency:5     # 5 ms one-way delay
    *->rack:r1:drop:3              # next 3 frames per link are eaten

A malformed spec entry is logged and skipped — the TPU_FAULT_SPEC rule:
bad chaos config must never take the rig (or an agent) down.
"""

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.fleet.topology import FleetTopology
from container_engine_accelerators_tpu_torch.metrics import counters

log = logging.getLogger(__name__)

# Injected one-way latency is capped so a typo ("latency:5000") cannot
# wedge a scenario: the rig models *relative* slowness, not real WAN RTTs.
MAX_INJECT_LATENCY_S = 0.25


class LinkPartitioned(OSError):
    """A frame hit a partitioned link (the sender's daemon surfaces
    this as a daemon-level op failure, like a real dial timeout)."""


@dataclasses.dataclass
class LinkStats:
    frames: int = 0
    bytes: int = 0
    drops: int = 0       # loss-injection ate the frame in flight
    dups: int = 0        # receiver dedup dropped a replayed frame
    blocked: int = 0     # send rejected: link partitioned
    latency_injected_s: float = 0.0


@dataclasses.dataclass
class LinkState:
    up: bool = True
    latency_s: float = 0.0
    drop_next: int = 0
    stats: LinkStats = dataclasses.field(default_factory=LinkStats)


@dataclasses.dataclass
class LinkFault:
    """One parsed spec entry."""

    sel_a: str
    sel_b: str
    bidirectional: bool
    action: str
    param: float = 0.0

    def spec(self) -> str:
        """Back to grammar form (round logs must stay JSON-clean)."""
        arrow = "<->" if self.bidirectional else "->"
        suffix = ""
        if self.action == "latency":
            suffix = f":{self.param * 1e3:g}"
        elif self.action == "drop":
            suffix = f":{int(self.param)}"
        return f"{self.sel_a}{arrow}{self.sel_b}:{self.action}{suffix}"

    def inverse(self) -> Optional["LinkFault"]:
        """The fault that undoes this one (scenario ``for:`` auto-heal);
        None when there is nothing to undo (a drop budget spends
        itself)."""
        if self.action == "partition":
            return dataclasses.replace(self, action="heal")
        if self.action == "latency":
            return dataclasses.replace(self, param=0.0)
        return None


def parse_link_fault(spec: str) -> Optional[LinkFault]:
    """Parse one grammar entry; None (logged) for malformed input."""
    try:
        if "<->" in spec:
            left, rest = spec.split("<->", 1)
            bidi = True
        elif "->" in spec:
            left, rest = spec.split("->", 1)
            bidi = False
        else:
            raise ValueError("expected '<->' or '->'")
        tokens = rest.split(":")
        if tokens[0] == "*":
            sel_b, tokens = "*", tokens[1:]
        elif len(tokens) >= 2 and tokens[0] in ("node", "rack"):
            sel_b, tokens = f"{tokens[0]}:{tokens[1]}", tokens[2:]
        else:
            raise ValueError(f"bad selector at {rest!r}")
        if not tokens:
            raise ValueError("missing action")
        action, params = tokens[0], tokens[1:]
        param = 0.0
        if action in ("partition", "heal"):
            if params:
                raise ValueError(f"{action} takes no parameter")
        elif action == "latency":
            param = float(params[0]) / 1e3 if params else 0.0
            if param < 0:
                raise ValueError("latency must be >= 0")
        elif action == "drop":
            param = float(int(params[0])) if params else 1.0
            if param < 1:
                raise ValueError("drop count must be >= 1")
        else:
            raise ValueError(f"unknown action {action!r}")
        left = left.strip()
        if not (left == "*" or left.startswith(("node:", "rack:"))):
            raise ValueError(f"bad selector {left!r}")
        return LinkFault(sel_a=left, sel_b=sel_b, bidirectional=bidi,
                         action=action, param=param)
    except (ValueError, IndexError) as e:
        log.error("ignoring malformed link-fault spec %r: %s", spec, e)
        return None


class LinkTable:
    """Directed per-(src, dst) link state for one fleet."""

    def __init__(self, topology: FleetTopology):
        self.topology = topology
        self._links: Dict[Tuple[str, str], LinkState] = {}
        self._lock = threading.Lock()

    def state(self, src: str, dst: str) -> LinkState:
        with self._lock:
            link = self._links.get((src, dst))
            if link is None:
                link = self._links[(src, dst)] = LinkState()
            return link

    def pairs_for(self, fault: LinkFault) -> List[Tuple[str, str]]:
        """The directed node pairs a fault touches (self-links never)."""
        a_nodes = self.topology.select(fault.sel_a)
        b_nodes = self.topology.select(fault.sel_b)
        out = []
        for a in a_nodes:
            for b in b_nodes:
                if a == b:
                    continue
                out.append((a, b))
                if fault.bidirectional:
                    out.append((b, a))
        # Dedup while preserving order (rack:r0<->rack:r0 style overlap).
        seen = set()
        uniq = []
        for p in out:
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        return uniq

    def apply(self, fault_or_spec) -> List[Tuple[str, str]]:
        """Arm one fault (a parsed :class:`LinkFault` or a grammar
        string); returns the directed pairs touched."""
        fault = (fault_or_spec if isinstance(fault_or_spec, LinkFault)
                 else parse_link_fault(fault_or_spec))
        if fault is None:
            return []
        pairs = self.pairs_for(fault)
        for src, dst in pairs:
            link = self.state(src, dst)
            if fault.action == "partition":
                link.up = False
            elif fault.action == "heal":
                link.up = True
                link.latency_s = 0.0
                link.drop_next = 0
            elif fault.action == "latency":
                link.latency_s = min(fault.param, MAX_INJECT_LATENCY_S)
            elif fault.action == "drop":
                link.drop_next += int(fault.param)
        if pairs:
            log.warning("link fault %s armed on %d link(s)",
                        fault.action, len(pairs))
        return pairs

    def snapshot_state(self) -> Dict[Tuple[str, str], dict]:
        """Current fault state per touched directed link — the comm
        graph's evidence source (collectives/topo.py).  Only links the
        table has actually seen (faulted or carried traffic) appear;
        an absent pair means "no evidence", which callers read as
        healthy at its tier's defaults."""
        with self._lock:
            return {
                pair: {
                    "up": link.up,
                    "latency_s": link.latency_s,
                    "drop_next": link.drop_next,
                }
                for pair, link in self._links.items()
            }

    def report(self) -> Dict[str, dict]:
        """Per-link accounting for the fleet report, tier-annotated via
        the production scheduler distance."""
        with self._lock:
            items = list(self._links.items())
        out = {}
        for (src, dst), link in items:
            out[f"{src}->{dst}"] = {
                "tier": self.topology.tier(src, dst),
                "up": link.up,
                "frames": link.stats.frames,
                "bytes": link.stats.bytes,
                "drops": link.stats.drops,
                "dups": link.stats.dups,
                "blocked": link.stats.blocked,
                "latency_injected_ms": round(
                    link.stats.latency_injected_s * 1e3, 3
                ),
            }
        return out


class FleetNet:
    """The delivery fabric: routes a sending daemon's frames to the
    destination daemon through the link table.

    Registration is by data port — the same address a real client would
    dial — so the daemons stay protocol-faithful: ``send`` still takes
    (host, port), and the fabric resolves which emulated node owns it.
    """

    def __init__(self, table: LinkTable):
        self.table = table
        self._by_port: Dict[int, Tuple[str, object]] = {}
        self._lock = threading.Lock()

    def register(self, node: str, daemon) -> None:
        with self._lock:
            # A restarted daemon binds a fresh port; drop stale entries
            # for the node so the table never routes to a dead object.
            for port, (name, _d) in list(self._by_port.items()):
                if name == node:
                    del self._by_port[port]
            self._by_port[int(daemon.data_port)] = (node, daemon)

    def unregister(self, node: str) -> None:
        with self._lock:
            for port, (name, _d) in list(self._by_port.items()):
                if name == node:
                    del self._by_port[port]

    def lookup(self, port: int) -> Optional[Tuple[str, object]]:
        with self._lock:
            return self._by_port.get(int(port))

    def deliver(self, src: str, host: str, port: int, flow: str,
                payload: bytes, seq: Optional[int], meta: dict) -> str:
        """Route one frame src → (host, port).  Returns the landing
        verdict ("landed" / "dup" / "dropped" / "unmatched"); raises
        :class:`LinkPartitioned` when the link is down (the sender's op
        fails, exactly like a dial into a null route)."""
        entry = self.lookup(port)
        if entry is None:
            raise LinkPartitioned(
                f"no fleet node listens on port {port} (node down?)"
            )
        dst, daemon = entry
        link = self.table.state(src, dst)
        if not link.up:
            link.stats.blocked += 1
            counters.inc("fleet.link.blocked")
            raise LinkPartitioned(f"link {src}->{dst} partitioned")
        if link.drop_next > 0:
            # Loss: the sender believes the frame left; the receiver
            # never sees it.  The retransmit (same seq) lands cleanly —
            # the dedup window only rejects seqs that actually LANDED.
            link.drop_next -= 1
            link.stats.drops += 1
            counters.inc("fleet.link.dropped")
            return "dropped"
        if link.latency_s > 0:
            time.sleep(link.latency_s)
            link.stats.latency_injected_s += link.latency_s
        verdict = daemon.land_frame(flow, payload, seq, meta,
                                    link=(src, dst))
        if verdict == "dup":
            link.stats.dups += 1
        else:
            link.stats.frames += 1
            link.stats.bytes += len(payload)
        return verdict
