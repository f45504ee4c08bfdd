"""Topology-aware scheduling daemon for gated GPU job pods (the JAX
package's ``scheduler/daemon.py`` for ``nvidia.com/gpu``).

As the reference scheduler
(ref: gpudirect-tcpxo/topology-scheduler/schedule-daemon.py):

- pods carrying a scheduling gate prefixed ``gke.io/topology-aware-auto-``
  are collected per gate (:197-205), grouped by job and FIFO-ordered by
  creation time (:26-37,368-369);
- candidate nodes must carry topology labels, have every taint tolerated,
  and have free capacity = allocatable − Σ(requests of pods already on
  the node) (:127-194), in CPU, memory and ``nvidia.com/gpu``
  (``deviceplugin/api.py::RESOURCE_NAME``, the resource the port's
  device plugin advertises; a ``google.com/tpu`` request takes none);
- pods sorted by completion index, nodes by topology key; an exhaustive
  increasing-index search picks the assignment minimizing the summed
  neighbor distance (:329-360) — the DCN hierarchy (``topology.py``);
- binding removes the gate and pins ``kubernetes.io/hostname`` via
  required nodeAffinity, then PUTs the pod back (:298-326).

Everything works on plain Kubernetes-JSON dicts, so the whole flow runs
against fixture dicts with no cluster.
"""

import logging
import time
from itertools import groupby
from typing import Callable, Dict, List, Optional, Set

from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    RESOURCE_NAME,
)
from container_engine_accelerators_tpu_torch.scheduler.k8s import (
    ApiException,
    CoreV1,
)
from container_engine_accelerators_tpu_torch.scheduler.quantity import (
    parse_quantity,
)
from container_engine_accelerators_tpu_torch.scheduler.topology import (
    PLACEMENT_GROUP_LABEL,
    node_topology_distance,
    node_topology_key,
)

log = logging.getLogger(__name__)

DEFAULT_GATE_PREFIX = "gke.io/topology-aware-auto-"
GPU_RESOURCE = RESOURCE_NAME
JOB_NAME_LABEL = "job-name"
COMPLETION_INDEX_LABEL = "batch.kubernetes.io/job-completion-index"


# ---- pod/job ordering ------------------------------------------------------


def split_pods_based_on_jobs(pods) -> List[List[dict]]:
    """Group schedulable-pod dicts by job name (consecutive groupby, as in
    the reference; callers sort groups by creation time right after)."""
    return [
        list(group)
        for _, group in groupby(pods, key=lambda p: p.get("job_name"))
    ]


def job_creation_time(job: List[dict]):
    return job[0].get("creation_time") or ""


def pod_sorting_key(pod: dict):
    """Uniform 3-tuple key: indexed pods first by completion index, then
    unindexed pods by (name-prefix, numeric-suffix) so 'xxx-pod2' sorts
    before 'xxx-pod10'.

    The reference returns ``int`` for indexed pods and ``tuple`` for
    unindexed ones (schedule-daemon.py:40-50), so a job mixing both
    crashes ``sorted()`` with a TypeError; one key shape fixes that
    without changing the order within either class.
    """
    if pod.get("index") is not None:
        return (0, "", int(pod["index"]))
    name = pod["name"]
    stripped = name.rstrip("0123456789")
    suffix = name[len(stripped):]
    return (1, stripped, int(suffix) if suffix else 0)


# ---- discovery -------------------------------------------------------------


def find_pod_gates(pods: List[dict], prefix: str) -> Set[str]:
    """All gate names with the topology prefix across pending pods."""
    gates = set()
    for pod in pods:
        for g in pod.get("spec", {}).get("schedulingGates", []) or []:
            if g.get("name", "").startswith(prefix):
                gates.add(g["name"])
    return gates


def _container_requests(spec: dict):
    cpu = mem = gpu = 0.0
    for container in spec.get("containers", []):
        req = (container.get("resources") or {}).get("requests") or {}
        cpu += parse_quantity(req.get("cpu", 0))
        mem += parse_quantity(req.get("memory", 0))
        gpu += int(parse_quantity(req.get(GPU_RESOURCE, 0)))
    return cpu, mem, gpu


def find_schedulable_pods(pods: List[dict], gate_name: str) -> Dict[str, dict]:
    """Pods still carrying ``gate_name``, flattened to scheduling records."""
    out = {}
    for pod in pods:
        spec = pod.get("spec", {})
        if not any(
            g.get("name") == gate_name
            for g in spec.get("schedulingGates", []) or []
        ):
            continue
        meta = pod.get("metadata", {})
        labels = meta.get("labels") or {}
        cpu, mem, gpu = _container_requests(spec)
        rec = {
            "name": meta.get("name"),
            "namespace": meta.get("namespace", "default"),
            "index": labels.get(COMPLETION_INDEX_LABEL),
            "job_name": labels.get(JOB_NAME_LABEL),
            "creation_time": meta.get("creationTimestamp"),
            "cpu": cpu,
            "memory": mem,
            "gpu": gpu,
            "node_selector": spec.get("nodeSelector"),
            "tolerations": spec.get("tolerations") or [],
        }
        out[rec["name"]] = rec
        log.info(
            "schedulable pod %s/%s cpu=%s mem=%s gpu=%s index=%s",
            rec["namespace"], rec["name"], cpu, mem, gpu, rec["index"],
        )
    return out


def _pod_used_resources(pod: dict):
    """Requests of a pod already placed on a node; terminated containers
    free their share (ref: schedule-daemon.py:94-109)."""
    statuses = (pod.get("status") or {}).get("containerStatuses")
    spec = pod.get("spec", {})
    if statuses is None:
        return _container_requests(spec)
    cpu = mem = gpu = 0.0
    for container, st in zip(spec.get("containers", []), statuses):
        if (st.get("state") or {}).get("terminated") is not None:
            continue
        req = (container.get("resources") or {}).get("requests") or {}
        cpu += parse_quantity(req.get("cpu", 0))
        mem += parse_quantity(req.get("memory", 0))
        gpu += int(parse_quantity(req.get(GPU_RESOURCE, 0)))
    return cpu, mem, gpu


def pods_tolerations(job: List[dict]) -> List[dict]:
    """Jobs are homogeneous: all pods share one toleration set."""
    return job[0].get("tolerations") or [] if job else []


def _toleration_matches(tol: dict, taint: dict) -> bool:
    """Kubernetes toleration semantics (the reference collapses these to
    a key lookup, schedule-daemon.py:127-194; the JAX package, and so
    this copy, implements the real rules):

    - empty toleration key + operator Exists tolerates every taint;
    - operator Exists ignores ``value`` (the API rejects Exists+value,
      but a hand-written manifest may carry one — ignore it here too);
    - operator Equal (the default) compares values;
    - empty toleration effect matches all effects, otherwise exact.
    """
    op = tol.get("operator") or "Equal"
    key = tol.get("key")
    if not key:
        if op != "Exists":
            return False
    elif key != taint.get("key"):
        return False
    if op != "Exists" and (tol.get("value") or "") != (taint.get("value") or ""):
        return False
    eff = tol.get("effect") or ""
    return eff == "" or eff == taint.get("effect")


def _taints_tolerated(taints, tolerations) -> bool:
    """True when no *blocking* taint is left untolerated.

    ``PreferNoSchedule`` is a soft preference — the real kube-scheduler
    still places pods on such nodes, so it never disqualifies a
    candidate here.  ``NoSchedule``/``NoExecute`` (and any unknown or
    missing effect, conservatively) block unless tolerated.
    ``tolerationSeconds`` bounds post-placement eviction on NoExecute,
    not admission, so it is rightly ignored at scheduling time.
    """
    for taint in taints or []:
        if taint.get("effect") == "PreferNoSchedule":
            continue
        if not any(_toleration_matches(t, taint) for t in tolerations or []):
            return False
    return True


def find_schedulable_nodes(
    nodes: List[dict], pods: List[dict], tolerations: List[dict]
) -> Dict[str, dict]:
    """Topology-labeled, untainted-or-tolerated nodes with free capacity."""
    out = {}
    for node in nodes:
        meta = node.get("metadata", {})
        name = meta.get("name")
        labels = meta.get("labels") or {}
        if PLACEMENT_GROUP_LABEL not in labels:
            log.info("skipping node %s: no topology metadata", name)
            continue
        if not _taints_tolerated(node.get("spec", {}).get("taints"), tolerations):
            log.info("skipping node %s: untolerated taint", name)
            continue

        alloc = (node.get("status") or {}).get("allocatable") or {}
        free_cpu = parse_quantity(alloc.get("cpu", 0))
        free_mem = parse_quantity(alloc.get("memory", 0))
        free_gpu = int(parse_quantity(alloc.get(GPU_RESOURCE, 0)))
        for pod in pods:
            if pod.get("spec", {}).get("nodeName") == name:
                cpu, mem, gpu = _pod_used_resources(pod)
                free_cpu -= cpu
                free_mem -= mem
                free_gpu -= gpu

        info = {
            "name": name,
            "cpu": free_cpu,
            "memory": free_mem,
            "gpu": free_gpu,
            "node_labels": labels,
        }
        out[name] = info
        log.info(
            "candidate node %s cpu=%s mem=%s gpu=%s key=%s",
            name, free_cpu, free_mem, free_gpu, node_topology_key(info),
        )
    return out


# ---- assignment search -----------------------------------------------------


def can_schedule(node: dict, pod: dict) -> bool:
    selector = pod.get("node_selector")
    labels = node["node_labels"]
    if selector:
        for key, value in selector.items():
            if labels.get(key) != value:
                return False
    return (
        node["cpu"] >= pod["cpu"]
        and node["memory"] >= pod["memory"]
        and node["gpu"] >= pod["gpu"]
    )


def calculate_pods_assignment(
    sorted_nodes: List[dict],
    sorted_pods: List[dict],
    search_budget_s: Optional[float] = 2.0,
    link_penalty: Optional[Callable[[dict, dict], float]] = None,
) -> List[int]:
    """Exhaustive strictly-increasing-index assignment search minimizing
    Σ distance(consecutive pods' nodes) (ref: schedule-daemon.py:329-360).

    Node order is the topology sort, so increasing indices enumerate
    physically-contiguous candidate sets; strict monotonicity both halves
    the search space and enforces one pod per node.

    The raw search is exponential in the worst case — C(nodes, pods)
    candidate sets, so a 200-node pool with a 64-pod job would hang the
    daemon's 1 s loop (the reference has no guard).
    ``search_budget_s`` caps wall-clock: on expiry the best assignment
    found so far is returned (the search reaches its first feasible —
    lexicographically smallest, i.e. most topology-packed-prefix —
    assignment almost immediately, so a truncated answer is still a
    valid, usually near-optimal placement).  Pass ``None`` to search
    exhaustively.

    ``link_penalty`` is the optional link-health annotation source
    (``collectives.topo.CommGraph.scheduler_link_penalty`` or a
    ``LinkHealthPenalty``): a callable adding a distance surcharge between two candidate nodes
    when the fabric between them is known partitioned or lossy.  The
    packer then *avoids* nodes behind bad links whenever a healthier
    placement exists, and — because a penalty is finite, never a veto
    — still returns the least-bad assignment when nothing healthy
    fits (capacity over purity: a degraded placement beats no
    placement).
    """
    if not sorted_pods:
        return []

    def _distance(a: dict, b: dict) -> float:
        d = node_topology_distance(a, b)
        if link_penalty is not None:
            d += link_penalty(a, b)
        return d
    assignment = [-i for i in reversed(range(1, len(sorted_pods) + 1))]
    best, best_distance = [], float("inf")
    deadline = (
        time.monotonic() + search_budget_s
        if search_budget_s is not None else None
    )
    iters = 0

    while True:
        iters += 1
        if deadline is not None and iters % 1024 == 0 \
                and time.monotonic() >= deadline:
            log.warning(
                "assignment search budget (%.1fs) exhausted after %d "
                "candidates (%d nodes, %d pods); returning best found",
                search_budget_s, iters, len(sorted_nodes), len(sorted_pods),
            )
            break
        all_ok = True
        i = len(assignment) - 1
        while i >= 0 and all_ok:
            assignment[i] += 1
            if assignment[i] == len(sorted_nodes):
                break
            if assignment[i] >= 0 and can_schedule(
                sorted_nodes[assignment[i]], sorted_pods[i]
            ):
                i -= 1
            elif i < len(assignment) - 1 and assignment[i] == assignment[i + 1] - 1:
                all_ok = False
        if assignment[-1] == len(sorted_nodes):
            break
        if all_ok:
            distance = sum(
                _distance(
                    sorted_nodes[assignment[i]], sorted_nodes[assignment[i - 1]]
                )
                for i in range(1, len(sorted_pods))
            )
            if distance < best_distance:
                best, best_distance = assignment.copy(), distance

    return best


# ---- binding ---------------------------------------------------------------


def schedule_pod_on_node(
    api: CoreV1, pod_name: str, namespace: str, node_name: str, gate_name: str
) -> bool:
    """Remove the gate, pin the hostname via nodeAffinity, PUT the pod."""
    try:
        pod = api.read_namespaced_pod(pod_name, namespace)
        gates = pod.get("spec", {}).get("schedulingGates", []) or []
        if not any(g.get("name") == gate_name for g in gates):
            return False
        pod["spec"]["schedulingGates"] = [
            g for g in gates if g.get("name") != gate_name
        ]
        pod["spec"]["affinity"] = {
            "nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{
                        "matchExpressions": [{
                            "key": "kubernetes.io/hostname",
                            "operator": "In",
                            "values": [node_name],
                        }]
                    }]
                }
            }
        }
        api.replace_namespaced_pod(pod_name, namespace, pod)
        log.info("pod %s/%s scheduled on %s", namespace, pod_name, node_name)
        return True
    except ApiException as e:
        log.error("binding %s/%s failed: %s", namespace, pod_name, e)
        return False


# ---- daemon ----------------------------------------------------------------


class SchedulerDaemon:
    def __init__(
        self,
        api: CoreV1,
        gate_prefix: str = DEFAULT_GATE_PREFIX,
        interval_s: float = 1.0,
        ignored_namespaces: Optional[List[str]] = None,
        settle_s: float = 5.0,
        sleep=time.sleep,
        search_budget_s: Optional[float] = 2.0,
        link_penalty: Optional[Callable[[dict, dict], float]] = None,
    ):
        self.api = api
        self.gate_prefix = gate_prefix
        self.interval_s = interval_s
        self.ignored_namespaces = set(ignored_namespaces or [])
        self.settle_s = settle_s  # job-atomicity heuristic (ref :455-457)
        self._sleep = sleep
        # Per-job cap on the assignment search (None = exhaustive).
        self.search_budget_s = search_budget_s
        # Optional link-health annotation source (see
        # calculate_pods_assignment).  The callable is consulted per
        # pass; whether it sees faults armed between passes is its own
        # contract.
        self.link_penalty = link_penalty

    def list_pods(self) -> List[dict]:
        pods = []
        for ns in self.api.list_namespaces():
            name = ns.get("metadata", {}).get("name")
            if name and name not in self.ignored_namespaces:
                pods.extend(self.api.list_namespaced_pods(name))
        return pods

    def schedule_gate(self, pods: List[dict], gate: str) -> int:
        """One pass for one gate; returns the number of pods bound."""
        pods_to_schedule = find_schedulable_pods(pods, gate)
        nodes = self.api.list_nodes()
        log.info("gate %s: %d pods to schedule", gate, len(pods_to_schedule))

        bound = 0
        jobs = split_pods_based_on_jobs(pods_to_schedule.values())
        for job in sorted(jobs, key=job_creation_time):
            job_name = job[0].get("job_name")
            candidates = find_schedulable_nodes(nodes, pods, pods_tolerations(job))
            sorted_pods = sorted(job, key=pod_sorting_key)
            sorted_nodes = sorted(candidates.values(), key=node_topology_key)
            assignment = calculate_pods_assignment(
                sorted_nodes, sorted_pods,
                search_budget_s=self.search_budget_s,
                link_penalty=self.link_penalty,
            )
            if not assignment:
                log.info("no placement for job %s under gate %s", job_name, gate)
                continue
            for i, pod in enumerate(sorted_pods):
                node = sorted_nodes[assignment[i]]
                if schedule_pod_on_node(
                    self.api, pod["name"], pod["namespace"], node["name"], gate
                ):
                    bound += 1
        return bound

    def run_once(self) -> int:
        pods = self.list_pods()
        gates = find_pod_gates(pods, self.gate_prefix)
        log.info("%d pods, %d gates", len(pods), len(gates))
        if not gates:
            return 0
        self._sleep(self.settle_s)
        bound = 0
        for gate in gates:
            pods = self.list_pods()  # re-list: stragglers may have appeared
            bound += self.schedule_gate(pods, gate)
        return bound

    def run_forever(self):
        while True:
            t0 = time.time()
            try:
                self.run_once()
            except ApiException as e:
                log.error("scheduling pass failed: %s", e)
            elapsed = time.time() - t0
            if elapsed < self.interval_s:
                self._sleep(self.interval_s - elapsed)
