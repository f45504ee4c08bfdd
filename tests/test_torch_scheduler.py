"""The port's topology-aware scheduler for ``nvidia.com/gpu`` against the
JAX package's for ``google.com/tpu``.

Fleets and gated jobs are drawn from a numpy seed: 2-4 clusters, racks
and hosts a level (a subset of at most 16 nodes, two placement groups,
a node without topology labels), taints, capacity already taken by bound
pods (some of whose containers have terminated), and 1-3 gated jobs of
2-4 pods under two gates, with tolerations, node selectors, indexed and
named pods and creation times out of order.  The same dicts go to both
packages, with ``google.com/tpu`` on the JAX side and ``nvidia.com/gpu``
on the port's; everything else is compared exactly: keys, distances,
candidate nodes and their free capacity, orders, the exhaustive
assignment (``search_budget_s=None``: the default budget is wall clock,
and a truncated search is not reproducible), the assignment under one
plain ``link_penalty`` callable, and ``run_once``'s PUT bodies.
"""

import itertools
import json

import numpy as np
import pytest

import torch_k8s_helpers as K
from container_engine_accelerators_tpu.scheduler import daemon as jd
from container_engine_accelerators_tpu.scheduler import k8s as jk8s
from container_engine_accelerators_tpu.scheduler import quantity as jq
from container_engine_accelerators_tpu.scheduler import topology as jt
from container_engine_accelerators_tpu_torch.cmd import topology_scheduler
from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    RESOURCE_NAME,
)
from container_engine_accelerators_tpu_torch.scheduler import daemon as pd
from container_engine_accelerators_tpu_torch.scheduler import k8s as pk8s
from container_engine_accelerators_tpu_torch.scheduler import quantity as pq
from container_engine_accelerators_tpu_torch.scheduler import topology as pt

TPU = jd.TPU_RESOURCE
GPU = RESOURCE_NAME
SEEDS = range(8)
GATE = jd.DEFAULT_GATE_PREFIX


def test_resource_is_the_device_plugins():
    assert pd.GPU_RESOURCE == GPU == "nvidia.com/gpu"


# ---- seeded fleets ---------------------------------------------------------


def draw_fleet(seed, resource):
    """(nodes, pods) as Kubernetes JSON, ``resource`` the accelerator
    key of every allocatable and request."""
    rng = np.random.default_rng(seed)
    n_clusters, n_racks, n_hosts = (int(v) for v in rng.integers(2, 5, 3))
    places = list(itertools.product(range(n_clusters), range(n_racks),
                                    range(n_hosts)))
    keep = sorted(rng.choice(len(places), min(len(places), 16),
                             replace=False))
    nodes = []
    for i, k in enumerate(keep):
        c, r, h = places[k]
        name = f"node-{i:02d}"
        labels = {jt.PLACEMENT_GROUP_LABEL: f"pg{int(rng.random() < 0.2)}",
                  jt.CLUSTER_LABEL: f"c{c}", jt.RACK_LABEL: f"c{c}-r{r}",
                  jt.HOST_LABEL: f"c{c}-r{r}-h{h}"}
        if i == 0:
            labels = {}  # no topology metadata: never a candidate
        taints = []
        if rng.random() < 0.25:
            taints.append({"key": "dedicated", "value": "ml",
                           "effect": str(rng.choice(
                               ["NoSchedule", "NoExecute",
                                "PreferNoSchedule"]))})
        nodes.append({
            "metadata": {"name": name, "labels": labels},
            "spec": {"taints": taints},
            "status": {"allocatable": {
                "cpu": str(int(rng.choice([16, 32]))), "memory": "64Gi",
                resource: str(int(rng.choice([4, 8, 8])))}},
        })
    pods = []
    for i, node in enumerate(nodes):
        if rng.random() < 0.35:
            n_ctr = int(rng.integers(1, 3))
            pod = _pod(f"bound-{i}", None, None, resource,
                       int(rng.choice([1, 2, 4])), n_ctr=n_ctr)
            pod["spec"]["nodeName"] = node["metadata"]["name"]
            if rng.random() < 0.5:
                pod["status"]["containerStatuses"] = [
                    {"state": {"terminated": {}} if j == 0 and n_ctr > 1
                     else {"running": {}}} for j in range(n_ctr)]
            pods.append(pod)
    for j in range(int(rng.integers(1, 4))):
        job = f"job-{j}"
        gate = GATE + str(rng.choice(["pool-a", "pool-b"]))
        gpus = int(rng.choice([1, 2, 4, 8]))
        indexed = rng.random() < 0.7
        tol = rng.random() < 0.5
        selector = ({jt.PLACEMENT_GROUP_LABEL: "pg0"}
                    if rng.random() < 0.3 else None)
        created = f"2026-01-0{int(rng.integers(1, 10))}T00:00:0{j}Z"
        for k in rng.permutation(int(rng.integers(2, 5))):
            pod = _pod(f"{job}-pod{k}", job, gate, resource, gpus,
                       index=int(k) if indexed else None, created=created)
            if tol:
                pod["spec"]["tolerations"] = [
                    {"key": "dedicated", "operator": "Equal",
                     "value": "ml"}]
            if selector:
                pod["spec"]["nodeSelector"] = selector
            pods.append(pod)
    return nodes, pods


def _pod(name, job, gate, resource, gpus, index=None, n_ctr=1,
         created="2026-01-01T00:00:00Z"):
    containers = [{"name": f"c{j}", "resources": {"requests": {
        "cpu": "500m", "memory": "1Gi", resource: str(gpus)}}}
        for j in range(n_ctr)]
    labels = {}
    if job:
        labels[jd.JOB_NAME_LABEL] = job
    if index is not None:
        labels[jd.COMPLETION_INDEX_LABEL] = str(index)
    spec = {"containers": containers}
    if gate:
        spec["schedulingGates"] = [{"name": gate}]
    return {"metadata": {"name": name, "namespace": "default",
                         "labels": labels, "creationTimestamp": created},
            "spec": spec, "status": {}}


def _plain(obj):
    """``obj`` as JSON reads it back (tuples become lists)."""
    return json.loads(json.dumps(obj))


def _as_port(obj):
    """A JAX-side value with the port's names, as JSON reads it back: the
    resource key and the records' ``tpu`` field renamed."""
    text = json.dumps(obj).replace(TPU, GPU).replace('"tpu":', '"gpu":')
    return json.loads(text)


def _infos(nodes):
    return [{"name": n["metadata"]["name"],
             "node_labels": n["metadata"]["labels"]} for n in nodes]


def _jobs(mod, nodes, pods):
    """Per gate (sorted), per job in FIFO order: (sorted candidate
    nodes, sorted pods)."""
    out = []
    for gate in sorted(mod.find_pod_gates(pods, GATE)):
        schedulable = mod.find_schedulable_pods(pods, gate)
        jobs = mod.split_pods_based_on_jobs(schedulable.values())
        for job in sorted(jobs, key=mod.job_creation_time):
            cands = mod.find_schedulable_nodes(nodes, pods,
                                               mod.pods_tolerations(job))
            out.append((sorted(cands.values(), key=mod.node_topology_key),
                        sorted(job, key=mod.pod_sorting_key)))
    return out


# ---- quantity --------------------------------------------------------------


@pytest.mark.parametrize("raw", [
    "100m", "2", "1Gi", "1G", "512Ki", 4, None, "", "1.5", "100n", "250u",
    "not-a-number", "12QQ", "1.5Gi", "2e3", "3Ei"])
def test_parse_quantity_equals_jax(raw):
    assert pq.parse_quantity(raw) == jq.parse_quantity(raw)


# ---- topology --------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_distances_equal_jax(seed):
    infos = _infos(draw_fleet(seed, GPU)[0]) + [{"node_labels": {}}]
    for a in infos:
        assert pt.node_topology_key(a) == jt.node_topology_key(a)
    for a, b in itertools.product(infos, repeat=2):
        assert (pt.node_topology_distance(a, b)
                == jt.node_topology_distance(a, b)), (a, b)


def test_tpu_slice_labels_change_nothing_in_the_port():
    """The port has no ICI tier: slice, coordinate and mesh labels move
    no key and no distance (the JAX package scores such a pair in ICI
    hops)."""
    infos = _infos(draw_fleet(0, GPU)[0])[1:]
    tagged = [{"node_labels": dict(
        i["node_labels"], **{jt.SLICE_LABEL: "s0",
                             jt.COORDS_LABEL: f"{n},0,0",
                             jt.TPU_TOPOLOGY_LABEL: "16x1x1"})}
        for n, i in enumerate(infos)]
    for (a, b), (ta, tb) in zip(itertools.product(infos, repeat=2),
                                itertools.product(tagged, repeat=2)):
        assert pt.node_topology_key(ta) == pt.node_topology_key(a)
        assert (pt.node_topology_distance(ta, tb)
                == pt.node_topology_distance(a, b))
    assert jt.node_topology_distance(tagged[0], tagged[1]) == 1.0


# ---- candidates, orders, assignments ----------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_candidates_and_orders_equal_jax(seed):
    jnodes, jpods = draw_fleet(seed, TPU)
    nodes, pods = draw_fleet(seed, GPU)
    assert pd.find_pod_gates(pods, GATE) == jd.find_pod_gates(jpods, GATE)
    got, want = _jobs(pd, nodes, pods), _jobs(jd, jnodes, jpods)
    assert _plain(got) == _as_port(want)
    assert got, "the fleet has no gated job"


@pytest.mark.parametrize("seed", SEEDS)
def test_exhaustive_assignment_equals_jax(seed):
    jnodes, jpods = draw_fleet(seed, TPU)
    nodes, pods = draw_fleet(seed, GPU)
    for (sn, sp), (jsn, jsp) in zip(_jobs(pd, nodes, pods),
                                    _jobs(jd, jnodes, jpods)):
        assert (pd.calculate_pods_assignment(sn, sp, search_budget_s=None)
                == jd.calculate_pods_assignment(jsn, jsp,
                                                search_budget_s=None))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_link_penalty_assignment_equals_jax(seed):
    """One plain callable on both sides: a surcharge on every pair that
    touches a host drawn as behind a bad link."""
    nodes, pods = draw_fleet(seed, GPU)
    jnodes, jpods = draw_fleet(seed, TPU)
    rng = np.random.default_rng(100 + seed)
    bad = {n["metadata"]["name"] for n in nodes if rng.random() < 0.3}

    def penalty(a, b):
        return 5e5 * ((a["name"] in bad) + (b["name"] in bad))

    assert bad
    for (sn, sp), (jsn, jsp) in zip(_jobs(pd, nodes, pods),
                                    _jobs(jd, jnodes, jpods)):
        assert (pd.calculate_pods_assignment(sn, sp, search_budget_s=None,
                                             link_penalty=penalty)
                == jd.calculate_pods_assignment(jsn, jsp,
                                                search_budget_s=None,
                                                link_penalty=penalty))


def _run_once(mod, k8s, seed, resource):
    nodes, pods = draw_fleet(seed, resource)
    cluster = K.FakeCluster(nodes, pods)
    daemon = mod.SchedulerDaemon(k8s.CoreV1(cluster.transport), settle_s=0,
                                 sleep=lambda s: None, search_budget_s=None)
    return daemon.run_once(), cluster.writes


@pytest.mark.parametrize("seed", SEEDS)
def test_run_once_put_bodies_equal_jax(seed):
    bound, writes = _run_once(pd, pk8s, seed, GPU)
    jbound, jwrites = _run_once(jd, jk8s, seed, TPU)
    assert bound == jbound
    assert _plain(writes) == _as_port(jwrites)
    for method, _, body in writes:
        assert method == "PUT"
        assert not any(g["name"].startswith(GATE)
                       for g in body["spec"]["schedulingGates"])
        term = body["spec"]["affinity"]["nodeAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"][
            "nodeSelectorTerms"][0]["matchExpressions"][0]
        assert term["key"] == "kubernetes.io/hostname"


def test_seeded_fleets_bind_pods():
    """The seeds above exercise binding, not only refusals."""
    assert sum(_run_once(pd, pk8s, s, GPU)[0] for s in SEEDS) > 0


# ---- one resource each -------------------------------------------------------


def _two_resource_node():
    return {"metadata": {"name": "n", "labels": {
        jt.PLACEMENT_GROUP_LABEL: "pg0", jt.CLUSTER_LABEL: "c",
        jt.RACK_LABEL: "r", jt.HOST_LABEL: "h"}},
        "spec": {}, "status": {"allocatable": {
            "cpu": "8", "memory": "8Gi", GPU: "8", TPU: "4"}}}


@pytest.mark.parametrize("resource", [TPU, GPU])
def test_a_request_takes_only_its_own_resource(resource):
    """A pod requesting only ``google.com/tpu`` takes no GPU capacity in
    the port, as the JAX scheduler ignores ``nvidia.com/gpu``."""
    bound = _pod("b", None, None, resource, 4)
    bound["spec"]["nodeName"] = "n"
    port = pd.find_schedulable_nodes([_two_resource_node()], [bound], [])
    jax = jd.find_schedulable_nodes([_two_resource_node()], [bound], [])
    assert port["n"]["gpu"] == (4 if resource == GPU else 8)
    assert jax["n"]["tpu"] == (0 if resource == TPU else 4)
    gated = _pod("g", "j", GATE + "x", resource, 4)
    assert pd.find_schedulable_pods([gated], GATE + "x")["g"]["gpu"] == (
        4 if resource == GPU else 0)


# ---- tolerations -------------------------------------------------------------


TAINT = {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}


@pytest.mark.parametrize("taints,tolerations", [
    ([TAINT], []),
    ([TAINT], [{"key": "dedicated", "operator": "Equal", "value": "ml"}]),
    ([TAINT], [{"key": "dedicated", "value": "other"}]),
    ([TAINT], [{"key": "dedicated", "operator": "Exists", "value": "x"}]),
    ([TAINT], [{"operator": "Exists"}]),
    ([TAINT], [{"key": "", "operator": "Equal"}]),
    ([dict(TAINT, effect="NoExecute")],
     [{"key": "dedicated", "operator": "Exists", "effect": "NoSchedule"}]),
    ([dict(TAINT, effect="PreferNoSchedule")], []),
    ([{"key": "k"}], [{"key": "k", "operator": "Exists",
                       "effect": "NoSchedule"}]),
])
def test_toleration_rules_equal_jax(taints, tolerations):
    assert (pd._taints_tolerated(taints, tolerations)
            == jd._taints_tolerated(taints, tolerations))


# ---- the client over HTTP, and the command -----------------------------------


CALLS = [
    ("list_namespaces", ()),
    ("list_namespaced_pods", ("default",)),
    ("list_nodes", ()),
    ("read_namespaced_pod", ("job-0-pod0", "default")),
    ("replace_namespaced_pod", ("job-0-pod0", "default",
                                {"metadata": {"name": "job-0-pod0",
                                              "namespace": "default"},
                                 "spec": {}})),
    ("patch_node_labels", ("node-01", {jt.RACK_LABEL: "moved"})),
]


@pytest.mark.parametrize("call,args", CALLS, ids=[c for c, _ in CALLS])
def test_core_v1_over_http_equals_jax(call, args):
    """Each call through the urllib transport against a real HTTP server:
    the same answer, and the same write, in both packages."""
    out = {}
    for name, k8s in (("port", pk8s), ("jax", jk8s)):
        cluster = K.FakeCluster(*draw_fleet(0, GPU))
        server, url = K.serve_http(cluster)
        try:
            api = k8s.CoreV1(k8s.in_cluster_transport(
                host=url, token_path="/nonexistent", ca_path="/nonexistent"))
            out[name] = (getattr(api, call)(*args), cluster.writes)
        finally:
            K.stop(server)
    assert out["port"] == out["jax"]


def test_transport_network_error_becomes_api_exception():
    t = pk8s.in_cluster_transport(host="http://127.0.0.1:1",
                                  token_path="/nonexistent",
                                  ca_path="/nonexistent")
    with pytest.raises(pk8s.ApiException):
        t("GET", "/api/v1/nodes")


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_cli_once_binds_as_jax(seed, capsys):
    """``cmd/topology_scheduler.py --once --settle-seconds 0`` against an
    HTTP API server: the PUTs of the JAX daemon's pass over its own
    server (16 nodes at most: either search ends well inside the default
    budget)."""
    cluster = K.FakeCluster(*draw_fleet(seed, GPU))
    jcluster = K.FakeCluster(*draw_fleet(seed, TPU))
    server, url = K.serve_http(cluster)
    jserver, jurl = K.serve_http(jcluster)
    try:
        assert topology_scheduler.main(
            ["--once", "--settle-seconds", "0", "--api-host", url]) == 0
        jbound = jd.SchedulerDaemon(
            jk8s.CoreV1(jk8s.in_cluster_transport(
                host=jurl, token_path="/nonexistent",
                ca_path="/nonexistent")), settle_s=0).run_once()
    finally:
        K.stop(server)
        K.stop(jserver)
    assert f"bound {jbound} pods" in capsys.readouterr().out
    assert _plain(cluster.writes) == _as_port(jcluster.writes)


def test_cli_ignored_namespace_binds_nothing(capsys):
    cluster = K.FakeCluster(*draw_fleet(0, GPU))
    server, url = K.serve_http(cluster)
    try:
        assert topology_scheduler.main(
            ["--once", "--settle-seconds", "0", "--api-host", url,
             "--ignored-namespace", "default"]) == 0
    finally:
        K.stop(server)
    assert "bound 0 pods" in capsys.readouterr().out
    assert cluster.writes == []


# ---- link-health annotations (the port's collectives/topo.py -> packer) ----


def _link_nodes(*names_racks):
    return sorted(
        ({"name": n, "cpu": 8.0, "memory": 2**34, "gpu": 8,
          "node_labels": {pt.PLACEMENT_GROUP_LABEL: "pg0",
                          pt.CLUSTER_LABEL: "c0", pt.RACK_LABEL: rack,
                          pt.HOST_LABEL: n}}
         for n, rack in names_racks),
        key=pt.node_topology_key)


def _link_pods():
    return [{"name": f"p-{i}", "namespace": "default", "index": str(i),
             "cpu": 1.0, "memory": 1.0, "gpu": 8, "node_selector": None}
            for i in range(2)]


def _fleet_penalty(*faults, racks=(("a", "r0"), ("b", "r0"), ("c", "r1"))):
    """A penalty built the production way: the port's fleet topology,
    real link-table faults, a CommGraph snapshot."""
    from container_engine_accelerators_tpu_torch.collectives.topo import (
        CommGraph,
    )
    from container_engine_accelerators_tpu_torch.fleet.links import LinkTable
    from container_engine_accelerators_tpu_torch.fleet.topology import (
        FleetTopology,
        NodeSpec,
    )

    fleet = FleetTopology([NodeSpec(name=n, rack=r) for n, r in racks])
    links = LinkTable(fleet)
    for f in faults:
        assert links.apply(f), f"fault {f!r} armed nothing"
    return CommGraph.build(fleet, links=links,
                           rates=lambda a, b: 0.0).scheduler_link_penalty()


@pytest.mark.parametrize("fault", ["node:a<->node:b:partition",
                                   "node:a<->node:b:drop:5"])
def test_link_penalty_steers_off_a_bad_link(fault):
    """Healthy: the packer takes the same-rack pair (a, b).  With that
    pair's fabric partitioned or lossy, the port's CommGraph penalty
    steers the job onto a cross-rack pair."""
    nodes = _link_nodes(("a", "r0"), ("b", "r0"), ("c", "r1"))
    pods = _link_pods()
    base = pd.calculate_pods_assignment(nodes, pods, search_budget_s=None)
    assert {nodes[i]["name"] for i in base} == {"a", "b"}
    steered = pd.calculate_pods_assignment(
        nodes, pods, search_budget_s=None,
        link_penalty=_fleet_penalty(fault))
    chosen = {nodes[i]["name"] for i in steered}
    assert "c" in chosen and chosen != {"a", "b"}


def test_link_penalty_never_vetoes_and_ignores_strangers():
    nodes = _link_nodes(("a", "r0"), ("b", "r0"))
    penalty = _fleet_penalty("node:a<->node:b:partition",
                             racks=(("a", "r0"), ("b", "r0")))
    assignment = pd.calculate_pods_assignment(
        nodes, _link_pods(), search_budget_s=None, link_penalty=penalty)
    assert {nodes[i]["name"] for i in assignment} == {"a", "b"}
    stranger = {"node_labels": {pt.HOST_LABEL: "zz-unknown"}}
    known = {"node_labels": {pt.HOST_LABEL: "a"}}
    assert penalty(stranger, known) == penalty(stranger, stranger) == 0.0


def test_live_link_health_penalty_follows_faults_in_the_daemon():
    """LinkHealthPenalty re-snapshots the link table, so a fault armed
    between passes steers the next placement of the port's packer."""
    from container_engine_accelerators_tpu_torch.collectives.topo import (
        LinkHealthPenalty,
    )
    from container_engine_accelerators_tpu_torch.fleet.links import LinkTable
    from container_engine_accelerators_tpu_torch.fleet.topology import (
        FleetTopology,
        NodeSpec,
    )

    fleet = FleetTopology([NodeSpec(name="a", rack="r0"),
                           NodeSpec(name="b", rack="r0"),
                           NodeSpec(name="c", rack="r1")])
    links = LinkTable(fleet)
    live = LinkHealthPenalty(fleet, links, rates=lambda a, b: 0.0,
                             refresh_s=0)
    nodes = _link_nodes(("a", "r0"), ("b", "r0"), ("c", "r1"))
    first = pd.calculate_pods_assignment(nodes, _link_pods(),
                                         search_budget_s=None,
                                         link_penalty=live)
    assert {nodes[i]["name"] for i in first} == {"a", "b"}
    links.apply("node:a<->node:b:partition")
    second = pd.calculate_pods_assignment(nodes, _link_pods(),
                                          search_budget_s=None,
                                          link_penalty=live)
    assert "c" in {nodes[i]["name"] for i in second}
