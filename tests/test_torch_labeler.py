"""The port's node labeler against the JAX package's.

On the same metadata fixtures the port's labels equal the DCN labels of
JAX's (cluster, rack, host), also where a ``tpu-env`` attribute is
present (the JAX labeler adds slice labels from it; a GPU node has
none); a missing or malformed ``physical_host`` gives None on both
sides.  The daemon's PATCH and ``cmd/label_nodes.py --once`` over HTTP
are held to the same labels.
"""

import types

import pytest

import torch_k8s_helpers as K
from container_engine_accelerators_tpu.scheduler import k8s as jk8s
from container_engine_accelerators_tpu.scheduler import labeler as jl
from container_engine_accelerators_tpu.scheduler import topology as jt
from container_engine_accelerators_tpu_torch.cmd import label_nodes
from container_engine_accelerators_tpu_torch.scheduler import k8s as pk8s
from container_engine_accelerators_tpu_torch.scheduler import labeler as pl

DCN = (jt.CLUSTER_LABEL, jt.RACK_LABEL, jt.HOST_LABEL)
HOST = "/instance/attributes/physical_host"
TPU_ENV = "/instance/attributes/tpu-env"
NAME = "/instance/name"
TPU_ENV_OK = ("TPU_NAME: 'slice-a'\nTOPOLOGY: '4x4x4'\nWORKER_ID: '5'\n"
              "ACCELERATOR_TYPE: 'v5p-128'\n")

FIXTURES = {
    "plain": {HOST: "/cluster-1/rack-7/host-3", NAME: "gpu-node-0"},
    "newline": {HOST: "/c/r/h\n", NAME: "gpu-node-0\n"},
    "extra_parts": {HOST: "/c/r/h/extra/more", NAME: "n"},
    "tpu_env": {HOST: "/c2/r0/h9", TPU_ENV: TPU_ENV_OK, NAME: "n"},
    "tpu_env_bad_topology": {HOST: "/c2/r0/h9",
                             TPU_ENV: "TPU_NAME: s\nTOPOLOGY: 4xq\n",
                             NAME: "n"},
    "missing": {NAME: "n"},
    "too_short": {HOST: "/c/r", NAME: "n"},
    "empty": {HOST: "", NAME: "n"},
    "no_name": {HOST: "/c/r/h"},
}


def _fetch(fixture):
    return lambda path: FIXTURES[fixture].get(path)


def _dcn(labels):
    return None if labels is None else {k: labels[k] for k in DCN}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_compute_labels_equal_jax_dcn_labels(fixture):
    got = pl.compute_labels(_fetch(fixture))
    want = jl.compute_labels(_fetch(fixture))
    assert got == _dcn(want)
    assert got is None or set(got) == set(DCN)


def test_tpu_env_gives_the_jax_labeler_slice_labels_only():
    """What the port leaves out: the JAX labeler's ICI labels."""
    want = jl.compute_labels(_fetch("tpu_env"))
    assert set(want) - set(DCN) == {jt.SLICE_LABEL, jt.TPU_TOPOLOGY_LABEL,
                                    jt.COORDS_LABEL}
    assert pl.compute_labels(_fetch("tpu_env")) == _dcn(want)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_update_node_labels_patches_as_jax(fixture):
    """The PATCH each package sends for its node, read by the same
    fetcher: the DCN labels of JAX's, on the same node."""
    node = {"metadata": {"name": "gpu-node-0", "labels": {}}}
    nodes = [node, {"metadata": {"name": "n", "labels": {}}}]
    out = {}
    for name, labeler, k8s in (("port", pl, pk8s), ("jax", jl, jk8s)):
        cluster = K.FakeCluster(nodes, [])
        got = labeler.update_node_labels(k8s.CoreV1(cluster.transport),
                                         _fetch(fixture))
        out[name] = (got, cluster.writes)
    (got, writes), (want, jwrites) = out["port"], out["jax"]
    assert got == _dcn(want)
    assert len(writes) == len(jwrites) == (0 if got is None else 1)
    for (m, path, body), (jm, jpath, jbody) in zip(writes, jwrites):
        assert (m, path) == (jm, jpath)
        assert body == {"metadata": {"labels": _dcn(
            jbody["metadata"]["labels"])}}


@pytest.mark.parametrize("fixture", ["plain", "tpu_env", "missing"])
def test_cli_once_over_http(fixture, capsys):
    """``cmd/label_nodes.py --once`` against an HTTP metadata server and
    API server: the PATCHed labels are ``compute_labels``'s."""
    metadata = FIXTURES[fixture]
    node_name = metadata[NAME].strip()
    cluster = K.FakeCluster([{"metadata": {"name": node_name,
                                           "labels": {"keep": "me"}}}], [])
    server, url = K.serve_http(cluster, metadata)
    try:
        assert label_nodes.main(
            ["--once", "--api-host", url,
             "--metadata-base", url + "/computeMetadata/v1"]) == 0
    finally:
        K.stop(server)
    want = pl.compute_labels(_fetch(fixture))
    assert f"labels: {want}" in capsys.readouterr().out
    if want is None:
        assert cluster.writes == []
        return
    assert cluster.writes == [("PATCH", f"/api/v1/nodes/{node_name}",
                               {"metadata": {"labels": want}})]
    assert cluster.nodes[0]["metadata"]["labels"] == {"keep": "me", **want}


def test_metadata_fetcher_sends_the_google_flavor_header():
    seen = []
    server, url = K.serve_http(None, {"/instance/name": "n0"})
    handler = server.RequestHandlerClass
    original = handler._api

    def spy(self, method):
        seen.append(self.headers.get("Metadata-Flavor"))
        return original(self, method)

    handler._api = spy
    try:
        fetch = pl.metadata_fetcher(url + "/computeMetadata/v1")
        assert fetch("/instance/name") == "n0"
        assert fetch("/instance/attributes/physical_host") is None
    finally:
        K.stop(server)
    assert seen == ["Google", "Google"]


def test_run_forever_updates_then_sleeps(monkeypatch):
    """One update a period (``UPDATE_INTERVAL_S``), as the JAX daemon."""
    cluster = K.FakeCluster([{"metadata": {"name": "gpu-node-0"}}], [])
    sleeps = []

    class Stop(Exception):
        pass

    def sleep(s):
        sleeps.append(s)
        if len(sleeps) == 2:
            raise Stop

    monkeypatch.setattr(pl, "time", types.SimpleNamespace(sleep=sleep))
    with pytest.raises(Stop):
        pl.run_forever(pk8s.CoreV1(cluster.transport), _fetch("plain"))
    assert sleeps == [pl.UPDATE_INTERVAL_S] * 2 == [jl.UPDATE_INTERVAL_S] * 2
    assert len(cluster.writes) == 2
