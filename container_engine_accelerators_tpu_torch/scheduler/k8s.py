"""A minimal Kubernetes API client (stdlib only): the JAX package's
``scheduler/k8s.py`` (the calls of the scheduling daemon, the node
labeler and the maintenance watcher), copied so that the port imports
nothing of the JAX package.  Resources are parsed
JSON dicts, and the transport is a seam, so tests need no cluster.

The in-cluster transport finds the API server from
``KUBERNETES_SERVICE_HOST`` / ``_PORT`` and authenticates with the pod's
service-account token and CA, as the official client's loader does.
"""

import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# transport(method, path, body dict or None) -> parsed JSON dict
Transport = Callable[[str, str, Optional[dict]], dict]


class ApiException(Exception):
    def __init__(self, status: int, reason: str, body: str = ""):
        super().__init__(f"HTTP {status}: {reason} {body[:200]}")
        self.status = status
        self.reason = reason
        self.body = body


def in_cluster_transport(
    host: Optional[str] = None,
    token_path: str = os.path.join(SERVICE_ACCOUNT_DIR, "token"),
    ca_path: str = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt"),
) -> Transport:
    """A transport with the pod's service-account credentials."""
    if host is None:
        host = "https://{}:{}".format(
            os.environ["KUBERNETES_SERVICE_HOST"],
            os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
    ctx = ssl.create_default_context(
        cafile=ca_path if os.path.exists(ca_path) else None)

    def transport(method: str, path: str, body: Optional[dict] = None) -> dict:
        token = ""
        if os.path.exists(token_path):  # read each time: tokens rotate
            with open(token_path) as f:
                token = f.read().strip()
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(host + path, data=data, method=method)
        if token:
            req.add_header("Authorization", "Bearer " + token)
        req.add_header("Accept", "application/json")
        if method == "PATCH":
            req.add_header("Content-Type",
                           "application/strategic-merge-patch+json")
        elif data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, context=ctx, timeout=60) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            raise ApiException(e.code, e.reason,
                               e.read().decode(errors="replace"))
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            # A transient network failure is an ApiException too, so the
            # daemons' loops survive it.
            raise ApiException(0, f"transport error: {e}")

    return transport


class CoreV1:
    """The CoreV1 calls the scheduler, the labeler and the maintenance
    watcher make."""

    def __init__(self, transport: Transport):
        self._t = transport

    def list_namespaces(self) -> List[dict]:
        return self._t("GET", "/api/v1/namespaces").get("items", [])

    def list_namespaced_pods(self, namespace: str) -> List[dict]:
        return self._t("GET", f"/api/v1/namespaces/{namespace}/pods").get(
            "items", [])

    def list_nodes(self) -> List[dict]:
        return self._t("GET", "/api/v1/nodes").get("items", [])

    def read_namespaced_pod(self, name: str, namespace: str) -> dict:
        return self._t("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def replace_namespaced_pod(self, name: str, namespace: str,
                               pod: dict) -> dict:
        return self._t("PUT", f"/api/v1/namespaces/{namespace}/pods/{name}",
                       pod)

    def patch_node_labels(self, name: str, labels: Dict[str, str]) -> dict:
        return self._t("PATCH", f"/api/v1/nodes/{name}",
                       {"metadata": {"labels": labels}})

    def read_node(self, name: str) -> dict:
        return self._t("GET", f"/api/v1/nodes/{name}")

    def patch_node_taints(self, name: str, taints: List[dict],
                          resource_version: Optional[str] = None) -> dict:
        """Replace the node's taint list whole.

        ``spec.taints`` is an atomic list under strategic-merge-patch (it
        has no patchMergeKey): this patch overwrites what is there.  A
        read-modify-write passes the ``metadata.resourceVersion`` of its
        read, so that the API server answers 409 Conflict when the node
        changed in between, instead of wiping a taint added meanwhile.
        """
        body: dict = {"spec": {"taints": taints}}
        if resource_version is not None:
            body["metadata"] = {"resourceVersion": resource_version}
        return self._t("PATCH", f"/api/v1/nodes/{name}", body)
