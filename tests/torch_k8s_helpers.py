"""An in-memory Kubernetes API and GCE metadata server for the scheduler
and labeler tests of the PyTorch port.  No jax here.

:class:`FakeCluster` answers the CoreV1 calls of both packages'
``scheduler/k8s.py`` as a transport function (``cluster.transport``),
so one cluster drives the JAX package's ``CoreV1`` and the port's alike
and records every write; :func:`serve_http` puts the same cluster (and a
metadata tree) behind a real HTTP server on localhost, for the urllib
transport and the command-line daemons.
"""

import copy
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_POD = re.compile(r"^/api/v1/namespaces/([^/]+)/pods/([^/]+)$")
_PODS = re.compile(r"^/api/v1/namespaces/([^/]+)/pods$")
_NODE = re.compile(r"^/api/v1/nodes/([^/]+)$")


class NotFound(Exception):
    pass


class FakeCluster:
    """Nodes and pods as Kubernetes JSON dicts.  ``writes`` records each
    PUT and PATCH as (method, path, body), in order."""

    def __init__(self, nodes, pods, namespaces=("default",)):
        self.nodes = copy.deepcopy(nodes)
        self.pods = {(p["metadata"]["namespace"], p["metadata"]["name"]):
                     copy.deepcopy(p) for p in pods}
        self.namespaces = list(namespaces)
        self.writes = []
        self._lock = threading.Lock()

    def _node(self, name):
        for node in self.nodes:
            if node["metadata"]["name"] == name:
                return node
        raise NotFound(name)

    def transport(self, method, path, body=None):
        with self._lock:
            return copy.deepcopy(self._answer(method, path, body))

    def _answer(self, method, path, body):
        if method in ("PUT", "PATCH"):
            self.writes.append((method, path, copy.deepcopy(body)))
        if method == "GET" and path == "/api/v1/namespaces":
            return {"items": [{"metadata": {"name": n}}
                              for n in self.namespaces]}
        if method == "GET" and path == "/api/v1/nodes":
            return {"items": self.nodes}
        m = _PODS.match(path)
        if m and method == "GET":
            return {"items": [p for (ns, _), p in self.pods.items()
                              if ns == m.group(1)]}
        m = _POD.match(path)
        if m:
            key = (m.group(1), m.group(2))
            if key not in self.pods:
                raise NotFound(path)
            if method == "PUT":
                self.pods[key] = copy.deepcopy(body)
            return self.pods[key]
        m = _NODE.match(path)
        if m:
            node = self._node(m.group(1))
            if method == "PATCH":
                labels = (body.get("metadata") or {}).get("labels")
                if labels:
                    node["metadata"].setdefault("labels", {}).update(labels)
            return node
        raise NotFound(f"{method} {path}")


def serve_http(cluster=None, metadata=None):
    """(server, base URL): ``cluster``'s API and the ``metadata`` dict
    (a path under ``/computeMetadata/v1`` -> its text; a missing path
    answers 404) on 127.0.0.1.  Stop it with :func:`stop`."""
    metadata = metadata or {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, text):
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _api(self, method):
            if self.path.startswith("/computeMetadata/v1"):
                value = metadata.get(self.path[len("/computeMetadata/v1"):])
                if value is None or method != "GET":
                    return self._send(404, "")
                return self._send(200, value)
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n)) if n else None
            if cluster is None:
                return self._send(404, "{}")
            try:
                out = cluster.transport(method, self.path, body)
            except NotFound:
                return self._send(404, "{}")
            self._send(200, json.dumps(out))

        def do_GET(self):
            self._api("GET")

        def do_PUT(self):
            self._api("PUT")

        def do_PATCH(self):
            self._api("PATCH")

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    server.thread = thread
    return server, f"http://127.0.0.1:{server.server_port}"


def stop(server):
    server.shutdown()
    server.server_close()
    server.thread.join(timeout=10)
