"""The port's NRI device injector against the JAX package's.

- ``get_devices``: equal results and equal errors on the same
  annotations (aliases and duplicates included).
- ``to_linux_device``: byte-equal serialized ``LinuxDevice``s on a real
  fifo and through the lstat seam (char and block devices, majors and
  minors drawn from a seed, as a GPU node's ``/dev/nvidia*`` would give).
- The wire, both ways: a runtime built on JAX's mux and ttrpc drives the
  port's plugin, and one built on the port's drives JAX's plugin, over a
  ``socketpair``.  Every response payload (and the RegisterPlugin
  request) equals the one JAX's runtime gets from JAX's plugin, byte for
  byte; errors carry the same code and message.
- The mux's oversized and large frames across the two packages, the
  reconnect budget, ``sendall`` and ``RetryPolicy.call``, and the daemon
  as a subprocess.
"""

import os
import socket
import stat
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from container_engine_accelerators_tpu.metrics import counters as jcounters
from container_engine_accelerators_tpu.nri import injector as jinj
from container_engine_accelerators_tpu.nri import mux as jmux
from container_engine_accelerators_tpu.nri import nri_v1alpha1_pb2 as jpb
from container_engine_accelerators_tpu.nri import plugin as jplugin
from container_engine_accelerators_tpu.nri import ttrpc as jttrpc
from container_engine_accelerators_tpu.utils import netio as jnetio
from container_engine_accelerators_tpu.utils import retry as jretry
from container_engine_accelerators_tpu_torch.metrics import counters as pcounters
from container_engine_accelerators_tpu_torch.nri import injector as pinj
from container_engine_accelerators_tpu_torch.nri import mux as pmux
from container_engine_accelerators_tpu_torch.nri import nri_v1alpha1_pb2 as ppb
from container_engine_accelerators_tpu_torch.nri import plugin as pplugin
from container_engine_accelerators_tpu_torch.nri import ttrpc as pttrpc
from container_engine_accelerators_tpu_torch.utils import netio as pnetio
from container_engine_accelerators_tpu_torch.utils import retry as pretry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": dict(mux=jmux, ttrpc=jttrpc, pb=jpb, plugin=jplugin,
                counters=jcounters, retry=jretry),
    "port": dict(mux=pmux, ttrpc=pttrpc, pb=ppb, plugin=pplugin,
                 counters=pcounters, retry=pretry),
}


def ann(ctr, value):
    return {pinj.CTR_DEVICE_KEY_PREFIX + ctr: value}


def _outcome(fn, *args, **kw):
    """fn's value, or the type and text of the exception it raised."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # compared between the packages
        return ("raised", type(e).__name__, str(e))


# ---- annotations -------------------------------------------------------------


ANNOTATIONS = {
    "yaml_list": ("gpu", "- path: /dev/nvidia0\n- path: /dev/nvidiactl\n"
                         "  file_mode: 0o660\n"),
    "json": ("gpu", '[{"path": "/dev/nvidia0"}, {"path": "/dev/nvidia-uvm"}]'),
    "duplicates_keep_first": ("gpu", "- path: /dev/nvidia0\n  uid: 1\n"
                                     "- path: /dev/nvidia0\n  uid: 2\n"),
    "other_container": ("other", "- path: /dev/nvidia0"),
    "null": ("gpu", "null"),
    "empty": ("gpu", ""),
    "not_yaml": ("gpu", "{not yaml: ["),
    "string": ("gpu", "just-a-string"),
    "no_path": ("gpu", "- type: c\n  major: 195"),
    "not_a_dict": ("gpu", "- /dev/nvidia0"),
    "alias_bomb": ("gpu", "a: &a [x,x,x,x,x]\nb: &b [*a,*a,*a,*a]\n"
                          "c: [*b,*b,*b,*b]\n"),
    "alias_in_list": ("gpu", "- &d {path: /dev/nvidia0}\n- *d\n"),
    "mig": ("gpu", "- path: /dev/nvidia0\n"
                   "- path: /dev/nvidia-caps/nvidia-cap12\n  gid: 7\n"),
}


@pytest.mark.parametrize("case", sorted(ANNOTATIONS))
def test_get_devices_equals_jax(case):
    ctr, value = ANNOTATIONS[case]
    got = _outcome(pinj.get_devices, ctr, ann("gpu", value))
    assert got == _outcome(jinj.get_devices, ctr, ann("gpu", value))


def test_get_devices_absent_annotations():
    for annotations in ({}, None):
        assert (pinj.get_devices("gpu", annotations)
                == jinj.get_devices("gpu", annotations) == [])


# ---- LinuxDevice bytes ---------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {}, {"file_mode": "0o660"}, {"file_mode": "0660"}, {"file_mode": 432},
    {"uid": 7, "gid": 8}, {"file_mode": 0, "uid": 0}])
def test_fifo_linux_device_bytes_equal_jax(tmp_path, extra):
    path = str(tmp_path / "fifo")
    os.mkfifo(path)
    entry = {"path": path, **extra}
    got = pinj.to_linux_device(entry).SerializeToString()
    assert got == jinj.to_linux_device(entry).SerializeToString()
    assert pinj.to_linux_device(entry).type == "p"


class _St:
    def __init__(self, mode, major, minor):
        self.st_mode = mode
        self.st_rdev = os.makedev(major, minor)


@pytest.mark.parametrize("seed", range(4))
def test_seam_linux_device_bytes_equal_jax(seed):
    """A GPU node's nodes through the lstat seam: char devices at the
    driver's majors (nvidia-uvm's and the caps' drawn, as the driver
    picks them at load time), and one block device."""
    rng = np.random.default_rng(seed)
    uvm, caps = (int(v) for v in rng.integers(200, 512, 2))
    nodes = {"/dev/nvidia0": (stat.S_IFCHR, 195, 0),
             f"/dev/nvidia{int(rng.integers(1, 8))}": (stat.S_IFCHR, 195, 7),
             "/dev/nvidiactl": (stat.S_IFCHR, 195, 255),
             "/dev/nvidia-uvm": (stat.S_IFCHR, uvm, 0),
             "/dev/nvidia-caps/nvidia-cap12": (stat.S_IFCHR, caps, 12),
             "/dev/sdb": (stat.S_IFBLK, 8, 16)}

    def lstat(path):
        kind, major, minor = nodes[path]
        return _St(kind | 0o666, major, minor)

    for path, (kind, major, minor) in nodes.items():
        entry = {"path": path, "file_mode": int(rng.choice([0, 0o660])),
                 "uid": int(rng.integers(0, 3))}
        got = pinj.to_linux_device(entry, lstat=lstat)
        assert (got.SerializeToString()
                == jinj.to_linux_device(entry, lstat=lstat)
                .SerializeToString())
        assert (got.type, got.major, got.minor) == (
            "c" if kind == stat.S_IFCHR else "b", major, minor)
    annotation = ann("gpu", "".join(f"- path: {p}\n" for p in nodes))
    assert (pinj.create_container_adjustment("gpu", annotation, lstat=lstat)
            .SerializeToString()
            == jinj.create_container_adjustment("gpu", annotation,
                                                lstat=lstat)
            .SerializeToString())


@pytest.mark.parametrize("kind", ["missing", "regular_file", "directory"])
def test_refused_paths_raise_as_jax(tmp_path, kind):
    path = {"missing": str(tmp_path / "absent"),
            "regular_file": str(tmp_path / "plain"),
            "directory": str(tmp_path)}[kind]
    if kind == "regular_file":
        open(path, "w").close()
    got = _outcome(pinj.to_linux_device, {"path": path})
    assert got[0] == "raised" and got[1] == "ValueError"
    assert got == _outcome(jinj.to_linux_device, {"path": path})


# ---- the wire, both ways -------------------------------------------------------


class Runtime:
    """containerd's side of the NRI socket, built on one package's mux
    and ttrpc: it records RegisterPlugin's payload and calls the
    plugin's service."""

    def __init__(self, sock, pkg):
        m, t = PKGS[pkg]["mux"], PKGS[pkg]["ttrpc"]
        self.pb = PKGS[pkg]["pb"]
        self.ttrpc = t
        self.mux = m.Mux(sock)
        self.registered = threading.Event()
        self.register_payload = None
        server = t.TtrpcServer(self.mux.open(m.RUNTIME_SERVICE_CONN))
        server.register(pplugin.RUNTIME_SERVICE, "RegisterPlugin",
                        self._register)
        self.client = t.TtrpcClient(self.mux.open(m.PLUGIN_SERVICE_CONN))
        self.mux.start_reader()
        threading.Thread(target=server.serve, daemon=True).start()

    def _register(self, payload):
        self.register_payload = payload
        self.registered.set()
        return self.pb.Empty().SerializeToString()

    def call(self, method, request):
        try:
            return ("ok", self.client.call(pplugin.PLUGIN_SERVICE, method,
                                           request.SerializeToString()))
        except self.ttrpc.TtrpcError as e:
            return ("error", e.code, str(e))


def _create(pb, annotations, ctr="gpu"):
    return pb.CreateContainerRequest(
        pod=pb.PodSandbox(name="pod", namespace="ns", uid="u1",
                          annotations=annotations),
        container=pb.Container(id="c1", name=ctr, pod_sandbox_id="p1"))


def _scenario(name, pb, fifo):
    """(method, request) calls of one scenario."""
    if name == "configure":
        return [("Configure", pb.ConfigureRequest(
            runtime_name="containerd", runtime_version="2.0"))]
    if name == "synchronize":
        return [("Synchronize", pb.SynchronizeRequest(
            pods=[pb.PodSandbox(name="p")],
            containers=[pb.Container(name="c")]))]
    if name == "create_fifo":
        return [("CreateContainer", _create(pb, ann("gpu", f"- path: {fifo}\n"
                                                    "  file_mode: 0o640")))]
    if name == "create_gpu_nodes":
        return [("CreateContainer", _create(pb, ann("gpu", "".join(
            f"- path: {p}\n" for p in SEAM))))]
    if name == "create_without_annotation":
        return [("CreateContainer", _create(pb, {}, ctr="plain"))]
    if name == "create_bad_annotation":
        return [("CreateContainer", _create(pb, ann("gpu", "- major: 1")))]
    if name == "create_missing_device":
        return [("CreateContainer", _create(pb, ann(
            "gpu", f"- path: {fifo}.absent")))]
    if name == "stop_and_state_change":
        return [("StopContainer", pb.StopContainerRequest()),
                ("StateChange", pb.StateChangeEvent())]
    if name == "unknown_method":
        return [("UpdateContainer", pb.Empty())]
    raise KeyError(name)


SCENARIOS = ["configure", "synchronize", "create_fifo", "create_gpu_nodes",
             "create_without_annotation", "create_bad_annotation",
             "create_missing_device", "stop_and_state_change",
             "unknown_method", "shutdown"]
SEAM = {"/dev/nvidia6": (195, 6), "/dev/nvidiactl": (195, 255),
        "/dev/nvidia-uvm": (237, 0)}


def _seam_lstat(path):
    if path not in SEAM:
        return os.lstat(path)
    return _St(stat.S_IFCHR | 0o666, *SEAM[path])


def _drive(runtime_pkg, plugin_pkg, scenario, fifo):
    """One session: (RegisterPlugin payload, the calls' outcomes, whether
    the plugin's serve returned)."""
    rsock, psock = socket.socketpair()
    plugin = PKGS[plugin_pkg]["plugin"].DeviceInjectorPlugin(
        lstat=_seam_lstat)
    t = threading.Thread(target=plugin.run_on_socket, args=(psock,),
                         daemon=True)
    t.start()
    try:
        rt = Runtime(rsock, runtime_pkg)
        assert rt.registered.wait(10)
        pb = PKGS[runtime_pkg]["pb"]
        if scenario == "shutdown":
            out = [rt.call("Shutdown", pb.Empty())]
            t.join(timeout=10)
            return rt.register_payload, out, not t.is_alive()
        return (rt.register_payload,
                [rt.call(m, req) for m, req in _scenario(scenario, pb, fifo)],
                None)
    finally:
        rsock.close()
        psock.close()


@pytest.mark.parametrize("runtime_pkg,plugin_pkg",
                         [("jax", "port"), ("port", "jax"), ("port", "port")],
                         ids=["jax_runtime-port_plugin",
                              "port_runtime-jax_plugin",
                              "port_runtime-port_plugin"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_wire_equals_jax(tmp_path, scenario, runtime_pkg, plugin_pkg):
    fifo = str(tmp_path / "dev-fifo")
    os.mkfifo(fifo)
    got = _drive(runtime_pkg, plugin_pkg, scenario, fifo)
    want = _drive("jax", "jax", scenario, fifo)
    assert got == want
    register = ppb.RegisterPluginRequest.FromString(got[0])
    assert (register.plugin_name, register.plugin_idx) == (
        "device_injector_nri", "10")


def test_wire_answers_what_the_plugin_should(tmp_path):
    """What the equal bytes say: CreateContainer is the one subscribed
    event, and the adjustment carries exactly the annotated devices."""
    fifo = str(tmp_path / "dev-fifo")
    os.mkfifo(fifo)
    _, (configure,), _ = _drive("jax", "port", "configure", fifo)
    assert ppb.ConfigureResponse.FromString(configure[1]).events == (
        pplugin.event_mask(ppb.CREATE_CONTAINER)) == 1 << 3
    _, (created,), _ = _drive("jax", "port", "create_gpu_nodes", fifo)
    devices = ppb.CreateContainerResponse.FromString(
        created[1]).adjust.linux.devices
    assert [(d.path, d.type, d.major, d.minor) for d in devices] == [
        (p, "c", *SEAM[p]) for p in SEAM]
    _, (bad,), _ = _drive("jax", "port", "create_missing_device", fifo)
    assert bad[0] == "error" and bad[1] == pttrpc.CODE_UNKNOWN


# ---- the mux -------------------------------------------------------------------


def test_mux_rejects_oversized_frame():
    a, b = socket.socketpair()
    mux = pmux.Mux(b)
    conn = mux.open(1)
    mux.start_reader()
    a.sendall(struct.pack(">II", 1, 0xFFFFFFFF))  # a corrupt length
    with pytest.raises(EOFError):
        conn.read_exact(1)
    a.close()
    b.close()
    assert pmux.MAX_PAYLOAD == jmux.MAX_PAYLOAD == 1 << 24
    with pytest.raises(ValueError):
        pmux.Mux(a).write(1, bytes(pmux.MAX_PAYLOAD + 1))


@pytest.mark.parametrize("tx,rx", [("port", "port"), ("port", "jax"),
                                   ("jax", "port")])
def test_mux_large_frame_crosses_the_trunk(tx, rx):
    """A 4 MiB frame and the one after it arrive whole and in order
    between the two packages' muxes."""
    a, b = socket.socketpair()
    conn_tx = PKGS[tx]["mux"].Mux(a).open(1)
    mux_rx = PKGS[rx]["mux"].Mux(b)
    conn_rx = mux_rx.open(1)
    mux_rx.start_reader()
    payload = bytes(range(256)) * (4 << 12)
    trailer = b"after-the-big-one"
    writer = threading.Thread(
        target=lambda: (conn_tx.write(payload), conn_tx.write(trailer)),
        daemon=True)
    writer.start()
    assert conn_rx.read_exact(len(payload)) == payload
    assert conn_rx.read_exact(len(trailer)) == trailer
    writer.join(timeout=30)
    assert not writer.is_alive()
    for s in (a, b):
        s.close()


def test_ttrpc_refuses_an_oversized_frame():
    class Conn:
        def __init__(self, data):
            self.data = data

        def read_exact(self, n):
            out, self.data = self.data[:n], self.data[n:]
            return out

    header = struct.pack(">IIBB", pttrpc.MESSAGE_LENGTH_MAX + 1, 1, 1, 0)
    with pytest.raises(pttrpc.TtrpcError):
        pttrpc.read_frame(Conn(header))


class _ShortSocket:
    """Takes at most ``limit`` bytes a send and records each size."""

    def __init__(self, limit):
        self.limit = limit
        self.sizes = []
        self.data = bytearray()

    def send(self, view):
        n = min(len(view), self.limit)
        self.sizes.append(n)
        self.data.extend(view[:n])
        return n


@pytest.mark.parametrize("limit", [1000, 3 << 19])
def test_sendall_loops_over_short_writes_as_jax(limit):
    data = bytes(range(256)) * 12289
    got, want = _ShortSocket(limit), _ShortSocket(limit)
    pnetio.sendall(got, data)
    jnetio.sendall(want, data)
    assert bytes(got.data) == data
    assert got.sizes == want.sizes
    assert max(got.sizes) <= pnetio.SENDALL_CAP


# ---- reconnects ----------------------------------------------------------------


def test_retry_call_equals_jax():
    """Attempts, sleeps and the error raised at the end, without jitter."""
    out = {}
    for name, mod in (("port", pretry), ("jax", jretry)):
        policy = mod.RetryPolicy(max_attempts=4, initial_backoff_s=0.1,
                                 jitter=0.0)
        calls, sleeps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionRefusedError(f"try {len(calls)}")
            return "up"

        def gone():
            raise OSError("gone")

        ok = policy.call(flaky, sleep=sleeps.append)
        dead = _outcome(policy.call, gone, sleep=sleeps.append)
        out[name] = (ok, len(calls), sleeps, dead)
    assert out["port"] == out["jax"]


FAST = dict(max_attempts=6, initial_backoff_s=0.01, max_backoff_s=0.05,
            deadline_s=10.0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_reconnect_after_trunk_loss(tmp_path, pkg):
    """The trunk dies; the plugin re-dials, registers again and counts
    one ``nri.reconnect`` (each package its own counters)."""
    P = PKGS[pkg]
    path = str(tmp_path / "nri.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(2)
    plugin = P["plugin"].DeviceInjectorPlugin(socket_path=path)
    before = P["counters"].get("nri.reconnect")
    t = threading.Thread(target=plugin.run, daemon=True, kwargs={
        "retry": P["retry"].RetryPolicy(**FAST)})
    t.start()
    try:
        conn1, _ = listener.accept()
        rt1 = Runtime(conn1, "port")
        assert rt1.registered.wait(10)
        conn1.shutdown(socket.SHUT_RDWR)
        conn1.close()
        conn2, _ = listener.accept()
        rt2 = Runtime(conn2, "jax")
        assert rt2.registered.wait(10), "no registration on the new trunk"
        assert rt2.register_payload == rt1.register_payload
        assert P["counters"].get("nri.reconnect") == before + 1
        status, raw = rt2.call("Configure", jpb.ConfigureRequest())
        assert jpb.ConfigureResponse.FromString(raw).events == 1 << 3
        rt2.call("Shutdown", jpb.Empty())
        t.join(timeout=10)
        assert not t.is_alive()
        conn2.close()
    finally:
        listener.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sessions_dropped_at_once_spend_the_budget(tmp_path, pkg):
    P = PKGS[pkg]
    path = str(tmp_path / "drop.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(8)
    stop = threading.Event()

    def dropper():
        while not stop.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                return
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    threading.Thread(target=dropper, daemon=True).start()
    plugin = P["plugin"].DeviceInjectorPlugin(socket_path=path)
    before = P["counters"].get("nri.reconnect.failed")
    try:
        with pytest.raises(OSError, match="keeps dropping"):
            plugin.run(retry=P["retry"].RetryPolicy(
                max_attempts=3, initial_backoff_s=0.01, max_backoff_s=0.02))
        assert P["counters"].get("nri.reconnect.failed") == before + 1
    finally:
        stop.set()
        listener.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_unreachable_socket_spends_the_budget(tmp_path, pkg):
    P = PKGS[pkg]
    plugin = P["plugin"].DeviceInjectorPlugin(
        socket_path=str(tmp_path / "never.sock"))
    before = P["counters"].get("nri.reconnect.failed")
    with pytest.raises(OSError):
        plugin.run(retry=P["retry"].RetryPolicy(
            max_attempts=2, initial_backoff_s=0.01, max_backoff_s=0.02))
    assert P["counters"].get("nri.reconnect.failed") == before + 1


# ---- the daemon ----------------------------------------------------------------


def test_daemon_registers_and_injects(tmp_path):
    """``python -m ...cmd.nri_device_injector`` dials the socket,
    registers, subscribes to CreateContainer and injects a fifo; it is
    killed at the end (the daemon never exits by itself)."""
    path = str(tmp_path / "nri.sock")
    fifo = str(tmp_path / "fifo")
    os.mkfifo(fifo)
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(1)
    listener.settimeout(60)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.nri_device_injector",
         "--nri-socket", path, "--plugin-idx", "42"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        conn, _ = listener.accept()
        rt = Runtime(conn, "port")
        assert rt.registered.wait(30)
        assert ppb.RegisterPluginRequest.FromString(
            rt.register_payload).plugin_idx == "42"
        _, raw = rt.call("Configure", ppb.ConfigureRequest())
        assert ppb.ConfigureResponse.FromString(raw).events == 1 << 3
        _, raw = rt.call("CreateContainer",
                         _create(ppb, ann("gpu", f"- path: {fifo}")))
        (device,) = ppb.CreateContainerResponse.FromString(
            raw).adjust.linux.devices
        assert (device.path, device.type) == (fifo, "p")
        conn.close()
    finally:
        proc.kill()
        proc.communicate(timeout=30)
        listener.close()
