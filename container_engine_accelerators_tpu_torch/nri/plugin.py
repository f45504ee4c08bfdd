"""The NRI plugin runtime: register with containerd, serve the lifecycle
hooks (a copy of the JAX package's ``nri/plugin.py``).

The connection (as github.com/containerd/nri pkg/stub): dial the NRI
socket, multiplex it (``mux.py``), serve the ``Plugin`` ttrpc service on
logical conn 1, call ``Runtime.RegisterPlugin`` on logical conn 2, then
answer Configure, Synchronize and CreateContainer until the runtime
closes the connection.  It subscribes to CreateContainer only, as the
reference plugin does (nri_device_injector.go:86).

A containerd restart (every upgrade bounces it) kills the ttrpc trunk.
``run()`` then re-dials with backoff under a :class:`RetryPolicy` budget
and registers again on the new trunk, so the bounce costs the plugin a
few seconds of deafness, not its life.  A session that lasts resets the
budget; only the runtime's ``Shutdown``, or a spent budget, ends the
loop.  Counters (``metrics/counters.py``): ``nri.reconnect`` for each
session re-established, ``nri.reconnect.failed`` when the budget is
spent.
"""

import logging
import socket
import threading
import time
from typing import Optional

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.nri import injector
from container_engine_accelerators_tpu_torch.nri import mux as nri_mux
from container_engine_accelerators_tpu_torch.nri import nri_v1alpha1_pb2 as pb
from container_engine_accelerators_tpu_torch.nri.ttrpc import (
    TtrpcClient,
    TtrpcServer,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

DEFAULT_NRI_SOCKET = "/var/run/nri/nri.sock"

# Rides out a containerd restart (systemd gives it seconds, not
# minutes) without hiding a runtime that is not there: a refused
# connect fails at once, so the budget is the sum of the sleeps.
RECONNECT_RETRY = RetryPolicy(
    max_attempts=8, initial_backoff_s=0.2, max_backoff_s=5.0,
    deadline_s=60.0,
)

# A session that lives at least this long counts as a recovery and
# resets the budget of short sessions; a shorter one is a runtime that
# accepts and drops the plugin at once (a crash loop, a half-up socket)
# and costs a backoff, not a spin.
MIN_SESSION_S = 5.0
PLUGIN_SERVICE = "nri.pkg.api.v1alpha1.Plugin"
RUNTIME_SERVICE = "nri.pkg.api.v1alpha1.Runtime"
PLUGIN_NAME = "device_injector_nri"
PLUGIN_IDX = "10"


def event_mask(*events: int) -> int:
    """Bit (e-1) subscribes Event e (nri pkg/api/event.go)."""
    m = 0
    for e in events:
        m |= 1 << (e - 1)
    return m


class DeviceInjectorPlugin:
    def __init__(
        self,
        socket_path: str = DEFAULT_NRI_SOCKET,
        plugin_name: str = PLUGIN_NAME,
        plugin_idx: str = PLUGIN_IDX,
        lstat=None,
    ):
        self.socket_path = socket_path
        self.plugin_name = plugin_name
        self.plugin_idx = plugin_idx
        self._lstat = lstat  # test seam; None = os.lstat
        self._shutdown = threading.Event()

    # ---- Plugin service handlers (runtime -> us) ---------------------------

    def _configure(self, payload: bytes) -> bytes:
        req = pb.ConfigureRequest.FromString(payload)
        log.info("configured by runtime %s %s", req.runtime_name,
                 req.runtime_version)
        return pb.ConfigureResponse(
            events=event_mask(pb.CREATE_CONTAINER)
        ).SerializeToString()

    def _synchronize(self, payload: bytes) -> bytes:
        req = pb.SynchronizeRequest.FromString(payload)
        log.info("synchronized: %d pods, %d containers",
                 len(req.pods), len(req.containers))
        return pb.SynchronizeResponse().SerializeToString()

    def _create_container(self, payload: bytes) -> bytes:
        req = pb.CreateContainerRequest.FromString(payload)
        ctr, pod = req.container.name, req.pod.name
        log.info("CreateContainer %s/%s/%s", req.pod.namespace, pod, ctr)
        kwargs = {"lstat": self._lstat} if self._lstat else {}
        adjust = injector.create_container_adjustment(
            ctr, dict(req.pod.annotations), **kwargs
        )
        for device in adjust.linux.devices:
            log.info("injecting device %s (%s %d:%d) into %s/%s",
                     device.path, device.type, device.major, device.minor,
                     pod, ctr)
        return pb.CreateContainerResponse(adjust=adjust).SerializeToString()

    def _stop_container(self, payload: bytes) -> bytes:
        return pb.StopContainerResponse().SerializeToString()

    def _state_change(self, payload: bytes) -> bytes:
        return pb.Empty().SerializeToString()

    def _handle_shutdown(self, payload: bytes) -> bytes:
        log.info("runtime is shutting down")
        self._shutdown.set()
        return pb.Empty().SerializeToString()

    # ---- lifecycle ---------------------------------------------------------

    def _build_server(self, conn) -> TtrpcServer:
        server = TtrpcServer(conn)
        for method, handler in [
            ("Configure", self._configure),
            ("Synchronize", self._synchronize),
            ("Shutdown", self._handle_shutdown),
            ("CreateContainer", self._create_container),
            ("StopContainer", self._stop_container),
            ("StateChange", self._state_change),
        ]:
            server.register(PLUGIN_SERVICE, method, handler)
        return server

    def run_on_socket(self, sock) -> None:
        """Serve one connected trunk socket until it closes or the runtime
        announces Shutdown (test seam)."""
        m = nri_mux.Mux(sock)
        server = self._build_server(m.open(nri_mux.PLUGIN_SERVICE_CONN))
        client = TtrpcClient(m.open(nri_mux.RUNTIME_SERVICE_CONN))
        m.start_reader()

        serve_thread = threading.Thread(
            target=server.serve, daemon=True, name="nri-plugin-server"
        )
        serve_thread.start()

        client.call(
            RUNTIME_SERVICE, "RegisterPlugin",
            pb.RegisterPluginRequest(
                plugin_name=self.plugin_name, plugin_idx=self.plugin_idx
            ).SerializeToString(),
        )
        log.info("registered NRI plugin %s (idx %s)",
                 self.plugin_name, self.plugin_idx)
        # Serve until the connection drops, or Shutdown arrives — then close
        # the trunk ourselves to unblock the serve loop.
        while serve_thread.is_alive():
            if self._shutdown.wait(timeout=0.2):
                # Give the serve loop a beat to flush the Shutdown response
                # before tearing down the trunk under it.
                time.sleep(0.2)
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                serve_thread.join(timeout=5)
                break

    def _dial(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(self.socket_path)
        except OSError:
            sock.close()
            raise
        return sock

    def run_once(self) -> None:
        """One dial and one session, no reconnect (``run()`` wraps this
        in the backoff loop)."""
        sock = self._dial()
        try:
            self.run_on_socket(sock)
        finally:
            sock.close()

    def run(self, retry: Optional[RetryPolicy] = None) -> None:
        """Serve forever, reconnecting with backoff when the trunk
        dies.  Ends cleanly on the runtime's Shutdown; raises the last
        OSError once a reconnect budget is spent — against a socket
        that stays unreachable, OR a runtime that keeps accepting and
        instantly dropping us (each short-lived session costs a
        backoff sleep and a budget slot; a session that lives past
        ``MIN_SESSION_S`` resets the budget).  Either way counts
        ``nri.reconnect.failed``: graceful degradation, never an
        unbounded spin."""
        policy = retry or RECONNECT_RETRY
        sessions = 0
        short_sessions = 0
        while not self._shutdown.is_set():
            try:
                sock = policy.call(self._dial, retry_on=(OSError,))
            except OSError:
                counters.inc("nri.reconnect.failed")
                log.error("NRI socket %s unreachable through the whole "
                          "reconnect budget; giving up", self.socket_path)
                raise
            if sessions:
                counters.inc("nri.reconnect")
                log.warning("NRI trunk re-established (reconnect #%d); "
                            "re-registering", sessions)
            sessions += 1
            started = time.monotonic()
            try:
                # Registration/serving failures are connection loss:
                # the next lap re-dials.  A TtrpcError surfaces as-is —
                # the runtime actively refusing us is not a blip.
                self.run_on_socket(sock)
            except (OSError, EOFError) as e:
                log.warning("NRI connection lost: %s", e)
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            if self._shutdown.is_set():
                break
            if time.monotonic() - started >= MIN_SESSION_S:
                short_sessions = 0
                continue
            short_sessions += 1
            if short_sessions >= policy.max_attempts:
                counters.inc("nri.reconnect.failed")
                log.error("NRI runtime dropped %d consecutive sessions "
                          "within %.0fs each; giving up",
                          short_sessions, MIN_SESSION_S)
                raise OSError(
                    f"NRI runtime at {self.socket_path} keeps dropping "
                    f"the trunk ({short_sessions} short sessions)"
                )
            time.sleep(policy.backoff_s(short_sessions - 1))
