"""NRI connection multiplexer: two logical byte streams on one socket (a
copy of the JAX package's ``nri/mux.py``).

Wire format (github.com/containerd/nri pkg/net/multiplex): each trunk
frame is an 8-byte header — conn id (u32 BE), payload length (u32 BE) —
and then that many bytes of that logical connection.  Conn 1
(PLUGIN_SERVICE_CONN) carries the runtime -> plugin ttrpc session (the
plugin serves); conn 2 (RUNTIME_SERVICE_CONN) plugin -> runtime (the
plugin calls).  Frame boundaries mean nothing: each logical connection
is a plain byte stream.

Left out of the copy: the JAX package's ``analysis.lockwatch``
annotation around the trunk write (its race instrument, not ported).
The write still holds the lock across the whole frame, which is the
framing guarantee.
"""

import struct
import threading
from typing import Dict

from container_engine_accelerators_tpu_torch.utils import netio

HEADER_LEN = 8
MAX_PAYLOAD = 1 << 24

PLUGIN_SERVICE_CONN = 1
RUNTIME_SERVICE_CONN = 2


class MuxConn:
    """One logical connection: buffered reads, writes through the trunk."""

    def __init__(self, mux: "Mux", conn_id: int):
        self._mux = mux
        self._id = conn_id
        self._buf = bytearray()
        self._cond = threading.Condition()
        self._closed = False

    # -- mux side ------------------------------------------------------------

    def _feed(self, data: bytes) -> None:
        with self._cond:
            self._buf.extend(data)
            self._cond.notify_all()

    def _close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- user side -----------------------------------------------------------

    def read_exact(self, n: int) -> bytes:
        with self._cond:
            while len(self._buf) < n:
                if self._closed:
                    raise EOFError("mux connection closed")
                self._cond.wait()
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def write(self, data: bytes) -> None:
        self._mux.write(self._id, data)


class Mux:
    def __init__(self, sock):
        self._sock = sock
        self._write_lock = threading.Lock()
        self._conns: Dict[int, MuxConn] = {}
        self._reader_started = False

    def open(self, conn_id: int) -> MuxConn:
        conn = self._conns.get(conn_id)
        if conn is None:
            conn = self._conns[conn_id] = MuxConn(self, conn_id)
        return conn

    def write(self, conn_id: int, data: bytes) -> None:
        if len(data) > MAX_PAYLOAD:
            raise ValueError(f"mux payload {len(data)} exceeds maximum")
        frame = struct.pack(">II", conn_id, len(data)) + data
        # The lock spans the whole frame: two logical connections
        # interleaving bytes would desynchronize the trunk.  A short
        # write would too, so the send loops (containerd's trunks carry
        # multi-MiB UpdateContainers payloads).
        with self._write_lock:
            netio.sendall(self._sock, frame)

    def start_reader(self) -> threading.Thread:
        """Demultiplex trunk frames into logical connections until the
        socket closes."""
        if self._reader_started:
            raise RuntimeError("the mux reader is already running")
        self._reader_started = True
        t = threading.Thread(target=self._read_loop, daemon=True,
                             name="nri-mux-reader")
        t.start()
        return t

    def _recv_exact(self, n: int) -> bytes:
        chunks = bytearray()
        while len(chunks) < n:
            chunk = self._sock.recv(n - len(chunks))
            if not chunk:
                raise EOFError("trunk socket closed")
            chunks.extend(chunk)
        return bytes(chunks)

    def _read_loop(self) -> None:
        try:
            while True:
                conn_id, length = struct.unpack(">II",
                                                self._recv_exact(HEADER_LEN))
                if length > MAX_PAYLOAD:
                    # A desynchronized or corrupt trunk: tear it down
                    # rather than buffer up to 4 GiB of garbage.
                    raise EOFError(
                        f"mux frame length {length} exceeds maximum; "
                        f"closing desynchronized trunk"
                    )
                payload = self._recv_exact(length) if length else b""
                self.open(conn_id)._feed(payload)
        except (EOFError, OSError):
            pass
        finally:
            for conn in self._conns.values():
                conn._close()
