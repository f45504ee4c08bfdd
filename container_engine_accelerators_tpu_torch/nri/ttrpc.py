"""Minimal ttrpc (containerd's light RPC), unary calls only: a copy of
the JAX package's ``nri/ttrpc.py``.

Wire format (github.com/containerd/ttrpc PROTOCOL.md): each frame is a
10-byte header — payload length (u32 BE), stream id (u32 BE), message
type (u8: 1 request, 2 response), flags (u8) — and then a protobuf
``Request`` / ``Response`` envelope (protos/ttrpc/ttrpc.proto).  Client
streams use odd ids.  At most 4 MiB of payload.

Server and client each own one byte stream (an NRI mux logical
connection), so each is a plain blocking read loop: NRI's surface is
unary only, and no stream interleaves.
"""

import itertools
import logging
import struct
import threading
from typing import Callable, Dict, Tuple

from container_engine_accelerators_tpu_torch.nri import ttrpc_pb2

log = logging.getLogger(__name__)

MESSAGE_HEADER_LEN = 10
MESSAGE_LENGTH_MAX = 4 << 20
TYPE_REQUEST = 0x1
TYPE_RESPONSE = 0x2

# google.rpc codes used in responses
CODE_OK = 0
CODE_UNKNOWN = 2
CODE_UNIMPLEMENTED = 12


class TtrpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"ttrpc error {code}: {message}")
        self.code = code


def read_frame(conn) -> Tuple[int, int, int, bytes]:
    """One frame -> (stream_id, type, flags, payload).  Raises EOFError
    when the connection closes."""
    header = conn.read_exact(MESSAGE_HEADER_LEN)
    length, stream_id = struct.unpack(">II", header[:8])
    msg_type, flags = header[8], header[9]
    if length > MESSAGE_LENGTH_MAX:
        raise TtrpcError(CODE_UNKNOWN, f"frame length {length} exceeds maximum")
    payload = conn.read_exact(length) if length else b""
    return stream_id, msg_type, flags, payload


def write_frame(conn, stream_id: int, msg_type: int, payload: bytes) -> None:
    header = struct.pack(">IIBB", len(payload), stream_id, msg_type, 0)
    conn.write(header + payload)


# Handler: request payload bytes -> response payload bytes
Handler = Callable[[bytes], bytes]


class TtrpcServer:
    """Serves unary requests on one connection until it closes."""

    def __init__(self, conn):
        self.conn = conn
        self._handlers: Dict[Tuple[str, str], Handler] = {}
        self._write_lock = threading.Lock()

    def register(self, service: str, method: str, handler: Handler) -> None:
        self._handlers[(service, method)] = handler

    def serve(self) -> None:
        """Blocking serve loop; returns when the connection closes."""
        while True:
            try:
                stream_id, msg_type, _, payload = read_frame(self.conn)
            except (EOFError, OSError):
                return
            if msg_type != TYPE_REQUEST:
                log.warning("ignoring unexpected frame type %d", msg_type)
                continue
            req = ttrpc_pb2.Request.FromString(payload)
            resp = ttrpc_pb2.Response()
            handler = self._handlers.get((req.service, req.method))
            if handler is None:
                resp.status.code = CODE_UNIMPLEMENTED
                resp.status.message = f"unknown method {req.service}.{req.method}"
            else:
                try:
                    resp.payload = handler(req.payload)
                    resp.status.code = CODE_OK
                except Exception as e:  # the RPC boundary: report, serve on
                    log.exception("%s.%s handler failed", req.service, req.method)
                    resp.status.code = CODE_UNKNOWN
                    resp.status.message = str(e)
            with self._write_lock:
                write_frame(self.conn, stream_id, TYPE_RESPONSE,
                            resp.SerializeToString())


class TtrpcClient:
    """Unary ttrpc client owning one connection (one call at a time)."""

    def __init__(self, conn):
        self.conn = conn
        self._ids = itertools.count(1, 2)  # client streams are odd
        self._lock = threading.Lock()

    def call(self, service: str, method: str, payload: bytes) -> bytes:
        req = ttrpc_pb2.Request(service=service, method=method,
                                payload=payload)
        with self._lock:
            stream_id = next(self._ids)
            write_frame(self.conn, stream_id, TYPE_REQUEST,
                        req.SerializeToString())
            while True:
                got_id, msg_type, _, data = read_frame(self.conn)
                if msg_type != TYPE_RESPONSE or got_id != stream_id:
                    log.warning("discarding frame type=%d stream=%d",
                                msg_type, got_id)
                    continue
                resp = ttrpc_pb2.Response.FromString(data)
                if resp.status.code != CODE_OK:
                    raise TtrpcError(resp.status.code, resp.status.message)
                return resp.payload
