"""Short-write/short-read hardened socket IO: the JAX package's
``utils/netio.py``, copied so that the port imports nothing of the JAX
package.  The NRI mux and the DCN transfer plane (``fleet/xferd.py``,
``parallel/dcn_client.py``, ``parallel/dcn_pipeline.py``) send and
receive through it.

Some loopback stacks truncate very large single-syscall payloads, so a
send is capped at :data:`SENDALL_CAP` a syscall and loops on the
kernel's own count of bytes written: ``sendall`` semantics that hold
even where the platform's ``sendall`` does not.  A receive loops
``recv_into`` against an exact byte budget: a frame is read whole or
the connection is reported dead, never a silently short buffer.
"""

import socket
from typing import Iterable

# Per-syscall send cap: far above the size where another syscall costs
# anything measurable, far below every truncation seen.
SENDALL_CAP = 1 << 20


def sendall(sock: socket.socket, data, cap: int = SENDALL_CAP) -> None:
    """``sock.sendall(data)`` with an explicit short-write loop and a
    per-syscall size cap.  Takes bytes, bytearray or memoryview."""
    view = memoryview(data)
    off = 0
    n = len(view)
    while off < n:
        sent = sock.send(view[off:off + min(cap, n - off)])
        if sent <= 0:
            raise ConnectionError("socket closed mid-send")
        off += sent


def sendall_parts(sock: socket.socket, parts: Iterable) -> None:
    """Send each buffer in ``parts`` back to back (header + name +
    payload as separate buffers — no concat copy of the payload)."""
    for part in parts:
        sendall(sock, part)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError``."""
    buf = bytearray(n)
    recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` completely from the socket or raise
    ``ConnectionError`` — never a silent short read."""
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("connection closed mid-read")
        got += r
