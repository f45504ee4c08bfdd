"""Socket sends that survive partial writes: ``sendall`` of the JAX
package's ``utils/netio.py``, copied so that the port imports nothing of
the JAX package (the NRI mux is its one caller here).

Some loopback stacks truncate very large single-syscall payloads, so a
send is capped at :data:`SENDALL_CAP` a syscall and loops on the
kernel's own count of bytes written: ``sendall`` semantics that hold
even where the platform's ``sendall`` does not.
"""

import socket

# Per-syscall send cap: far above the size where another syscall costs
# anything measurable, far below every truncation seen.
SENDALL_CAP = 1 << 20


def sendall(sock: socket.socket, data) -> None:
    """``sock.sendall(data)`` with an explicit short-write loop and a
    per-syscall size cap.  Takes bytes, bytearray or memoryview."""
    view = memoryview(data)
    off = 0
    n = len(view)
    while off < n:
        sent = sock.send(view[off:off + min(SENDALL_CAP, n - off)])
        if sent <= 0:
            raise ConnectionError("socket closed mid-send")
        off += sent
