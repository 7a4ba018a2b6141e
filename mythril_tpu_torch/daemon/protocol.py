"""Length-framed JSON wire protocol over a Unix-domain socket
(docs/daemon.md §protocol).

One frame = a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON. A client connection carries exactly one request
object and then reads event objects until a terminal event
(``report`` / ``error`` / ``pong`` / ``status`` / ``stopping`` /
``unknown``) — the server streams progress (``queued``, ``started``)
before the terminal frame, which is what lets ``myth analyze
--daemon`` block on a queued submission without polling.

ALL socket construction in this package routes through the helpers
here (``listen_unix`` / ``connect_unix``); together with server.py's
accept loop they are the one sanctioned socket seam in the codebase —
lint rule 9, ``socket-io-outside-daemon``, bans socket/bind/connect
calls everywhere outside ``mythril_tpu_torch/daemon/`` the same way rule 5
fences raw pickle into checkpoint.py.

Frames are bounded (``MAX_FRAME``): a corrupt or adversarial length
prefix must fail loudly instead of allocating gigabytes inside the
resident server every tenant shares.
"""

import json
import os
import socket
import struct
from typing import Optional

#: frame-size ceiling: reports over the 18-fixture corpus measure in
#: the tens of KB; 64 MB leaves two orders of magnitude of headroom
#: while still refusing a garbage length prefix
MAX_FRAME = 64 * 1024 * 1024

_LEN = struct.Struct(">I")


class ProtocolError(Exception):
    """Malformed frame (bad length, truncated body, non-JSON)."""


def send_frame(sock: socket.socket, obj) -> None:
    """Serialize ``obj`` as one length-framed JSON frame."""
    body = json.dumps(obj).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(body)} bytes)")
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes, or None on a clean EOF at a frame
    boundary (mid-frame EOF raises — a truncated frame is an error,
    a closed idle connection is not)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 16))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket):
    """One decoded frame, or None on clean EOF."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ProtocolError(f"frame length {length} exceeds cap")
    body = _recv_exact(sock, length)
    if body is None:
        raise ProtocolError("connection closed before frame body")
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad frame payload: {e}") from e


def listen_unix(path: str, backlog: int = 16) -> socket.socket:
    """Bind a fresh Unix-domain listener at ``path`` (a stale socket
    file from a dead daemon is replaced; a LIVE daemon on the path is
    detected and refused — two daemons sharing one socket would split
    the queue invisibly)."""
    if os.path.exists(path):
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.settimeout(0.5)
            probe.connect(path)
        except OSError:
            os.unlink(path)  # stale: no listener behind it
        else:
            probe.close()
            raise OSError(f"daemon already listening on {path}")
        finally:
            probe.close()
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(backlog)
    return sock


def connect_unix(path: str,
                 timeout: Optional[float] = None) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if timeout is not None:
        sock.settimeout(timeout)
    sock.connect(path)
    return sock
