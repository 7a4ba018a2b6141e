"""Daemon client (docs/daemon.md): submit analyses to a resident
``myth serve`` process and stream back the report.

Used by ``myth analyze --daemon SOCK`` (interfaces/cli.py) and
``bench_corpus.py --daemon``; tests drive :class:`DaemonClient`
directly. With no daemon configured (``MTPU_DAEMON`` empty and no
``--daemon``) none of this is imported and the one-shot path runs
bit-for-bit — the master-gate contract.
"""

import logging
import time
from typing import Iterator, Optional

from . import protocol

log = logging.getLogger(__name__)


class DaemonError(Exception):
    """The daemon answered with an error event (or the stream broke)."""


class DaemonClient:
    """Thin request-per-connection client for an AnalysisDaemon."""

    def __init__(self, socket_path: str,
                 connect_timeout: float = 5.0):
        self.socket_path = str(socket_path)
        self.connect_timeout = connect_timeout

    def _roundtrip(self, msg: dict) -> dict:
        sock = protocol.connect_unix(self.socket_path,
                                     timeout=self.connect_timeout)
        try:
            sock.settimeout(None)
            protocol.send_frame(sock, msg)
            reply = protocol.recv_frame(sock)
            if reply is None:
                raise DaemonError("daemon closed the connection")
            return reply
        finally:
            sock.close()

    def ping(self) -> dict:
        return self._roundtrip({"op": "ping"})

    def status(self) -> dict:
        return self._roundtrip({"op": "status"})

    def result(self, request_id: str) -> dict:
        """The persisted done-row for a request id (``event`` is
        ``report`` when done, ``pending`` while queued/active,
        ``unknown`` otherwise) — how a client reattaches to work a
        drained daemon finished, or a restarted daemon resumed."""
        return self._roundtrip({"op": "result", "id": request_id})

    def shutdown(self, drain: bool = True) -> dict:
        return self._roundtrip({"op": "shutdown", "drain": drain})

    def submit(self, code: str, **params) -> Iterator[dict]:
        """Stream the events of one analyze request (``queued`` →
        ``started`` → ``report``/``error``). ``params`` are the
        server's REQUEST_DEFAULTS keys (bin_runtime, name, timeout,
        tpu_lanes, transaction_count, modules, outform, id)."""
        sock = protocol.connect_unix(self.socket_path,
                                     timeout=self.connect_timeout)
        try:
            sock.settimeout(None)
            msg = dict(params)
            msg.update({"op": "analyze", "code": code})
            protocol.send_frame(sock, msg)
            while True:
                event = protocol.recv_frame(sock)
                if event is None:
                    raise DaemonError(
                        "daemon hung up mid-request (drained? check "
                        "daemon_queue.json / op result)")
                yield event
                if event.get("event") in ("report", "error"):
                    return
        finally:
            sock.close()

    def analyze(self, code: str, **params) -> dict:
        """Blocking submit: the terminal ``report`` event, raising
        :class:`DaemonError` on an error event."""
        last = None
        for event in self.submit(code, **params):
            last = event
        if last is None or last.get("event") != "report":
            raise DaemonError(str((last or {}).get("error",
                                                   "no report")))
        return last


def wait_ready(socket_path: str, timeout_s: float = 30.0,
               interval_s: float = 0.1) -> bool:
    """Poll until a daemon answers a ping on ``socket_path`` (tests,
    bench harnesses — the server also prints a ready line)."""
    client = DaemonClient(socket_path, connect_timeout=1.0)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if client.ping().get("event") == "pong":
                return True
        except (OSError, protocol.ProtocolError, DaemonError):
            pass
        time.sleep(interval_s)
    return False


def analyze_via_daemon(socket_path: str, code: str,
                       outform: str = "json",
                       name: Optional[str] = None,
                       **params) -> dict:
    """The CLI/bench submission helper: one report event dict with
    ``output`` rendered in ``outform`` plus the structured issue
    list and per-request counters."""
    client = DaemonClient(socket_path)
    return client.analyze(code, outform=outform, name=name, **params)
