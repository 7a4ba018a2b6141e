"""Resident analysis daemon (docs/daemon.md, ROADMAP item 1).

Every one-shot ``myth analyze`` pays process-lifetime state on every
request: cold XLA kernel tracing/compiles (~22 s per propagation
bucket — the BENCH_r07/r11 long pole even with the persistent disk
cache, which saves recompilation but not per-process retracing), cold
incremental solver sessions, a cold static-pass memo, and a verdict
cache warmed only from disk. This package is the reference's L5/L6
orchestration split made real: a long-lived server (``myth serve``)
holds exactly that state hot, and the second, third, and millionth
request over it starts warm.

Layout:

* :mod:`.protocol` — the length-framed JSON wire format over a
  Unix-domain socket; the ONE sanctioned socket seam in the repo
  (lint rule 9, ``socket-io-outside-daemon``).
* :mod:`.server` — :class:`~.server.AnalysisDaemon`: accept loop,
  cost-model-scheduled request queue, per-request isolation over the
  PR-12 reset seams, process-wide sharing of the jit caches / static
  memo / warm store / solver pool, and SIGTERM drain through the
  PR-10 live-checkpoint path.
* :mod:`.client` — :class:`~.client.DaemonClient` plus the
  ``analyze_via_daemon`` helper the CLI and ``bench_corpus.py
  --daemon`` submit through.

Master gate: ``MTPU_DAEMON`` names the socket a client should use
(also settable per-invocation with ``myth analyze --daemon SOCK``).
Default EMPTY: the plain CLI never touches a socket, never creates a
daemon directory, and behaves bit-for-bit like the pre-daemon build.
"""

import os
from typing import Optional

#: daemon socket filename created under ``myth serve --out-dir DIR``
SOCKET_NAME = "daemon.sock"


def configured_socket(cli_value: Optional[str] = None) -> Optional[str]:
    """The daemon socket a client should submit through: an explicit
    ``--daemon SOCK`` wins, else ``MTPU_DAEMON`` (empty or ``0`` =
    off — the master gate's bit-for-bit one-shot default)."""
    if cli_value:
        return str(cli_value)
    env = os.environ.get("MTPU_DAEMON", "")
    if env in ("", "0"):
        return None
    return env
