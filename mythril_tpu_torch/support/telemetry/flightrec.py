"""Crash flight recorder (docs/observability.md).

On a fatal exception or SIGTERM, dump everything a post-mortem needs
into ``<out-dir>/flightrec/``:

* ``trace.json`` — the span ring buffer as Chrome trace JSON (the
  last N spans before death, one lane per thread);
* ``events.jsonl`` — the same buffer as a flat event log;
* ``metrics.json`` — the live metrics-registry snapshot, including
  the full SolverStatistics counter block via its provider;
* ``inflight.json`` — the active constraint-set fingerprints of
  solver queries that were mid-solve when the process died
  (smt/solver/core's in-flight registry);
* ``crash.json`` — reason, exception type/message/traceback, rank.

A dead rank in a sharded corpus run leaves a diagnosable artifact
instead of a truncated log; corpus mode installs the recorder per
rank automatically (parallel/corpus.py), CLIs arm it through
``telemetry.configure(out_dir=...)``.

Dumping is best-effort and re-entrant-safe: a second fatal during
the dump cannot recurse, and nothing here ever raises into the
crashing frame.
"""

import json
import os
import signal
import sys
import threading
import traceback
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from . import metrics, spans

DIRNAME = "flightrec"

_CFG = {"dir": None, "rank": 0}
_INSTALLED = {"excepthook": False, "sigterm": False}
_DUMPING = threading.Lock()

#: live resume-checkpoint provider (support/checkpoint.arm_live_dump):
#: called as fn(flightrec_dir, rank) during dump(), expected to write
#: resume_rank<rank>.ckpt and return its path (or None). Latest
#: analysis wins — a rank runs one contract at a time.
_RESUME_PROVIDER = {"fn": None}


def register_resume_provider(fn) -> None:
    """Arm the checkpoint path: on SIGTERM/fatal the dump also writes
    a live resume checkpoint beside the spans/metrics artifacts
    (single-flight and never-raises like every other hook here)."""
    _RESUME_PROVIDER["fn"] = fn


def configure(out_dir=None, rank: Optional[int] = None) -> None:
    if out_dir is not None:
        _CFG["dir"] = str(out_dir)
    if rank is not None:
        _CFG["rank"] = int(rank)


def configured_dir():
    return _CFG["dir"]


def _inflight_queries() -> list:
    try:
        from ...smt.solver import core

        return core.inflight_queries()
    except Exception:
        return []


def dump(reason: str, exc_info=None) -> Optional[Path]:
    """Write the flight-record set; returns the directory, or None
    when unconfigured/failed. Safe to call from signal handlers and
    except hooks (single-flight, never raises)."""
    out_dir = _CFG["dir"]
    if out_dir is None:
        return None
    if not _DUMPING.acquire(blocking=False):
        return None  # a dump is already in progress
    try:
        rank = _CFG["rank"]
        dest = Path(out_dir) / DIRNAME
        dest.mkdir(parents=True, exist_ok=True)
        spans.export_chrome_trace(dest / f"trace_rank{rank}.json",
                                  rank=rank)
        spans.export_jsonl(dest / f"events_rank{rank}.jsonl",
                           rank=rank)
        crash = {
            "reason": reason,
            "rank": rank,
            "pid": os.getpid(),
            "utc": datetime.now(timezone.utc).isoformat(),
            "span_stats": spans.stats(),
        }
        if exc_info is not None:
            et, ev, tb = exc_info
            crash["exception"] = {
                "type": getattr(et, "__name__", str(et)),
                "message": str(ev)[:2000],
                "traceback": traceback.format_exception(et, ev, tb),
            }
        for name, payload in (
            (f"metrics_rank{rank}.json",
             lambda: metrics.registry().snapshot()),
            (f"inflight_rank{rank}.json",
             lambda: {"queries": _inflight_queries()}),
            (f"crash_rank{rank}.json", lambda: crash),
        ):
            try:
                tmp = dest / (name + ".tmp")
                tmp.write_text(json.dumps(payload(), default=str))
                os.replace(tmp, dest / name)
            except Exception:
                continue
        # live resume checkpoint (support/checkpoint.arm_live_dump):
        # the dying rank's contract re-enters the queue as resumable
        # work instead of restarting from zero
        provider = _RESUME_PROVIDER["fn"]
        if provider is not None:
            try:
                provider(dest, rank)
            except Exception:
                pass
        return dest
    except Exception:
        return None
    finally:
        _DUMPING.release()


def _chain_excepthook() -> None:
    if _INSTALLED["excepthook"]:
        return
    prev = sys.excepthook

    def hook(et, ev, tb):
        if not issubclass(et, KeyboardInterrupt):
            dump("fatal_exception", (et, ev, tb))
        prev(et, ev, tb)

    sys.excepthook = hook
    _INSTALLED["excepthook"] = True


def _install_sigterm() -> None:
    if _INSTALLED["sigterm"]:
        return
    if threading.current_thread() is not threading.main_thread():
        return  # signal handlers install from the main thread only
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            dump("SIGTERM")
            # restore and re-deliver so the process still dies with
            # the default disposition (a supervisor sees SIGTERM, not
            # a swallowed exit)
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, handler)
        _INSTALLED["sigterm"] = True
    except (ValueError, OSError):
        pass


def install(out_dir=None, rank: Optional[int] = None) -> None:
    """Arm the recorder: set the destination and hook fatal paths
    (uncaught exception + SIGTERM). Idempotent."""
    configure(out_dir=out_dir, rank=rank)
    if _CFG["dir"] is None:
        return
    _chain_excepthook()
    _install_sigterm()
