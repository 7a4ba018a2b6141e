"""Slow-query log (docs/observability.md).

Solver queries whose wall exceeds ``MTPU_SLOW_QUERY_MS`` (default
1000) append one JSON line — constraint-set fingerprint tids, tier,
tactic, wall — to ``<out-dir>/slow_queries.jsonl``. This is the raw
per-query material learned solver routing (ROADMAP open item 3)
trains on: which constraint shapes were slow, under which tactic.

Armed by ``telemetry.configure(out_dir=...)`` (corpus mode arms it
per rank automatically) or ``MTPU_SLOW_QUERY_LOG=<path>``; unarmed,
the fast path is two comparisons.
"""

import json
import os
import threading

FILENAME = "slow_queries.jsonl"

_CFG = {"path": os.environ.get("MTPU_SLOW_QUERY_LOG") or None}
_LOCK = threading.Lock()


def configure(out_dir=None, path=None) -> None:
    if path is not None:
        _CFG["path"] = str(path)
    elif out_dir is not None:
        _CFG["path"] = os.path.join(str(out_dir), FILENAME)


def configured_path():
    return _CFG["path"]


def threshold_ms() -> float:
    try:
        return float(os.environ.get("MTPU_SLOW_QUERY_MS", "1000"))
    except ValueError:
        return 1000.0


def maybe_record(wall_ms: float, **fields) -> None:
    """Append a slow-query record when armed and over threshold.
    Never raises — this is telemetry, not a solve path."""
    path = _CFG["path"]
    if path is None or wall_ms < threshold_ms():
        return
    rec = {"wall_ms": round(wall_ms, 1)}
    rec.update(fields)
    try:
        line = json.dumps(rec)
        with _LOCK:
            with open(path, "a") as f:
                f.write(line + "\n")
    except Exception:
        pass
