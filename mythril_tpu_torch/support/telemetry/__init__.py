"""Run-wide observability subsystem (docs/observability.md).

Three pillars:

* **span tracing** (spans.py) — ``trace.span("window_drain", n=k)``
  at every major engine seam, recorded into a bounded ring buffer,
  exportable as Chrome trace-event JSON (Perfetto) and JSONL. Gated
  ``MTPU_TRACE`` / ``--trace-out``; off by default and free when off.
* **metrics registry** (metrics.py) — typed counters/gauges/
  histograms, always on; absorbs the SolverStatistics counter block
  via a snapshot provider, persists per-tactic solver-wall histograms
  into stats.json and ships per-rank snapshots through the corpus
  shard-report merge.
* **crash flight recorder** (flightrec.py) — on fatal exception or
  SIGTERM, dumps spans + metrics + in-flight solver query
  fingerprints to ``<out-dir>/flightrec/``.

Plus the slow-query log (slowlog.py) and the shared counter-line
renderer both telemetry plugins use (render.py).

``configure()`` is the one-call CLI hookup: arms tracing, the flight
recorder and the slow-query log, and registers the at-exit trace
export for ``--trace-out``.
"""

import atexit

from . import flightrec, metrics, render, slowlog
from . import spans as trace

__all__ = ["trace", "metrics", "flightrec", "slowlog", "render",
           "configure", "flush_trace"]

_ATEXIT = {"registered": False, "trace_out": None, "rank": 0,
           "flushed": False}


def flush_trace() -> None:
    """Write the configured --trace-out artifact now (idempotent per
    configure; bench.py calls this explicitly because it exits via
    os._exit, which skips atexit)."""
    path = _ATEXIT["trace_out"]
    if path is None or _ATEXIT["flushed"]:
        return
    _ATEXIT["flushed"] = True
    trace.export_chrome_trace(path, rank=_ATEXIT["rank"])
    trace.export_jsonl(str(path) + "l", rank=_ATEXIT["rank"])


def configure(trace_out=None, out_dir=None, enable=None,
              rank=None) -> None:
    """Wire telemetry for a run.

    trace_out — write a Chrome trace JSON there at process exit
    (implies span tracing ON; a ``.jsonl``-suffixed twin rides along).
    out_dir   — arm the crash flight recorder (flightrec/ inside it)
    and the slow-query log (slow_queries.jsonl inside it).
    enable    — force span tracing on/off regardless of MTPU_TRACE.
    rank      — corpus rank stamped on exported artifacts.
    """
    if rank is not None:
        _ATEXIT["rank"] = int(rank)
    if trace_out is not None:
        _ATEXIT["trace_out"] = str(trace_out)
        _ATEXIT["flushed"] = False
        if enable is None:
            enable = True
        if not _ATEXIT["registered"]:
            _ATEXIT["registered"] = True
            atexit.register(flush_trace)
    if enable is not None:
        trace.set_enabled(enable)
    if out_dir is not None:
        slowlog.configure(out_dir=out_dir)
        flightrec.install(out_dir=out_dir, rank=rank)
