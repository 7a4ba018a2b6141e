"""Run-wide span tracing (docs/observability.md).

Low-overhead, thread-safe spans recorded into a bounded ring buffer
and exportable as Chrome trace-event JSON (loadable in Perfetto — one
lane per thread, so solver-pool workers show up as separate tracks)
plus a flat JSONL event log. Gated by ``MTPU_TRACE`` (default OFF):
the off path is a single attribute check returning a shared no-op
context manager, so instrumented seams cost nothing measurable and
change no behavior. Counters/metrics (metrics.py) stay on regardless.

Span taxonomy (the ``subsystem.operation`` names every seam uses) is
documented in docs/observability.md; the crash flight recorder
(flightrec.py) dumps this module's ring buffer post-mortem.

All span timing uses ``time.monotonic()`` — wall clocks step under
NTP and a stepped span would corrupt latency histograms the same way
it corrupted ``steal_latency_s`` (see tools/lint_static.py rule
``wall-clock-in-monotonic-path``).
"""

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

#: process epoch: every recorded timestamp is monotonic-relative to
#: this, so exported traces start near t=0
_EPOCH = time.monotonic()

_DEFAULT_CAP = 65536


def _env_on() -> bool:
    return os.environ.get("MTPU_TRACE", "0") not in ("", "0")


def _env_cap() -> int:
    try:
        return max(16, int(os.environ.get("MTPU_TRACE_BUF",
                                          str(_DEFAULT_CAP))))
    except ValueError:
        return _DEFAULT_CAP


class _State:
    def __init__(self):
        self.on = _env_on()
        self.cap = _env_cap()
        self.lock = threading.Lock()
        #: ring buffer of event tuples
        #: (phase, name, t0_rel_s, dur_s, tid, attrs-or-None)
        self.buf: deque = deque(maxlen=self.cap)
        self.recorded = 0
        self.dropped = 0
        #: thread ident -> thread name (Chrome trace lane labels)
        self.tid_names: Dict[int, str] = {}


_STATE = _State()


def enabled() -> bool:
    return _STATE.on


def set_enabled(on: bool) -> None:
    """Runtime gate override (bench stages, tests, --trace-out)."""
    _STATE.on = bool(on)


def configure(capacity: Optional[int] = None,
              enable: Optional[bool] = None) -> None:
    """Resize the ring buffer and/or flip the gate (tests, CLIs).
    Resizing clears the buffer."""
    with _STATE.lock:
        if capacity is not None:
            _STATE.cap = max(16, int(capacity))
            _STATE.buf = deque(maxlen=_STATE.cap)
            _STATE.recorded = 0
            _STATE.dropped = 0
    if enable is not None:
        _STATE.on = bool(enable)


def clear() -> None:
    with _STATE.lock:
        _STATE.buf.clear()
        _STATE.recorded = 0
        _STATE.dropped = 0


def stats() -> dict:
    with _STATE.lock:
        return {"recorded": _STATE.recorded,
                "dropped": _STATE.dropped,
                "buffered": len(_STATE.buf),
                "capacity": _STATE.cap,
                "enabled": _STATE.on}


def _record(phase: str, name: str, t0: float, dur: float,
            attrs: Optional[dict]) -> None:
    th = threading.current_thread()
    tid = th.ident or 0
    s = _STATE
    with s.lock:
        if tid not in s.tid_names:
            s.tid_names[tid] = th.name
        if len(s.buf) >= s.cap:
            s.dropped += 1  # ring semantics: newest wins
        s.buf.append((phase, name, t0 - _EPOCH, dur, tid, attrs))
        s.recorded += 1


class _Span:
    """One traced region. ``set(**attrs)`` adds attributes after
    entry (e.g. a verdict known only at exit)."""

    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self.t0 = time.monotonic()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if et is not None:
            self.set(error=et.__name__)
        _record("X", self.name, self.t0,
                time.monotonic() - self.t0, self.attrs)
        return False


class _NullSpan:
    """Shared no-op context manager — the entire off path."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, **attrs):
    """``with trace.span("window_drain", lane_count=n): ...`` — the
    instrumentation primitive. Returns a shared no-op when tracing is
    off."""
    if not _STATE.on:
        return _NULL
    return _Span(name, attrs or None)


def event(name: str, **attrs) -> None:
    """Instant (zero-duration) event — offer/claim/replay marks."""
    if not _STATE.on:
        return
    _record("i", name, time.monotonic(), 0.0, attrs or None)


def begin(name: str, **attrs) -> None:
    """Open a duration event on the current thread (paired with
    ``end``); for long regions where a ``with`` block would force a
    wholesale re-indent. An unmatched begin is harmless (Perfetto
    closes it at trace end)."""
    if not _STATE.on:
        return
    _record("B", name, time.monotonic(), 0.0, attrs or None)


def end(name: str, **attrs) -> None:
    if not _STATE.on:
        return
    _record("E", name, time.monotonic(), 0.0, attrs or None)


def call_jit(name: str, jfn, *args, **kwargs):
    """Call a ``jax.jit`` function under tracing: when the call grew
    the function's compile cache it records an ``xla.compile`` span
    (the cold one-offs BENCH_r06 took a PR to localize — now
    self-evident in any trace), otherwise a plain execute span named
    ``name``. Warm execute spans measure DISPATCH time (jax dispatch
    is async); compile happens synchronously inside the call so
    compile spans are true walls. Tracing off: a direct call."""
    if not _STATE.on:
        return jfn(*args, **kwargs)
    size_fn = getattr(jfn, "_cache_size", None)
    before = None
    if size_fn is not None:
        try:
            before = size_fn()
        except Exception:
            before = None
    t0 = time.monotonic()
    out = jfn(*args, **kwargs)
    dur = time.monotonic() - t0
    compiled = False
    if before is not None:
        try:
            compiled = size_fn() > before
        except Exception:
            pass
    if compiled:
        _record("X", "xla.compile", t0, dur, {"kernel": name})
        try:
            from . import metrics

            metrics.registry().counter("xla_compiles").inc()
            metrics.registry().histogram("xla_compile_ms").observe(
                dur * 1000.0)
        except Exception:
            pass
    else:
        _record("X", name, t0, dur, None)
    return out


# -- per-query context (tier/tactic attribution) -------------------------

_qtls = threading.local()


@contextmanager
def query_context(**kw):
    """Tag solver queries issued inside the block with tier/tactic
    attributes; core.check reads the innermost context for its span,
    the per-tactic wall histograms and the slow-query log. Nesting
    merges (inner keys win)."""
    old = getattr(_qtls, "ctx", None)
    _qtls.ctx = dict(old, **kw) if old else dict(kw)
    try:
        yield
    finally:
        _qtls.ctx = old


def current_query_context() -> dict:
    return getattr(_qtls, "ctx", None) or {}


# -- export --------------------------------------------------------------

def snapshot_events() -> List[tuple]:
    """A consistent copy of the ring buffer (oldest first)."""
    with _STATE.lock:
        return list(_STATE.buf)


def chrome_trace_dict(rank: int = 0) -> dict:
    """The Chrome trace-event (JSON object format) representation of
    the ring buffer — ``pid`` is the corpus rank so multi-rank traces
    can be concatenated by merging traceEvents lists."""
    with _STATE.lock:
        events = list(_STATE.buf)
        names = dict(_STATE.tid_names)
    te = []
    for tid, name in sorted(names.items()):
        te.append({"ph": "M", "name": "thread_name", "pid": rank,
                   "tid": tid, "args": {"name": name}})
    for phase, name, t0, dur, tid, attrs in events:
        e = {"ph": phase, "name": name, "pid": rank, "tid": tid,
             "ts": round(t0 * 1e6, 1)}
        if phase == "X":
            e["dur"] = round(dur * 1e6, 1)
        if phase == "i":
            e["s"] = "t"  # instant scope: thread
        if attrs:
            e["args"] = attrs
        te.append(e)
    return {"traceEvents": te, "displayTimeUnit": "ms",
            "otherData": {"tool": "mythril-tpu", "rank": rank,
                          "dropped_spans": _STATE.dropped}}


def export_chrome_trace(path, rank: int = 0) -> None:
    """Write the ring buffer as Chrome trace JSON (Perfetto loads it
    directly). Never raises."""
    try:
        payload = chrome_trace_dict(rank=rank)
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, str(path))
    except Exception:
        pass


def export_jsonl(path, rank: int = 0) -> None:
    """Write the ring buffer as a flat JSONL event log (one object
    per line; grep/jq-friendly twin of the Chrome export)."""
    try:
        with _STATE.lock:
            events = list(_STATE.buf)
            names = dict(_STATE.tid_names)
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            for phase, name, t0, dur, tid, attrs in events:
                rec = {"ph": phase, "name": name,
                       "t_s": round(t0, 6), "dur_s": round(dur, 6),
                       "thread": names.get(tid, str(tid)),
                       "rank": rank}
                if attrs:
                    rec["attrs"] = attrs
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, str(path))
    except Exception:
        pass
