"""Run-wide span tracing, the part of
``mythril_tpu/support/telemetry/spans.py`` the device screens use.

Low-overhead, thread-safe spans recorded into a bounded ring buffer.
Gated by ``MTPU_TRACE`` (default OFF): the off path is a single
attribute check returning a shared no-op context manager, so
instrumented seams cost nothing measurable and change no behavior.

``launch`` takes the place of the JAX package's ``call_jit``: the port
has no compile step, so a kernel launch is a plain span. Its duration
is the host's enqueue time (launches are asynchronous); device time
comes from torch.profiler (tools/prof_torch_port.py).

All span timing uses ``time.monotonic()``.
"""

import os
import threading
import time
from collections import deque
from typing import List, Optional

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


_STATE = _State()


def set_enabled(on: bool) -> None:
    """Runtime gate override (tests, profiling)."""
    _STATE.on = bool(on)


def _record(phase: str, name: str, t0: float, dur: float,
            attrs: Optional[dict]) -> None:
    tid = threading.current_thread().ident or 0
    s = _STATE
    with s.lock:
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
    """``with trace.span("propagate.fixpoint", states=n): ...`` — the
    instrumentation primitive. Returns a shared no-op when tracing is
    off."""
    if not _STATE.on:
        return _NULL
    return _Span(name, attrs or None)


def launch(name: str, fn, *args, **kwargs):
    """Call a kernel wrapper (or its plain version) under a span named
    ``name``. Tracing off: a direct call."""
    if not _STATE.on:
        return fn(*args, **kwargs)
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    _record("X", name, t0, time.monotonic() - t0, None)
    return out


def snapshot_events() -> List[tuple]:
    """A consistent copy of the ring buffer (oldest first)."""
    with _STATE.lock:
        return list(_STATE.buf)
