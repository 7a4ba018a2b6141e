"""Typed metrics registry (docs/observability.md).

Counters, gauges and histograms with one process-wide registry —
always on (unlike spans), cheap enough for per-solver-query use. The
registry ABSORBS the legacy ``SolverStatistics`` counter block: the
statistics singleton registers itself as a snapshot *provider*
(``register_provider``), so ``registry().snapshot()`` carries the
full solver counter set under the ``solver`` key while every existing
``ss.batch_count += 1`` call site keeps working unchanged — the old
API is a shim over the same numbers, and the counter-drift guard
(tests/test_counter_drift.py) fails the build when the two views
diverge.

Per-tactic solver-query wall histograms (observed by
smt/solver/core.check) persist into ``--out-dir/stats.json`` beside
the cost model (parallel/cost_model.save_stats) — the raw material
for learned per-contract solver routing (ROADMAP open item 3) — and
per-rank snapshots ship through the corpus shard-report/merge path
(parallel/corpus.py) into the corpus aggregate.
"""

import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence

#: default latency buckets (milliseconds): solver walls span ~0.1 ms
#: cache-warm discharges to multi-second portfolio races
DEFAULT_MS_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10000, 30000)


class Counter:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus sum/count/max —
    enough to reconstruct means and tail quantile bounds without
    keeping samples."""

    __slots__ = ("name", "buckets", "_lock", "counts", "sum", "count",
                 "max")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, v: float) -> None:
        idx = bisect_left(self.buckets, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            if v > self.max:
                self.max = v

    def to_dict(self) -> dict:
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self.counts),
                    "sum": round(self.sum, 3),
                    "count": self.count,
                    "max": round(self.max, 3)}


class Registry:
    """Process-wide metric registry. get-or-create accessors are the
    only API call sites need; everything is thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._providers: Dict[str, Callable[[], dict]] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, buckets))
        return h

    def register_provider(self, name: str,
                          fn: Callable[[], dict]) -> None:
        """Attach an external counter block (e.g. SolverStatistics)
        whose live dict is merged into every snapshot under `name`."""
        with self._lock:
            self._providers[name] = fn

    def export_state(self) -> dict:
        """The registry's NATIVE metrics (no providers) — the shape
        persisted into stats.json and shipped in shard reports."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: h.to_dict()
                     for n, h in self._histograms.items()}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def snapshot(self) -> dict:
        """export_state plus every registered provider's live block
        (the flight recorder's metrics.json view)."""
        out = self.export_state()
        with self._lock:
            providers = dict(self._providers)
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception:
                out[name] = {"error": "provider failed"}
        return out

    def reset(self) -> None:
        """Drop native metrics (tests only; providers stay)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def register_provider(name: str, fn: Callable[[], dict]) -> None:
    _REGISTRY.register_provider(name, fn)


def merge_states(states: Sequence[Optional[dict]]) -> dict:
    """Merge per-rank ``export_state`` dicts into one aggregate:
    counters/histogram counts and sums add, gauges and histogram max
    take the max (the corpus shard-report merge path)."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for st in states:
        if not isinstance(st, dict):
            continue
        for n, v in (st.get("counters") or {}).items():
            counters[n] = counters.get(n, 0) + v
        for n, v in (st.get("gauges") or {}).items():
            gauges[n] = max(gauges.get(n, v), v)
        for n, h in (st.get("histograms") or {}).items():
            cur = hists.get(n)
            if cur is None:
                hists[n] = {"buckets": list(h.get("buckets", [])),
                            "counts": list(h.get("counts", [])),
                            "sum": h.get("sum", 0.0),
                            "count": h.get("count", 0),
                            "max": h.get("max", 0.0)}
                continue
            if cur.get("buckets") == h.get("buckets") and \
                    len(cur.get("counts", [])) == len(h.get("counts",
                                                            [])):
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], h["counts"])]
            cur["sum"] = round(cur.get("sum", 0.0)
                               + h.get("sum", 0.0), 3)
            cur["count"] = cur.get("count", 0) + h.get("count", 0)
            cur["max"] = max(cur.get("max", 0.0), h.get("max", 0.0))
    return {"counters": counters, "gauges": gauges,
            "histograms": hists}
