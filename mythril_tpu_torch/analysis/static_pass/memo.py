"""Per-code-hash memoization and migration shipping of static results.

The analysis is pure in the code bytes, so results key on a content
hash and are shared process-wide; corpus re-analyses and re-seeded
engines never re-derive. Entries are plain picklable data (namedtuples
of ints/frozensets + one numpy array — no SMT terms), so migration
batches ship them whole (support/checkpoint.save_static_sidecar) and
a thief imports them ahead of its resume instead of re-analyzing.

Eviction policy (PR 8): the memo is a true LRU — ``get`` bumps the
entry, and when the cap trips the LEAST-recently-used entry leaves,
not insertion order's oldest. Sidecar imports fill COLD slots only:
a thief adopting a victim's whole memo must never evict the entries
its own in-flight contracts are hot on (the old FIFO pop did exactly
that under a 256-entry import). Evictions count process-wide
(``evictions()``/SolverStatistics.static_memo_evictions) so a cap
thrash is visible in telemetry instead of silent re-analysis."""

import hashlib
import logging
import threading
from collections import OrderedDict
from typing import List, Optional

log = logging.getLogger(__name__)

_LOCK = threading.Lock()
_MEMO: "OrderedDict[str, object]" = OrderedDict()
_MEMO_CAP = 256  # a corpus run touches a few dozen codes
_EVICTIONS = 0


def code_hash(code: bytes) -> str:
    return hashlib.sha256(code).hexdigest()


def _evict_lru() -> None:
    """Drop the least-recently-used entry (callers hold _LOCK)."""
    global _EVICTIONS
    _MEMO.popitem(last=False)
    _EVICTIONS += 1
    try:
        from ...smt.solver.solver_statistics import SolverStatistics

        SolverStatistics().bump(static_memo_evictions=1)
    except Exception:
        pass


def get(key: str):
    with _LOCK:
        info = _MEMO.get(key)
        if info is not None:
            _MEMO.move_to_end(key)  # bump-on-use: hot entries survive
        return info


def put(key: str, info) -> None:
    with _LOCK:
        if key in _MEMO:
            _MEMO.move_to_end(key)
            _MEMO[key] = info
            return
        while len(_MEMO) >= _MEMO_CAP:
            _evict_lru()
        _MEMO[key] = info


def clear() -> None:
    with _LOCK:
        _MEMO.clear()


def evictions() -> int:
    """Process-wide cap evictions so far (telemetry + tests)."""
    with _LOCK:
        return _EVICTIONS


def export_entries(keys: Optional[List[str]] = None) -> List:
    """StaticInfo entries to ship with a migration batch (all memoized
    codes by default — a run's memo is a handful of contracts)."""
    with _LOCK:
        if keys is None:
            return list(_MEMO.values())
        return [_MEMO[k] for k in keys if k in _MEMO]


def import_entries(entries: List) -> int:
    """Adopt shipped entries into COLD slots (idempotent; existing
    keys win — they are derived from identical bytes). An import never
    evicts: once the cap is reached, remaining shipped entries are
    dropped — the thief can always re-derive them from bytes, while a
    hot in-process entry evicted mid-sweep costs a re-analysis on the
    very next window."""
    n = 0
    dropped = 0
    for info in entries:
        key = getattr(info, "code_hash", None)
        if not key:
            continue
        with _LOCK:
            if key in _MEMO:
                continue
            if len(_MEMO) >= _MEMO_CAP:
                dropped += 1
                continue
            # imports land COLD (front of the LRU order): the thief's
            # own entries stay ahead of everything it merely adopted
            _MEMO[key] = info
            _MEMO.move_to_end(key, last=False)
            n += 1
    if n:
        log.info("imported %d shipped static-pass entries", n)
    if dropped:
        log.info("dropped %d shipped static-pass entries (memo full; "
                 "thief re-derives on demand)", dropped)
    return n
