"""Cross-run warm store: code-hash-keyed persistence of proofs, facts,
static artifacts, and learned solver routing (docs/warm_store.md).

Every ``myth analyze`` used to start cold: an empty verdict cache, a
re-computed static pass, and a solver portfolio re-discovering which
tactic wins — even when the same bytecode (or a near-duplicate fork,
the dominant case at analysis-as-a-service scale, ROADMAP item 1) was
fully analyzed minutes ago. This module is the disk-backed half of the
run-wide caches: one versioned entry per sha256(code) under
``--out-dir/warm/`` (override ``MTPU_WARM_DIR``), carrying

* the **verdict-cache banks** — exact/ancestor UNSAT proofs, SAT
  models, propagated facts and absorbed bounds, exported through the
  existing ``VerdictCache.export_entries`` 5-tuple seam (proofs only,
  never timeouts — the same rule migration sidecars follow);
* the **full static sidecar** — CFG/reach/taint/selectors/deps plus
  the PR-12 verified loop-summary templates, framed with the
  ``checkpoint.STATIC_SIDECAR_SHAPE`` version exactly like a shipped
  migration sidecar (version-skewed entries drop whole);
* the **cost model's** per-contract fork peak and width clamp (the
  stats.json material, unified behind the store so a standalone
  ``myth analyze`` warm-starts ``pick_width`` too);
* a per-query-shape **tactic record** (tactic, budget, wall
  histogram) that ``core.check`` and the PR-4 portfolio race consult
  to pick the *first-try* tactic and first budget per shape, with the
  race demoted to the fallback for shapes with no history (ROADMAP
  item 2's learned-routing loop, closed over Z3's own tactics — the
  Bitwuzla engine itself is not installable in this environment).

Load happens once at analysis start (``begin_analysis``): imported
banks are adopted exactly like a thief adopting a migration sidecar —
``VerdictCache.import_entries`` re-interns the terms so fingerprints
re-derive locally, and ``static_pass/memo.import_entries`` fills COLD
slots only (the PR-8 LRU rule — a warm import never evicts a hot
in-process entry). Saves happen at round sinks (``round_sink``, wired
in laser/svm.py beside the checkpoint sink) and at analysis end, via
atomic tmp+rename.

Trust boundary: a store entry is dropped WHOLE — never partially
adopted — when its version, static-sidecar shape, or recorded code
hash disagrees with this build/this request, or when the payload is
truncated/corrupt. Only proofs ever enter (the verdict cache cannot
record a timeout), so a stale or adversarial *absence* degrades to a
cold start and nothing else.

Gate: ``MTPU_WARM`` (default on; ``=0`` — or ``--no-warm-store`` — is
bit-for-bit off: no load, no save, no store directory is ever
created, and the routing consult short-circuits on an empty table).
With no directory configured (no ``--out-dir``-style caller and no
``MTPU_WARM_DIR``) the store is inert the same way.

All disk I/O for the store lives in THIS module (lint rule 8,
``warm-store-io-outside-module`` — the same one-sanctioned-seam shape
as rule 5's raw-pickle ban); serialization itself routes through the
checkpoint helpers (``dump_with_terms``/``load_with_terms``) so term
DAGs travel as flat tables and re-intern with hash-consing intact.

Counters: warm_hits / warm_misses / verdicts_warmed / facts_warmed /
static_warmed / route_first_try_wins (SolverStatistics -> the "Warm
store" render group -> bench detail -> shard reports -> corpus
aggregate).
"""

import io
import logging
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: store format version: bump on any payload-layout change — skewed
#: entries drop whole (a mixed-build fleet re-derives from bytes
#: instead of adopting a stale shape)
STORE_VERSION = 1

#: verdict entries persisted per save (newest first — the run-wide
#: cache can hold 16k entries across a whole corpus rank; the tail
#: relevant to ONE code is much smaller, and GC caps total disk)
EXPORT_CAP = 4096

#: routing: minimum observed queries per (shape, tactic) before the
#: record may steer a first try, and the definitive-outcome ratio it
#: must clear (a shape that mostly times out must keep the full-budget
#: default path — a routed short try would just add wall)
ROUTE_MIN_SAMPLES = 3
ROUTE_MIN_DEFINITIVE = 0.6
#: routed first-try budget = ROUTE_BUDGET_FACTOR * p90(wall), clamped
ROUTE_BUDGET_FACTOR = 2.0
ROUTE_BUDGET_MIN_S = 0.05
ROUTE_BUDGET_MAX_S = 5.0
#: per-(shape, tactic) reservoir of recent definitive walls (ms)
_WALL_RESERVOIR = 50

#: GC defaults (tools/warm_gc.py + the corpus runner): entry-count cap
#: and age cap, both overridable by env
GC_MAX_ENTRIES = int(os.environ.get("MTPU_WARM_MAX_ENTRIES", "512"))
GC_MAX_AGE_DAYS = float(os.environ.get("MTPU_WARM_MAX_AGE_DAYS", "0")
                        or 0) or None

#: tri-state override for tests/bench (None = read MTPU_WARM + args)
FORCE: Optional[bool] = None

_LOCK = threading.RLock()
#: out-dir-derived store location (configure()); MTPU_WARM_DIR wins
_CONFIGURED_DIR: Optional[str] = None
#: the analysis currently bracketed by begin_analysis/end_analysis:
#: {"key": code hash, "disassembly": ..., "loaded": bool}
_CURRENT: Optional[dict] = None
#: routing records LOADED from the store (consulted — cross-run
#: history only, so a cold run's behavior never depends on its own
#: earlier queries and every =0/off path stays bit-for-bit)
_ROUTES_LOADED: Dict[str, dict] = {}
#: routing records OBSERVED this process (saved, never consulted)
_ROUTES_FRESH: Dict[str, dict] = {}
#: cheap per-query guard: observation/consult short-circuit unless an
#: active begin_analysis/configure turned the store on
_ACTIVE = False


def enabled() -> bool:
    """The MTPU_WARM master gate (default on; ``=0`` or
    ``--no-warm-store`` is bit-for-bit off)."""
    if FORCE is not None:
        return FORCE
    try:
        from .support_args import args

        if getattr(args, "no_warm_store", False):
            return False
    except Exception:
        pass
    return os.environ.get("MTPU_WARM", "1") != "0"


def store_dir() -> Optional[str]:
    """The store directory: MTPU_WARM_DIR wins, else the configured
    ``<out-dir>/warm``, else None (store inert)."""
    env = os.environ.get("MTPU_WARM_DIR")
    if env:
        return env
    return _CONFIGURED_DIR


def active() -> bool:
    return enabled() and store_dir() is not None


def configure(out_dir) -> None:
    """Bind the store to ``<out_dir>/warm`` (corpus runner, bench).
    Nothing is created until the first save; MTPU_WARM_DIR overrides."""
    global _CONFIGURED_DIR, _ACTIVE
    with _LOCK:
        _CONFIGURED_DIR = str(Path(out_dir) / "warm")
        _ACTIVE = active()


def swap_analysis(state: Optional[dict]) -> Optional[dict]:
    """Exchange the begin_analysis/end_analysis bracket — the packed
    daemon's member baton switch (docs/daemon.md §wave packing): each
    member's in-flight analysis context (code hash key, verdict-bank
    mark, static key set) parks with the member, so interleaved
    tenants keep per-request bank attribution. Returns the outgoing
    bracket (None when no analysis was in flight)."""
    global _CURRENT
    with _LOCK:
        prev = _CURRENT
        _CURRENT = state
    return prev


def reset() -> None:
    """Drop all in-process store state (tests)."""
    global _CONFIGURED_DIR, _CURRENT, _ACTIVE
    with _LOCK:
        _CONFIGURED_DIR = None
        _CURRENT = None
        _ROUTES_LOADED.clear()
        _ROUTES_FRESH.clear()
        _ACTIVE = False


def _stats():
    from ..smt.solver.solver_statistics import SolverStatistics

    return SolverStatistics()


def code_key(contract) -> str:
    """The store key for a contract: same binding checkpoints carry
    (checkpoint.code_identity — sha256 over the creation-or-runtime
    hex), so a warm entry can never be adopted by other code."""
    from .checkpoint import code_identity

    return code_identity(contract)


def _entry_path(key: str) -> Optional[Path]:
    d = store_dir()
    if not d:
        return None
    return Path(d) / (key + ".warm")


# -- entry serialization -------------------------------------------------

#: lock-file suffix beside each entry (``<key>.warm.lock``): the
#: per-entry advisory flock serializing concurrent writers on one code
#: hash — two daemon tenants, or a tenant racing the GC. Reads need no
#: lock (the rename is atomic and an open fd survives an unlink), and
#: the tmp+rename keeps even an UNLOCKED writer whole-file-atomic; the
#: lock's job is ordering — a reader after save N sees save N, not
#: save N-1 re-landing late — and keeping the GC from deleting an
#: entry mid-rewrite. Lock files are empty and only GC'd once their
#: entry is gone.
_LOCK_SUFFIX = ".lock"


def _entry_lock(path: Path):
    """The per-entry advisory lock (support/lock.LockFile)."""
    from .lock import LockFile

    return LockFile(str(path) + _LOCK_SUFFIX)


def _write_entry(key: str, payload: dict) -> bool:
    """Atomic tmp+rename write through the checkpoint term-safe
    pickler (term DAGs travel as flat tables), serialized per entry by
    the advisory lock (two simultaneous requests on one code hash must
    not interleave their saves with each other or with a GC delete).
    Best-effort: a save failure must never block the analysis it
    warms."""
    path = _entry_path(key)
    if path is None:
        return False
    try:
        from . import state_codec
        from .checkpoint import dump_with_terms

        path.parent.mkdir(parents=True, exist_ok=True)
        with _entry_lock(path):
            fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                       prefix=".warm-")
            try:
                with os.fdopen(fd, "wb") as f:
                    if state_codec.enabled():
                        # codec frame: the verdict-bank entries (the
                        # entry's bulk — sibling constraint prefixes)
                        # delta-chain against one shared term table
                        # (docs/state_codec.md); the rest of the
                        # payload rides as frame meta
                        verdicts = list(payload.get("verdicts", ()))
                        meta = {k: v for k, v in payload.items()
                                if k != "verdicts"}
                        f.write(state_codec.encode_frame(
                            meta, verdicts))
                    else:
                        dump_with_terms(f, payload)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return True
    except Exception as e:
        log.warning("warm store save failed (%s); next run starts "
                    "cold", e)
        return False


def _read_entry(key: str) -> Optional[dict]:
    """Load and validate one entry. Version-skewed, shape-skewed,
    corrupt, or foreign-hash payloads drop WHOLE and are never
    trusted — the analysis just starts cold."""
    path = _entry_path(key)
    if path is None or not path.exists():
        return None
    try:
        from . import state_codec
        from .checkpoint import STATIC_SIDECAR_SHAPE, load_with_terms

        with open(path, "rb") as f:
            data = f.read()
        if state_codec.is_frame(data):
            # codec frame (written gate-on): meta + verdict parts.
            # CodecError propagates into the drop-whole handler below.
            meta, verdicts = state_codec.decode_frame(data)
            payload = dict(meta)
            payload["verdicts"] = list(verdicts)
        else:
            payload = load_with_terms(io.BytesIO(data))
        if not isinstance(payload, dict):
            log.info("warm store %s: malformed payload — dropped",
                     path.name)
            return None
        if payload.get("version") != STORE_VERSION:
            log.info("warm store %s: version %s != %d — dropped",
                     path.name, payload.get("version"), STORE_VERSION)
            return None
        if payload.get("static_shape") != STATIC_SIDECAR_SHAPE:
            log.info("warm store %s: static shape %s != %d — dropped",
                     path.name, payload.get("static_shape"),
                     STATIC_SIDECAR_SHAPE)
            return None
        if payload.get("code_hash") != key:
            log.warning("warm store %s: recorded hash %.12s != "
                        "requested %.12s — foreign entry dropped",
                        path.name, str(payload.get("code_hash")), key)
            return None
        return payload
    except (KeyboardInterrupt, MemoryError):
        raise
    except Exception as e:
        log.warning("warm store %s unreadable (%s) — dropped; "
                    "starting cold", path.name, e)
        return None


# -- analysis bracketing -------------------------------------------------


def begin_analysis(contract) -> bool:
    """Load the contract's warm entry once, at analysis start: adopt
    the verdict banks (like a migration-sidecar replay), fill cold
    static-memo slots, seed the cost model, and arm the routing
    consult. Returns True on a warm hit."""
    global _CURRENT, _ACTIVE
    if not active():
        _ACTIVE = False
        return False
    _ACTIVE = True
    try:
        key = code_key(contract)
    except Exception as e:
        log.debug("warm store: no code identity (%s)", e)
        return False
    disassembly = getattr(contract, "disassembly", None)
    # mark the verdict cache BEFORE importing: a save then exports the
    # imported banks plus everything THIS analysis proves, but not a
    # whole corpus rank's accumulation from earlier contracts (the
    # full-bank export measured quadratic over an 18-contract sweep)
    mark = 0
    try:
        from ..smt.solver import verdicts as verdict_mod

        vc0 = verdict_mod.cache()
        if vc0 is not None:
            mark = vc0.mark()
    except Exception:
        mark = 0
    # the static-memo keys THIS contract's codes hash to (runtime +
    # creation): a save exports only those StaticInfos, not the whole
    # rank's memo (code created mid-run falls back to re-analysis —
    # milliseconds, memoized)
    static_keys = []
    try:
        from ..analysis.static_pass import code_bytes_of, memo

        rt = code_bytes_of(disassembly) if disassembly is not None \
            else None
        if rt:
            static_keys.append(memo.code_hash(rt))
        creation = getattr(contract, "creation_code", "") or ""
        if creation:
            static_keys.append(memo.code_hash(
                bytes.fromhex(creation.replace("0x", ""))))
    except Exception:
        pass
    with _LOCK:
        _CURRENT = {"key": key, "disassembly": disassembly,
                    "loaded": False, "mark": mark,
                    "static_keys": static_keys}
    payload = _read_entry(key)
    ss = _stats()
    if payload is None:
        ss.bump(warm_misses=1)
        return False
    ss.bump(warm_hits=1)
    with _LOCK:
        _CURRENT["loaded"] = True

    # (a) verdict banks: proofs/facts/bounds re-intern into THIS
    # process's term table — the thief-adoption seam verbatim
    entries = list(payload.get("verdicts") or ())
    proofs = sum(1 for e in entries
                 if len(e) > 1 and e[1] in ("sat", "unsat"))
    facts = sum(1 for e in entries
                if (len(e) > 3 and e[3]) or (len(e) > 4 and e[4]))
    if entries:
        try:
            from ..smt.solver import verdicts as verdict_mod

            vc = verdict_mod.cache()
            if vc is not None:
                vc.import_entries(entries)
                ss.bump(verdicts_warmed=proofs, facts_warmed=facts)
        except Exception as e:
            log.warning("warm verdict import failed (%s); re-proving",
                        e)

    # (b) static sidecar: cold-slot-only import (PR-8 LRU rule); the
    # shape gate already passed whole-entry, but stale individual
    # entries still filter through the sidecar's own field probe
    sentries = list(payload.get("static") or ())
    if sentries:
        try:
            from ..analysis.static_pass import memo as static_memo
            from .checkpoint import filter_static_entries

            n = static_memo.import_entries(
                filter_static_entries(sentries))
            if n:
                ss.bump(static_warmed=n)
        except Exception as e:
            log.warning("warm static import failed (%s); "
                        "re-analyzing", e)

    # (c) cost model: fork peak -> pick_width warm start, width clamp.
    # MTPU_WARM_COST=0 keeps the proofs/static/routing banks but skips
    # the width warm start: seeding PATH_HISTORY flips the FIRST lane
    # sweep to the learned (wider) width, whose kernels this process
    # has not traced yet — a win for a long-lived daemon with warm jit
    # caches, a per-process tracing cost for one-shot CLI runs.
    cost = payload.get("cost") or {}
    try:
        from ..parallel import cost_model

        peak = int(cost.get("fork_peak", 0) or 0)
        if os.environ.get("MTPU_WARM_COST", "1") == "0":
            peak = 0
        if peak > 0 and disassembly is not None:
            cost_model.record_host_peak(disassembly, peak)
            code = cost_model._light_code_bytes(disassembly)
            if code is not None:
                try:
                    from ..laser.lane_engine import PATH_HISTORY

                    if peak > PATH_HISTORY.get(code, 0):
                        PATH_HISTORY[code] = peak
                except Exception:
                    pass  # lane path optional
        clamps = cost.get("width_clamps")
        if isinstance(clamps, dict):
            for shape, clamp in clamps.items():
                if clamp:
                    cost_model.record_width_clamp(
                        int(clamp),
                        shape=int(shape) if int(shape) else None)
        else:
            # pre-map entry: the scalar loads as the shape-blind clamp
            clamp = cost.get("width_clamp")
            if clamp:
                cost_model.record_width_clamp(int(clamp))
    except Exception as e:
        log.debug("warm cost seed failed: %s", e)

    # (d) learned routing: loaded records steer first tries; fresh
    # observations keep accumulating separately and merge at save
    routes = payload.get("routing") or {}
    if isinstance(routes, dict):
        with _LOCK:
            for shape, tactics in routes.items():
                slot = _ROUTES_LOADED.setdefault(str(shape), {})
                for tactic, rec in (tactics or {}).items():
                    _merge_route(slot, str(tactic), rec)
    return True


def round_sink() -> None:
    """Persist the current analysis's banks at a transaction-round
    boundary (wired in laser/svm.py beside the checkpoint sink) — a
    SIGTERM'd run leaves its proofs for the next submission."""
    if _ACTIVE and _CURRENT is not None:
        _save_current()


def end_analysis() -> None:
    """Final save + context clear (orchestration/mythril_analyzer.py,
    after fire_lasers settles the detector-phase proofs too)."""
    global _CURRENT
    if _CURRENT is not None and _ACTIVE:
        _save_current()
    with _LOCK:
        _CURRENT = None


def _save_current() -> bool:
    with _LOCK:
        ctx = dict(_CURRENT) if _CURRENT else None
    if ctx is None or not active():
        return False
    from .checkpoint import STATIC_SIDECAR_SHAPE

    payload = {
        "version": STORE_VERSION,
        "code_hash": ctx["key"],
        "static_shape": STATIC_SIDECAR_SHAPE,
        "saved_at": time.time(),
        "verdicts": [],
        "static": [],
        "cost": {},
        "routing": export_routes(),
    }
    try:
        from ..smt.solver import verdicts as verdict_mod

        vc = verdict_mod.cache()
        if vc is not None:
            payload["verdicts"] = vc.export_all_entries(
                cap=EXPORT_CAP, since=int(ctx.get("mark", 0) or 0))
    except Exception as e:
        log.debug("warm verdict export failed: %s", e)
    try:
        from ..analysis.static_pass import memo as static_memo

        keys = ctx.get("static_keys") or None
        payload["static"] = static_memo.export_entries(keys=keys)
    except Exception as e:
        log.debug("warm static export failed: %s", e)
    try:
        from ..parallel import cost_model

        dis = ctx.get("disassembly")
        peak = cost_model.observed_fork_peak(dis) if dis is not None \
            else 0
        payload["cost"] = {"fork_peak": int(peak),
                           # legacy scalar (shape-blind entry) rides
                           # for pre-map readers; the per-shape map is
                           # what new runs adopt
                           "width_clamp": cost_model.WIDTH_CLAMP,
                           "width_clamps": {
                               str(k): v for k, v in
                               cost_model.WIDTH_CLAMPS.items()}}
    except Exception as e:
        log.debug("warm cost export failed: %s", e)
    return _write_entry(ctx["key"], payload)


# -- learned solver routing (ROADMAP item 2) -----------------------------


def query_shape(n_assertions: int) -> str:
    """Coarse structural shape of a feasibility query: the pow2 bucket
    of its constraint count (the same bucketing the compile keys use —
    shapes must repeat across runs for history to mean anything)."""
    n = max(1, int(n_assertions))
    return "n%d" % (1 << (n - 1).bit_length())


def _merge_route(slot: dict, tactic: str, rec) -> None:
    """Merge one (tactic -> record) into ``slot`` (callers hold
    _LOCK). Records are plain JSON-able dicts."""
    if not isinstance(rec, dict):
        return
    cur = slot.setdefault(tactic, {"n": 0, "definitive": 0,
                                   "walls_ms": []})
    cur["n"] += int(rec.get("n", 0) or 0)
    cur["definitive"] += int(rec.get("definitive", 0) or 0)
    walls = [float(w) for w in (rec.get("walls_ms") or ())[:_WALL_RESERVOIR]]
    cur["walls_ms"] = (cur["walls_ms"] + walls)[-_WALL_RESERVOIR:]


def observe_query(n_assertions: int, tactic: str, wall_s: float,
                  status: str) -> None:
    """Record one solver-core outcome for the save-side routing table
    (never consulted in-run — cross-run history only, so cold-path
    behavior never depends on this process's own earlier queries)."""
    if not _ACTIVE:
        return
    tactic = (tactic or "incremental").split(".")[-1]
    if tactic not in ("incremental", "oneshot"):
        return
    definitive = status in ("sat", "unsat")
    shape = query_shape(n_assertions)
    with _LOCK:
        slot = _ROUTES_FRESH.setdefault(shape, {})
        cur = slot.setdefault(tactic, {"n": 0, "definitive": 0,
                                       "walls_ms": []})
        cur["n"] += 1
        if definitive:
            cur["definitive"] += 1
            walls = cur["walls_ms"]
            walls.append(round(wall_s * 1000.0, 3))
            del walls[:-_WALL_RESERVOIR]


def route_for_query(n_assertions: int,
                    timeout_s: float) -> Optional[Tuple[str, float]]:
    """(first-try tactic, first-try budget seconds) for a query shape
    with enough LOADED history, else None (callers keep today's path —
    the full-budget default, or the short-try-then-race escalation).
    The budget is ROUTE_BUDGET_FACTOR x the shape's p90 definitive
    wall, clamped; a routed first try that still comes back UNKNOWN
    falls back to the caller's full pipeline, so routing can cost
    bounded extra wall but never a verdict."""
    if not _ACTIVE or not _ROUTES_LOADED:
        return None
    if os.environ.get("MTPU_WARM_ROUTE", "1") == "0":
        return None  # banks stay warm; first tries keep the default
    shape = query_shape(n_assertions)
    with _LOCK:
        tactics = _ROUTES_LOADED.get(shape)
        if not tactics:
            return None
        best = None
        for tactic, rec in tactics.items():
            n = int(rec.get("n", 0) or 0)
            d = int(rec.get("definitive", 0) or 0)
            if n < ROUTE_MIN_SAMPLES or d / n < ROUTE_MIN_DEFINITIVE:
                continue
            walls = sorted(float(w) for w in rec.get("walls_ms") or ())
            if not walls:
                continue
            p50 = walls[len(walls) // 2]
            p90 = walls[min(len(walls) - 1, int(0.9 * len(walls)))]
            score = (d / n, -p50)
            if best is None or score > best[0]:
                best = (score, tactic, p90)
    if best is None:
        return None
    _score, tactic, p90 = best
    # the failure cost bound: a routed try that exhausts its budget
    # falls back to the caller's FULL pipeline, so the budget is
    # additionally capped at a quarter of the caller's timeout — a
    # timeout-class query a route mispredicts wastes at most 25%
    # extra wall, never a doubled solve
    budget = min(max(ROUTE_BUDGET_FACTOR * p90 / 1000.0,
                     ROUTE_BUDGET_MIN_S), ROUTE_BUDGET_MAX_S,
                 0.25 * float(timeout_s))
    return tactic, max(min(budget, float(timeout_s)), 1e-3)


def export_routes() -> Dict[str, dict]:
    """Loaded + fresh routing records merged for persistence."""
    with _LOCK:
        out: Dict[str, dict] = {}
        for table in (_ROUTES_LOADED, _ROUTES_FRESH):
            for shape, tactics in table.items():
                slot = out.setdefault(shape, {})
                for tactic, rec in tactics.items():
                    _merge_route(slot, tactic, rec)
        return out


# -- garbage collection (tools/warm_gc.py + the corpus runner) -----------


def gc_store(path=None, max_entries: Optional[int] = None,
             max_age_days: Optional[float] = None,
             dry_run: bool = False) -> dict:
    """Cap the store by entry count and age — LRU by mtime (a warm hit
    does not rewrite the file, but every completed analysis re-saves
    its entry, so mtime tracks useful recency). ``dry_run`` reports
    what WOULD go without unlinking. Returns a summary dict."""
    d = Path(path) if path else (Path(store_dir())
                                 if store_dir() else None)
    if d is None or not d.is_dir():
        return {"dir": str(d) if d else None, "kept": 0,
                "removed": [], "dry_run": dry_run}
    if max_entries is None:
        max_entries = GC_MAX_ENTRIES
    if max_age_days is None:
        max_age_days = GC_MAX_AGE_DAYS
    files = []
    for f in d.glob("*.warm"):
        try:
            files.append((f.stat().st_mtime, f))
        except OSError:
            continue
    files.sort()  # oldest first
    now = time.time()
    doomed = []
    survivors = []
    for mtime, f in files:
        if max_age_days and now - mtime > max_age_days * 86400.0:
            doomed.append(f)
        else:
            survivors.append(f)
    if max_entries is not None and len(survivors) > max_entries:
        extra = len(survivors) - max_entries
        doomed.extend(survivors[:extra])  # oldest beyond the cap
        survivors = survivors[extra:]
    removed = []
    for f in doomed:
        if not dry_run:
            # per-entry advisory lock, NON-blocking: a writer holding
            # the lock is mid-save on this code hash — the entry is
            # hot, so it survives this GC pass instead of having its
            # fresh save deleted out from under the tenant
            lock = _entry_lock(f)
            try:
                if not lock.acquire(blocking=False):
                    survivors.append(f)
                    continue
            except OSError:
                pass  # flock unsupported: fall back to plain unlink
            try:
                f.unlink()
            except OSError:
                pass
            finally:
                try:
                    lock.release()
                except OSError:
                    pass
        removed.append(f.name)
    if not dry_run:
        # orphaned lock files (entry already GC'd): empty, but a
        # long-lived store should not accrete them without bound.
        # Skip any a live writer holds — it is about to re-create
        # the entry.
        for lf in d.glob("*.warm" + _LOCK_SUFFIX):
            entry = Path(str(lf)[: -len(_LOCK_SUFFIX)])
            if entry.exists():
                continue
            probe = _entry_lock(entry)
            try:
                if probe.acquire(blocking=False):
                    try:
                        lf.unlink()
                    except OSError:
                        pass
                    probe.release()
            except OSError:
                pass
    if removed and not dry_run:
        log.info("warm store gc: removed %d entr%s (%d kept)",
                 len(removed), "y" if len(removed) == 1 else "ies",
                 len(survivors))
    return {"dir": str(d), "kept": len(survivors),
            "removed": removed, "dry_run": dry_run}


#: flight-recorder artifacts the age cap sweeps (crash dumps are
#: post-mortem material — useful while fresh, landfill after)
_FLIGHTREC_PATTERNS = ("resume_rank*.ckpt", "trace_rank*.json",
                       "events_rank*.jsonl", "metrics_rank*.json",
                       "inflight_rank*.json", "crash_rank*.json")


def gc_flightrec(path, max_entries: Optional[int] = None,
                 max_age_days: Optional[float] = None,
                 dry_run: bool = False) -> dict:
    """Cap a crash flight recorder's dump directory
    (``<out-dir>/flightrec/`` — support/telemetry/flightrec.py) by the
    SAME count/age/LRU policy the warm-store GC applies: dump
    artifacts older than the age cap go; ``resume_rank*.ckpt`` live
    checkpoints beyond the count cap go oldest-first (mtime LRU — a
    resumable rank rewrites its file on every dump, so mtime tracks
    liveness).  A ``*.ckpt.verdicts`` sidecar whose checkpoint is
    gone — GC'd now, resumed-and-removed earlier, or never landed —
    is an orphan and goes too: it can never be replayed without the
    snapshot it rode with.  ``dry_run`` reports without unlinking.
    Returns a summary dict (tools/warm_gc.py --flightrec)."""
    d = Path(path) if path else None
    if d is None or not d.is_dir():
        return {"dir": str(d) if d else None, "kept": 0,
                "removed": [], "orphan_sidecars": [],
                "dry_run": dry_run}
    if max_entries is None:
        max_entries = GC_MAX_ENTRIES
    if max_age_days is None:
        max_age_days = GC_MAX_AGE_DAYS
    files = []
    for pattern in _FLIGHTREC_PATTERNS:
        for f in d.glob(pattern):
            try:
                files.append((f.stat().st_mtime, f))
            except OSError:
                continue
    files.sort()  # oldest first
    now = time.time()
    doomed: List[Path] = []
    survivors: List[Path] = []
    for mtime, f in files:
        if max_age_days and now - mtime > max_age_days * 86400.0:
            doomed.append(f)
        else:
            survivors.append(f)
    if max_entries is not None:
        ckpts = [f for f in survivors if f.suffix == ".ckpt"]
        if len(ckpts) > max_entries:
            extra = set(ckpts[: len(ckpts) - max_entries])
            doomed.extend(f for f in survivors if f in extra)
            survivors = [f for f in survivors if f not in extra]
    removed = []
    for f in doomed:
        if not dry_run:
            try:
                f.unlink()
            except OSError:
                continue
        removed.append(f.name)
    # orphan sweep: sidecars whose checkpoint no longer exists (or is
    # doomed this pass — dry-run reasons about the hypothetical state)
    doomed_names = {f.name for f in doomed}
    orphans = []
    for sc in sorted(d.glob("*.ckpt.verdicts")):
        ckpt_name = sc.name[: -len(".verdicts")]
        alive = (d / ckpt_name).exists() \
            and ckpt_name not in doomed_names
        if alive:
            continue
        if not dry_run:
            try:
                sc.unlink()
            except OSError:
                continue
        orphans.append(sc.name)
    if (removed or orphans) and not dry_run:
        log.info("flightrec gc: removed %d dump(s) + %d orphaned "
                 "sidecar(s) (%d kept)",
                 len(removed), len(orphans), len(survivors))
    return {"dir": str(d), "kept": len(survivors),
            "removed": removed, "orphan_sidecars": orphans,
            "dry_run": dry_run}
