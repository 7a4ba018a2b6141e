"""Run-wide feasibility verdict cache with parent-delta fingerprints.

PR 1's batched discharge (batch.py) reuses work *within* one call: a
trie-ordered pass dedupes shared prefixes and an in-batch registry
subset-kills supersets. But every window and every call site still
starts cold — a constraint prefix proved SAT or UNSAT in window k is
re-proved in window k+1, and the same open-state screen re-solves the
same prefixes contract-round after contract-round. Incremental
word-level solvers win precisely by reusing work across monotonically
growing constraint sets (PolySAT, arxiv 2406.04696) and by screening
with cheap word-level abstractions before the expensive decision
procedure (Bitwuzla, arxiv 2006.01621). This module carries both
across the WHOLE run.

Fingerprinting: path-constraint lists only grow, so a child's cache
key is computed incrementally as ``(parent_fingerprint, delta)`` — the
interned key of the longest already-seen prefix extended by the new
tail — and the key itself is the interned *frozenset* of constraint
tids. Terms are hash-consed process-wide, so a tid-set denotes one
fixed formula forever; frozensets make the key canonical under
constraint reordering and duplication (the soundness requirement: two
orderings of the same conjunction must hit the same entry — see
docs/feasibility_cache.md).

Three reuse tiers run before any solver work:

1. **ancestor-UNSAT subsumption** — a cached UNSAT tid-set kills every
   superset query by monotonicity of conjunction, across windows and
   call sites (the run-wide extension of batch.py's in-batch
   subset-kill). The index keys each UNSAT set by its max tid, so a
   probe is O(|query|) dict hits.
2. **model shadowing** — the longest cached-SAT prefix's model is
   evaluated against ONLY the delta constraints. Evaluation is
   functional and total (terms.eval_term with model completion), so a
   surviving model proves the child SAT with zero solver work; large
   sibling waves route the delta evaluation to the device interval
   kernel with the model pinned as point intervals
   (ops/intervals.shadow_prefilter), host term-eval serves the rest.
3. **interval-bound inheritance** — the per-prefix syntactic variable
   bounds (smt/interval.extract_bounds) are cached per key; a child's
   interval screen seeds from the parent's cached bounds and
   intersects only the delta's contributions instead of rescanning the
   whole system from top.

Verdicts recorded here are only ever *proofs*: core SAT results (with
their model), core/interval/relational UNSAT refutations. Timeouts and
deadline-exhaustion pessimism never enter the cache. Counters land in
SolverStatistics (verdict_hits / verdict_shadows / verdict_unsat_kills
/ verdict_shadow_rejects / verdict_bound_seeds) and surface through
the benchmark and instruction-profiler plugins, bench.py detail
blocks, and ``bench.py --smoke``.
"""

import logging
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from . import core
from .solver_statistics import SolverStatistics

SAT, UNSAT, UNKNOWN = core.SAT, core.UNSAT, core.UNKNOWN

log = logging.getLogger(__name__)


def _locked(fn):
    """Run a VerdictCache method under the instance lock (re-entrant,
    so locked methods may call each other)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper

#: module switch — bench.py --smoke flips it off for the parity
#: spot-check; cache() returns None while disabled
ENABLED = True

#: verdict entries retained (LRU); each may pin a ModelData
_ENTRY_CAP = 16384
#: ancestor-UNSAT keys retained (FIFO)
_UNSAT_CAP = 4096
#: fingerprint-trie tuples retained (cleared wholesale at the cap; keys
#: re-derive cold afterwards)
_FP_CAP = 1 << 18
#: prefix steps walked back looking for a shadowable SAT parent or an
#: inheritable bounds entry
_SHADOW_WALK = 16
#: sibling-delta group size that routes shadow evaluation to the
#: device interval kernel (host term-eval below it)
DEVICE_SHADOW_MIN = 8
#: harvested propagation-fact entries retained (LRU; ops/propagate.py
#: writes them, batch.discharge / support/model.get_model assert them
#: as hints ahead of the real constraints)
_FACT_CAP = 4096


class _Entry:
    __slots__ = ("verdict", "model", "bounds", "stamp")

    def __init__(self):
        self.verdict: Optional[str] = None
        self.model = None  # core.ModelData for SAT entries
        self.bounds: Optional[dict] = None  # var_tid -> (var, lo, hi)
        # write-stamp (monotone per cache): lets the warm store export
        # only entries touched since a mark instead of re-serializing
        # the whole run-wide bank at every round sink
        self.stamp: int = 0


class VerdictCache:
    """Run-wide verdict store keyed by canonical constraint-tid sets."""

    def __init__(self):
        # one re-entrant lock over every public entry point: solver-
        # pool workers (smt/solver/pool.py) publish proofs and the
        # caller pre-pass probes concurrently. A fingerprint-striped
        # scheme was considered and rejected — the trie (_fp/_intern),
        # the entry LRU and the UNSAT index are shared across any
        # stripe split, and every critical section is a handful of
        # dict operations, so stripes would add deadlock surface
        # without removing contention (docs/solver_pool.md).
        self._lock = threading.RLock()
        # monotone write counter backing _Entry.stamp / _fact_stamps
        self._stamp = 0
        # ordered tid-tuple -> interned frozenset key (the trie: a
        # child extends its parent prefix's key by the delta tid)
        self._fp: Dict[tuple, frozenset] = {}
        self._intern: Dict[frozenset, frozenset] = {}
        self._entries: "OrderedDict[frozenset, _Entry]" = OrderedDict()
        self._unsat_by_rep: Dict[int, List[frozenset]] = {}
        self._unsat_order: List[frozenset] = []
        # harvested propagation facts per canonical key: implied
        # consequences of the keyed set (docs/propagation.md), safe to
        # assert ahead of its real constraints in any solver query
        self._facts: "OrderedDict[frozenset, tuple]" = OrderedDict()
        # fact-bank write stamps (kept beside _facts rather than on
        # _Entry so note_facts never has to mint LRU entries)
        self._fact_stamps: Dict[frozenset, int] = {}

    # -- fingerprinting ----------------------------------------------------

    @_locked
    def key(self, tids: tuple) -> frozenset:
        """Canonical key for an ORDERED constraint-tid tuple.

        Incremental: when the proper prefix ``tids[:-1]`` has been seen
        (the monotone path-growth hot case), the key is the parent's
        interned set extended by the one delta tid; only a cold chain
        pays a full-set build. Canonical: the interned frozenset is
        order- and duplicate-insensitive."""
        got = self._fp.get(tids)
        if got is not None:
            return got
        parent = self._fp.get(tids[:-1]) if tids else None
        if parent is not None:
            tail = tids[-1]
            ks = parent if tail in parent else parent | frozenset((tail,))
        else:
            ks = frozenset(tids)
        ks = self._intern.setdefault(ks, ks)
        if len(self._fp) > _FP_CAP:
            self._fp.clear()
        self._fp[tids] = ks
        return ks

    # -- entry bookkeeping -------------------------------------------------

    def _ensure_entry(self, ks: frozenset) -> _Entry:
        e = self._entries.get(ks)
        if e is None:
            e = self._entries[ks] = _Entry()
            while len(self._entries) > _ENTRY_CAP:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(ks)
        return e

    def _index_unsat(self, ks: frozenset) -> None:
        if not ks:
            return
        bucket = self._unsat_by_rep.setdefault(max(ks), [])
        if ks in bucket:
            return
        bucket.append(ks)
        self._unsat_order.append(ks)
        while len(self._unsat_order) > _UNSAT_CAP:
            old = self._unsat_order.pop(0)
            lst = self._unsat_by_rep.get(max(old))
            if lst and old in lst:
                lst.remove(old)
                if not lst:
                    del self._unsat_by_rep[max(old)]

    @_locked
    def record(self, tids, verdict: str, model=None,
               index_unsat: bool = True) -> None:
        """Store a PROVED verdict (and its model) for a tid tuple/list.

        Callers must never pass timeout or deadline pessimism here —
        only core SAT/UNSAT results and sound screen refutations."""
        if not ENABLED or verdict not in (SAT, UNSAT):
            return
        ks = self.key(tuple(tids))
        if not ks:
            return  # the empty conjunction needs no cache
        e = self._ensure_entry(ks)
        if e.verdict is not None and e.verdict != verdict:
            # two proofs disagreeing means a soundness bug somewhere
            # upstream — keep the first, but say so loudly
            log.warning("verdict cache conflict for %d-constraint set: "
                        "%s then %s", len(ks), e.verdict, verdict)
            return
        e.verdict = verdict
        self._stamp += 1
        e.stamp = self._stamp
        if model is not None and e.model is None:
            e.model = model
        if verdict == UNSAT and index_unsat:
            self._index_unsat(ks)

    # -- harvested propagation facts (ops/propagate.py) --------------------

    @_locked
    def note_facts(self, tids, facts: Sequence) -> None:
        """Store learned facts (raw terms IMPLIED by the keyed set —
        pinned constants, tightened bounds, forced bit masks the device
        propagation pass derived). Asserting them ahead of the real
        constraints cannot change a query's verdict or model set."""
        if not ENABLED or not facts:
            return
        ks = self.key(tuple(tids))
        if not ks:
            return
        self._facts[ks] = tuple(facts)
        self._facts.move_to_end(ks)
        self._stamp += 1
        self._fact_stamps[ks] = self._stamp
        while len(self._facts) > _FACT_CAP:
            old, _ = self._facts.popitem(last=False)
            self._fact_stamps.pop(old, None)

    @_locked
    def facts_for(self, tids) -> tuple:
        """Harvested facts for an exact tid key (empty tuple when the
        propagation pass has not screened this set)."""
        got = self._facts.get(self.key(tuple(tids)))
        if got is None:
            return ()
        return got

    @_locked
    def absorb_bounds(self, tids, bounds: Dict[int, tuple]) -> None:
        """Meet propagated per-variable bounds into the entry's cached
        bounds, so tier-3 interval inheritance (bounds_for) seeds
        descendants from the PROPAGATED state instead of the raw
        syntactic extraction."""
        if not ENABLED or not bounds:
            return
        ks = self.key(tuple(tids))
        if not ks:
            return
        e = self._ensure_entry(ks)
        cur = dict(e.bounds) if e.bounds else {}
        for var_tid, (var, lo, hi) in bounds.items():
            old = cur.get(var_tid)
            if old is None:
                cur[var_tid] = (var, lo, hi)
            else:
                _, olo, ohi = old
                cur[var_tid] = (var, max(lo, olo), min(hi, ohi))
        e.bounds = cur
        self._stamp += 1
        e.stamp = self._stamp

    # -- tier 1: ancestor-UNSAT subsumption --------------------------------

    @_locked
    def ancestor_unsat(self, ks: frozenset) -> bool:
        idx = self._unsat_by_rep
        if not idx:
            return False
        for t in ks:
            for u in idx.get(t, ()):
                if u is ks or u <= ks:
                    return True
        return False

    # -- tier 2: parent-model shadowing ------------------------------------

    def _walk_parents(self, tids: tuple):
        """Yield (parent entry, delta index list) over cached ancestor
        prefixes of an ordered tid tuple, longest delta-1 first, within
        _SHADOW_WALK splits.

        Two parent shapes per split — path constraints grow at the
        tail, but `Constraints.get_all_constraints` appends the keccak
        axiom term LAST, so a normalized child is ``P + delta + [ax]``
        while its parent was seen as ``P + [ax]``: the plain prefix
        ``tids[:i]`` covers raw discharge sets, and ``tids[:i] +
        (tids[-1],)`` covers the axiom-tailed normalized shape (its
        delta excludes the shared trailing term)."""
        n = len(tids)
        for i in range(n - 1, max(0, n - 1 - _SHADOW_WALK), -1):
            cands = [(tids[:i], list(range(i, n)))]
            if i < n - 1:
                cands.append(
                    (tids[:i] + (tids[-1],), list(range(i, n - 1))))
            for ptids, delta in cands:
                pk = self._fp.get(ptids)
                if pk is None:
                    continue
                e = self._entries.get(pk)
                if e is not None:
                    yield e, delta

    def _shadow_parent(self, tids: tuple):
        """(parent ModelData, delta index list) for the longest cached
        ancestor with a SAT verdict AND model, within _SHADOW_WALK."""
        for e, delta in self._walk_parents(tids):
            if e.verdict == SAT and e.model is not None:
                return e.model, delta
        return None

    @staticmethod
    def _shadow_eval_host(model, delta_terms) -> Optional[bool]:
        """True: model satisfies every delta constraint (SAT proof —
        evaluation is total and functional, so the completed assignment
        extends the parent's satisfying one). False: some delta is
        concretely false under it (shadow rejected; says nothing about
        the child's satisfiability). None: evaluation failed."""
        try:
            for t in delta_terms:
                if model.eval_term(t, complete=True) is not True:
                    return False
        except Exception:
            return None
        return True

    @_locked
    def probe(self, terms: Sequence, tids: Optional[tuple] = None,
              shadow: bool = True):
        """(verdict | None, ModelData | None) for a raw-term conjunction.

        Tier order: exact-key hit, ancestor-UNSAT subsumption, host
        parent-model shadow (skipped with ``shadow=False`` — the
        pruner's pre-screen kill pass wants only O(lookup) tiers).
        Counts land in SolverStatistics."""
        if not ENABLED or not terms:
            return None, None
        if tids is None:
            tids = tuple(t.tid for t in terms)
        ks = self.key(tids)
        ss = SolverStatistics()
        e = self._entries.get(ks)
        if e is not None and e.verdict in (SAT, UNSAT):
            self._entries.move_to_end(ks)
            ss.verdict_hits += 1
            return e.verdict, e.model
        if self.ancestor_unsat(ks):
            ss.verdict_unsat_kills += 1
            # memoize as an exact entry (no re-indexing: the ancestor
            # already covers every further descendant)
            self.record(tids, UNSAT, index_unsat=False)
            return UNSAT, None
        if not shadow:
            return None, None
        sp = self._shadow_parent(tids)
        if sp is not None:
            model, delta = sp
            terms = list(terms)
            got = self._shadow_eval_host(model, [terms[j] for j in delta])
            if got is True:
                ss.verdict_shadows += 1
                self.record(tids, SAT, model=model)
                return SAT, model
            if got is False:
                ss.verdict_shadow_rejects += 1
        return None, None

    def _device_ok(self, n: int) -> bool:
        from ...models.pruner import _device_threshold
        from ...support.devices import effective_tpu_lanes

        return bool(effective_tpu_lanes()) and n >= _device_threshold()

    @_locked
    def shadow_prepass(self, term_sets: Sequence[Sequence],
                       undecided: Sequence[int]) -> Dict[int, bool]:
        """Device-batched tier-2 shadow over a query wave.

        Groups still-unverdicted queries by their shadowable parent
        model; groups large enough for the interval kernel evaluate on
        device with the model pinned as point intervals (a must-true
        sweep over the deltas is a SAT proof; a must-false one rejects
        the shadow). Small groups fall through to probe()'s host
        term-eval. Returns {query index: True} for proved queries."""
        if not ENABLED:
            return {}
        groups: Dict[int, tuple] = {}
        for i in undecided:
            ts = term_sets[i]
            if not ts:
                continue
            sp = self._shadow_parent(tuple(t.tid for t in ts))
            if sp is None:
                continue
            model, delta = sp
            groups.setdefault(id(model), (model, []))[1].append(
                (i, ts, delta))
        out: Dict[int, bool] = {}
        ss = SolverStatistics()
        for model, items in groups.values():
            if len(items) < DEVICE_SHADOW_MIN or not self._device_ok(
                    len(items)):
                continue
            # a device call that raises raises to the caller
            from ...ops.intervals import shadow_prefilter

            proved, rejected = shadow_prefilter(
                [[list(ts)[j] for j in delta]
                 for (_i, ts, delta) in items],
                model.bv, model.bools)
            for (i, ts, _delta), p, r in zip(items, proved, rejected):
                if p:
                    ss.verdict_shadows += 1
                    self.record(tuple(t.tid for t in ts), SAT,
                                model=model)
                    out[i] = True
                elif r:
                    ss.verdict_shadow_rejects += 1
        return out

    # -- tier 3: interval-bound inheritance --------------------------------

    @_locked
    def bounds_for(self, raws: Sequence, tids: tuple) -> dict:
        """{var_tid: (var, lo, hi)} merged syntactic bounds for the
        system, inheriting the longest cached prefix's bounds and
        intersecting only the delta terms' contributions."""
        from ..interval import _term_contributions

        ks = self.key(tids)
        e = self._entries.get(ks)
        if e is not None and e.bounds is not None:
            return e.bounds
        base, delta = None, range(len(tids))
        for pe, d in self._walk_parents(tids):
            if pe.bounds is not None:
                base, delta = pe.bounds, d
                SolverStatistics().verdict_bound_seeds += 1
                break
        bounds = dict(base) if base else {}
        for j in delta:
            for var, lo, hi in _term_contributions(raws[j]):
                old = bounds.get(var.tid)
                if old is None:
                    w = var.width if isinstance(var.width, int) else 256
                    olo, ohi = 0, (1 << w) - 1
                else:
                    _, olo, ohi = old
                bounds[var.tid] = (var, max(lo, olo), min(hi, ohi))
        self._ensure_entry(ks).bounds = bounds
        return bounds

    # -- migration shipping (parallel/migrate.py) --------------------------

    @_locked
    def export_entries(self, term_lists: Sequence[Sequence]) -> List:
        """Cached proofs AND harvested propagation banks restricted to
        the given states' constraint prefixes, as ``(ordered terms,
        verdict, model, facts, bounds)`` tuples ready for term-safe
        pickling (support/checkpoint.py sidecars).

        For each normalized raw-term list this collects the exact-key
        entry, every cached ordered-prefix entry (both discharge
        shapes: plain ``tids[:j]`` and the axiom-tailed ``tids[:j] +
        (tids[-1],)``), and every indexed UNSAT set subsumed by the
        state's tid-set. Terms ship as objects — the thief re-interns
        them into its own table, so the fingerprints re-derive there
        (tids are process-local). Models ship as slim copies (the
        eval memos and env caches stay home). ``facts`` are the
        note_facts bank (raw implied terms from ops/propagate.py) and
        ``bounds`` the absorb_bounds bank as ``(var term, lo, hi)``
        triples — shipping them means a thief asserts the victim's
        propagated facts as solver hints and seeds tier-3 screens from
        the propagated bounds instead of re-deriving both on device.
        A prefix with ONLY banked facts/bounds (no verdict yet) ships
        with verdict None."""
        out: Dict[frozenset, tuple] = {}

        def _banks(pk):
            facts = self._facts.get(pk, ())
            e = self._entries.get(pk)
            bounds = ()
            if e is not None and e.bounds:
                bounds = tuple((var, lo, hi)
                               for var, lo, hi in e.bounds.values())
            return tuple(facts), bounds

        for terms in term_lists:
            terms = list(terms)
            if not terms:
                continue
            tids = tuple(t.tid for t in terms)
            by_tid = {t.tid: t for t in terms}
            n = len(tids)
            cands = []
            for j in range(1, n + 1):
                cands.append(tids[:j])
                if j < n:
                    cands.append(tids[:j] + (tids[-1],))
            for ptids in cands:
                pk = self._fp.get(ptids)
                if pk is None or pk in out:
                    continue
                e = self._entries.get(pk)
                verdict = e.verdict if e is not None \
                    and e.verdict in (SAT, UNSAT) else None
                facts, bounds = _banks(pk)
                if verdict is None and not facts and not bounds:
                    continue
                seen = set()
                ordered = [by_tid[t] for t in ptids
                           if t in pk and not (t in seen or seen.add(t))]
                out[pk] = (ordered, verdict,
                           _slim_model(e.model) if e is not None
                           else None, facts, bounds)
            ks = frozenset(tids)
            for t in ks:
                for u in self._unsat_by_rep.get(t, ()):
                    if u not in out and u <= ks:
                        facts, bounds = _banks(u)
                        out[u] = ([by_tid[x] for x in sorted(u)],
                                  UNSAT, None, facts, bounds)
        entries = list(out.values())
        SolverStatistics().verdicts_shipped += len(entries)
        return entries

    @_locked
    def mark(self) -> int:
        """Current write-stamp: pass to export_all_entries(since=...)
        to export only entries recorded/banked after this point (the
        warm store marks at analysis start, so one contract's entry
        carries ITS banks — imported ones re-stamp on import — not a
        whole corpus rank's accumulation)."""
        return self._stamp

    @_locked
    def export_all_entries(self, cap: int = 4096,
                           since: int = 0) -> List:
        """EVERY banked proof/fact/bound as export_entries 5-tuples,
        newest first up to ``cap`` — the warm-store save seam
        (support/warm_store.py). Unlike export_entries this is not
        restricted to given states' prefixes: the cache is run-wide
        and verdicts are term-level facts, so an entry minted while
        another contract was in flight is sound to replay anywhere
        (it simply never matches foreign term sets). Only proofs can
        exist here — record() refuses anything but SAT/UNSAT, and a
        timeout never enters — so the proofs-only persistence
        invariant is inherited, not re-checked. ``since`` filters to
        entries written after a mark() point. Entries whose terms
        have left the tid index (cannot happen for interned terms,
        but guarded) are skipped whole."""
        from .. import terms as T

        out: List = []
        fact_only = [ks for ks in self._facts
                     if ks not in self._entries]
        entry_keys = list(self._entries.keys())
        entry_keys.reverse()  # LRU order: most-recently-used first
        for ks in entry_keys + fact_only:
            if len(out) >= cap:
                break
            e = self._entries.get(ks)
            if since and max(
                    e.stamp if e is not None else 0,
                    self._fact_stamps.get(ks, 0)) <= since:
                continue
            verdict = e.verdict if e is not None \
                and e.verdict in (SAT, UNSAT) else None
            facts = tuple(self._facts.get(ks, ()))
            bounds = ()
            if e is not None and e.bounds:
                bounds = tuple((var, lo, hi)
                               for var, lo, hi in e.bounds.values())
            if verdict is None and not facts and not bounds:
                continue
            ordered = []
            for tid in sorted(ks):
                t = T.term_by_tid(tid)
                if t is None:
                    ordered = None
                    break
                ordered.append(t)
            if not ordered:
                continue
            out.append((ordered, verdict,
                        _slim_model(e.model) if e is not None
                        else None, facts, bounds))
        return out

    @_locked
    def import_entries(self, entries: Sequence) -> int:
        """Record shipped proofs — and replay shipped propagation-fact/
        bound banks — under THIS process's term table (the terms
        re-interned on load carry this table's tids). Accepts both the
        5-tuple format and legacy ``(terms, verdict, model)`` triples.
        Returns the number of entries replayed; counted in
        verdicts_replayed."""
        if not ENABLED:
            return 0
        n = 0
        for entry in entries:
            try:
                terms, verdict, model = entry[0], entry[1], entry[2]
                facts = entry[3] if len(entry) > 3 else ()
                bounds = entry[4] if len(entry) > 4 else ()
                tids = tuple(t.tid for t in terms)
                if verdict in (SAT, UNSAT):
                    self.record(tids, verdict, model=model)
                if facts:
                    self.note_facts(tids, facts)
                if bounds:
                    self.absorb_bounds(
                        tids,
                        {var.tid: (var, lo, hi)
                         for var, lo, hi in bounds})
                n += 1
            except Exception:  # a cache, never an error path
                log.debug("verdict import skipped one entry",
                          exc_info=True)
        SolverStatistics().verdicts_replayed += n
        return n

    @_locked
    def interval_unsat(self, assertions: Sequence) -> bool:
        """state_infeasible with inherited bound seeds; a refutation is
        a sound proof and is recorded for ancestor subsumption."""
        from ..interval import must_be_false

        raws = [getattr(t, "raw", t) for t in assertions]
        if not raws:
            return False
        tids = tuple(t.tid for t in raws)
        ks = self.key(tids)
        e = self._entries.get(ks)
        if e is not None and e.verdict is not None:
            return e.verdict == UNSAT
        if self.ancestor_unsat(ks):
            # a shipped or prior-window UNSAT prefix subsumes this set
            # (migration sidecars land here on the thief)
            SolverStatistics().verdict_unsat_kills += 1
            self.record(tids, UNSAT, index_unsat=False)
            return True
        bounds = self.bounds_for(raws, tids)
        memo: Dict[int, object] = {}
        for var, lo, hi in bounds.values():
            if lo > hi:
                self.record(tids, UNSAT)
                return True
            memo[var.tid] = (lo, hi)
        if any(must_be_false(t, memo) for t in raws):
            self.record(tids, UNSAT)
            return True
        return False


def _slim_model(model):
    """Copy of a ModelData holding only the assignment dicts: the
    per-model eval memos / env caches can pin hundreds of MB and mean
    nothing on another rank."""
    if model is None:
        return None
    try:
        slim = core.ModelData()
        slim.bv = dict(model.bv)
        slim.bools = dict(model.bools)
        slim.arrays = dict(model.arrays)
        slim.funcs = dict(model.funcs)
        return slim
    except Exception:
        return None


_CACHE = VerdictCache()


def cache() -> Optional[VerdictCache]:
    """The process-wide cache, or None while the module is disabled."""
    return _CACHE if ENABLED else None


def reset_cache() -> None:
    """Drop every cached verdict (tests; not needed between contracts —
    tids denote interned terms whose satisfiability never changes)."""
    global _CACHE
    _CACHE = VerdictCache()
