"""Batched, shared-prefix incremental feasibility discharge.

Sibling path-feasibility queries forked from one JUMPI share long
constraint prefixes — the engine's drain sites and open-state screens
re-discharge near-identical conjunctions thousands of times per
analysis, and solving each superset independently is pure waste (the
word-level incremental lever PolySAT and Bitwuzla's incremental track
exploit; PAPERS.md). This module turns a WAVE of feasibility queries
into one pass over the shared incremental session (core._IncrementalSession):

1. queries sort in trie order — shortest constraint set first, then
   lexicographic by constraint tid — so every strict subset discharges
   before its supersets and shared prefixes become adjacent;
2. each constraint term blasts AT MOST ONCE per process (the session's
   `_prepared` map); terms a query shares with any earlier query are
   prefix-dedup hits, not re-encodings;
3. an UNSAT verdict records the query's constraint-tid set: any later
   query whose set is a superset is UNSAT by monotonicity of
   conjunction, WITHOUT a solve (subset-kill). The session-level
   unsat-core subsumption additionally covers cross-batch repeats;
4. a SAT model is handed to the caller (`on_sat_model`) — fed into the
   ModelCache, it quick-sat-serves sibling queries before any fresh
   solve (`quick_sat`).

Since PR 2 every query also consults the RUN-WIDE verdict cache
(verdicts.py): exact-key reuse, ancestor-UNSAT subsumption and
parent-model shadowing answer repeats across windows and call sites
before the in-batch screens even matter, and every core SAT/UNSAT
proof found here is recorded back for the rest of the run.

Verdicts are exactly the core's (SAT/UNSAT/UNKNOWN); soundness is
inherited — subset-kill only ever strengthens a proved-UNSAT set.
Counters land in SolverStatistics (solver_statistics.py) and surface
through the benchmark/instruction-profiler plugins and bench.py.
"""

import logging
import threading
from typing import Callable, List, Optional, Sequence

from .. import terms as T
from . import core
from . import pool as pool_mod
from . import verdicts as verdict_mod
from .solver_statistics import SolverStatistics

SAT, UNSAT, UNKNOWN = core.SAT, core.UNSAT, core.UNKNOWN

log = logging.getLogger(__name__)

#: recorded UNSAT tid-sets per registry (screens are O(sets) per query)
_REGISTRY_CAP = 512


def tid_key(terms: Sequence["T.Term"]) -> tuple:
    return tuple(t.tid for t in terms)


def _propagate_prescreen(norm, verdicts, registry, ss) -> None:
    """Device product-domain propagation screen over the wave's still-
    undecided queries (ops/propagate.py, MTPU_PROPAGATE): refuted lanes
    verdict UNSAT before any solver work, and the surviving lanes'
    harvested facts land in the run-wide verdict cache where
    `_hints_for` asserts them ahead of the real constraints. Engaged
    under the same gates as the device interval screen (lane config,
    batch threshold); any verdict recorded here is a sound refutation,
    so MTPU_PROPAGATE=0 changes cost, never results. A device call
    that raises raises to the caller: a wave under the threshold skips
    the screen, a failed one is not skipped."""
    from ...ops import propagate

    if not propagate.enabled():
        return
    undecided = [i for i, v in enumerate(verdicts) if v is None]
    kills = propagate.prescreen(norm, undecided)
    for i in kills:
        verdicts[i] = UNSAT
        registry.note_unsat(frozenset(t.tid for t in norm[i]))


def _hints_for(vc, work) -> list:
    """Harvested propagation facts for a query plus the static
    storage-ITE facts (analysis/static_pass/deps.py). Both kinds are
    implied consequences — the propagation facts of the asserted set,
    the static facts of the term structure alone — so asserting them
    first cannot change the verdict."""
    if not work:
        return []
    hints = []
    if vc is not None:
        try:
            hints = list(vc.facts_for(tid_key(work)))
        except Exception:
            hints = []
    try:
        from ...analysis.static_pass import deps as static_deps

        hints += static_deps.static_hints_for_set(work)
    except Exception:
        pass
    return hints


def order_by_prefix(term_sets: Sequence[Sequence]) -> List[int]:
    """Indices in trie order: shortest set first, lexicographic by
    constraint tid within a length. A strict subset has strictly fewer
    constraints, so it always discharges before its supersets (the
    subset-kill invariant); equal-length sets sharing a prefix become
    adjacent, so the incremental session re-blasts nothing shared."""
    keys = [tid_key(ts) for ts in term_sets]
    return sorted(range(len(term_sets)),
                  key=lambda i: (len(keys[i]), keys[i]))


def count_prepared(terms: Sequence["T.Term"]) -> int:
    """How many distinct terms of this query the ambient incremental
    session has already blasted — each is a prefix-dedup hit: its
    Tseitin clauses (and Ackermann axioms) are reused, not re-encoded.
    The ambient session is this thread's private one on a pool worker
    (prefix affinity makes these hits) and the process-global session
    otherwise."""
    sess = core.thread_session() or core._session
    return count_prepared_in(sess, terms)


def count_prepared_in(sess, terms: Sequence["T.Term"]) -> int:
    if sess is None:
        return 0
    seen = set()
    hits = 0
    for t in terms:
        if t.tid in seen:
            continue
        seen.add(t.tid)
        if t.tid in sess._prepared:
            hits += 1
    return hits


class SubsetRegistry:
    """Verdict propagation across a batch (or across the windows of one
    lane-engine explore): UNSAT constraint-tid sets kill every superset
    without a solve; SAT sets answer every subset without a solve.

    Thread-safe: pooled discharge workers (smt/solver/pool.py) note
    verdicts and screen against the registry concurrently — a verdict
    proved by one worker kills sibling supersets on every other worker
    mid-wave. One lock; every critical section is a short list scan."""

    def __init__(self):
        self._lock = threading.Lock()
        self._unsat: List[frozenset] = []
        self._sat: List[frozenset] = []

    def unsat_superset(self, tids: frozenset) -> bool:
        with self._lock:
            return any(u <= tids for u in self._unsat)

    def sat_subset(self, tids: frozenset) -> bool:
        with self._lock:
            return any(tids <= s for s in self._sat)

    def note_unsat(self, tids: frozenset) -> None:
        with self._lock:
            if tids not in self._unsat:
                self._unsat.append(tids)
                del self._unsat[:-_REGISTRY_CAP]

    def note_sat(self, tids: frozenset) -> None:
        with self._lock:
            if tids not in self._sat:
                self._sat.append(tids)
                del self._sat[:-_REGISTRY_CAP]


def discharge(
    term_sets: Sequence[Sequence["T.Term"]],
    timeout_s: float = 2.0,
    conflict_budget: int = 0,
    quick_sat: Optional[Callable] = None,
    on_sat_model: Optional[Callable] = None,
    registry: Optional[SubsetRegistry] = None,
) -> List[str]:
    """Verdicts (SAT/UNSAT/UNKNOWN) for a batch of raw-term
    conjunctions, in input order.

    `quick_sat(conjunction_term)` returns a truthy value when a cached
    model already satisfies the query (the ModelCache seam — the caller
    supplies it so this module stays below the support layer);
    `on_sat_model(model_data)` receives each fresh SAT model so the
    caller can feed the cache for the remaining siblings. `registry`
    persists subset/superset verdicts across calls (one lane-engine
    explore screens many windows against the same prefix tree).

    With the persistent solver pool enabled (smt/solver/pool.py,
    K > 1) the surviving queries fan out over the pool's worker
    sessions with trie-subtree affinity — see _discharge_pooled; at
    K=1 this serial body runs unchanged."""
    from ...support.telemetry import trace

    pool = pool_mod.get_pool()
    with trace.span("solver.discharge", n=len(term_sets),
                    pooled=pool.parallel):
        if pool.parallel:
            return _discharge_pooled(
                pool, term_sets, timeout_s, conflict_budget,
                quick_sat, on_sat_model, registry)
        return _discharge_serial(term_sets, timeout_s,
                                 conflict_budget, quick_sat,
                                 on_sat_model, registry)


def _discharge_serial(
    term_sets: Sequence[Sequence["T.Term"]],
    timeout_s: float = 2.0,
    conflict_budget: int = 0,
    quick_sat: Optional[Callable] = None,
    on_sat_model: Optional[Callable] = None,
    registry: Optional[SubsetRegistry] = None,
) -> List[str]:
    """The single-context trie walk (today's behavior, and the K=1
    fallback — bit-for-bit)."""
    ss = SolverStatistics()
    n = len(term_sets)
    if not n:
        return []
    ss.batch_count += 1
    ss.batch_queries += n
    if registry is None:
        registry = SubsetRegistry()
    verdicts: List[Optional[str]] = [None] * n

    # constant-fold screen + normalized per-query term list
    norm: List[list] = []
    for i, ts in enumerate(term_sets):
        work = [t for t in ts if t.op != T.TRUE]
        if any(t.op == T.FALSE for t in work):
            verdicts[i] = UNSAT
            work = []
        norm.append(work)

    _propagate_prescreen(norm, verdicts, registry, ss)

    for i in order_by_prefix(norm):
        if verdicts[i] is not None:
            continue
        work = norm[i]
        if not work:
            verdicts[i] = SAT
            continue
        tids = frozenset(t.tid for t in work)
        if registry.unsat_superset(tids):
            ss.subset_kills += 1
            verdicts[i] = UNSAT
            continue
        if registry.sat_subset(tids):
            ss.sat_subsumed += 1
            verdicts[i] = SAT
            continue
        # run-wide verdict cache (verdicts.py): exact-key reuse,
        # ancestor-UNSAT subsumption across windows AND call sites,
        # parent-model shadowing — all before any solver work
        vc = verdict_mod.cache()
        if vc is not None:
            v, model = vc.probe(work)
            if v == UNSAT:
                registry.note_unsat(tids)
                verdicts[i] = UNSAT
                continue
            if v == SAT:
                registry.note_sat(tids)
                verdicts[i] = SAT
                if on_sat_model is not None and model is not None:
                    try:
                        on_sat_model(model)
                    except Exception:
                        pass
                continue
        if quick_sat is not None:
            try:
                if quick_sat(T.mk_bool_and(*work)):
                    ss.quick_sat_hits += 1
                    registry.note_sat(tids)
                    verdicts[i] = SAT
                    continue
            except Exception:  # a cache probe, never an error path
                pass
        ss.prefix_dedup_hits += count_prepared(work)
        ss.batch_solve_calls += 1
        # harvested propagation facts assert FIRST: the core starts
        # from the propagated state instead of rediscovering it
        # (implied consequences — the verdict cannot change)
        hints = _hints_for(vc, work)
        if hints:
            ss.bump(hinted_solves=1)
        try:
            from ...support.telemetry import trace

            with trace.query_context(tier="batch.serial"):
                ctx = core.check(hints + list(work),
                                 timeout_s=timeout_s,
                                 conflict_budget=conflict_budget)
        except (KeyboardInterrupt, MemoryError):
            raise  # fatal, never a degrade (the _device_failed class)
        except Exception as e:  # degraded, never wrong: keep the query
            log.debug("batch discharge solve failed: %s", e)
            verdicts[i] = UNKNOWN
            continue
        verdicts[i] = ctx.status
        if ctx.status == UNSAT:
            registry.note_unsat(tids)
            if vc is not None:  # a core refutation is a run-wide proof
                vc.record(tid_key(work), UNSAT)
        elif ctx.status == SAT:
            registry.note_sat(tids)
            if vc is not None:
                vc.record(tid_key(work), SAT, model=ctx.model)
            if on_sat_model is not None and ctx.model is not None:
                try:
                    on_sat_model(ctx.model)
                except Exception:
                    pass
    return [v if v is not None else UNKNOWN for v in verdicts]


def _discharge_pooled(pool, term_sets, timeout_s, conflict_budget,
                      quick_sat, on_sat_model, registry) -> List[str]:
    """Trie-sharded parallel discharge (docs/solver_pool.md).

    The cheap tiers stay on the caller thread in trie order — exactly
    the serial screens: constant folds, registry subset/superset
    kills, run-wide verdict cache probes, quick-sat. Only queries that
    would have reached the solver fan out: the trie partitions into
    subtrees by root constraint tid and each subtree goes to its
    affinity worker (pool.worker_for), which discharges the subtree in
    trie order against its own persistent session — so the in-batch
    subset-kill invariant holds WITHIN a subtree by ordering, and
    ACROSS subtrees through the shared registry, which workers
    re-check right before each solve. Hard queries escalate to the
    2-tactic portfolio race (pool.solve_query). A worker death hands
    its queries back for serial re-discharge here (never a lost or
    false verdict)."""
    ss = SolverStatistics()
    n = len(term_sets)
    if not n:
        return []
    ss.bump(batch_count=1, batch_queries=n)
    if registry is None:
        registry = SubsetRegistry()
    verdicts: List[Optional[str]] = [None] * n

    norm: List[list] = []
    for i, ts in enumerate(term_sets):
        work = [t for t in ts if t.op != T.TRUE]
        if any(t.op == T.FALSE for t in work):
            verdicts[i] = UNSAT
            work = []
        norm.append(work)

    _propagate_prescreen(norm, verdicts, registry, ss)

    vc = verdict_mod.cache()
    survivors: List[int] = []
    for i in order_by_prefix(norm):
        if verdicts[i] is not None:
            continue
        work = norm[i]
        if not work:
            verdicts[i] = SAT
            continue
        tids = frozenset(t.tid for t in work)
        if registry.unsat_superset(tids):
            ss.bump(subset_kills=1)
            verdicts[i] = UNSAT
            continue
        if registry.sat_subset(tids):
            ss.bump(sat_subsumed=1)
            verdicts[i] = SAT
            continue
        if vc is not None:
            v, model = vc.probe(work)
            if v == UNSAT:
                registry.note_unsat(tids)
                verdicts[i] = UNSAT
                continue
            if v == SAT:
                registry.note_sat(tids)
                verdicts[i] = SAT
                if on_sat_model is not None and model is not None:
                    try:
                        on_sat_model(model)
                    except Exception:
                        pass
                continue
        if quick_sat is not None:
            try:
                if quick_sat(T.mk_bool_and(*work)):
                    ss.bump(quick_sat_hits=1)
                    registry.note_sat(tids)
                    verdicts[i] = SAT
                    continue
            except Exception:  # a cache probe, never an error path
                pass
        survivors.append(i)

    if not survivors:
        return [v if v is not None else UNKNOWN for v in verdicts]

    def make_fn(i):
        work = norm[i]
        tids = frozenset(t.tid for t in work)

        def fn():
            # late screens: a sibling worker may have refuted a subset
            # (or proved a superset) since the caller's pre-pass
            if registry.unsat_superset(tids):
                ss.bump(subset_kills=1)
                return (UNSAT, None)
            if registry.sat_subset(tids):
                ss.bump(sat_subsumed=1)
                return (SAT, None)
            sess = core.thread_session()
            hits = count_prepared_in(sess, work)
            if hits:
                ss.bump(affinity_prefix_hits=1, prefix_dedup_hits=hits)
            ss.bump(batch_solve_calls=1)
            hints = _hints_for(vc, work)
            if hints:
                ss.bump(hinted_solves=1)
            try:
                from ...support.telemetry import trace

                with trace.query_context(tier="batch.pooled"):
                    ctx = pool.solve_query(hints + list(work),
                                           timeout_s,
                                           conflict_budget)
            except (KeyboardInterrupt, MemoryError):
                raise  # fatal, never a degrade
            except Exception as e:  # degraded, never wrong
                log.debug("pooled discharge solve failed: %s", e)
                return (UNKNOWN, None)
            if ctx.status == UNSAT:
                registry.note_unsat(tids)
                if vc is not None:
                    vc.record(tid_key(work), UNSAT)
            elif ctx.status == SAT:
                registry.note_sat(tids)
                if vc is not None:
                    vc.record(tid_key(work), SAT, model=ctx.model)
            return (ctx.status, ctx.model)

        return fn

    # subtree root = the first constraint tid of the trie key: sibling
    # paths forked from one prefix share it, so they land on the same
    # worker (whose session keeps the prefix blasted run-wide)
    items = [(norm[i][0].tid, make_fn(i)) for i in survivors]
    results = pool.map_wave(items)

    for i, res in zip(survivors, results):
        if res is pool_mod.NEEDS_SERIAL:
            # the worker died: re-derive this verdict serially on the
            # caller (global session, full budget — the plain path)
            res = _serial_requery(i, norm, registry, vc, timeout_s,
                                  conflict_budget, ss)
        verdicts[i], model = res
        if (verdicts[i] == SAT and model is not None
                and on_sat_model is not None):
            try:
                on_sat_model(model)
            except Exception:
                pass
    return [v if v is not None else UNKNOWN for v in verdicts]


def _serial_requery(i, norm, registry, vc, timeout_s, conflict_budget,
                    ss):
    """Caller-side re-discharge of a query whose worker died (the
    worker-death robustness contract: verdicts are re-derived through
    the plain serial path, never guessed)."""
    work = norm[i]
    tids = frozenset(t.tid for t in work)
    if registry.unsat_superset(tids):
        ss.bump(subset_kills=1)
        return (UNSAT, None)
    if registry.sat_subset(tids):
        ss.bump(sat_subsumed=1)
        return (SAT, None)
    ss.bump(batch_solve_calls=1)
    hints = _hints_for(vc, work)
    if hints:
        ss.bump(hinted_solves=1)
    try:
        from ...support.telemetry import trace

        with trace.query_context(tier="batch.requery"):
            ctx = core.check(hints + list(work), timeout_s=timeout_s,
                             conflict_budget=conflict_budget)
    except (KeyboardInterrupt, MemoryError):
        raise  # fatal, never a degrade
    except Exception as e:
        log.debug("serial requery failed: %s", e)
        return (UNKNOWN, None)
    if ctx.status == UNSAT:
        registry.note_unsat(tids)
        if vc is not None:
            vc.record(tid_key(work), UNSAT)
    elif ctx.status == SAT:
        registry.note_sat(tids)
        if vc is not None:
            vc.record(tid_key(work), SAT, model=ctx.model)
    return (ctx.status, ctx.model)


def discharge_async(
    term_sets: Sequence[Sequence["T.Term"]],
    timeout_s: float = 2.0,
    conflict_budget: int = 0,
    quick_sat: Optional[Callable] = None,
    on_sat_model: Optional[Callable] = None,
    registry: Optional[SubsetRegistry] = None,
):
    """Futures variant of discharge: returns a pool.PoolFuture whose
    result() is the verdict list. The submit/collect split is the
    fully-async feasibility seam — the lane engine's fork screen
    submits at drain k and collects at drain k+1, so the solver wall
    hides behind a whole device window instead of just the dispatch
    gap; collection books the hidden time as async_overlap_ms. With
    the pool at K=1 the work runs inline at submit and result() is
    immediate (serial semantics preserved)."""
    from . import pool as pool_mod

    pool = pool_mod.get_pool()
    sets = [list(ts) for ts in term_sets]
    return pool.submit_async(lambda: discharge(
        sets, timeout_s=timeout_s, conflict_budget=conflict_budget,
        quick_sat=quick_sat, on_sat_model=on_sat_model,
        registry=registry))
