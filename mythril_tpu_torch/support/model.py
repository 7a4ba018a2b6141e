"""Global solver entry point with model caching (capability parity:
mythril/support/model.py:21-96 — restructured as a staged pipeline:
normalize, trivial-false scan, quick-sat with path-guided repair
(smt/repair.py), sound interval pre-screen, then the CDCL core)."""

import logging
import os
from functools import lru_cache
from pathlib import Path

from ..exceptions import SolverTimeOutException, UnsatError
from ..laser.time_handler import time_handler
from ..smt import And, Model, Optimize, sat, simplify, unknown, unsat
from ..smt.solver import verdicts as verdict_mod
from .support_args import args
from .support_utils import ModelCache

log = logging.getLogger(__name__)


from .run_context import SwappableProxy  # noqa: E402

model_cache = SwappableProxy(ModelCache())

#: interval pre-screen effectiveness over get_model queries (read by
#: bench configs): queries screened / proved UNSAT without CDCL
SCREEN_STATS = {"screened": 0, "proved_unsat": 0}


def _normalized(constraints):
    """Flatten a Constraints object to a bool-free term list, raising
    immediately on a literal False."""
    for constraint in constraints:
        if constraint is False:
            raise UnsatError
    if type(constraints) != tuple:
        constraints = constraints.get_all_constraints()
    return [c for c in constraints if type(c) != bool]


def _interval_unsat(constraints) -> bool:
    """Sound abstract-interval refutation: ~74% of get_model queries in
    a typical analysis are UNSAT, and the interval pass proves most of
    those for ~0.5 ms where a CDCL proof costs tens of ms
    (smt/interval.py over-approximates the feasible set, so
    "infeasible" is definitive; any screen failure defers to CDCL).

    Routed through the run-wide verdict cache (smt/solver/verdicts.py)
    when enabled: the screen seeds from the longest cached prefix's
    variable bounds instead of top (tier 3), and a refutation is
    recorded so every descendant set dies by ancestor subsumption
    without re-screening."""
    try:
        SCREEN_STATS["screened"] += 1
        raws = [c.raw for c in constraints]
        vc = verdict_mod.cache()
        if vc is not None:
            infeasible = vc.interval_unsat(raws)
        else:
            from ..smt.interval import state_infeasible

            infeasible = state_infeasible(raws)
        if infeasible:
            SCREEN_STATS["proved_unsat"] += 1
            return True
    except Exception:
        pass
    return False


def _dump_query(s, constraints, minimize, maximize) -> None:
    Path(args.solver_log).mkdir(parents=True, exist_ok=True)
    tag = abs(hash(tuple(
        list(constraints) + list(minimize) + list(maximize)
        + [len(constraints), len(minimize), len(maximize)]
    )))
    with open(f"{args.solver_log}/{tag}.smt2", "w") as f:
        f.write(s.sexpr())


def witness_paths(constraints, model):
    """Re-concretize merged-lane constraints to single witness paths
    (docs/lane_merge.md): for every constraint carrying a
    ``MergeProvenance`` annotation (an OR minted by the window/round
    merge pass, laser/merge.py), find the ONE original disjunct the
    model satisfies. Returns ``[(constraint, disjunct_index,
    disjunct_terms)]`` — detection-module reports built from the model
    correspond exactly to that original path. Evaluation is total
    (model completion), so a SAT model always selects a disjunct unless
    term evaluation itself fails."""
    from ..laser.merge import MergeProvenance

    out = []
    md = model.raw[0] if getattr(model, "raw", None) else model
    for c in constraints:
        anns = getattr(c, "_annotations", None)
        if not anns:
            continue
        for prov in anns:
            if not isinstance(prov, MergeProvenance):
                continue
            for di, terms in enumerate(prov.disjuncts):
                try:
                    if all(md.eval_term(t, complete=True) is True
                           for t in terms):
                        out.append((c, di, terms))
                        break
                except Exception:
                    continue
    return out


def _attach_witness(model, constraints):
    """Best-effort: pin the witness-disjunct selection onto the model
    object (``model.witness_disjuncts``) when any constraint carries
    merge provenance. Never raises — a report without the pin still
    holds a valid model of the OR."""
    try:
        wit = witness_paths(constraints, model)
        if wit:
            model.witness_disjuncts = wit
    except Exception:
        pass
    return model


#: default get_model memo size. The seed shipped 2**23 (8M) entries —
#: every entry pins a Model with its term-eval memos, so a corpus run
#: could grow the memo into an OOM. 2**14 models still covers the
#: within-contract repeat window (the run-wide verdict cache now owns
#: long-range reuse) at a bounded footprint.
DEFAULT_MODEL_LRU = 2 ** 14


def _model_lru_maxsize() -> int:
    """get_model memo size: MYTHRIL_TPU_MODEL_LRU env overrides the
    support_args default (0 disables memoization entirely)."""
    raw = os.environ.get("MYTHRIL_TPU_MODEL_LRU")
    if raw is None:
        raw = getattr(args, "model_lru_size", DEFAULT_MODEL_LRU)
    try:
        size = int(raw)
    except (TypeError, ValueError):
        return DEFAULT_MODEL_LRU
    return max(size, 0)


def _get_model_impl(
    constraints,
    minimize=(),
    maximize=(),
    enforce_execution_time=True,
    solver_timeout=None,
):
    """Return a Model for the constraints (tuple or Constraints);
    raises UnsatError / SolverTimeOutException like the reference."""
    timeout = solver_timeout or args.solver_timeout
    if enforce_execution_time:
        timeout = min(timeout, time_handler.time_remaining() - 500)
        if timeout <= 0:
            raise UnsatError
    constraints = _normalized(constraints)

    # run-wide verdict cache (smt/solver/verdicts.py): an exact-key or
    # ancestor-UNSAT verdict answers ANY query (UNSAT is objective-
    # independent); a SAT verdict/model-shadow answers plain
    # feasibility queries and warm-starts optimization ones. Every
    # proof found below is recorded back — these record sites are all
    # sound (core results and screen refutations; the deadline raise
    # above and the timeout path never record).
    vc = verdict_mod.cache()
    tids = None
    verdict_model = None
    if vc is not None:
        try:
            raws = [c.raw for c in constraints]
            tids = tuple(t.tid for t in raws)
            v, md = vc.probe(raws, tids)
        except Exception:
            v, md = None, None
        if v == verdict_mod.UNSAT:
            raise UnsatError
        if v == verdict_mod.SAT and md is not None:
            if not minimize and not maximize:
                model = Model([md])
                model_cache.put(model, 1)
                return _attach_witness(model, constraints)
            verdict_model = md

    # optimization queries must reach the core — a cached model
    # satisfies, but says nothing about the objective. The interval
    # refutation is objective-independent, so it screens EVERY query
    # (get_transaction_sequence always minimizes, and it is the
    # hottest unsat producer).
    phase_hint = verdict_model
    cached = model_cache.check_quick_sat(
        simplify(And(*constraints)).raw
    )
    if not minimize and not maximize:
        if cached:
            if vc is not None and tids is not None:
                try:
                    vc.record(tids, verdict_mod.SAT,
                              model=cached.raw[0])
                except Exception:
                    pass
            return _attach_witness(cached, constraints)
    else:
        # a cached/repaired model cannot answer an optimization query,
        # but it WARM-STARTS it: the solver's decision phases seed
        # from a satisfying assignment, so the objective search's
        # first solve is near-pure propagation instead of a cold walk
        # of a ~100k-variable instance. Even a model that does NOT
        # satisfy this query biases most variables correctly (sibling
        # paths share almost all structure); CDCL conflicts repair the
        # rest far faster than a cold zero-phase walk.
        # the verdict cache's parent-prefix model (set above) is the
        # closest sibling assignment available; the scan/most-recent
        # models only fill in when it is absent
        if phase_hint is None:
            if cached is None:
                cached = model_cache.most_recent()
            if cached is not None:
                try:
                    phase_hint = cached.raw[0]
                except Exception:
                    phase_hint = None
    if _interval_unsat(constraints):
        raise UnsatError
    # relational balance-delta refutation (smt/relational.py): the
    # detector's attacker-profit UNSATs — the hardest instances an
    # analysis issues — discharge in microseconds when the outflow
    # chain argument applies; like the interval screen it is sound and
    # objective-independent, so it may answer optimization queries too
    try:
        from ..smt.relational import relational_unsat

        if relational_unsat(constraints):
            if vc is not None and tids is not None:
                vc.record(tids, verdict_mod.UNSAT)
            raise UnsatError
    except UnsatError:
        raise
    except Exception as e:  # a screen, never an error path — but loud
        log.warning("relational screen unavailable: %s", e)

    s = Optimize()
    s.set_timeout(timeout)
    if phase_hint is not None:
        s.set_phase_hint(phase_hint)
    # harvested propagation facts (ops/propagate.py) assert AHEAD of
    # the real constraints: implied consequences of the asserted set,
    # so the verdict and model set are unchanged while the core starts
    # from the propagated bounds/bits instead of rediscovering them
    if vc is not None and tids is not None:
        try:
            facts = tuple(vc.facts_for(tids))
        except Exception:
            facts = ()
        # static storage-ITE facts (analysis/static_pass/deps.py):
        # implied by the term structure alone, same contract as the
        # propagation facts — assert ahead, verdict unchanged
        try:
            from ..analysis.static_pass import deps as static_deps

            facts += tuple(static_deps.static_hints_for_set(
                [getattr(c, "raw", c) for c in constraints
                 if type(c) != bool]))
        except Exception:
            pass
        if facts:
            from ..smt.bool import Bool
            from ..smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(hinted_solves=1)
            s.add(*[Bool(f) for f in facts])
    for constraint in constraints:
        s.add(constraint)
    for e in minimize:
        s.minimize(e)
    for e in maximize:
        s.maximize(e)
    if args.solver_log:
        _dump_query(s, constraints, minimize, maximize)

    from .telemetry import trace

    # default tier only: a caller's tier (check_batch, batch.pooled)
    # wins — this is the direct-get_model attribution
    tier = trace.current_query_context().get("tier", "get_model")
    with trace.query_context(tier=tier):
        result = s.check()
    if result == sat:
        model = s.model()
        model_cache.put(model, 1)
        if vc is not None and tids is not None:
            try:
                vc.record(tids, verdict_mod.SAT, model=model.raw[0])
            except Exception:
                pass
        return _attach_witness(model, constraints)
    if result == unknown:
        log.debug("Timeout/error encountered while solving expression")
        raise SolverTimeOutException
    # a core refutation (not a timeout): a run-wide proof
    if vc is not None and tids is not None:
        vc.record(tids, verdict_mod.UNSAT)
    raise UnsatError


get_model = lru_cache(maxsize=_model_lru_maxsize())(_get_model_impl)


def configure_model_lru(maxsize=None) -> None:
    """Rebuild the get_model memo with a new size (corpus drivers and
    tests; None re-reads env/support_args)."""
    global get_model
    get_model.cache_clear()
    get_model = lru_cache(
        maxsize=_model_lru_maxsize() if maxsize is None else maxsize
    )(_get_model_impl)


def check_batch(constraint_sets, solver_timeout=None,
                enforce_execution_time=True):
    """Batched `is_possible` over many constraint sets (the open-state
    reachability screen and the fork-pruning seam): one verdict per set,
    in input order, with exactly `Constraints.is_possible` semantics
    (timeout -> False for the default analysis timeout, True for a
    short custom one).

    The batch layer (smt/solver/batch.py) orders the queries in trie
    order — shortest constraint set first, then lexicographic by
    constraint tid — so strict subsets discharge before their supersets
    and shared prefixes blast once in the incremental session. An UNSAT
    set kills every superset in the batch without a solve (subset-kill)
    and a proved-SAT set answers every subset — including duplicate
    sibling sets — without a solve (SAT-subsumption); both directions
    are sound by monotonicity of conjunction. Every surviving query
    routes through `get_model`, so its verdict feeds the same lru cache
    and ModelCache single-query callers read — a SAT model found for
    one sibling quick-sat-serves the rest before any fresh solve, and
    later `is_possible` calls on the same sets are cache hits.
    `batch_solve_calls` counts only queries whose discharge reached the
    solver core (the query_count delta): a verdict from the batch
    screens, the get_model lru, the ModelCache, or the interval/
    relational refutations is a saved solve either way.

    Every query also consults the RUN-WIDE verdict cache
    (smt/solver/verdicts.py) — exact-key hits, ancestor-UNSAT
    subsumption across discharge calls, and parent-model shadowing
    (device-batched over large sibling waves, host term-eval otherwise)
    answer before `get_model` is even reached, and `get_model` records
    each fresh proof back for the rest of the run.

    With the persistent solver pool enabled (smt/solver/pool.py,
    K > 1) the queries that survive every screen fan out across the
    pool's worker sessions with trie-subtree affinity — each worker
    runs the same per-query `get_model` pipeline against its own
    incremental context; at K=1 the serial loop below runs
    unchanged."""
    from ..smt.solver.batch import (
        SubsetRegistry,
        count_prepared,
        order_by_prefix,
    )
    from ..smt.solver.solver_statistics import SolverStatistics

    sets = list(constraint_sets)
    if not sets:
        return []
    verdicts = [None] * len(sets)
    norm = [()] * len(sets)
    for i, cs in enumerate(sets):
        if not hasattr(cs, "get_all_constraints"):
            # bare Bool lists: lift to Constraints so the lru key is
            # hashable and the keccak axioms ride along, exactly as
            # they would under `Constraints.is_possible`
            from ..laser.state.constraints import Constraints

            cs = sets[i] = Constraints(list(cs))
        try:
            norm[i] = [c.raw for c in _normalized(cs)]
        except UnsatError:
            verdicts[i] = False
    ss = SolverStatistics()
    ss.batch_count += 1
    ss.batch_queries += len(sets)
    registry = SubsetRegistry()
    vc = verdict_mod.cache()
    # device bidirectional propagation screen (ops/propagate.py,
    # MTPU_PROPAGATE): product-domain refutations kill lanes before
    # any solver work, and surviving lanes harvest facts that hint
    # their `get_model` solves below. Sound — only proved-UNSAT sets
    # verdict False here. A device call that raises raises to the
    # caller (a wave under the threshold skips the screen).
    from ..ops import propagate

    if propagate.enabled():
        kills = propagate.prescreen(
            norm, [i for i, v in enumerate(verdicts) if v is None])
        for i in kills:
            verdicts[i] = False
            registry.note_unsat(frozenset(t.tid for t in norm[i]))
    if vc is not None:
        # device-batched tier-2 shadow: sibling queries sharing one
        # cached-SAT parent evaluate their deltas in a single interval-
        # kernel dispatch with the parent model pinned; proved queries
        # never reach the per-query loop below
        try:
            proved = vc.shadow_prepass(
                norm, [i for i, v in enumerate(verdicts) if v is None])
        except Exception:
            proved = {}
        for i in proved:
            verdicts[i] = True
            registry.note_sat(frozenset(t.tid for t in norm[i]))
    from ..smt.solver import core as solver_core
    from ..smt.solver import pool as pool_mod

    pool = pool_mod.get_pool()
    pooled = pool.parallel

    def feasible_one(i, tids):
        """The per-query solve step, shared by the serial loop and the
        pool workers (a worker's thread-local session makes the whole
        get_model pipeline — quick-sat, screens, incremental core —
        run against its own context). Registry/vc updates are
        thread-safe; `batch_solve_calls` reads the PER-THREAD query
        delta, exact under concurrency."""
        q0 = solver_core.thread_query_count()
        try:
            from .telemetry import trace

            with trace.query_context(tier="check_batch"):
                get_model(
                    sets[i],
                    solver_timeout=solver_timeout,
                    enforce_execution_time=enforce_execution_time,
                )
            verdict = True
            registry.note_sat(tids)
        # ordering matters: SolverTimeOutException SUBCLASSES
        # UnsatError, and a timeout is NOT a proof either way — its
        # tid-set must enter neither registry side
        except SolverTimeOutException:
            verdict = solver_timeout is not None
        except UnsatError:
            verdict = False
            registry.note_unsat(tids)
        if solver_core.thread_query_count() > q0:
            ss.bump(batch_solve_calls=1)
        return verdict

    survivors = []
    for i in order_by_prefix(norm):
        if verdicts[i] is not None:
            continue
        tids = frozenset(t.tid for t in norm[i])
        if registry.unsat_superset(tids):
            ss.subset_kills += 1
            verdicts[i] = False
            continue
        if registry.sat_subset(tids):
            ss.sat_subsumed += 1
            verdicts[i] = True
            continue
        if vc is not None:
            v, _md = vc.probe(norm[i])
            if v == verdict_mod.UNSAT:
                registry.note_unsat(tids)
                verdicts[i] = False
                continue
            if v == verdict_mod.SAT:
                registry.note_sat(tids)
                verdicts[i] = True
                continue
        ss.prefix_dedup_hits += count_prepared(norm[i])
        if pooled and norm[i]:
            survivors.append((i, tids))
            continue
        verdicts[i] = feasible_one(i, tids)
    if survivors:
        # trie-subtree affinity fan-out: siblings sharing their first
        # constraint land on the worker whose session holds the prefix
        def make_fn(i, tids):
            def fn():
                # a sibling worker may have settled a subset meanwhile
                if registry.unsat_superset(tids):
                    ss.bump(subset_kills=1)
                    return False
                if registry.sat_subset(tids):
                    ss.bump(sat_subsumed=1)
                    return True
                return feasible_one(i, tids)
            return fn

        items = [(norm[i][0].tid, make_fn(i, tids))
                 for i, tids in survivors]
        results = pool.map_wave(items)
        for (i, tids), res in zip(survivors, results):
            if res is pool_mod.NEEDS_SERIAL:
                # worker death: re-derive serially on the caller —
                # the same screens and get_model path, never a guess
                if registry.unsat_superset(tids):
                    ss.bump(subset_kills=1)
                    res = False
                elif registry.sat_subset(tids):
                    ss.bump(sat_subsumed=1)
                    res = True
                else:
                    res = feasible_one(i, tids)
            verdicts[i] = res
    return [bool(v) for v in verdicts]


def check_batch_async(constraint_sets, solver_timeout=None,
                      enforce_execution_time=True):
    """Futures variant of `check_batch`: returns a pool.PoolFuture
    whose result() is the keep-list, so callers submit a screen at one
    window/round boundary and collect at the next — the solver wall
    hides behind device execution or end-of-round host work instead of
    serializing after it (docs/solver_pool.md; the hidden time books
    as `async_overlap_ms`). With the pool at K=1 the screen runs
    inline at submit and result() is immediate — serial callers see
    exactly today's behavior."""
    from ..smt.solver import pool as pool_mod

    sets = list(constraint_sets)
    return pool_mod.get_pool().submit_async(lambda: check_batch(
        sets, solver_timeout=solver_timeout,
        enforce_execution_time=enforce_execution_time))
