"""Word-level decision procedure: preprocess -> interval filter -> bit-blast
-> native CDCL -> model.

This module is the engine behind the Solver/Optimize facades
(mythril_tpu_torch/smt/solver/__init__.py), replacing the z3 backend the reference
uses (reference mythril/laser/smt/solver/solver.py:18-121). Pipeline:

1. flatten conjunctions, constant-fold (already folded at construction);
2. equality propagation: ``var == const`` / ``var == term`` assertions become
   substitutions, iterated to fixpoint — this alone discharges most concrete
   EVM path queries without SAT;
3. unsigned-interval must-false filter (mythril_tpu_torch/smt/interval.py) — the
   host twin of the TPU lane pruner;
4. array/UF elimination by read-over-write reduction (done at construction)
   plus Ackermann expansion;
5. bit-blast (mythril_tpu_torch/smt/bitblast.py) onto the native CDCL core with the
   caller's timeout/conflict budget;
6. model extraction back through the substitution and Ackermann maps.
"""

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import terms as T
from ..bitblast import make_blaster
from ..interval import interval as abs_interval
from ...native import SatSolver

SAT, UNSAT, UNKNOWN = "sat", "unsat", "unknown"

log = logging.getLogger(__name__)


class ModelData:
    """Concrete assignment extracted from a successful check."""

    def __init__(self):
        self.bv: Dict[str, int] = {}
        self.bools: Dict[str, bool] = {}
        self.arrays: Dict[str, Tuple[int, Dict[int, int]]] = {}
        self.funcs: Dict[str, Dict[tuple, int]] = {}

    def env(self, complete: bool = True) -> "T.EvalEnv":
        # extraction never mutates a ModelData after check(); cache the
        # merged env — quick-sat re-evaluates cached models constantly
        cached = getattr(self, "_env_cache", None)
        if cached is not None and cached[0] == complete:
            return cached[1]
        bv = dict(self.bv)
        bv.update(self.bools)
        env = T.EvalEnv(bv=bv, arrays=self.arrays, funcs=self.funcs,
                        complete=complete)
        self._env_cache = (complete, env)
        return env

    #: persistent-memo size bound: STORE nodes memoize dict snapshots,
    #: so an unbounded memo grows quadratically on deep storage chains.
    #: Sized so a 64k-path terminal storm's shared-prefix DAG stays
    #: memoized across the whole quick-sat scan (~80 B/entry → ~160 MB
    #: at the cap); a 100k cap thrashed and made sibling evaluation
    #: quadratic (re-walking the shared prefix per open state)
    _MEMO_CAP = 2_000_000

    def eval_term(self, t: "T.Term", complete: bool = True):
        # persistent per-model memo: terms are hash-consed process-wide
        # and the assignment is frozen, so subterm values computed for
        # one quick-sat probe stay valid for every later probe
        memos = getattr(self, "_eval_memos", None)
        if memos is None:
            memos = self._eval_memos = {}
        memo = memos.setdefault(complete, {})
        if len(memo) > self._MEMO_CAP:
            memo.clear()
        return T.eval_term(t, self.env(complete=complete), memo)


def _flatten(assertions: List["T.Term"]) -> List["T.Term"]:
    out = []
    stack = list(assertions)
    while stack:
        a = stack.pop()
        if a.op == T.AND:
            stack.extend(a.args)
        else:
            out.append(a)
    return out


def _equality_propagation(assertions):
    """Extract var==term substitutions and apply to fixpoint (bounded)."""
    subs: Dict[int, T.Term] = {}
    for _ in range(8):
        new_sub = {}
        for a in assertions:
            if a.op != T.EQ:
                continue
            x, y = a.args
            for lhs, rhs in ((x, y), (y, x)):
                if (
                    lhs.op == T.BV_VAR
                    and lhs.tid not in subs
                    and lhs.tid not in new_sub
                    and lhs.tid not in _free_var_tids(rhs)
                ):
                    new_sub[lhs.tid] = rhs
                    break
        if not new_sub:
            break
        memo: Dict[int, T.Term] = {}
        assertions = [T.substitute_term(a, new_sub, memo) for a in assertions]
        subs = {
            k: T.substitute_term(v, new_sub, memo) for k, v in subs.items()
        }
        subs.update(new_sub)
        if all(a.op == T.TRUE for a in assertions):
            break
    return assertions, subs


_FREE_CACHE: Dict[int, frozenset] = {}


def _free_var_tids(t: "T.Term") -> frozenset:
    stack = [t]
    while stack:
        cur = stack[-1]
        if cur.tid in _FREE_CACHE:
            stack.pop()
            continue
        if cur.op in (T.BV_VAR, T.BOOL_VAR, T.ARRAY_VAR):
            _FREE_CACHE[cur.tid] = frozenset((cur.tid,))
            stack.pop()
            continue
        pending = [a for a in cur.args if a.tid not in _FREE_CACHE]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        if not cur.args:
            _FREE_CACHE[cur.tid] = frozenset()
        else:
            _FREE_CACHE[cur.tid] = frozenset().union(
                *(_FREE_CACHE[a.tid] for a in cur.args)
            )
    return _FREE_CACHE[t.tid]



def _congruence_axioms(x, fresh, select_map, apply_map):
    """Axiom terms tying a new Ackermann variable to previously seen
    instances, plus the (map, key, entry) registration to perform once
    the axioms are safely asserted. Shared by the one-shot and
    incremental paths so their semantics cannot drift."""
    axioms = []
    if x.op == T.SELECT:
        base = x.args[0]
        if base.op == T.CONST_ARRAY:
            axioms.append(T.mk_eq(fresh, base.args[0]))
            return axioms, None
        name = base.name
        idx1 = x.args[1]
        for (idx2, var2) in select_map.get(name, ()):
            # two DISTINCT constant indices make the congruence axiom
            # vacuously true — and constant indices are the common case
            # (calldata words, storage slots), so skipping them turns
            # the quadratic axiom set into pairs touching a symbolic
            # index only (an identical constant hits the instance cache
            # and never reaches here)
            if (
                idx1.op == T.BV_CONST
                and idx2.op == T.BV_CONST
                and idx1.val != idx2.val
            ):
                continue
            axioms.append(
                T.mk_bool_or(
                    T.mk_not(T.mk_eq(idx1, idx2)),
                    T.mk_eq(fresh, var2),
                )
            )
        return axioms, (select_map, name, (idx1, fresh))
    name = x.name
    for (args2, var2) in apply_map.get(name, ()):
        if any(
            a1.op == T.BV_CONST and a2.op == T.BV_CONST and a1.val != a2.val
            for a1, a2 in zip(x.args, args2)
        ):
            continue  # distinct constant argument: vacuous congruence
        hyp = [
            T.mk_not(T.mk_eq(a1, a2))
            for a1, a2 in zip(x.args, args2)
        ]
        axioms.append(T.mk_bool_or(*hyp, T.mk_eq(fresh, var2)))
    return axioms, (apply_map, name, (x.args, fresh))


def _ackermannize(assertions):
    """Replace SELECT/APPLY instances with fresh vars + congruence axioms.

    Returns (new_assertions, select_map, apply_map) where
    select_map: base array name -> list[(idx_term, fresh_var_term)]
    apply_map:  func name -> list[(args_terms, fresh_var_term)]
    """
    select_map: Dict[str, list] = {}
    apply_map: Dict[str, list] = {}
    counter = [0]

    def process(t_list):
        # repeatedly eliminate innermost select/apply nodes
        out = list(t_list)
        extra: List[T.Term] = []
        for _ in range(64):
            targets = []
            seen = set()
            for a in out + extra:
                T.collect(
                    a,
                    lambda x: x.op in (T.SELECT, T.APPLY),
                    targets,
                    seen,
                )
            # innermost only: none of my args contain select/apply
            def innermost(x):
                return not any(
                    T.collect(arg, lambda y: y.op in (T.SELECT, T.APPLY))
                    for arg in x.args
                )

            inner = [x for x in targets if innermost(x)]
            if not inner:
                break
            mapping = {}
            for x in inner:
                counter[0] += 1
                fresh = T.bv_var(f"__ack_{counter[0]}", x.width)
                mapping[x.tid] = fresh
                axioms, reg = _congruence_axioms(
                    x, fresh, select_map, apply_map
                )
                extra.extend(axioms)
                if reg is not None:
                    target, name, entry = reg
                    target.setdefault(name, []).append(entry)
            memo: Dict[int, T.Term] = {}
            out = [T.substitute_term(a, mapping, memo) for a in out]
            extra = [T.substitute_term(a, mapping, memo) for a in extra]
            for name in select_map:
                select_map[name] = [
                    (T.substitute_term(i, mapping, memo), v)
                    for (i, v) in select_map[name]
                ]
            for name in apply_map:
                apply_map[name] = [
                    (
                        tuple(T.substitute_term(a, mapping, memo) for a in ags),
                        v,
                    )
                    for (ags, v) in apply_map[name]
                ]
        return out + extra

    return process(assertions), select_map, apply_map


class CheckContext:
    """One check() invocation; retains blaster for model extraction."""

    def __init__(self):
        self.status = UNKNOWN
        self.model: Optional[ModelData] = None
        self.stats = {}


class _IncrementalSession:
    """Process-wide assumption-based incremental solving session.

    Tseitin definitions (bidirectional equivalences) and Ackermann
    congruence axioms are universally valid, so they accumulate as
    permanent clauses in ONE native CDCL instance; a query is just the
    set of its constraints' root literals passed as assumptions. Each
    term in the (globally hash-consed) DAG is therefore blasted at most
    once per process, and learned clauses carry across the thousands of
    near-identical path-feasibility checks the engine issues
    (reference behavior: a fresh z3 solver per query)."""

    def __init__(self):
        self.sat = SatSolver()
        self.blaster = make_blaster(self.sat)
        # generation stamp: reset_session() bumps the process counter,
        # invalidating thread-local worker sessions lazily (their
        # owning threads replace them on next use — a cross-thread
        # teardown would race the owner mid-solve)
        self.gen = _SESSION_GEN[0]
        # ackermannization state shared across queries
        self.ack_cache: Dict[int, "T.Term"] = {}  # select/apply tid -> var
        self.select_map: Dict[str, list] = {}
        self.apply_map: Dict[str, list] = {}
        self._ack_counter = [0]
        self._dirty = False
        # constraint tid -> (root lit, ackermann-expanded term)
        self._prepared: Dict[int, tuple] = {}
        # failed-assumption cores of past UNSAT answers: clauses only
        # ever accumulate in a session, so a query whose assumption set
        # contains a recorded core is unsat without touching the solver
        # (detector storms re-refute near-identical systems otherwise —
        # 24 attacker-profit checks on one corpus contract cost 27 s of
        # CDCL before this, ~1 s after)
        self.unsat_cores: List[frozenset] = []

    def prepare(self, work: List["T.Term"]) -> Tuple[List[int], list]:
        """(assumption literals, expanded terms) for a constraint list,
        blasting any terms not yet known to the session."""
        lits = []
        expanded_terms = []
        for t in work:
            entry = self._prepared.get(t.tid)
            if entry is None:
                expanded = self._ackermannize_term(t)
                self.blaster._ensure_blasted(expanded)
                entry = (self.blaster.bool_lit(expanded), expanded)
                self._prepared[t.tid] = entry
            lits.append(entry[0])
            expanded_terms.append(entry[1])
        return lits, expanded_terms

    def _ackermannize_term(self, t: "T.Term") -> "T.Term":
        """Eliminate SELECT/APPLY via session-cached fresh variables,
        asserting congruence axioms permanently as new instances appear.
        Sets _dirty while the shared caches are mid-mutation: an
        exception with _dirty set means the session may hold an Ackermann
        variable without its axioms and must be discarded."""
        self._dirty = True
        out = self._ackermannize_inner(t)
        self._dirty = False
        return out

    def _ackermannize_inner(self, t: "T.Term") -> "T.Term":
        for _ in range(64):
            targets: List["T.Term"] = []
            T.collect(t, lambda x: x.op in (T.SELECT, T.APPLY), targets)
            inner = [
                x
                for x in targets
                if not any(
                    T.collect(arg, lambda y: y.op in (T.SELECT, T.APPLY))
                    for arg in x.args
                )
            ]
            if not inner:
                return t
            mapping = {}
            for x in inner:
                cached = self.ack_cache.get(x.tid)
                if cached is not None:
                    mapping[x.tid] = cached
                    continue
                self._ack_counter[0] += 1
                fresh = T.bv_var(
                    f"__ack_{self._ack_counter[0]}", x.width
                )
                self.ack_cache[x.tid] = fresh
                mapping[x.tid] = fresh
                axioms, reg = _congruence_axioms(
                    x, fresh, self.select_map, self.apply_map
                )
                for axiom in axioms:
                    self._assert_axiom(axiom)
                if reg is not None:
                    target, name, entry = reg
                    target.setdefault(name, []).append(entry)
            t = T.substitute_term(t, mapping)
        return t

    def _assert_axiom(self, axiom: "T.Term") -> None:
        """Congruence axioms may themselves contain selects/applies in
        their index terms; expand before asserting permanently."""
        expanded = self._ackermannize_inner(axiom)
        self.blaster.assert_term(expanded)


_session: Optional[_IncrementalSession] = None
_SESSION_VAR_LIMIT = 3_000_000
_CORE_CACHE_CAP = 512

#: reset_session() generation counter (see _IncrementalSession.gen)
_SESSION_GEN = [0]

#: serializes queries against the PROCESS-GLOBAL session. Solver-pool
#: worker threads each own a thread-local session (set_thread_session)
#: and never contend here; the lock only matters when a background
#: orchestration task (async open-state screen, discharge_async
#: collection) and the main thread both bottom out in the shared
#: global session.
_SESSION_LOCK = threading.RLock()

_tls = threading.local()


def set_thread_session(sess: Optional[_IncrementalSession]) -> None:
    """Install (or clear, with None) THIS thread's private incremental
    session. While set, every check() on this thread runs against it
    lock-free — the session must be owned by exactly one thread."""
    _tls.session = sess


def ensure_thread_session() -> _IncrementalSession:
    """This thread's private session, creating one if absent (solver
    pool worker startup)."""
    sess = getattr(_tls, "session", None)
    if sess is None:
        sess = _IncrementalSession()
        _tls.session = sess
    return sess


def thread_session() -> Optional[_IncrementalSession]:
    return getattr(_tls, "session", None)


def thread_query_count() -> int:
    """Queries THIS thread has sent to the core (monotone). The pooled
    batch layers read the per-thread delta around a call to tell a
    cache hit from a real solve — the global query_count is shared by
    every worker and its delta is meaningless under concurrency."""
    return getattr(_tls, "qcount", 0)

#: unsat-core subsumption effectiveness (read by bench detail)
CORE_STATS = {"cached": 0, "hits": 0}

#: in-flight query registry (crash flight recorder,
#: support/telemetry/flightrec.py): every live check() registers its
#: constraint-set fingerprint here so a dying rank can dump what its
#: solvers were chewing on. Keyed by (thread ident, per-thread seq).
_INFLIGHT: Dict[tuple, dict] = {}
_INFLIGHT_LOCK = threading.Lock()


def inflight_queries() -> List[dict]:
    """Snapshot of currently-solving queries: fingerprint tids, tier/
    tactic attribution, budget, and monotonic age in seconds."""
    now = time.monotonic()
    with _INFLIGHT_LOCK:
        entries = list(_INFLIGHT.values())
    out = []
    for e in entries:
        d = dict(e)
        d["age_s"] = round(now - d.pop("t0"), 3)
        out.append(d)
    return out

# set False to fall back to one-shot solving (fresh instance per query)
INCREMENTAL = True


def _get_session() -> _IncrementalSession:
    sess = getattr(_tls, "session", None)
    if sess is not None:
        if (sess.sat.nvars > _SESSION_VAR_LIMIT
                or sess.gen != _SESSION_GEN[0]):
            sess = _IncrementalSession()
            _tls.session = sess
        return sess
    global _session
    if (_session is None or _session.sat.nvars > _SESSION_VAR_LIMIT
            or _session.gen != _SESSION_GEN[0]):
        _session = _IncrementalSession()
    return _session


#: daemon session keep-alive (docs/daemon.md §shared-state, satellite
#: of ISSUE 14): when True, reset_session()'s per-analysis retirement
#: is a no-op and every worker's incremental session stays hot across
#: requests. Sound by construction: a session's PERMANENT clauses are
#: only Tseitin definitions and Ackermann congruence axioms —
#: universally valid, query-independent — and each query is purely an
#: assumption set over them, so "pop the assertion stack back to the
#: empty frame" is the state a session already returns to between
#: queries. Retirement is a PERF policy (a one-shot sweep over many
#: unrelated contracts accumulates dead clauses — measured 40x over an
#: 18-contract run); the daemon's re-submission-heavy traffic inverts
#: that tradeoff (same code hash = same term DAG = already-blasted
#: clauses and valid unsat cores), and the _SESSION_VAR_LIMIT recycle
#: still bounds growth for mixed tenants.
KEEP_SESSIONS = False


def set_keep_sessions(keep: bool) -> None:
    """Flip the daemon keep-alive (daemon/server.py arms it; tests
    and MTPU_DAEMON_KEEP_SESSIONS=0 restore retirement)."""
    global KEEP_SESSIONS
    KEEP_SESSIONS = bool(keep)


def reset_session(force: bool = False) -> None:
    """Drop the shared incremental session — and, via the generation
    counter, every solver-pool worker's thread-local session (each
    worker replaces its own lazily; tearing one down from here would
    race its owner mid-solve). Call between independent analyses (e.g.
    per contract): constraints from different contracts share no
    structure, so a stale session only adds dead clauses that every
    solve must re-satisfy (measured 40x slowdown over an 18-contract
    sweep).

    Under the daemon keep-alive (KEEP_SESSIONS) the retirement is
    skipped — see the flag's docstring for why that is sound — unless
    ``force`` is set (pool reconfiguration, tests)."""
    global _session
    if KEEP_SESSIONS and not force:
        return
    _SESSION_GEN[0] += 1
    _session = None


def _solve_cancellable(sat, lits, remaining_s, conflict_budget, cancel):
    """sat.solve in short slices so a portfolio-race loser can be
    interrupted between slices (pool.RaceToken.interrupt — the native
    core has no asynchronous interrupt, but learned clauses and the
    assumption trail persist across calls, so resuming a slice costs
    only the assumption re-propagation). Semantics match one
    solve(timeout=remaining_s, conflicts=conflict_budget) call apart
    from the cancel exits: True/False are definitive, None means
    budget exhausted or cancelled."""
    deadline = time.monotonic() + remaining_s
    confl0 = sat.stats()["conflicts"]
    while True:
        if cancel is not None and cancel():
            return None
        left_s = deadline - time.monotonic()
        if left_s <= 0:
            return None
        slice_c = 1024
        if conflict_budget > 0:
            left_c = conflict_budget - (sat.stats()["conflicts"]
                                        - confl0)
            if left_c <= 0:
                return None
            slice_c = min(slice_c, left_c)
        res = sat.solve(assumptions=lits,
                        timeout=min(0.05, left_s), conflicts=slice_c)
        if res is not None:
            return res


def _check_incremental(ctx, work, timeout_s, conflict_budget,
                       t0, cancel=None) -> CheckContext:
    """Assumption-based query against this thread's session (see
    _IncrementalSession): a pool worker's private session when one is
    installed (lock-free — the worker owns it), the process-global
    session otherwise (under _SESSION_LOCK, so background discharge
    futures and the main thread cannot interleave on one native
    solver)."""
    if thread_session() is not None:
        return _check_incremental_unlocked(
            ctx, work, timeout_s, conflict_budget, t0, cancel)
    with _SESSION_LOCK:
        return _check_incremental_unlocked(
            ctx, work, timeout_s, conflict_budget, t0, cancel)


def _check_incremental_unlocked(ctx, work, timeout_s, conflict_budget,
                                t0, cancel=None) -> CheckContext:
    sess = _get_session()
    try:
        lits, expanded = sess.prepare(work)
    except Exception:
        # a failure while the ackermann caches were mid-mutation can
        # leave a fresh var without its congruence axioms: discard the
        # session. Failures after the caches settled (e.g. the blaster
        # rejecting an op) leave consistent state — keep the session and
        # let the one-shot fallback handle this query.
        if sess._dirty:
            if getattr(_tls, "session", None) is sess:
                _tls.session = None
            else:
                global _session
                _session = None
        raise

    lit_set = frozenset(lits)
    for core in sess.unsat_cores:
        if core <= lit_set:
            CORE_STATS["hits"] += 1
            ctx.status = UNSAT
            return ctx

    remaining = timeout_s - (time.monotonic() - t0)
    if remaining <= 0:
        ctx.status = UNKNOWN
        return ctx
    if cancel is None:
        res = sess.sat.solve(
            assumptions=lits, timeout=remaining,
            conflicts=conflict_budget
        )
    else:
        res = _solve_cancellable(sess.sat, lits, remaining,
                                 conflict_budget, cancel)
    if res is None:
        ctx.status = UNKNOWN
        return ctx
    if res is False:
        try:
            core = frozenset(sess.sat.core())
        except Exception:
            core = None
        # a valid core is a subset of this query's assumptions; cache
        # it for subsumption (clauses only accumulate, so it stays
        # refuted for the life of the session). An empty core would
        # mean the permanent clauses alone are unsat — the session is
        # poisoned (sat.ok latched false) and must not cache anything.
        if core and core <= lit_set:
            if core not in sess.unsat_cores:
                sess.unsat_cores.append(core)
                CORE_STATS["cached"] += 1
                del sess.unsat_cores[:-_CORE_CACHE_CAP]
        ctx.status = UNSAT
        return ctx

    ctx.status = SAT
    ctx.model = _extract_model(
        sess.blaster, sess.sat, {}, sess.select_map, sess.apply_map,
        scope=_query_scope(work, expanded),
    )
    ctx.stats = sess.sat.stats()
    return ctx


def _seed_phases_from_hint(blaster, sat, work, hint) -> int:
    """Bias the fresh instance's decision phases toward a model that
    satisfies the (un-optimized) constraints — quick-sat/repair hands
    the optimizer a warm start, collapsing the cold first solve of a
    ~100k-variable instance to near-pure propagation. Returns bits
    seeded (observability)."""
    found: List["T.Term"] = []
    seen: set = set()
    for a in work:
        # one shared seen set: assertions share large DAGs, and a
        # per-assertion walk would revisit every shared subterm
        T.collect(a, lambda x: x.op == T.BV_VAR, found, seen)
    pairs = []
    bv = hint.bv
    for v in found:
        val = bv.get(v.name)
        if val is None:
            continue
        try:
            bits = blaster.bits(v)
        except Exception:
            continue
        for i, lit in enumerate(bits):
            if not isinstance(lit, int) or lit == 0:
                continue
            want = (int(val) >> i) & 1
            pairs.append((abs(lit), bool(want) ^ (lit < 0)))
    sat.seed_phases(pairs)
    return len(pairs)


def check(
    assertions: List["T.Term"],
    timeout_s: float = 10.0,
    conflict_budget: int = 0,
    minimize: List["T.Term"] = (),
    maximize: List["T.Term"] = (),
    phase_hint=None,
    cancel=None,
    force_oneshot: bool = False,
) -> CheckContext:
    """Decide conjunction of Bool terms; optionally lexicographically
    minimize the given BV terms (used by Optimize for tx-sequence
    minimization, reference analysis/solver.py:222-259).

    `cancel` (a nullary callable) makes the underlying CDCL run in
    interruptible slices — the portfolio-race loser's exit
    (smt/solver/pool.py); `force_oneshot` skips the incremental
    session and solves on a fresh instance with equality propagation —
    the race's second tactic. Both default off and leave the serial
    path byte-identical.

    Every call counts as one solver query in SolverStatistics — this is
    the fresh-solve entry every cache/screen layer above bottoms out in,
    so `query_count`/`solver_time` measure actual solver work (the
    batched discharge reads the per-thread delta to tell a cache hit
    from a solve). Each call also registers in the in-flight registry
    (flight recorder), records a `solver.check` span when tracing is
    on, feeds the per-tactic wall histogram, and lands in the
    slow-query log when it exceeds MTPU_SLOW_QUERY_MS
    (docs/observability.md)."""
    from ...support.telemetry import metrics, slowlog
    from ...support.telemetry import trace
    from .solver_statistics import SolverStatistics

    ss = SolverStatistics()
    ss.bump(query_count=1)
    _tls.qcount = getattr(_tls, "qcount", 0) + 1
    qctx = trace.current_query_context()
    tactic = qctx.get("tactic") or (
        "oneshot" if force_oneshot else "incremental")
    tier = qctx.get("tier", "direct")
    t_q = time.monotonic()
    key = (threading.get_ident(), _tls.qcount)
    tids = [a.tid for a in assertions]
    with _INFLIGHT_LOCK:
        _INFLIGHT[key] = {"tids": tids, "tier": tier,
                          "tactic": tactic, "timeout_s": timeout_s,
                          "t0": t_q}
    status = "error"
    try:
        with trace.span("solver.check", tier=tier, tactic=tactic,
                        n=len(assertions)) as sp:
            ctx = None
            # learned first-try routing (support/warm_store.py,
            # docs/warm_store.md): a plain satisfiability query whose
            # SHAPE has enough cross-run history first-tries the
            # recorded winning tactic at the recorded budget; a
            # definitive answer skips the full-budget default (and,
            # on the pooled path, the portfolio race). UNKNOWN falls
            # back to the untouched default pipeline, so routing can
            # cost bounded extra wall but never a verdict. The pool's
            # own tiers consult before calling here (pool.solve_query)
            # and are excluded, as are optimization/cancellable calls.
            route = None
            if (cancel is None and not force_oneshot and not minimize
                    and not maximize
                    and tier not in ("pool.first", "pool.race")):
                try:
                    from ...support import warm_store

                    route = warm_store.route_for_query(
                        len(assertions), timeout_s)
                except (KeyboardInterrupt, MemoryError):
                    raise  # fatal, never a degrade
                except Exception:  # a hint, never an error path
                    route = None
            if route is not None:
                r_tactic, r_budget = route
                ctx = _check_unmeasured(
                    assertions, r_budget, conflict_budget, (), (),
                    phase_hint, None, r_tactic == "oneshot")
                if ctx.status in (SAT, UNSAT):
                    tactic = "routed." + r_tactic
                    ss.bump(route_first_try_wins=1)
                else:
                    ctx = None  # routed budget exhausted: full path
            if ctx is None:
                ctx = _check_unmeasured(assertions, timeout_s,
                                        conflict_budget, minimize,
                                        maximize, phase_hint, cancel,
                                        force_oneshot)
            status = ctx.status
            sp.set(status=status, tactic=tactic)
        return ctx
    finally:
        wall = time.monotonic() - t_q
        ss.bump(solver_time=wall)
        with _INFLIGHT_LOCK:
            _INFLIGHT.pop(key, None)
        try:
            metrics.registry().histogram(
                "solver_wall_ms." + tactic).observe(wall * 1000.0)
            # warm-store routing history (cross-run only; inert
            # unless a store is active — support/warm_store.py)
            from ...support import warm_store

            warm_store.observe_query(len(assertions), tactic, wall,
                                     status)
            slowlog.maybe_record(
                wall * 1000.0, tids=tids, tier=tier, tactic=tactic,
                timeout_s=timeout_s, status=status)
        except (KeyboardInterrupt, MemoryError):
            raise  # fatal, never a degrade
        except Exception:  # telemetry only, never a solve path
            pass


def _check_unmeasured(
    assertions: List["T.Term"],
    timeout_s: float = 10.0,
    conflict_budget: int = 0,
    minimize: List["T.Term"] = (),
    maximize: List["T.Term"] = (),
    phase_hint=None,
    cancel=None,
    force_oneshot: bool = False,
) -> CheckContext:
    ctx = CheckContext()
    t0 = time.monotonic()
    work = _flatten(assertions)
    if any(a.op == T.FALSE for a in work):
        ctx.status = UNSAT
        return ctx
    work = [a for a in work if a.op != T.TRUE]

    # interval pre-filter (host twin of the TPU lane pruner)
    memo: Dict[int, object] = {}
    for a in work:
        mf, mt = abs_interval(a, memo)
        if not mt:
            ctx.status = UNSAT
            return ctx

    # Plain satisfiability checks (the engine's thousands of per-fork
    # `is_possible` queries over growing path-constraint prefixes) run
    # against the shared incremental session: every term blasts at most
    # once per process and learned clauses persist. Optimization queries
    # (rare; one per reported issue) stay on the one-shot path — their
    # binary-search probes are much cheaper against a small bespoke
    # formula than against the session's accumulated clause set.
    if INCREMENTAL and not minimize and not maximize \
            and not force_oneshot:
        try:
            return _check_incremental(
                ctx, work, timeout_s, conflict_budget, t0, cancel,
            )
        except NotImplementedError:
            pass  # unsupported term shape: fall through to one-shot

    # ---- one-shot path (fresh instance; also the fallback) ---------------
    work, subs = _equality_propagation(work)
    if any(a.op == T.FALSE for a in work):
        ctx.status = UNSAT
        return ctx
    work = [a for a in work if a.op != T.TRUE]

    work, select_map, apply_map = _ackermannize(work)
    work = [a for a in work if a.op != T.TRUE]
    if any(a.op == T.FALSE for a in work):
        ctx.status = UNSAT
        return ctx

    sat = SatSolver()
    blaster = make_blaster(sat)
    for a in work:
        blaster.assert_term(a)
    if phase_hint is not None:
        try:
            _seed_phases_from_hint(blaster, sat, work, phase_hint)
        except Exception as e:  # a bias, never an error path
            log.debug("phase seeding skipped: %s", e)

    remaining = timeout_s - (time.monotonic() - t0)
    if remaining <= 0:
        ctx.status = UNKNOWN
        return ctx
    if cancel is None:
        res = sat.solve(timeout=remaining, conflicts=conflict_budget)
    else:
        res = _solve_cancellable(sat, (), remaining, conflict_budget,
                                 cancel)
    if res is None:
        ctx.status = UNKNOWN
        return ctx
    if res is False:
        ctx.status = UNSAT
        return ctx

    # SAT: optional lexicographic optimization of objectives (MSB->LSB)
    if minimize or maximize:
        if not _optimize_objectives(
            blaster, sat, minimize, maximize, subs, timeout_s, t0
        ):
            # no satisfying assignment could be restored within budget
            ctx.status = UNKNOWN
            return ctx

    ctx.status = SAT
    ctx.model = _extract_model(blaster, sat, subs, select_map, apply_map)
    ctx.stats = sat.stats()
    return ctx


def _optimize_objectives(blaster, sat, minimize, maximize, subs, timeout_s,
                         t0):
    """Lexicographic optimization by binary search on the objective value
    (~log2(initial model value) solves per objective instead of one solve
    per bit — the per-bit MSB probing dominated get_transaction_sequence
    wall time with ~256 incremental solves per objective).

    Invariant restored on every exit path: the SAT core holds a
    satisfying assignment for the original constraints."""
    fixed: List[int] = []
    objectives = [(obj, False) for obj in minimize] + [
        (obj, True) for obj in maximize
    ]
    for obj, maximizing in objectives:
        obj_sub = T.substitute_term(obj, subs)
        if obj_sub.op == T.BV_CONST:
            continue
        try:
            blaster._ensure_blasted(obj_sub)  # deep terms: avoid recursion
            bits = blaster.bits(obj_sub)
        except NotImplementedError:
            continue  # objective contains arrays not present in constraints

        def read_val():
            v = 0
            for i, l in enumerate(bits):
                if blaster.is_true(l):
                    v |= 1 << i
                elif blaster.is_false(l):
                    pass
                elif sat.value(abs(l)) != (l < 0):
                    v |= 1 << i
            return v

        def bound_lit(limit, upper):
            """Literal for obj <= limit (upper) / obj >= limit."""
            const = blaster.const_bits(limit, len(bits))
            if upper:
                return -blaster.ult_vec(const, bits)  # !(limit < obj)
            return -blaster.ult_vec(bits, const)  # !(obj < limit)

        # current model gives the starting bound
        remaining = timeout_s - (time.monotonic() - t0)
        if remaining <= 0:
            break
        r = sat.solve(assumptions=fixed, timeout=remaining,
                      conflicts=20000)
        if r is not True:
            break
        best = read_val()
        lo, hi = 0, best
        full = (1 << len(bits)) - 1
        if maximizing:
            lo, hi = best, full
        while lo < hi:
            remaining = timeout_s - (time.monotonic() - t0)
            if remaining <= 0:
                break
            mid = (lo + hi) // 2  # probe the lower (upper) half
            want = bound_lit(mid, upper=not maximizing)
            r = sat.solve(
                assumptions=fixed + [want], timeout=remaining,
                conflicts=20000,
            )
            if r is True:
                got = read_val()
                if maximizing:
                    lo = max(got, mid + 1)
                    best = max(best, got)
                else:
                    hi = min(got, mid)
                    best = min(best, got)
            elif r is False:
                if maximizing:
                    hi = mid
                else:
                    lo = mid + 1
            else:
                break
        # pin the found optimum for subsequent objectives
        eq_lits = []
        ok = True
        for i, l in enumerate(bits):
            want_bit = (best >> i) & 1
            if blaster.is_true(l) or blaster.is_false(l):
                if int(blaster.is_true(l)) != want_bit:
                    ok = False  # constant bits contradict (stale best)
                continue
            eq_lits.append(l if want_bit else -l)
        if ok:
            fixed.extend(eq_lits)
    # restore a model consistent with whatever got fixed; fall back to the
    # unconstrained problem if even that probe is over budget
    r = sat.solve(
        assumptions=fixed,
        timeout=max(1.0, timeout_s - (time.monotonic() - t0)),
    )
    if r is not True:
        r = sat.solve(
            timeout=max(1.0, timeout_s - (time.monotonic() - t0))
        )
    return r is True


def _query_scope(work, expanded):
    """(var terms, array names, function names) reachable from a query:
    restricts session-wide model extraction to what the caller can ask
    about — extraction iterates the query's own variable terms instead
    of walking the session's full _bv/_bool maps (which span every
    query ever made and grow for the life of the process)."""
    var_terms, arrays, funcs = [], set(), set()
    seen: set = set()
    seen_vars: set = set()
    for t in list(work) + list(expanded):
        for v in T.collect(
            t,
            lambda x: x.op in (T.BV_VAR, T.BOOL_VAR, T.ARRAY_VAR,
                               T.APPLY),
            seen=seen,
        ):
            if v.op == T.ARRAY_VAR:
                arrays.add(v.name)
            elif v.op == T.APPLY:
                funcs.add(v.name)
            elif v.tid not in seen_vars:
                seen_vars.add(v.tid)
                var_terms.append(v)
    return var_terms, arrays, funcs


def _extract_model(blaster, sat, subs, select_map, apply_map,
                   scope=None) -> ModelData:
    md = ModelData()
    if hasattr(blaster, "snapshot_model"):
        # one native call for the whole assignment instead of one FFI
        # crossing per extracted word; _extract_model_inner runs under
        # try/finally so a raising extraction can't leak a stale snap
        blaster.snapshot_model()
    try:
        return _extract_model_inner(md, blaster, sat, subs, select_map,
                                    apply_map, scope)
    finally:
        if hasattr(blaster, "snapshot_model"):
            blaster._snap = None


def _extract_model_inner(md, blaster, sat, subs, select_map, apply_map,
                         scope):
    arr_names = func_names = ack_tids = None
    if scope is not None:
        scope_vars, arr_names, func_names = scope
        ack_tids = {
            t.tid
            for t in scope_vars
            if t.op == T.BV_VAR and t.name.startswith("__ack_")
        }
        for t in scope_vars:
            if t.op == T.BV_VAR:
                if not t.name.startswith("__ack_") and t.tid in blaster._bv:
                    md.bv[t.name] = blaster.model_value(t)
            elif t.tid in blaster._bool:
                md.bools[t.name] = bool(blaster.model_value(t))
    else:
        for key, bits in list(blaster._bv.items()):
            if not isinstance(key, int):
                continue
            t = _term_by_tid(key)
            if t is not None and t.op == T.BV_VAR and not t.name.startswith(
                "__ack_"
            ):
                md.bv[t.name] = blaster.model_value(t)
        for key, lit in list(blaster._bool.items()):
            t = _term_by_tid(key)
            if t is not None and t.op == T.BOOL_VAR:
                md.bools[t.name] = bool(blaster.model_value(t))
    env = T.EvalEnv(bv=dict(md.bv, **md.bools), arrays=md.arrays,
                    funcs=md.funcs, complete=True)
    # arrays from ackermann select instances (before subs eval: rhs terms may
    # contain selects which eval_term resolves through env.arrays)
    for name, entries in select_map.items():
        if arr_names is not None and name not in arr_names:
            continue
        if ack_tids is not None:
            # only this query's select instances: entry lists are shared
            # across every query that ever touched this array name
            entries = [e for e in entries if e[1].tid in ack_tids]
        table: Dict[int, int] = {}
        for idx_t, var_t in entries:
            if idx_t.tid in blaster._bv:
                idx_v = blaster.model_value(idx_t)
            else:
                idx_v = T.eval_term(idx_t, env)
            if var_t.tid in blaster._bv:
                val_v = blaster.model_value(var_t)
            else:
                val_v = 0
            table.setdefault(idx_v, val_v)
        md.arrays[name] = (0, table)
    for name, entries in apply_map.items():
        if func_names is not None and name not in func_names:
            continue
        if ack_tids is not None:
            entries = [e for e in entries if e[1].tid in ack_tids]
        table2: Dict[tuple, int] = {}
        for args_t, var_t in entries:
            key2 = tuple(
                blaster.model_value(a)
                if a.tid in blaster._bv
                else T.eval_term(a, env)
                for a in args_t
            )
            val = (
                blaster.model_value(var_t) if var_t.tid in blaster._bv else 0
            )
            table2.setdefault(key2, val)
        md.funcs[name] = table2
    # substitution-derived values (vars eliminated before blasting)
    for tid, rhs in subs.items():
        t = _term_by_tid(tid)
        if t is None or t.op != T.BV_VAR:
            continue
        try:
            # rhs may contain blasted vars; evaluate via blaster when present
            if rhs.tid in blaster._bv:
                md.bv[t.name] = blaster.model_value(rhs)
            else:
                md.bv[t.name] = T.eval_term(rhs, env)
        except Exception:
            md.bv[t.name] = 0
    return md


_term_by_tid = T.term_by_tid
