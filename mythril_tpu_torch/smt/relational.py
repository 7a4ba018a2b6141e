"""Relational balance-delta refutation.

Detector pre-solves of the shape "can this account's balance strictly
exceed its starting balance?" (ether_thief's attacker-profit check,
reference mythril/analysis/module/modules/ether_thief.py:44-79) produce
the hardest UNSAT instances an analysis issues: a `ULT(start, balance)`
conjunct whose balance side is the full transfer history — an ITE tree
over maybe-aliasing transfer targets with sum/difference leaves. The
CDCL core refutes each one in seconds inside a large session; but the
refutation argument is always the same *relational* one: on every
transfer path the balance delta is a sum of non-negative outflows, and
every outflow v carried a no-underflow guard `v <= balance-at-transfer`
into the path constraints, so the balance can never climb above start.

This module runs that argument directly on the term DAG:

1. substitute the query's own `var == const` equalities (collapses the
   target-aliasing ITE conditions the detector pinned, e.g.
   `sender == ATTACKER`);
2. enumerate the balance tree's remaining ITE cases (budgeted), each
   yielding an exact mod-2^256 linear form over hash-consed atoms;
3. discharge a case when its guard assignment contradicts a literal
   conjunct, or when its delta (balance minus start) is outflow-only
   and the outflows chain through no-underflow guards found among the
   constraints:  W_0 = start;  guard v_t <= W_t  =>  W_{t+1} =
   W_t - v_t stays in [0, W_t]  (all in ZZ: by induction no term in
   the chain wraps, so the mod-2^256 guard semantics coincide with the
   integer ones).  Every case discharged  =>  the conjunct is false in
   every model  =>  the query is UNSAT.

All matching is exact (tid equality on interned terms); any shape this
reasoning does not cover falls through to the CDCL core unchanged.
"""

from typing import Dict, List, Optional, Tuple

from . import terms as T

M256 = 1 << 256

#: enumeration budgets: cases per conjunct / node visits per attempt
_MAX_CASES = 96
_MAX_VISITS = 60_000
#: outflow-chain search is a tiny backtracking cover; bound its size
_MAX_CHAIN = 8

STATS = {"attempts": 0, "refuted": 0}


class _Bail(Exception):
    """Budget exhausted or unsupported shape: defer to CDCL."""


def _bool_ite_literal(c: "T.Term") -> Optional[Tuple["T.Term", bool]]:
    """Decode a boolean-encoded path condition: the engine asserts
    JUMPI conditions as `ite(cond,1,0) != 0` / `== 0` shapes; returns
    (cond, truth) when `c` is one."""
    val = True
    while c.op == T.NOT:
        val = not val
        c = c.args[0]
    if c.op != T.EQ:
        return None
    a, b = c.args
    if b.op == T.ITE:
        a, b = b, a
    if a.op != T.ITE or b.op != T.BV_CONST:
        return None
    th, el = a.args[1], a.args[2]
    if th.op != T.BV_CONST or el.op != T.BV_CONST:
        return None
    if b.val == th.val and b.val != el.val:
        return a.args[0], val
    if b.val == el.val and b.val != th.val:
        return a.args[0], not val
    return None


def _harvest(raws: List["T.Term"]) -> Tuple[Dict[int, "T.Term"],
                                            Dict[int, bool]]:
    """(substitution, fixed ITE-condition truths) implied by literal
    conjuncts, iterated once through the boolean-encoded layer.

    Equalities pin any non-const term to a constant (vars, but also
    e.g. `select(balance, 0x0) == 0` for a known account's starting
    balance); `ite(cond,1,0) != 0`-shaped conjuncts fix `cond`, and a
    fixed `cond` that is itself an equality feeds back into the
    substitution (a `callvalue == 0` branch binds the value)."""
    sub: Dict[int, "T.Term"] = {}
    fixed: Dict[int, bool] = {}

    def note_eq(c: "T.Term"):
        x, y = c.args
        for lhs, rhs in ((x, y), (y, x)):
            if (
                rhs.op == T.BV_CONST
                and lhs.op != T.BV_CONST
                and lhs.tid not in sub
            ):
                sub[lhs.tid] = rhs

    for c in raws:
        if c.op == T.EQ:
            note_eq(c)
        lit = _bool_ite_literal(c)
        if lit is not None:
            cond, val = lit
            fixed[cond.tid] = val
            if val and cond.op == T.EQ:
                note_eq(cond)
    return sub, fixed


def _cases(t: "T.Term", mu: Dict[int, bool], budget: List[int]):
    """Enumerate (mu', coeffs, const) linearizations of `t`.

    mu assigns truth values to ITE condition tids along this case; the
    linear form is exact in Z/2^256: t == const + sum(coeff * atom)
    under every model consistent with mu'. Case splits thread mu
    left-to-right through sums so shared conditions stay consistent.
    """
    budget[0] -= 1
    if budget[0] <= 0:
        raise _Bail
    op = t.op
    if op == T.ITE:
        cond = t.args[0]
        known = mu.get(cond.tid)
        if cond.op == T.TRUE or known is True:
            yield from _cases(t.args[1], mu, budget)
            return
        if cond.op == T.FALSE or known is False:
            yield from _cases(t.args[2], mu, budget)
            return
        for val, branch in ((True, t.args[1]), (False, t.args[2])):
            mu2 = dict(mu)
            mu2[cond.tid] = val
            yield from _cases(branch, mu2, budget)
        return
    if op in (T.ADD, T.SUB):
        sign = 1 if op == T.ADD else -1
        for mu1, c1, k1 in _cases(t.args[0], mu, budget):
            for mu2, c2, k2 in _cases(t.args[1], mu1, budget):
                coeffs = dict(c1)
                for tid, co in c2.items():
                    nc = coeffs.get(tid, 0) + sign * co
                    if nc:
                        coeffs[tid] = nc
                    else:
                        coeffs.pop(tid, None)
                yield mu2, coeffs, (k1 + sign * k2) % M256
        return
    if op == T.NEG:
        for mu1, c1, k1 in _cases(t.args[0], mu, budget):
            yield mu1, {tid: -co for tid, co in c1.items()}, (-k1) % M256
        return
    if op == T.BV_CONST:
        yield mu, {}, t.val
        return
    yield mu, {t.tid: 1}, 0


def _single_case(t: "T.Term", mu: Dict[int, bool],
                 budget: List[int]) -> Optional[Tuple[dict, int]]:
    """(coeffs, const) when `t` linearizes WITHOUT further case splits
    under mu; None when it would split (ambiguous under this case)."""
    first = None
    try:
        for mu1, coeffs, k in _cases(t, mu, budget):
            if first is not None:
                return None
            if len(mu1) != len(mu):
                return None  # split on a condition mu doesn't fix
            first = (coeffs, k)
    except _Bail:
        return None
    return first


def _collect_ule_guards(raws: List["T.Term"], sub, memo) -> List[
        Tuple["T.Term", "T.Term"]]:
    """(small, big) pairs with small <= big implied by a literal
    conjunct: ULE(a,b) / ULT(a,b) assert it directly, NOT(ULT(b,a))
    asserts it contrapositively (UGE's construction)."""
    out = []
    for c in raws:
        if c.op in (T.ULE, T.ULT):
            a, b = c.args
            out.append((T.substitute_term(a, sub, memo),
                        T.substitute_term(b, sub, memo)))
        elif c.op == T.NOT and c.args[0].op == T.ULT:
            b, a = c.args[0].args
            out.append((T.substitute_term(a, sub, memo),
                        T.substitute_term(b, sub, memo)))
    return out


def _lin_guards(guards, pos_tids, mu, case_sub, budget) -> List[
        Tuple[int, Dict[int, int]]]:
    """(v_tid, rhs linear form) pairs for guards whose small side is a
    single atom of interest, linearized under the case."""
    sub_memo: Dict[int, "T.Term"] = {}
    out = []
    for small, big in guards:
        if case_sub:
            small = T.substitute_term(small, case_sub, sub_memo)
            big = T.substitute_term(big, case_sub, sub_memo)
        if small.op == T.BV_CONST:
            continue
        small_lin = _single_case(small, mu, budget)
        if small_lin is None or small_lin[1] != 0 \
                or len(small_lin[0]) != 1:
            continue
        (v_tid, v_co), = small_lin[0].items()
        if v_co != 1 or v_tid not in pos_tids:
            continue
        big_lin = _single_case(big, mu, budget)
        if big_lin is None or big_lin[1] != 0:
            continue
        out.append((v_tid, big_lin[0]))
    return out


def _discharge_case(s_tid: int, delta: Dict[int, int], guards, mu,
                    case_sub, budget) -> bool:
    """Prove delta = b - s can never be (strictly) positive.

    Outflows N (negative coeffs) must chain through no-underflow
    guards anchored at start:  v_t <= start - (v_1 + .. + v_{t-1}),
    so start - N stays in [0, start] with no wrap.  Each inflow v in P
    (positive coeffs) must carry a guard v <= X where X's linear form
    is a +1-coefficient sub-multiset of N not claimed by another
    inflow:  v's integer value is then <= the sum of those outflows
    (a wrapped X only strengthens the bound), so P <= N and
    b = start - N + P lands in [0, start]."""
    neg = {tid: -co for tid, co in delta.items() if co < 0}
    pos = {tid: co for tid, co in delta.items() if co > 0}
    if sum(neg.values()) > _MAX_CHAIN or sum(pos.values()) > _MAX_CHAIN:
        return False
    interest = set(neg) | set(pos)
    lin = _lin_guards(guards, interest, mu, case_sub, budget)

    # bound every inflow by a disjoint sub-multiset of the outflows
    avail = dict(neg)
    for v_tid, count in pos.items():
        if count != 1:
            return False
        bounded = False
        for g_tid, rhs in lin:
            if g_tid != v_tid:
                continue
            if any(co < 0 or co > avail.get(tid, 0)
                   for tid, co in rhs.items()):
                continue
            for tid, co in rhs.items():
                avail[tid] -= co
            bounded = True
            break
        if not bounded:
            return False

    # chain the full outflow multiset from start
    def expect(used: Dict[int, int]) -> Dict[int, int]:
        # MERGE coefficients (dropping zeros): when the start atom is
        # itself consumed as an outflow, its +1 start coefficient must
        # combine to 1-n — overwriting it (e[tid] = -n) made a guard of
        # the form `v <= 0 - start` match as if it proved
        # `v <= start - start`, and relational_unsat then declared
        # satisfiable sets UNSAT (ADVICE.md high; regression in
        # tests/test_relational.py)
        e = {s_tid: 1}
        for tid, n in used.items():
            nc = e.get(tid, 0) - n
            if nc:
                e[tid] = nc
            else:
                e.pop(tid, None)
        return e

    def search(remaining: Dict[int, int], used: Dict[int, int]) -> bool:
        if not any(remaining.values()):
            return True
        want_big = expect(used)
        for v_tid, big_form in lin:
            if remaining.get(v_tid, 0) <= 0:
                continue
            if big_form != want_big:
                continue
            remaining[v_tid] -= 1
            used[v_tid] = used.get(v_tid, 0) + 1
            if search(remaining, used):
                return True
            remaining[v_tid] += 1
            used[v_tid] -= 1
        return False

    return search(dict(neg), {})


def _node_count_within(t: "T.Term", cap: int) -> bool:
    """Bounded DFS: does the DAG hold at most `cap` distinct nodes?
    Aborts as soon as the cap is exceeded (no full-DAG walk)."""
    seen = set()
    stack = [t]
    while stack:
        cur = stack.pop()
        if cur.tid in seen:
            continue
        seen.add(cur.tid)
        if len(seen) > cap:
            return False
        stack.extend(cur.args)
    return True


def _small_conjuncts(sub_conjuncts: List["T.Term"]) -> List["T.Term"]:
    """Conjuncts cheap enough to re-fold per case (the ACTORS-style
    `Or(sender == A, sender == B)` disjunctions are tiny; path
    conditions over calldata are not)."""
    return [sc for sc in sub_conjuncts if _node_count_within(sc, 64)]


def _case_bindings(mu: Dict[int, bool]) -> Dict[int, "T.Term"]:
    """Substitution implied by a case's guard assignment: every guard
    condition maps to its truth constant, and a TRUE `term == const`
    guard additionally binds the term."""
    case_sub: Dict[int, "T.Term"] = {}
    for cond_tid, val in mu.items():
        case_sub[cond_tid] = T.bool_t(val)
        if not val:
            continue
        cond = _term_by_tid(cond_tid)
        if cond is None or cond.op != T.EQ:
            continue
        a, b = cond.args
        for lhs, rhs in ((a, b), (b, a)):
            if rhs.op == T.BV_CONST and lhs.op != T.BV_CONST:
                case_sub.setdefault(lhs.tid, rhs)
    return case_sub


def _relinearize(delta: Dict[int, int], k: int, mu: Dict[int, bool],
                 case_sub, budget: List[int]
                 ) -> Optional[Tuple[Dict[int, int], int]]:
    """Re-express a linear form's atoms under the case's own equality
    bindings (a `sender_1 == ATTACKER` guard folds
    `select(balance, sender_1)` onto the attacker chain); returns the
    merged (coeffs, const) or None when an atom stays ambiguous."""
    memo: Dict[int, "T.Term"] = {}
    out: Dict[int, int] = {}
    for tid, co in delta.items():
        t = _term_by_tid(tid)
        if t is None:
            return None
        t2 = T.substitute_term(t, case_sub, memo)
        if t2.tid == tid:
            out[tid] = out.get(tid, 0) + co
            continue
        lin = _single_case(t2, mu, budget)
        if lin is None:
            return None
        sub_coeffs, sub_k = lin
        k = (k + co * sub_k) % M256
        for tid2, co2 in sub_coeffs.items():
            nc = out.get(tid2, 0) + co * co2
            if nc:
                out[tid2] = nc
            else:
                out.pop(tid2, None)
    return {t_: c_ for t_, c_ in out.items() if c_}, k


def _case_contradicts(mu: Dict[int, bool], small: List["T.Term"],
                      budget: List[int]) -> bool:
    """Does the case's guard assignment falsify some small conjunct?

    Builds one substitution from the case: every guard condition maps
    to its assigned truth constant, and every TRUE `term == const`
    guard additionally binds the term (so `sender_1 == 0` folds an
    ACTORS disjunction `Or(sender_1 == A, sender_1 == B)` to false).
    Substitution rebuilds through the folding constructors, so a
    contradicted conjunct literally becomes FALSE."""
    case_sub = _case_bindings(mu)
    if not case_sub:
        return False
    # guard cross-check: two guards may bind the same term to
    # different constants (sender == ATTACKER and sender == 0 both
    # "True"); folding each condition under the OTHER guards'
    # bindings exposes the contradiction
    bindings = {
        tid: t for tid, t in case_sub.items() if t.op == T.BV_CONST
    }
    memo: Dict[int, "T.Term"] = {}
    if bindings:
        for cond_tid, val in mu.items():
            cond = _term_by_tid(cond_tid)
            if cond is None:
                continue
            budget[0] -= 4
            if budget[0] <= 0:
                raise _Bail
            folded = T.substitute_term(cond, bindings, memo)
            if (folded.op == T.TRUE and val is False) or (
                folded.op == T.FALSE and val is True
            ):
                return True
    memo2: Dict[int, "T.Term"] = {}  # memos are mapping-specific
    for sc in small:
        budget[0] -= 4
        if budget[0] <= 0:
            raise _Bail
        if T.substitute_term(sc, case_sub, memo2).op == T.FALSE:
            return True
    return False


_term_by_tid = T.term_by_tid


def _refute_conjunct(c: "T.Term", raws: List["T.Term"], sub,
                     conjunct_tids, neg_tids, small, fixed_mu,
                     memo) -> bool:
    """True when ULT(s, b) is provably false under the constraint set."""
    s_raw, b_raw = c.args
    budget = [_MAX_VISITS]
    s = T.substitute_term(s_raw, sub, memo)
    b = T.substitute_term(b_raw, sub, memo)
    s_lin = _single_case(s, {}, budget)
    if s_lin is None or s_lin[1] != 0 or len(s_lin[0]) != 1:
        return False
    (s_tid, s_co), = s_lin[0].items()
    if s_co != 1:
        return False

    guards = None
    n_cases = 0
    for mu, coeffs, k in _cases(b, dict(fixed_mu), budget):
        n_cases += 1
        if n_cases > _MAX_CASES:
            return False
        # vacuous case: its guard assignment contradicts a literal
        # conjunct (cond asserted true but taken false, or vice versa),
        # or folds a small conjunct (ACTORS disjunctions) to false
        vacuous = any(
            (cond_tid in conjunct_tids and val is False)
            or (cond_tid in neg_tids and val is True)
            for cond_tid, val in mu.items()
        ) or _case_contradicts(mu, small, budget)
        if vacuous:
            continue
        delta = dict(coeffs)
        delta[s_tid] = delta.get(s_tid, 0) - 1
        delta = {tid: co for tid, co in delta.items() if co}
        case_sub = _case_bindings(mu)
        if k != 0 or any(co > 0 for co in delta.values()):
            # an inflow (or constant) survives: re-express the atoms
            # under the case's own equality bindings — the common
            # refutable shape routes the inflow back onto the
            # attacker/start chain, where it cancels
            rel = _relinearize(delta, k, mu, case_sub, budget) \
                if case_sub else None
            if rel is not None:
                delta, k = rel
            if k != 0:
                return False
        if not delta:
            continue  # b == s exactly: not strictly greater
        if guards is None:
            guards = _collect_ule_guards(raws, sub, memo)
        if not _discharge_case(s_tid, delta, guards, mu, case_sub,
                               budget):
            return False
    return True


def relational_unsat(constraints) -> bool:
    """Sound structural refutation of a constraint conjunction; False
    means "not refuted here" (never "satisfiable")."""
    raws = []
    for c in constraints:
        raw = getattr(c, "raw", c)
        if raw.op == T.FALSE:
            return True
        raws.append(raw)
    # cheap shape gate: a ULT conjunct whose greater side carries
    # transfer structure (ite/sum tree) and smaller side a select/atom
    # — ordinary bounds checks (ULT(offset, base+32)) must not pay the
    # pre-pass below
    candidates = [
        c for c in raws
        if c.op == T.ULT
        and c.args[1].op in (T.ITE, T.ADD, T.SUB)
        and c.args[0].op in (T.SELECT, T.BV_VAR)
    ]
    if not candidates:
        return False
    STATS["attempts"] += 1
    sub, fixed = _harvest(raws)
    memo: Dict[int, "T.Term"] = {}
    sub_conjuncts = [T.substitute_term(r, sub, memo) for r in raws]
    conjunct_tids = {r.tid for r in sub_conjuncts}
    neg_tids = {
        r.args[0].tid for r in sub_conjuncts if r.op == T.NOT
    }
    small = _small_conjuncts(sub_conjuncts)
    # re-key the fixed condition truths through the substitution (a
    # bound condition folds to a constant and needs no entry)
    fixed_mu: Dict[int, bool] = {}
    for tid, val in fixed.items():
        t = _term_by_tid(tid)
        if t is None:
            continue
        t2 = T.substitute_term(t, sub, memo)
        if t2.op not in (T.TRUE, T.FALSE):
            fixed_mu[t2.tid] = val
    for c in candidates:
        try:
            if _refute_conjunct(c, raws, sub, conjunct_tids, neg_tids,
                                small, fixed_mu, memo):
                STATS["refuted"] += 1
                return True
        except _Bail:
            continue
    return False
