"""Unsigned-interval abstract propagation over the term DAG.

This is the host prototype of the TPU lane pre-filter promised by the build
plan (SURVEY.md §2.10 solver-level row): before any SAT call, every assertion
is abstractly evaluated; a must-false assertion proves the path infeasible
without touching the CDCL core. The same transfer functions are mirrored as
vectorized jax kernels in mythril_tpu/ops/intervals.py for on-device lane
pruning.

Domain: [lo, hi] over unsigned width-w integers (no wrap tracking — any
overflow widens to top). Bools are 3-valued via (may_be_false, may_be_true).
"""

from typing import Dict, Tuple

from . import terms as T

BoolAbs = Tuple[bool, bool]  # (may_be_false, may_be_true)


def _top(w: int) -> Tuple[int, int]:
    return (0, (1 << w) - 1)


def interval(t: "T.Term", memo: Dict[int, object] = None):
    """Abstract value: (lo, hi) for BV terms, (may_false, may_true) for
    Bool terms. Arrays/UF applications go to top. Iterative post-order
    driver (deep chains exceed the recursion limit)."""
    if memo is None:
        memo = {}
    stack = [t]
    while stack:
        cur = stack[-1]
        if cur.tid in memo:
            stack.pop()
            continue
        pending = [a for a in cur.args if a.tid not in memo]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        memo[cur.tid] = _interval_node(cur, memo)
    return memo[t.tid]


def _interval_node(t: "T.Term", memo):
    op = t.op
    w = t.width if isinstance(t.width, int) else 0
    full = _top(w) if w else None
    if op == T.BV_CONST:
        v = (t.val, t.val)
    elif op == T.TRUE:
        v = (False, True)
    elif op == T.FALSE:
        v = (True, False)
    elif op in (T.BV_VAR, T.SELECT, T.APPLY):
        v = full
    elif op == T.BOOL_VAR:
        v = (True, True)
    elif op == T.ADD:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if ahi + bhi < (1 << w):
            v = (alo + blo, ahi + bhi)
        else:
            v = full
    elif op == T.SUB:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if alo >= bhi:
            v = (alo - bhi, ahi - blo)
        else:
            v = full
    elif op == T.MUL:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if ahi * bhi < (1 << w):
            v = (alo * blo, ahi * bhi)
        else:
            v = full
    elif op == T.UDIV:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if blo >= 1:
            v = (alo // bhi, ahi // blo)
        else:
            v = full  # divisor may be 0 -> result may be all-ones
    elif op == T.UREM:
        (alo, ahi) = interval(t.args[1], memo)
        if ahi >= 1:
            v = (0, ahi - 1) if alo >= 1 else (0, (1 << w) - 1)
        else:
            v = interval(t.args[0], memo)  # x % 0 = x
    elif op == T.BAND:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        v = (0, min(ahi, bhi))
    elif op == T.BOR:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        hi = (1 << max(ahi.bit_length(), bhi.bit_length())) - 1
        v = (max(alo, blo), min(hi, (1 << w) - 1))
    elif op == T.BXOR:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        hi = (1 << max(ahi.bit_length(), bhi.bit_length())) - 1
        v = (0, min(hi, (1 << w) - 1))
    elif op == T.BNOT:
        (alo, ahi) = interval(t.args[0], memo)
        m = (1 << w) - 1
        v = (m - ahi, m - alo)
    elif op == T.NEG:
        (alo, ahi) = interval(t.args[0], memo)
        if alo == ahi:
            nv = (-alo) & ((1 << w) - 1)
            v = (nv, nv)
        elif alo >= 1:
            v = ((1 << w) - ahi, (1 << w) - alo)
        else:
            v = full
    elif op == T.SHL:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if blo == bhi and bhi < w and (ahi << bhi) < (1 << w):
            v = (alo << blo, ahi << bhi)
        else:
            v = full
    elif op == T.LSHR:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        v = (alo >> min(bhi, w), ahi >> min(blo, w))
    elif op == T.ASHR:
        v = full
    elif op == T.CONCAT:
        lo = hi = 0
        for part in t.args:
            (plo, phi) = interval(part, memo)
            lo = (lo << part.width) | plo
            hi = (hi << part.width) | phi
        v = (lo, hi)
    elif op == T.EXTRACT:
        hi_b, lo_b = t.params
        (alo, ahi) = interval(t.args[0], memo)
        if ahi >> (hi_b + 1) == alo >> (hi_b + 1):
            # high bits fixed; slice the shifted interval if it fits
            slo, shi = alo >> lo_b, ahi >> lo_b
            m = (1 << (hi_b - lo_b + 1)) - 1
            if shi - slo <= m and (slo & m) <= (shi & m):
                v = (slo & m, shi & m)
            else:
                v = _top(hi_b - lo_b + 1)
        else:
            v = _top(hi_b - lo_b + 1)
    elif op == T.ZEXT:
        v = interval(t.args[0], memo)
    elif op == T.SEXT:
        (alo, ahi) = interval(t.args[0], memo)
        iw = t.args[0].width
        if ahi < (1 << (iw - 1)):  # provably non-negative
            v = (alo, ahi)
        else:
            v = full
    elif op in (T.ITE,):
        (mf, mt) = interval(t.args[0], memo)
        (alo, ahi) = interval(t.args[1], memo)
        (blo, bhi) = interval(t.args[2], memo)
        if not mf:
            v = (alo, ahi)
        elif not mt:
            v = (blo, bhi)
        else:
            v = (min(alo, blo), max(ahi, bhi))
    elif op in (T.SDIV, T.SREM):
        v = full
    elif op == T.EQ:
        a, b = t.args
        if a.is_array or b.is_array or a.is_bool or b.is_bool:
            # array/bool equalities carry no numeric interval information
            v = (True, True)
        else:
            (alo, ahi) = interval(a, memo)
            (blo, bhi) = interval(b, memo)
            if ahi < blo or bhi < alo:
                v = (True, False)  # must be false
            elif alo == ahi == blo == bhi:
                v = (False, True)  # must be true
            else:
                v = (True, True)
    elif op == T.ULT:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if ahi < blo:
            v = (False, True)
        elif alo >= bhi:
            v = (True, False)
        else:
            v = (True, True)
    elif op == T.ULE:
        (alo, ahi) = interval(t.args[0], memo)
        (blo, bhi) = interval(t.args[1], memo)
        if ahi <= blo:
            v = (False, True)
        elif alo > bhi:
            v = (True, False)
        else:
            v = (True, True)
    elif op in (T.SLT, T.SLE):
        v = (True, True)
    elif op == T.AND:
        mf, mt = False, True
        for a in t.args:
            (f, tt) = interval(a, memo)
            if not tt:
                mf, mt = True, False
                break
            mf = mf or f
        v = (mf, mt)
    elif op == T.OR:
        mf, mt = True, False
        for a in t.args:
            (f, tt) = interval(a, memo)
            if not f:
                mf, mt = False, True
                break
            mt = mt or tt
        v = (mf, mt)
    elif op == T.NOT:
        (f, tt) = interval(t.args[0], memo)
        v = (tt, f)
    elif op == T.XOR:
        (af, at) = interval(t.args[0], memo)
        (bf, bt) = interval(t.args[1], memo)
        v = (at and bt or af and bf, at and bf or af and bt)
    elif op == T.BOOL_ITE:
        (cf, ct) = interval(t.args[0], memo)
        (af, at) = interval(t.args[1], memo)
        (bf, bt) = interval(t.args[2], memo)
        mf = (ct and af) or (cf and bf)
        mt = (ct and at) or (cf and bt)
        v = (mf, mt)
    else:
        v = full if w else (True, True)
    return v


def must_be_false(t: "T.Term", memo=None) -> bool:
    mf, mt = interval(t, memo)
    return not mt


def must_be_true(t: "T.Term", memo=None) -> bool:
    mf, mt = interval(t, memo)
    return not mf


# ---------------------------------------------------------------------------
# cross-assertion screening: variable-bound seeding
# ---------------------------------------------------------------------------
#
# Screening each assertion in isolation misses the dominant infeasibility
# shape in LASER paths: contradictory branch conditions over the same
# symbol (x > 10 on one JUMPI, x < 5 on a later one). Before evaluating, we
# scan the whole constraint system for syntactic `var <cmp> const` facts
# (through conjunctions and negations), intersect them into per-variable
# bounds, and seed the memo with the narrowed intervals so the forward
# pass sees them. Mirrored on device by mythril_tpu/ops/intervals.py.


#: per-assertion bound contributions, memoized by tid: a constraint
#: term's syntactic var-vs-const facts are state-independent, and wave
#: screening evaluates the SAME shared constraint objects across
#: thousands of sibling systems — extracting each term's facts once
#: turns the per-system seed pass into a cheap interval merge.
_CONTRIB_CACHE: Dict[int, tuple] = {}


def _term_contributions(t: "T.Term") -> tuple:
    cached = _CONTRIB_CACHE.get(t.tid)
    if cached is None:
        facts: list = []

        def note(var, lo, hi):
            facts.append((var, lo, hi))

        _visit_bounds(t, note, True)
        cached = tuple(facts)
        if len(_CONTRIB_CACHE) > 1 << 20:
            _CONTRIB_CACHE.clear()
        _CONTRIB_CACHE[t.tid] = cached
    return cached


def extract_bounds(assertions) -> Dict[int, Tuple["T.Term", int, int]]:
    """{var_tid: (var_term, lo, hi)} from syntactic var-vs-const facts.

    An empty range (lo > hi) marks the whole system infeasible."""
    bounds: Dict[int, Tuple["T.Term", int, int]] = {}
    for t in assertions:
        for var, lo, hi in _term_contributions(getattr(t, "raw", t)):
            old = bounds.get(var.tid)
            if old is None:
                w = var.width if isinstance(var.width, int) else 256
                olo, ohi = 0, (1 << w) - 1
            else:
                _, olo, ohi = old
            bounds[var.tid] = (var, max(lo, olo), min(hi, ohi))
    return bounds


def _visit_bounds(root, note, positive=True):
    """Walk one assertion for syntactic atom-vs-const facts, calling
    note(atom, lo, hi) for each."""

    def visit(t, positive=True):
        op = t.op
        if op == T.NOT:
            visit(t.args[0], not positive)
            return
        if op == T.AND and positive:
            for a in t.args:
                visit(a, True)
            return
        if op == T.OR and not positive:
            # not(a or b) == not a and not b
            for a in t.args:
                visit(a, False)
            return
        if op not in (T.ULT, T.ULE, T.EQ):
            return
        a, b = t.args
        # SELECT/APPLY atoms bound like variables (the evaluator already
        # treats them as opaque memo-keyed atoms): this is what lets the
        # keccak manager's interval axioms — ULE(lo, keccak(x)),
        # ULT(keccak(x), hi), keccak(x) & 63 == 0 — refute detector
        # probes such as `keccak(x) == small-constant` without a solver
        _atom = (T.BV_VAR, T.SELECT, T.APPLY)
        av, bv = a.op in _atom, b.op in _atom
        ac, bc = a.op == T.BV_CONST, b.op == T.BV_CONST
        w = a.width if isinstance(a.width, int) else 0
        if not w:
            return
        m = (1 << w) - 1
        if op == T.EQ and positive:
            if av and bc:
                note(a, b.val, b.val)
            elif bv and ac:
                note(b, a.val, a.val)
            else:
                # var (+/-) const == const is exact under wrap-around:
                # x + c == k  <=>  x == (k - c) mod 2^w
                for lhs, rhs in ((a, b), (b, a)):
                    if rhs.op != T.BV_CONST or lhs.op not in (T.ADD, T.SUB):
                        continue
                    p, q = lhs.args
                    if lhs.op == T.ADD and p.op == T.BV_VAR and q.op == T.BV_CONST:
                        note(p, (rhs.val - q.val) & m, (rhs.val - q.val) & m)
                    elif lhs.op == T.ADD and q.op == T.BV_VAR and p.op == T.BV_CONST:
                        note(q, (rhs.val - p.val) & m, (rhs.val - p.val) & m)
                    elif lhs.op == T.SUB and p.op == T.BV_VAR and q.op == T.BV_CONST:
                        note(p, (rhs.val + q.val) & m, (rhs.val + q.val) & m)
        elif op == T.ULT:
            if positive:
                if av and bc:  # a < c
                    note(a, 0, b.val - 1)
                elif ac and bv:  # c < b
                    note(b, a.val + 1, m)
            else:  # not(a < b) == a >= b
                if av and bc:
                    note(a, b.val, m)
                elif ac and bv:
                    note(b, 0, a.val)
        elif op == T.ULE:
            if positive:
                if av and bc:
                    note(a, 0, b.val)
                elif ac and bv:
                    note(b, a.val, m)
            else:  # not(a <= b) == a > b
                if av and bc:
                    note(a, b.val + 1, m)
                elif ac and bv:
                    note(b, 0, a.val - 1)

    visit(root, positive)


def state_infeasible(assertions) -> bool:
    """True iff the constraint system is provably unsat in the interval
    domain with variable-bound seeding. Sound: never prunes a sat system."""
    raw = [getattr(t, "raw", t) for t in assertions]
    bounds = extract_bounds(raw)
    memo: Dict[int, object] = {}
    for var, lo, hi in bounds.values():
        if lo > hi:
            return True  # contradictory bounds on one variable
        memo[var.tid] = (lo, hi)
    return any(must_be_false(t, memo) for t in raw)
