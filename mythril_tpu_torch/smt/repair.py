"""Path-guided model repair: quick-sat for near-miss path conditions.

Path-feasibility storms (one query per leaf of a forked subtree — the
reference solves each from scratch through z3, laser/smt/solver/
solver.py:55-78) have a special shape: sibling leaves share almost all
of their conjuncts and differ in a handful of branch literals over
calldata bits, storage slots, or caller words.  A cached model from one
sibling therefore *almost* satisfies the next query.  Instead of paying
a CDCL proof per leaf, this module takes a recently satisfying model,
computes the exact bit cells each failed conjunct forces (pushing the
requirement down through extract/concat/zext/masking/ite structure),
patches those cells, and re-evaluates the whole conjunction under the
patched assignment.

Two ideas make the forcing pass land on real EVM path conditions:

* **base-model arm selection** — an ``ite`` guard (calldata-size
  bounds, ISZERO lowering) that already evaluates the right way under
  the donor model needs no requirement at all; only genuinely flipped
  branches force bits;
* **donor evaluation of hard sides** — a comparison against a term the
  forcer cannot decompose (a balance select, an arithmetic chain) uses
  the donor model's value for that term as the bound and forces only
  the tractable side;
* **modular inversion through arithmetic** — on low-contiguous masks
  (which every full-width overflow literal has) ADD/SUB/MUL-by-odd are
  invertible mod 2^k, so a requirement on a sum/product becomes a
  requirement on one operand with the donor's value for the other; a
  symbolic SELECT index or APPLY argument is pinned to the cell the
  donor resolves it to.  This is what lets repairs land on
  arithmetic-overflow witnesses over keccak-laden balance reads, not
  just branch-bit literals.

Soundness rests entirely on the final evaluation: a repair is returned
only when the complete formula evaluates to True under the patched
model, so a wrong guess costs microseconds and falls back to the CDCL
core.  The forcing pass is a heuristic, never an authority.
"""

from typing import Dict, Optional, Tuple

from . import terms as T
from .model import Model
from .solver.core import ModelData

#: how many recent models to attempt a repair against per query
REPAIR_MODELS = 4
#: abandon queries whose failed-conjunct count exceeds this — a model
#: that far off is not a sibling, and the solver will be cheaper
MAX_FAILED = 48

#: repair effectiveness counters (read by bench detail)
STATS = {"attempts": 0, "repaired": 0,
         "verify_skipped": 0, "verify_evaled": 0,
         "budget_exhausted": 0}

#: conjunct tid -> frozenset of read-cell keys, or None when the term
#: contains structure the extractor does not model (always re-verify).
#: Keys: ("bv", name) | ("bool", name) | ("arr", name, idx) for a
#: constant-index select | ("arr*", name) for any other read of the
#: array | ("func", name).
_CELLS_CACHE: Dict[int, Optional[frozenset]] = {}


def _read_cells(t: "T.Term") -> Optional[frozenset]:
    """Every model cell `t`'s value can depend on. Exact at the leaf
    level: eval_term reads only variable/array/function leaves, so two
    models agreeing on these cells give `t` the same value."""
    cached = _CELLS_CACHE.get(t.tid, False)
    if cached is not False:
        return cached
    cells = set()
    stack = [t]
    seen = set()
    while stack:
        cur = stack.pop()
        if cur.tid in seen:
            continue
        seen.add(cur.tid)
        op = cur.op
        if op == T.BV_VAR:
            cells.add(("bv", cur.name))
        elif op == T.BOOL_VAR:
            cells.add(("bool", cur.name))
        elif op == T.APPLY:
            cells.add(("func", cur.name))
            stack.extend(cur.args)
        elif op == T.SELECT:
            arr, idx = cur.args
            if arr.op == T.ARRAY_VAR and idx.op == T.BV_CONST:
                cells.add(("arr", arr.name, idx.val))
                continue  # both children accounted for
            # symbolic index / store chain: the walk below adds a
            # whole-array marker at each ARRAY_VAR leaf and collects
            # the index's and stored values' own cells
            stack.extend(cur.args)
        elif op == T.ARRAY_VAR:
            cells.add(("arr*", cur.name))
        else:
            stack.extend(cur.args)
    out = frozenset(cells)
    _CELLS_CACHE[t.tid] = out
    return out

_Cell = Tuple  # ("bv", name) | ("arr", name, idx) | ("bool", name)
#              | ("func", name, argvals)


_mask = T._mask
_signed = T._signed


class _Repairer:
    """One repair attempt of one query against one donor model."""

    #: force/lit call budget per attempt: branch-flipping handlers
    #: (ITE arms, BAND/arith avenue retries, OR/AND literal arms)
    #: explore two avenues per node, so deep chains could otherwise go
    #: exponential — repair is an optimization, cap and bail. Priced
    #: generously against LINEAR traversal (a 256-byte concat walk is
    #: ~257 calls; 16 failed conjuncts of that shape stay well inside),
    #: while an exponential blowup still dies in milliseconds;
    #: STATS["budget_exhausted"] records every capped attempt.
    _FORCE_BUDGET = 65536

    def __init__(self, md: ModelData):
        self.md = md
        self.reqs: Dict[_Cell, Tuple[int, int]] = {}
        self._budget = self._FORCE_BUDGET

    # -- donor-model evaluation (best-effort) -----------------------------

    def _ev(self, t: "T.Term"):
        try:
            return self.md.eval_term(t, complete=False)
        except Exception:
            return None

    # -- requirement store ------------------------------------------------

    def _merge(self, key: _Cell, mask: int, val: int) -> bool:
        m0, v0 = self.reqs.get(key, (0, 0))
        if (v0 ^ val) & (m0 & mask):
            return False
        self.reqs[key] = (m0 | mask, v0 | (val & mask))
        return True

    # -- bit forcing ------------------------------------------------------

    def force(self, t: "T.Term", mask: int, val: int) -> bool:
        """Push "bits in `mask` of `t` must equal `val`" down to
        assignable cells.  Only bit-transparent structure is traversed;
        anything else aborts this avenue."""
        mask &= _mask(t.width)
        val &= mask
        if mask == 0:
            return True
        self._budget -= 1
        if self._budget <= 0:
            if self._budget == 0:
                STATS["budget_exhausted"] += 1
            return False
        op = t.op
        if op == T.BV_CONST:
            return (t.val & mask) == val
        if op == T.BV_VAR:
            return self._merge(("bv", t.name), mask, val)
        if op == T.SELECT:
            arr, idx = t.args
            if arr.op == T.ARRAY_VAR:
                # symbolic index (balances[keccak(slot)]): pin the cell
                # the DONOR resolves the index to — if the patch later
                # perturbs the index, the final verification rejects it
                iv = idx.val if idx.op == T.BV_CONST else self._ev(idx)
                if isinstance(iv, int):
                    return self._merge(("arr", arr.name, iv), mask, val)
            return False
        if op == T.APPLY:
            argv = []
            for a in t.args:
                av = a.val if a.op == T.BV_CONST else self._ev(a)
                if not isinstance(av, int):
                    return False
                argv.append(av)
            return self._merge(("func", t.name, tuple(argv)), mask, val)
        if op == T.EXTRACT:
            _hi, lo = t.params
            return self.force(t.args[0], mask << lo, val << lo)
        if op == T.ZEXT:
            inner = t.args[0]
            im = _mask(inner.width)
            if val & ~im:
                return False  # a 1 forced into the zero extension
            return self.force(inner, mask & im, val)
        if op == T.CONCAT:
            pos = 0
            for part in reversed(t.args):  # parts are MSB-first
                pw = _mask(part.width)
                if (mask >> pos) & pw and not self.force(
                    part, (mask >> pos) & pw, (val >> pos) & pw
                ):
                    return False
                pos += part.width
            return True
        if op in (T.BAND, T.BOR, T.BXOR):
            # a known side (constant, or donor-evaluable — verified by
            # the final whole-formula evaluation) fixes the other's bits
            for c, other in (t.args, tuple(reversed(t.args))):
                cv = c.val if c.op == T.BV_CONST else self._ev(c)
                if not isinstance(cv, int):
                    continue
                saved = dict(self.reqs)
                if op == T.BAND:
                    if val & ~cv:
                        ok = False  # need a 1 where the AND forces 0
                    else:
                        ok = self.force(other, mask & cv, val)
                elif op == T.BOR:
                    if ~val & mask & cv:
                        ok = False  # need a 0 where the OR forces 1
                    else:
                        ok = self.force(other, mask & ~cv, val & ~cv)
                else:
                    ok = self.force(other, mask, val ^ (cv & mask))
                if ok:
                    return True
                self.reqs = saved
            return False
        if op in (T.ADD, T.SUB, T.MUL, T.NEG):
            # modular arithmetic is invertible on low-contiguous masks
            # (carries only travel upward) — the shape every overflow
            # check has (full 256-bit equality/bound on a sum/product)
            if mask & (mask + 1):
                return False
            modm = mask  # mask == 2^k - 1
            if op == T.NEG:
                return self.force(t.args[0], mask, -val & modm)
            a, b = t.args
            for x, y, x_is_left in ((a, b, True), (b, a, False)):
                cv = y.val if y.op == T.BV_CONST else self._ev(y)
                if not isinstance(cv, int):
                    continue
                if op == T.ADD:
                    tgt = (val - cv) & modm
                elif op == T.SUB:
                    tgt = (val + cv) & modm if x_is_left else (cv - val) & modm
                else:  # MUL: invertible only by an odd factor
                    if not cv & 1:
                        continue
                    tgt = (val * pow(cv, -1, modm + 1)) & modm
                saved = dict(self.reqs)
                if self.force(x, mask, tgt):
                    return True
                self.reqs = saved
            return False
        if op == T.SEXT:
            inner = t.args[0]
            iw = inner.width
            im = _mask(iw)
            ext_req = mask >> iw  # requested bits in the extension
            m2, v2 = mask & im, val & im
            if ext_req:
                ebits = val >> iw
                if ebits not in (0, ext_req):
                    return False  # extension bits must replicate the sign
                sbit = 1 << (iw - 1)
                if m2 & sbit and bool(v2 & sbit) != bool(ebits):
                    return False
                m2 |= sbit
                v2 = (v2 & ~sbit) | (sbit if ebits else 0)
            return self.force(inner, m2, v2)
        if op == T.UREM:
            # x % c == val: pick the simplest preimage, x = val itself
            d = t.args[1]
            dv = d.val if d.op == T.BV_CONST else self._ev(d)
            if mask == _mask(t.width) and isinstance(dv, int) and 0 <= val < dv:
                return self.force(t.args[0], mask, val)
            return False
        if op == T.BNOT:
            return self.force(t.args[0], mask, ~val & mask)
        if op == T.SHL:
            sh = t.args[1]
            if sh.op == T.BV_CONST:
                if val & _mask(min(sh.val, t.width)):
                    return False  # low bits of a left shift are 0
                return self.force(t.args[0], mask >> sh.val, val >> sh.val)
            return False
        if op == T.LSHR:
            sh = t.args[1]
            if sh.op == T.BV_CONST:
                w = t.width
                if sh.val and val >> max(w - sh.val, 0):
                    return False  # high bits of a right shift are 0
                return self.force(
                    t.args[0],
                    (mask << sh.val) & _mask(w),
                    (val << sh.val) & _mask(w),
                )
            return False
        if op == T.ITE:
            cond, a, b = t.args
            cv = self._ev(cond)
            # prefer the arm the donor already selects: no condition
            # requirement at all (the guard survives the patch unless
            # the final verification says otherwise); the other arm is
            # the fallback, carrying its condition requirement
            if cv is True:
                order = [(a, None), (b, False)]
            elif cv is False:
                order = [(b, None), (a, True)]
            else:
                order = [(a, True), (b, False)]
            for arm, cond_want in order:
                saved = dict(self.reqs)
                if self.force(arm, mask, val) and (
                    cond_want is None or self.lit(cond, cond_want)
                ):
                    return True
                self.reqs = saved
            return False
        return False

    # -- literal requirements ---------------------------------------------

    def lit(self, t: "T.Term", want: bool) -> bool:
        """Derive cell requirements that make boolean term `t` evaluate
        to `want`."""
        self._budget -= 1
        if self._budget <= 0:
            if self._budget == 0:
                STATS["budget_exhausted"] += 1
            return False  # shared with force(): both explore branches
        op = t.op
        if op == T.NOT:
            return self.lit(t.args[0], not want)
        if op == T.TRUE:
            return want
        if op == T.FALSE:
            return not want
        if op == T.BOOL_VAR:
            return self._merge(("bool", t.name), 1, 1 if want else 0)
        if op == T.AND and want:
            return all(self.lit(a, True) for a in t.args)
        if op == T.OR and not want:
            return all(self.lit(a, False) for a in t.args)
        if op in (T.OR, T.AND):
            # one arm must go my way: donor-true arms first
            arms = sorted(
                t.args, key=lambda a: self._ev(a) is not (op == T.OR)
            )
            for arm in arms:
                saved = dict(self.reqs)
                if self.lit(arm, op == T.OR):
                    return True
                self.reqs = saved
            return False
        if op == T.BOOL_ITE:
            cond, a, b = t.args
            cv = self._ev(cond)
            if cv is True:
                order = [(a, None), (b, False)]
            elif cv is False:
                order = [(b, None), (a, True)]
            else:
                order = [(a, True), (b, False)]
            for arm, cond_want in order:
                saved = dict(self.reqs)
                if self.lit(arm, want) and (
                    cond_want is None or self.lit(cond, cond_want)
                ):
                    return True
                self.reqs = saved
            return False
        if op == T.EQ:
            a, b = t.args
            if a.is_bool:
                va, vb = self._ev(a), self._ev(b)
                for x, vx in ((a, vb), (b, va)):
                    if vx is None:
                        continue
                    saved = dict(self.reqs)
                    if self.lit(x, vx if want else not vx):
                        return True
                    self.reqs = saved
                return False
            return self._cmp(op, a, b, want)
        if op in (T.ULT, T.ULE, T.SLT, T.SLE):
            return self._cmp(op, t.args[0], t.args[1], want)
        return False

    def _bound(self, t: "T.Term") -> Optional[int]:
        """A concrete value for one side of a comparison: a constant,
        or the donor model's evaluation of a side the forcer cannot
        decompose (its value must survive the patch — verified)."""
        if t.op == T.BV_CONST:
            return t.val
        v = self._ev(t)
        return v if isinstance(v, int) else None

    def _cmp(self, op: str, a: "T.Term", b: "T.Term", want: bool) -> bool:
        if not want:  # !(a < b) == b <= a ; !(a <= b) == b < a
            a, b = b, a
            op = {T.ULT: T.ULE, T.ULE: T.ULT,
                  T.SLT: T.SLE, T.SLE: T.SLT, T.EQ: T.EQ}[op]
            if op == T.EQ:
                # disequality: flip the lowest bit of a known side
                for expr, other in ((a, b), (b, a)):
                    bound = self._bound(other)
                    if bound is None:
                        continue
                    saved = dict(self.reqs)
                    full = _mask(expr.width)
                    if self.force(expr, full, (bound ^ 1) & full):
                        return True
                    self.reqs = saved
                return False
        if op == T.EQ:
            for expr, other in ((a, b), (b, a)):
                bound = self._bound(other)
                if bound is None:
                    continue
                saved = dict(self.reqs)
                if self.force(expr, _mask(expr.width), bound):
                    return True
                self.reqs = saved
            return False
        strict = op in (T.ULT, T.SLT)
        is_signed = op in (T.SLT, T.SLE)
        w = a.width
        full = _mask(w)
        # force the left side below a known right bound
        hi = self._bound(b)
        if hi is not None:
            lo_lim = -(1 << (w - 1)) if is_signed else 0
            tgt = (_signed(hi, w) if is_signed else hi) - (1 if strict else 0)
            if tgt >= lo_lim:
                saved = dict(self.reqs)
                if self.force(a, full, tgt & full):
                    return True
                self.reqs = saved
        # or force the right side above a known left bound
        lo = self._bound(a)
        if lo is not None:
            hi_lim = (1 << (w - 1)) - 1 if is_signed else full
            tgt = (_signed(lo, w) if is_signed else lo) + (1 if strict else 0)
            if tgt <= hi_lim:
                saved = dict(self.reqs)
                if self.force(b, full, tgt & full):
                    return True
                self.reqs = saved
        return False


def try_repair(constraint_term: "T.Term", model) -> Optional[Model]:
    """Patch `model` (a facade Model) into one satisfying
    `constraint_term`, or return None.  Never raises."""
    mds = getattr(model, "raw", None)
    if not mds or len(mds) != 1:
        return None  # bucketed independence models: skip
    md = mds[0]
    conjuncts = (
        constraint_term.args
        if constraint_term.op == T.AND
        else (constraint_term,)
    )
    STATS["attempts"] += 1
    rep = _Repairer(md)
    failed = 0
    scan: list = []
    for c in conjuncts:
        try:
            r = md.eval_term(c, complete=False)
        except KeyError:
            r = None  # unbound symbol: the repair may bind it
        except Exception:
            return None
        scan.append(r)
        if r is True:
            continue
        failed += 1
        if failed > MAX_FAILED:
            return None
        try:
            if not rep.lit(c, True):
                return None
        except Exception:
            # the forcer recurses on term depth; a store-chain lowered
            # to thousands of nested ITEs must fall back to CDCL, not
            # crash the solve path
            return None
    if not failed:
        return None  # the plain scan would have taken this hit

    nd = ModelData()
    nd.bv = dict(md.bv)
    nd.bools = dict(md.bools)
    nd.arrays = {k: (d, dict(e)) for k, (d, e) in md.arrays.items()}
    nd.funcs = {k: dict(v) for k, v in md.funcs.items()}
    for key, (mask, val) in rep.reqs.items():
        kind = key[0]
        if kind == "bv":
            cur = nd.bv.get(key[1], 0)
            nd.bv[key[1]] = (cur & ~mask) | val
        elif kind == "bool":
            nd.bools[key[1]] = bool(val)
        elif kind == "func":
            _, name, argv = key
            table = nd.funcs.setdefault(name, {})
            cur = table.get(argv, 0)
            table[argv] = (cur & ~mask) | val
        else:
            _, name, idx = key
            default, entries = nd.arrays.setdefault(name, (0, {}))
            cur = entries.get(idx, default)
            entries[idx] = (cur & ~mask) | val

    # the authority: the patched assignment must satisfy the WHOLE
    # formula under evaluation (complete=True matches what the CDCL
    # core returns — don't-care symbols default like an omitted decl).
    # CELL-SCOPED: a conjunct that evaluated True under the donor and
    # whose read-cell set is disjoint from the patched cells has the
    # SAME value under the patch (evaluation depends only on leaf
    # cells) — only intersecting or previously-unresolved conjuncts
    # re-evaluate. On sibling terminal storms this turns the full-DAG
    # verification walk into a handful of literal evaluations.
    patch_keys = set()
    for key in rep.reqs:
        kind = key[0]
        if kind == "arr":
            patch_keys.add(key)
            patch_keys.add(("arr*", key[1]))
        elif kind == "func":
            patch_keys.add(("func", key[1]))
        else:
            patch_keys.add((kind, key[1]))
    try:
        for c, r in zip(conjuncts, scan):
            if r is True:
                cells = _read_cells(c)
                if cells is not None and cells.isdisjoint(patch_keys):
                    STATS["verify_skipped"] += 1
                    continue
            STATS["verify_evaled"] += 1
            if nd.eval_term(c, complete=True) is not True:
                return None
    except Exception:
        return None
    STATS["repaired"] += 1
    return Model([nd])
