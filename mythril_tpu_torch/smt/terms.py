"""Hash-consed expression DAG: the word-level term core of the SMT stack.

Design (TPU-first, not a translation): where the reference wraps z3 C++ AST
objects (reference mythril/laser/smt/expression.py:10, bitvec.py:25), this
build owns the whole term representation. Terms are immutable, interned
(structural hash-consing) nodes; every constructor constant-folds and applies
local rewrite rules, so concrete execution through the facade never builds
garbage symbolic nodes. The DAG is the single source of truth for:

- the bit-blaster (mythril_tpu_torch/smt/bitblast.py) lowering to the native CDCL
  core,
- the interval/known-bits propagator (mythril_tpu_torch/smt/interval.py) used as
  the fast `is_possible` pre-filter (device-mirrored later),
- concrete evaluation under a model (eval_term), replacing z3's model.eval.

Sorts: BV(width) with arbitrary width (EVM uses 256, keccak concat uses 512),
BOOL, ARRAY(dom_width, rng_width), and uninterpreted functions.
"""

from typing import Dict, Iterable, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Op tags. BV-valued:
ADD, SUB, MUL, UDIV, UREM, SDIV, SREM = (
    "add", "sub", "mul", "udiv", "urem", "sdiv", "srem",
)
BAND, BOR, BXOR, BNOT, NEG = "band", "bor", "bxor", "bnot", "neg"
SHL, LSHR, ASHR = "shl", "lshr", "ashr"
CONCAT, EXTRACT, ZEXT, SEXT = "concat", "extract", "zext", "sext"
ITE = "ite"  # ite over BV (cond is Bool)
SELECT, APPLY = "select", "apply"
BV_CONST, BV_VAR = "bv_const", "bv_var"
# Bool-valued:
TRUE, FALSE, BOOL_VAR = "true", "false", "bool_var"
EQ, ULT, ULE, SLT, SLE = "eq", "ult", "ule", "slt", "sle"
AND, OR, NOT, XOR = "and", "or", "not", "xor"
BOOL_ITE = "bool_ite"
# Array-valued:
ARRAY_VAR, CONST_ARRAY, STORE = "array_var", "const_array", "store"

_BOOL_OPS = frozenset(
    (TRUE, FALSE, BOOL_VAR, EQ, ULT, ULE, SLT, SLE, AND, OR, NOT, XOR,
     BOOL_ITE)
)
_ARRAY_OPS = frozenset((ARRAY_VAR, CONST_ARRAY, STORE))

_COMMUTATIVE = frozenset((ADD, MUL, BAND, BOR, BXOR, EQ, AND, OR, XOR))


class Term:
    """One interned DAG node. Never construct directly — use mk()/helpers."""

    __slots__ = ("op", "args", "params", "width", "val", "name", "tid")

    def __init__(self, op, args, params, width, val, name, tid):
        self.op = op
        self.args = args      # tuple of Term
        self.params = params  # tuple of ints/strs (extract bounds, sorts, ...)
        self.width = width    # BV width; 0 for Bool; (dom, rng) for arrays
        self.val = val        # int for BV_CONST; True/False for TRUE/FALSE
        self.name = name      # for *_VAR / APPLY function name
        self.tid = tid

    def __hash__(self):
        return self.tid

    def __repr__(self):
        if self.op == BV_CONST:
            return f"0x{self.val:x}[{self.width}]"
        if self.op in (BV_VAR, BOOL_VAR, ARRAY_VAR):
            return self.name
        if self.op in (TRUE, FALSE):
            return self.op
        inner = ", ".join(map(repr, self.args))
        p = ",".join(map(str, self.params)) if self.params else ""
        return f"{self.op}{'<'+p+'>' if p else ''}({inner})"

    @property
    def is_bool(self):
        return self.op in _BOOL_OPS

    @property
    def is_array(self):
        return self.op in _ARRAY_OPS


_table: Dict[tuple, Term] = {}
_next_tid = [1]

#: miss-path interning lock (None = single-threaded fast path). The
#: solver pool (smt/solver/pool.py) flips it on before its workers
#: start: two threads racing the miss path would otherwise intern two
#: Terms with distinct tids for one structural key, breaking the
#: tid-set fingerprints every cache layer keys on. The hit path stays
#: lock-free — an interned entry is immutable and dict reads are
#: atomic under the GIL — so single-threaded construction cost is
#: unchanged.
_INTERN_LOCK = None


def set_thread_safe_interning(enabled: bool = True) -> None:
    """Serialize the interning MISS path across threads (idempotent;
    there is no reason to ever turn it back off mid-process)."""
    global _INTERN_LOCK
    if enabled and _INTERN_LOCK is None:
        import threading

        _INTERN_LOCK = threading.Lock()
    elif not enabled:
        _INTERN_LOCK = None


def _intern(op, args=(), params=(), width=0, val=None, name=None) -> Term:
    key = (op, tuple(a.tid for a in args), params, width, val, name)
    t = _table.get(key)
    if t is not None:
        return t
    lock = _INTERN_LOCK
    if lock is None:
        t = Term(op, tuple(args), params, width, val, name, _next_tid[0])
        _next_tid[0] += 1
        _table[key] = t
        return t
    with lock:
        t = _table.get(key)  # re-check: the race this lock exists for
        if t is None:
            t = Term(op, tuple(args), params, width, val, name,
                     _next_tid[0])
            _next_tid[0] += 1
            _table[key] = t
        return t


def dag_size() -> int:
    return len(_table)


# -- leaves ------------------------------------------------------------------

_TRUE = _intern(TRUE, val=True)
_FALSE = _intern(FALSE, val=False)


def true_t() -> Term:
    return _TRUE


def false_t() -> Term:
    return _FALSE


def bool_t(v: bool) -> Term:
    return _TRUE if v else _FALSE


def bv_const(value: int, width: int) -> Term:
    return _intern(BV_CONST, width=width, val=value & ((1 << width) - 1))


def bv_var(name: str, width: int) -> Term:
    return _intern(BV_VAR, width=width, name=name)


def bool_var(name: str) -> Term:
    return _intern(BOOL_VAR, name=name)


def array_var(name: str, dom: int, rng: int) -> Term:
    return _intern(ARRAY_VAR, width=(dom, rng), name=name)


def const_array(dom: int, rng: int, default: Term) -> Term:
    return _intern(CONST_ARRAY, args=(default,), width=(dom, rng))


def func_decl(name: str, domain: Tuple[int, ...], rng: int):
    """Uninterpreted function handle; application via apply_func."""
    return (name, tuple(domain), rng)


def is_const(t: Term) -> bool:
    return t.op == BV_CONST


def _mask(w: int) -> int:
    return (1 << w) - 1


def _signed(v: int, w: int) -> int:
    return v - (1 << w) if v >> (w - 1) else v


# -- BV constructors with folding -------------------------------------------

def _sort2(a: Term, b: Term):
    """Canonical operand order for commutative ops (callers are all
    commutative constructors)."""
    if a.tid > b.tid:
        return b, a
    return a, b


def mk_add(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bv_const(a.val + b.val, a.width)
    if is_const(a) and a.val == 0:
        return b
    if is_const(b) and b.val == 0:
        return a
    # associative re-fold: (x + c1) + c2 -> x + (c1+c2); (x - c1) + c2 etc.
    for x, y in ((a, b), (b, a)):
        if not is_const(y):
            continue
        if x.op == ADD:
            for i in (0, 1):
                if is_const(x.args[i]):
                    return mk_add(
                        x.args[1 - i],
                        bv_const(x.args[i].val + y.val, a.width),
                    )
        elif x.op == SUB:
            if is_const(x.args[1]):
                return mk_sub(
                    x.args[0], bv_const(x.args[1].val - y.val, a.width)
                )
            if is_const(x.args[0]):
                return mk_sub(
                    bv_const(x.args[0].val + y.val, a.width), x.args[1]
                )
    a, b = _sort2(a, b)
    return _intern(ADD, (a, b), width=a.width)


def mk_sub(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bv_const(a.val - b.val, a.width)
    if is_const(b) and b.val == 0:
        return a
    if a is b:
        return bv_const(0, a.width)
    return _intern(SUB, (a, b), width=a.width)


def mk_mul(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bv_const(a.val * b.val, a.width)
    for x, y in ((a, b), (b, a)):
        if is_const(x):
            if x.val == 0:
                return bv_const(0, a.width)
            if x.val == 1:
                return y
    a, b = _sort2(a, b)
    return _intern(MUL, (a, b), width=a.width)


def _is_shl_of_one(t: Term) -> bool:
    """Matches shl(1, x) — the shape EXP(2^m, e) lowers to. Divisions by
    such terms rewrite to shifts/masks, keeping the Solidity
    storage-packing idiom (value / 256**k % 2**n) out of the O(w^2)
    divider circuit."""
    return t.op == SHL and is_const(t.args[0]) and t.args[0].val == 1


def mk_udiv(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(b):
        if b.val == 0:
            return bv_const(_mask(a.width), a.width)  # SMT-LIB bvudiv x/0
        if is_const(a):
            return bv_const(a.val // b.val, a.width)
        if b.val == 1:
            return a
        if b.val & (b.val - 1) == 0:  # 2^k: shift instead of divide
            return mk_lshr(
                a, bv_const(b.val.bit_length() - 1, a.width))
    if _is_shl_of_one(b):
        # a / (1 << x) == a >> x, except the SMT-LIB division-by-zero
        # case (x >= width makes the divisor 0 -> all-ones)
        return mk_ite(
            mk_eq(b, bv_const(0, b.width)),
            bv_const(_mask(a.width), a.width),
            mk_lshr(a, b.args[1]),
        )
    if b.op == ITE and all(
        is_const(arm) or _is_shl_of_one(arm) for arm in b.args[1:]
    ):
        # lift the divide through a cheap-armed ITE so each side takes
        # the shift/constant rewrite above
        return mk_ite(
            b.args[0], mk_udiv(a, b.args[1]), mk_udiv(a, b.args[2])
        )
    return _intern(UDIV, (a, b), width=a.width)


def mk_urem(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(b):
        if b.val == 0:
            return a  # SMT-LIB bvurem x%0 = x
        if is_const(a):
            return bv_const(a.val % b.val, a.width)
        if b.val == 1:
            return bv_const(0, a.width)
        if b.val & (b.val - 1) == 0:  # 2^k: mask instead of modulo
            return mk_and(a, bv_const(b.val - 1, a.width))
    if _is_shl_of_one(b):
        # a % (1 << x) == a & ((1 << x) - 1); when the shift overflows
        # to 0 the mask becomes all-ones and a & ones == a, which is
        # exactly the SMT-LIB x % 0 = x case
        return mk_and(a, mk_sub(b, bv_const(1, b.width)))
    if b.op == ITE and all(
        is_const(arm) or _is_shl_of_one(arm) for arm in b.args[1:]
    ):
        return mk_ite(
            b.args[0], mk_urem(a, b.args[1]), mk_urem(a, b.args[2])
        )
    return _intern(UREM, (a, b), width=a.width)


def mk_sdiv(a: Term, b: Term) -> Term:
    assert a.width == b.width
    w = a.width
    if is_const(a) and is_const(b):
        sa, sb = _signed(a.val, w), _signed(b.val, w)
        if sb == 0:
            return bv_const(1 if sa < 0 else _mask(w), w)
        q = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            q = -q
        return bv_const(q, w)
    return _intern(SDIV, (a, b), width=w)


def mk_srem(a: Term, b: Term) -> Term:
    assert a.width == b.width
    w = a.width
    if is_const(a) and is_const(b):
        sa, sb = _signed(a.val, w), _signed(b.val, w)
        if sb == 0:
            return a
        r = abs(sa) % abs(sb)
        if sa < 0:
            r = -r
        return bv_const(r, w)
    return _intern(SREM, (a, b), width=w)


def mk_and(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bv_const(a.val & b.val, a.width)
    for x, y in ((a, b), (b, a)):
        if is_const(x):
            if x.val == 0:
                return bv_const(0, a.width)
            if x.val == _mask(a.width):
                return y
            # fold nested constant masks: band(c1, band(c2, t)) ==
            # band(c1 & c2, t). The EVM's address-masking idiom stacks
            # masks (every AND with 2^160-1 re-masks the same select),
            # and without this fold two semantically identical
            # conditions intern to DIFFERT tids — defeating every
            # tid-equality screen downstream (dedup, repair cells, the
            # relational refuter's case consistency)
            if y.op == BAND:
                for u, v in ((y.args[0], y.args[1]),
                             (y.args[1], y.args[0])):
                    if is_const(u):
                        return mk_and(bv_const(x.val & u.val, a.width),
                                      v)
    if a is b:
        return a
    a, b = _sort2(a, b)
    return _intern(BAND, (a, b), width=a.width)


def mk_or(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bv_const(a.val | b.val, a.width)
    for x, y in ((a, b), (b, a)):
        if is_const(x):
            if x.val == 0:
                return y
            if x.val == _mask(a.width):
                return x
    if a is b:
        return a
    a, b = _sort2(a, b)
    return _intern(BOR, (a, b), width=a.width)


def mk_xor(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bv_const(a.val ^ b.val, a.width)
    if a is b:
        return bv_const(0, a.width)
    for x, y in ((a, b), (b, a)):
        if is_const(x) and x.val == 0:
            return y
    a, b = _sort2(a, b)
    return _intern(BXOR, (a, b), width=a.width)


def mk_bnot(a: Term) -> Term:
    if is_const(a):
        return bv_const(~a.val, a.width)
    if a.op == BNOT:
        return a.args[0]
    return _intern(BNOT, (a,), width=a.width)


def mk_neg(a: Term) -> Term:
    if is_const(a):
        return bv_const(-a.val, a.width)
    return _intern(NEG, (a,), width=a.width)


def mk_shl(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(b):
        if b.val == 0:
            return a
        if b.val >= a.width:
            return bv_const(0, a.width)
        if is_const(a):
            return bv_const(a.val << b.val, a.width)
    return _intern(SHL, (a, b), width=a.width)


def mk_lshr(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(b):
        if b.val == 0:
            return a
        if b.val >= a.width:
            return bv_const(0, a.width)
        if is_const(a):
            return bv_const(a.val >> b.val, a.width)
    return _intern(LSHR, (a, b), width=a.width)


def mk_ashr(a: Term, b: Term) -> Term:
    assert a.width == b.width
    w = a.width
    if is_const(b):
        if b.val == 0:
            return a
        if is_const(a):
            sh = min(b.val, w - 1) if b.val >= w else b.val
            return bv_const(_signed(a.val, w) >> min(sh, w - 1), w)
    return _intern(ASHR, (a, b), width=w)


def mk_concat(*parts: Term) -> Term:
    """Concat MSB-first (z3 convention): concat(a, b) = a:b with a on top."""
    flat = []
    for p in parts:
        if p.op == CONCAT:
            flat.extend(p.args)
        else:
            flat.append(p)
    # merge adjacent constants and adjacent extracts of one base term
    # (concat(extract(h,m+1,x), extract(m,l,x)) == extract(h,l,x) — the
    # shape byte-granular memory reads of a stored word produce)
    merged = []
    for p in flat:
        if merged and is_const(merged[-1]) and is_const(p):
            prev = merged.pop()
            merged.append(
                bv_const((prev.val << p.width) | p.val, prev.width + p.width)
            )
        elif (
            merged
            and merged[-1].op == EXTRACT
            and p.op == EXTRACT
            and merged[-1].args[0] is p.args[0]
            and merged[-1].params[1] == p.params[0] + 1
        ):
            prev = merged.pop()
            merged.append(
                mk_extract(prev.params[0], p.params[1], p.args[0])
            )
        else:
            merged.append(p)
    if len(merged) == 1:
        return merged[0]
    width = sum(p.width for p in merged)
    return _intern(CONCAT, tuple(merged), width=width)


def mk_extract(hi: int, lo: int, a: Term) -> Term:
    """Bits hi..lo inclusive (z3 convention), LSB = bit 0."""
    assert 0 <= lo <= hi < a.width
    w = hi - lo + 1
    if w == a.width:
        return a
    if is_const(a):
        return bv_const(a.val >> lo, w)
    if a.op == EXTRACT:
        ihi, ilo = a.params
        return mk_extract(ilo + hi, ilo + lo, a.args[0])
    if a.op == CONCAT:
        # project onto the concat parts if the slice lands inside few parts
        parts = []
        off = 0
        for p in reversed(a.args):  # LSB-side part first
            p_lo, p_hi = off, off + p.width - 1
            if p_hi >= lo and p_lo <= hi:
                s_lo = max(lo, p_lo) - p_lo
                s_hi = min(hi, p_hi) - p_lo
                parts.append(mk_extract(s_hi, s_lo, p))
            off += p.width
        if len(parts) == 1:
            return parts[0]
        return mk_concat(*reversed(parts))
    if a.op == ZEXT:
        inner = a.args[0]
        if hi < inner.width:
            return mk_extract(hi, lo, inner)
        if lo >= inner.width:
            return bv_const(0, w)
    return _intern(EXTRACT, (a,), params=(hi, lo), width=w)


def mk_zext(n: int, a: Term) -> Term:
    if n == 0:
        return a
    if is_const(a):
        return bv_const(a.val, a.width + n)
    return _intern(ZEXT, (a,), params=(n,), width=a.width + n)


def mk_sext(n: int, a: Term) -> Term:
    if n == 0:
        return a
    if is_const(a):
        return bv_const(_signed(a.val, a.width), a.width + n)
    return _intern(SEXT, (a,), params=(n,), width=a.width + n)


def mk_ite(c: Term, a: Term, b: Term) -> Term:
    assert c.is_bool and a.width == b.width
    if c.op == TRUE:
        return a
    if c.op == FALSE:
        return b
    if a is b:
        return a
    return _intern(ITE, (c, a, b), width=a.width)


def mk_select(arr: Term, idx: Term) -> Term:
    # read-over-write reduction at construction
    if arr.op == STORE:
        base, widx, wval = arr.args
        if is_const(idx) and is_const(widx):
            if idx.val == widx.val:
                return wval
            return mk_select(base, idx)
        return mk_ite(mk_eq(idx, widx), wval, mk_select(base, idx))
    if arr.op == CONST_ARRAY:
        return arr.args[0]
    rng = arr.width[1]
    return _intern(SELECT, (arr, idx), width=rng)


def mk_store(arr: Term, idx: Term, val: Term) -> Term:
    return _intern(STORE, (arr, idx, val), width=arr.width)


def apply_func(decl, *args: Term) -> Term:
    name, domain, rng = decl
    assert tuple(a.width for a in args) == domain, (decl, args)
    return _intern(APPLY, tuple(args), params=domain + (rng,), width=rng,
                   name=name)


# -- Bool constructors -------------------------------------------------------

def mk_eq(a: Term, b: Term) -> Term:
    if a.is_array or b.is_array:
        return _intern(EQ, _sort2(a, b))
    assert a.width == b.width, (a.width, b.width)
    if is_const(a) and is_const(b):
        return bool_t(a.val == b.val)
    if a is b:
        return _TRUE
    a, b = _sort2(a, b)
    return _intern(EQ, (a, b))


def mk_ult(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bool_t(a.val < b.val)
    if a is b:
        return _FALSE
    if is_const(b) and b.val == 0:
        return _FALSE
    if is_const(a) and a.val == _mask(a.width):
        return _FALSE
    return _intern(ULT, (a, b))


def mk_ule(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bool_t(a.val <= b.val)
    if a is b:
        return _TRUE
    if is_const(a) and a.val == 0:
        return _TRUE
    if is_const(b) and b.val == _mask(a.width):
        return _TRUE
    return _intern(ULE, (a, b))


def mk_slt(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bool_t(_signed(a.val, a.width) < _signed(b.val, b.width))
    if a is b:
        return _FALSE
    return _intern(SLT, (a, b))


def mk_sle(a: Term, b: Term) -> Term:
    assert a.width == b.width
    if is_const(a) and is_const(b):
        return bool_t(_signed(a.val, a.width) <= _signed(b.val, b.width))
    if a is b:
        return _TRUE
    return _intern(SLE, (a, b))


def mk_not(a: Term) -> Term:
    if a.op == TRUE:
        return _FALSE
    if a.op == FALSE:
        return _TRUE
    if a.op == NOT:
        return a.args[0]
    return _intern(NOT, (a,))


def mk_bool_and(*args: Term) -> Term:
    flat = []
    for a in args:
        if a.op == FALSE:
            return _FALSE
        if a.op == TRUE:
            continue
        if a.op == AND:
            flat.extend(a.args)
        else:
            flat.append(a)
    seen, uniq = set(), []
    for a in flat:
        if a.tid not in seen:
            seen.add(a.tid)
            uniq.append(a)
    # complementary literals annihilate: and(..., a, not(a), ...) is
    # FALSE (lane-merge OR terms and re-tested branch conditions build
    # exactly this shape; the fold keeps them out of every screen)
    for a in uniq:
        if a.op == NOT and a.args[0].tid in seen:
            return _FALSE
    if not uniq:
        return _TRUE
    if len(uniq) == 1:
        return uniq[0]
    uniq.sort(key=lambda t: t.tid)
    return _intern(AND, tuple(uniq))


def mk_bool_or(*args: Term) -> Term:
    flat = []
    for a in args:
        if a.op == TRUE:
            return _TRUE
        if a.op == FALSE:
            continue
        if a.op == OR:
            flat.extend(a.args)
        else:
            flat.append(a)
    seen, uniq = set(), []
    for a in flat:
        if a.tid not in seen:
            seen.add(a.tid)
            uniq.append(a)
    # complementary literals saturate: or(..., a, not(a), ...) is TRUE
    # (a fully-rejoined CFG diamond's merged constraint collapses to
    # no constraint at all — Constraints.append then drops it)
    for a in uniq:
        if a.op == NOT and a.args[0].tid in seen:
            return _TRUE
    if not uniq:
        return _FALSE
    if len(uniq) == 1:
        return uniq[0]
    uniq.sort(key=lambda t: t.tid)
    return _intern(OR, tuple(uniq))


def mk_bool_xor(a: Term, b: Term) -> Term:
    if a.op in (TRUE, FALSE) and b.op in (TRUE, FALSE):
        return bool_t(a.val != b.val)
    if a is b:
        return _FALSE
    a, b = _sort2(a, b)
    return _intern(XOR, (a, b))


def mk_bool_ite(c: Term, a: Term, b: Term) -> Term:
    if c.op == TRUE:
        return a
    if c.op == FALSE:
        return b
    if a is b:
        return a
    if a.op == TRUE and b.op == FALSE:
        return c
    if a.op == FALSE and b.op == TRUE:
        return mk_not(c)
    return _intern(BOOL_ITE, (c, a, b))


# ---------------------------------------------------------------------------
# Concrete evaluation under an assignment (the model.eval replacement).

class EvalEnv:
    """Assignment for evaluation: BV/Bool var values, array and UF models.

    arrays: name -> (default_int, {index_int: value_int})
    funcs:  name -> {args_tuple: value_int}
    Unbound symbols evaluate to ``default`` (model completion) when
    ``complete`` is True, else raise KeyError.
    """

    def __init__(self, bv=None, arrays=None, funcs=None, complete=True,
                 default=0):
        self.bv = bv or {}
        self.arrays = arrays or {}
        self.funcs = funcs or {}
        self.complete = complete
        self.default = default


def eval_term(t: Term, env: EvalEnv, memo=None):
    """Evaluate to an int (BV), bool (Bool) or array model tuple.

    Iterative post-order driver: EVM paths build term chains thousands of
    nodes deep, far past Python's recursion limit."""
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
        memo[cur.tid] = _eval_node(cur, env, memo)
    return memo[t.tid]


def _eval_node(t: Term, env: EvalEnv, memo):
    op = t.op
    if op == BV_CONST:
        v = t.val
    elif op in (TRUE, FALSE):
        v = t.val
    elif op in (BV_VAR, BOOL_VAR):
        if t.name in env.bv:
            v = env.bv[t.name]
        elif env.complete:
            v = env.default if op == BV_VAR else False
        else:
            raise KeyError(t.name)
    elif op == ARRAY_VAR:
        if t.name in env.arrays:
            v = env.arrays[t.name]
        elif env.complete:
            v = (env.default, {})
        else:
            raise KeyError(t.name)
    elif op == CONST_ARRAY:
        v = (eval_term(t.args[0], env, memo), {})
    elif op == STORE:
        base = eval_term(t.args[0], env, memo)
        idx = eval_term(t.args[1], env, memo)
        val = eval_term(t.args[2], env, memo)
        entries = dict(base[1])
        entries[idx] = val
        v = (base[0], entries)
    elif op == SELECT:
        arr = eval_term(t.args[0], env, memo)
        idx = eval_term(t.args[1], env, memo)
        v = arr[1].get(idx, arr[0])
    elif op == APPLY:
        argv = tuple(eval_term(a, env, memo) for a in t.args)
        table = env.funcs.get(t.name, {})
        if argv in table:
            v = table[argv]
        elif env.complete:
            v = env.default
        else:
            raise KeyError((t.name, argv))
    else:
        a = [eval_term(x, env, memo) for x in t.args]
        w = t.width if isinstance(t.width, int) else 0
        m = _mask(w) if w else 0
        if op == ADD:
            v = (a[0] + a[1]) & m
        elif op == SUB:
            v = (a[0] - a[1]) & m
        elif op == MUL:
            v = (a[0] * a[1]) & m
        elif op == UDIV:
            v = m if a[1] == 0 else a[0] // a[1]
        elif op == UREM:
            v = a[0] if a[1] == 0 else a[0] % a[1]
        elif op == SDIV:
            sa, sb = _signed(a[0], w), _signed(a[1], w)
            if sb == 0:
                v = 1 if sa < 0 else m
            else:
                q = abs(sa) // abs(sb)
                v = (-q if (sa < 0) != (sb < 0) else q) & m
        elif op == SREM:
            sa, sb = _signed(a[0], w), _signed(a[1], w)
            if sb == 0:
                v = a[0]
            else:
                r_ = abs(sa) % abs(sb)
                v = (-r_ if sa < 0 else r_) & m
        elif op == BAND:
            v = a[0] & a[1]
        elif op == BOR:
            v = a[0] | a[1]
        elif op == BXOR:
            v = a[0] ^ a[1]
        elif op == BNOT:
            v = (~a[0]) & m
        elif op == NEG:
            v = (-a[0]) & m
        elif op == SHL:
            v = (a[0] << a[1]) & m if a[1] < w else 0
        elif op == LSHR:
            v = a[0] >> a[1] if a[1] < w else 0
        elif op == ASHR:
            v = (_signed(a[0], w) >> min(a[1], w - 1)) & m
        elif op == CONCAT:
            v = 0
            for part, pv in zip(t.args, a):
                v = (v << part.width) | pv
        elif op == EXTRACT:
            hi, lo = t.params
            v = (a[0] >> lo) & _mask(hi - lo + 1)
        elif op == ZEXT:
            v = a[0]
        elif op == SEXT:
            v = _signed(a[0], t.args[0].width) & m
        elif op == ITE or op == BOOL_ITE:
            v = a[1] if a[0] else a[2]
        elif op == EQ:
            v = a[0] == a[1]
        elif op == ULT:
            v = a[0] < a[1]
        elif op == ULE:
            v = a[0] <= a[1]
        elif op == SLT:
            w2 = t.args[0].width
            v = _signed(a[0], w2) < _signed(a[1], w2)
        elif op == SLE:
            w2 = t.args[0].width
            v = _signed(a[0], w2) <= _signed(a[1], w2)
        elif op == AND:
            v = all(a)
        elif op == OR:
            v = any(a)
        elif op == NOT:
            v = not a[0]
        elif op == XOR:
            v = a[0] != a[1]
        else:
            raise NotImplementedError(op)
    memo[t.tid] = v
    return v


# ---------------------------------------------------------------------------
# Substitution (reference parity: z3.substitute in bool.py:92 / array.py:42).

def substitute_term(t: Term, mapping: Dict[int, Term], memo=None) -> Term:
    """Replace subterms by tid -> replacement. Rebuilds with folding.
    Iterative post-order (deep chains exceed the recursion limit).

    Empty mapping is an identity: every term is built through the
    normalizing mk_* constructors, so a rules-only rebuild returns the
    same interned node — simplify() rides this shortcut."""
    if not mapping:
        return t
    if memo is None:
        memo = {}

    def resolved(x: Term):
        if x.tid in mapping:
            return mapping[x.tid]
        return memo.get(x.tid)

    stack = [t]
    while stack:
        cur = stack[-1]
        if resolved(cur) is not None:
            stack.pop()
            continue
        if not cur.args:
            memo[cur.tid] = cur
            stack.pop()
            continue
        pending = [a for a in cur.args if resolved(a) is None]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        new_args = tuple(resolved(a) for a in cur.args)
        if all(na is a for na, a in zip(new_args, cur.args)):
            memo[cur.tid] = cur
        else:
            memo[cur.tid] = rebuild(
                cur.op, new_args, cur.params, cur.width, cur.name
            )
    return resolved(t)


_REBUILD2 = {
    ADD: mk_add, SUB: mk_sub, MUL: mk_mul, UDIV: mk_udiv, UREM: mk_urem,
    SDIV: mk_sdiv, SREM: mk_srem, BAND: mk_and, BOR: mk_or, BXOR: mk_xor,
    SHL: mk_shl, LSHR: mk_lshr, ASHR: mk_ashr, EQ: mk_eq, ULT: mk_ult,
    ULE: mk_ule, SLT: mk_slt, SLE: mk_sle, XOR: mk_bool_xor,
}


def rebuild(op, args, params, width, name) -> Term:
    f2 = _REBUILD2.get(op)
    if f2 is not None:
        return f2(args[0], args[1])
    if op == BNOT:
        return mk_bnot(args[0])
    if op == NEG:
        return mk_neg(args[0])
    if op == NOT:
        return mk_not(args[0])
    if op == CONCAT:
        return mk_concat(*args)
    if op == EXTRACT:
        return mk_extract(params[0], params[1], args[0])
    if op == ZEXT:
        return mk_zext(params[0], args[0])
    if op == SEXT:
        return mk_sext(params[0], args[0])
    if op == ITE:
        return mk_ite(args[0], args[1], args[2])
    if op == BOOL_ITE:
        return mk_bool_ite(args[0], args[1], args[2])
    if op == AND:
        return mk_bool_and(*args)
    if op == OR:
        return mk_bool_or(*args)
    if op == SELECT:
        return mk_select(args[0], args[1])
    if op == STORE:
        return mk_store(args[0], args[1], args[2])
    if op == APPLY:
        decl = (name, params[:-1], params[-1])
        return apply_func(decl, *args)
    if op == CONST_ARRAY:
        return const_array(width[0], width[1], args[0])
    raise NotImplementedError(op)


def collect(t: Term, pred, out=None, seen=None):
    """All distinct subterms satisfying pred (iterative DFS)."""
    if out is None:
        out = []
    if seen is None:
        seen = set()
    stack = [t]
    while stack:
        cur = stack.pop()
        if cur.tid in seen:
            continue
        seen.add(cur.tid)
        if pred(cur):
            out.append(cur)
        stack.extend(cur.args)
    return out


_TID_INDEX: Dict[int, Term] = {}
_TID_INDEXED_UPTO = [0]


def term_by_tid(tid: int):
    """Term for a tid, or None. `_table` is insertion-ordered and
    append-only: only the suffix of terms created since the last call
    is indexed (amortized O(new terms))."""
    if len(_TID_INDEX) != len(_table):
        import itertools

        for t in itertools.islice(_table.values(), _TID_INDEXED_UPTO[0],
                                  None):
            _TID_INDEX[t.tid] = t
        _TID_INDEXED_UPTO[0] = len(_table)
    return _TID_INDEX.get(tid)
