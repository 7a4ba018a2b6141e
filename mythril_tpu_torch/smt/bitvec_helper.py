"""Free functions over BitVec (reference parity:
mythril/laser/smt/bitvec_helper.py:30-231)."""

from typing import Union

from . import terms as T
from .bitvec import BitVec, _coerce, _pad
from .bool import Bool


def _ann(*items):
    out = set()
    for it in items:
        if hasattr(it, "annotations"):
            out |= it.annotations
    return out


def _pair(a: BitVec, b) -> tuple:
    bo = _coerce(b, a.raw.width)
    return _pad(a.raw, bo)


def UGT(a: BitVec, b: BitVec) -> Bool:
    x, y = _pair(a, b)
    return Bool(T.mk_ult(y, x), _ann(a, b))


def UGE(a: BitVec, b: BitVec) -> Bool:
    x, y = _pair(a, b)
    return Bool(T.mk_ule(y, x), _ann(a, b))


def ULT(a: BitVec, b: BitVec) -> Bool:
    x, y = _pair(a, b)
    return Bool(T.mk_ult(x, y), _ann(a, b))


def ULE(a: BitVec, b: BitVec) -> Bool:
    x, y = _pair(a, b)
    return Bool(T.mk_ule(x, y), _ann(a, b))


def UDiv(a: BitVec, b: BitVec) -> BitVec:
    x, y = _pair(a, b)
    return BitVec(T.mk_udiv(x, y), _ann(a, b))


def URem(a: BitVec, b: BitVec) -> BitVec:
    x, y = _pair(a, b)
    return BitVec(T.mk_urem(x, y), _ann(a, b))


def SRem(a: BitVec, b: BitVec) -> BitVec:
    x, y = _pair(a, b)
    return BitVec(T.mk_srem(x, y), _ann(a, b))


def LShR(a: BitVec, b: BitVec) -> BitVec:
    x, y = _pair(a, b)
    return BitVec(T.mk_lshr(x, y), _ann(a, b))


def If(a: Union[Bool, bool], b, c):
    """If-then-else; overloaded for BitVec/int and Array branches
    (reference bitvec_helper.py:139-171)."""
    from .array import BaseArray

    if not isinstance(a, Bool):
        a = Bool(T.bool_t(bool(a)))
    if isinstance(b, BaseArray) and isinstance(c, BaseArray):
        raise NotImplementedError("array-valued If is not used by the engine")
    if isinstance(b, (bool, Bool)) and isinstance(c, (bool, Bool)):
        bb = b if isinstance(b, Bool) else Bool(T.bool_t(b))
        cc = c if isinstance(c, Bool) else Bool(T.bool_t(c))
        return Bool(T.mk_bool_ite(a.raw, bb.raw, cc.raw), _ann(a, bb, cc))
    width = (
        b.raw.width
        if isinstance(b, BitVec)
        else (c.raw.width if isinstance(c, BitVec) else 256)
    )
    bb = b.raw if isinstance(b, BitVec) else T.bv_const(b, width)
    cc = c.raw if isinstance(c, BitVec) else T.bv_const(c, width)
    bb2, cc2 = _pad(bb, cc)
    return BitVec(T.mk_ite(a.raw, bb2, cc2), _ann(a, b, c))


def Concat(*args) -> BitVec:
    """Concat MSB-first; accepts a single list (reference
    bitvec_helper.py:174-188)."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return BitVec(T.mk_concat(*(a.raw for a in args)), _ann(*args))


def Extract(high: int, low: int, bv: BitVec) -> BitVec:
    return BitVec(T.mk_extract(high, low, bv.raw), _ann(bv))


def Sum(*args: BitVec) -> BitVec:
    acc = args[0].raw
    for a in args[1:]:
        x, y = _pad(acc, a.raw)
        acc = T.mk_add(x, y)
    return BitVec(acc, _ann(*args))


def BVAddNoOverflow(a, b, signed: bool) -> Bool:
    """True iff a + b does not overflow (reference bitvec_helper.py:199)."""
    if not isinstance(a, BitVec):
        a = BitVec(T.bv_const(a, b.raw.width))
    if not isinstance(b, BitVec):
        b = BitVec(T.bv_const(b, a.raw.width))
    x, y = _pad(a.raw, b.raw)
    w = x.width
    if signed:
        xe, ye = T.mk_sext(1, x), T.mk_sext(1, y)
        s = T.mk_add(xe, ye)
        lo = T.bv_const((-(1 << (w - 1))) & ((1 << (w + 1)) - 1), w + 1)
        hi = T.bv_const((1 << (w - 1)) - 1, w + 1)
        ok = T.mk_bool_and(T.mk_sle(lo, s), T.mk_sle(s, hi))
        return Bool(ok, _ann(a, b))
    xe, ye = T.mk_zext(1, x), T.mk_zext(1, y)
    s = T.mk_add(xe, ye)
    return Bool(
        T.mk_eq(T.mk_extract(w, w, s), T.bv_const(0, 1)), _ann(a, b)
    )


def BVMulNoOverflow(a, b, signed: bool) -> Bool:
    """True iff a * b does not overflow (reference bitvec_helper.py:204)."""
    if not isinstance(a, BitVec):
        a = BitVec(T.bv_const(a, b.raw.width))
    if not isinstance(b, BitVec):
        b = BitVec(T.bv_const(b, a.raw.width))
    x, y = _pad(a.raw, b.raw)
    w = x.width
    if signed:
        xe, ye = T.mk_sext(w, x), T.mk_sext(w, y)
        p = T.mk_mul(xe, ye)
        lo = T.bv_const((-(1 << (w - 1))) & ((1 << (2 * w)) - 1), 2 * w)
        hi = T.bv_const((1 << (w - 1)) - 1, 2 * w)
        ok = T.mk_bool_and(T.mk_sle(lo, p), T.mk_sle(p, hi))
        return Bool(ok, _ann(a, b))
    xe, ye = T.mk_zext(w, x), T.mk_zext(w, y)
    p = T.mk_mul(xe, ye)
    return Bool(
        T.mk_eq(
            T.mk_extract(2 * w - 1, w, p), T.bv_const(0, w)
        ),
        _ann(a, b),
    )


def BVSubNoUnderflow(a, b, signed: bool) -> Bool:
    """True iff a - b does not underflow (reference bitvec_helper.py:209)."""
    if not isinstance(a, BitVec):
        a = BitVec(T.bv_const(a, b.raw.width))
    if not isinstance(b, BitVec):
        b = BitVec(T.bv_const(b, a.raw.width))
    x, y = _pad(a.raw, b.raw)
    if signed:
        xe, ye = T.mk_sext(1, x), T.mk_sext(1, y)
        w = x.width
        d = T.mk_sub(xe, ye)
        lo = T.bv_const((-(1 << (w - 1))) & ((1 << (w + 1)) - 1), w + 1)
        hi = T.bv_const((1 << (w - 1)) - 1, w + 1)
        return Bool(
            T.mk_bool_and(T.mk_sle(lo, d), T.mk_sle(d, hi)), _ann(a, b)
        )
    return Bool(T.mk_ule(y, x), _ann(a, b))
