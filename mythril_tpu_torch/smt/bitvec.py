"""Symbolic bitvector facade (reference parity: mythril/laser/smt/bitvec.py).

All Python operators are overloaded; annotations union through every binop.
Mixed-width operands are zero-padded to the wider width, mirroring the
reference's `_padded_operation` (bitvec.py:16-26) used for post-keccak
512-bit values meeting 256-bit words.
"""

from typing import Optional, Set, Union

from . import terms as T
from .bool import Bool
from .expression import Expression


def _coerce(other, width: int) -> "T.Term":
    if isinstance(other, BitVec):
        return other.raw
    if isinstance(other, bool):
        return T.bv_const(int(other), width)
    if isinstance(other, int):
        return T.bv_const(other, width)
    raise TypeError(f"cannot coerce {type(other)} to BitVec")


def _pad(a: "T.Term", b: "T.Term"):
    if a.width == b.width:
        return a, b
    if a.width < b.width:
        return T.mk_zext(b.width - a.width, a), b
    return a, T.mk_zext(a.width - b.width, b)


class BitVec(Expression["T.Term"]):
    """A bit vector symbol or value."""

    def __init__(self, raw: "T.Term", annotations: Optional[Set] = None):
        super().__init__(raw, annotations)

    @property
    def symbolic(self) -> bool:
        return self.raw.op != T.BV_CONST

    @property
    def value(self) -> Optional[int]:
        if self.raw.op == T.BV_CONST:
            return self.raw.val
        return None

    def size(self) -> int:
        return self.raw.width

    def _bin(self, other, mk) -> "BitVec":
        o = _coerce(other, self.raw.width)
        a, b = _pad(self.raw, o)
        ann = self.annotations | (
            other.annotations if isinstance(other, Expression) else set()
        )
        return BitVec(mk(a, b), ann)

    def _cmp(self, other, mk) -> Bool:
        o = _coerce(other, self.raw.width)
        a, b = _pad(self.raw, o)
        ann = self.annotations | (
            other.annotations if isinstance(other, Expression) else set()
        )
        return Bool(mk(a, b), ann)

    def __add__(self, other) -> "BitVec":
        return self._bin(other, T.mk_add)

    __radd__ = __add__

    def __sub__(self, other) -> "BitVec":
        return self._bin(other, T.mk_sub)

    def __rsub__(self, other) -> "BitVec":
        o = _coerce(other, self.raw.width)
        a, b = _pad(o, self.raw)
        return BitVec(T.mk_sub(a, b), self.annotations)

    def __mul__(self, other) -> "BitVec":
        return self._bin(other, T.mk_mul)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "BitVec":
        # signed division, z3 `/` semantics (reference bitvec.py:96-103)
        return self._bin(other, T.mk_sdiv)

    def __and__(self, other) -> "BitVec":
        return self._bin(other, T.mk_and)

    __rand__ = __and__

    def __or__(self, other) -> "BitVec":
        return self._bin(other, T.mk_or)

    __ror__ = __or__

    def __xor__(self, other) -> "BitVec":
        return self._bin(other, T.mk_xor)

    __rxor__ = __xor__

    def __mod__(self, other) -> "BitVec":
        # signed remainder, z3 `%`... note: z3 `%` on BitVecRef is URem?
        # z3 maps Python % to bvsmod; the reference uses explicit URem/SRem
        # helpers everywhere it matters, so plain srem here is adequate.
        return self._bin(other, T.mk_srem)

    def __invert__(self) -> "BitVec":
        return BitVec(T.mk_bnot(self.raw), self.annotations)

    def __neg__(self) -> "BitVec":
        return BitVec(T.mk_neg(self.raw), self.annotations)

    def __lt__(self, other) -> Bool:
        return self._cmp(other, T.mk_slt)

    def __gt__(self, other) -> Bool:
        o = _coerce(other, self.raw.width)
        a, b = _pad(self.raw, o)
        ann = self.annotations | (
            other.annotations if isinstance(other, Expression) else set()
        )
        return Bool(T.mk_slt(b, a), ann)

    def __le__(self, other) -> Bool:
        return self._cmp(other, T.mk_sle)

    def __ge__(self, other) -> Bool:
        o = _coerce(other, self.raw.width)
        a, b = _pad(self.raw, o)
        ann = self.annotations | (
            other.annotations if isinstance(other, Expression) else set()
        )
        return Bool(T.mk_sle(b, a), ann)

    def __eq__(self, other) -> Bool:  # type: ignore[override]
        if other is None:
            return Bool(T.false_t())
        return self._cmp(other, T.mk_eq)

    def __ne__(self, other) -> Bool:  # type: ignore[override]
        if other is None:
            return Bool(T.true_t())
        o = _coerce(other, self.raw.width)
        a, b = _pad(self.raw, o)
        ann = self.annotations | (
            other.annotations if isinstance(other, Expression) else set()
        )
        return Bool(T.mk_not(T.mk_eq(a, b)), ann)

    def __lshift__(self, other) -> "BitVec":
        return self._bin(other, T.mk_shl)

    def __rshift__(self, other) -> "BitVec":
        # arithmetic shift right (z3 `>>` semantics, reference bitvec.py:240)
        return self._bin(other, T.mk_ashr)

    def __hash__(self) -> int:
        return self.raw.tid
