"""Pure ALU term semantics shared by the host interpreter and the lane
engine's drain resolver.

Each function builds exactly the term the corresponding `Instruction`
handler pushes (reference mythril/laser/ethereum/instructions.py:269-765).
Factoring them out of the handlers is what guarantees the TPU lane engine's
deferred-op resolution (mythril_tpu_torch/ops/symdrain.py) can never diverge from
the one-state-at-a-time interpreter (mythril_tpu_torch/laser/instructions.py):
both call these.

Argument order convention: operands are given in stack-pop order — `a` is
the top of the stack, `b` the next item, `c` the third. This matches both
the handlers' pop sequences and the lane stepper's peek order
(mythril_tpu_torch/ops/symstep.py record layout).
"""

from typing import Optional, Tuple, Union

from ..smt import (
    BitVec,
    Bool,
    Concat,
    Extract,
    If,
    LShR,
    Not,
    SRem,
    UDiv,
    ULT,
    UGT,
    URem,
    simplify,
    symbol_factory,
)
from .function_managers import exponent_function_manager

TT256M1 = symbol_factory.BitVecVal(2**256 - 1, 256)


def _val(v: int) -> BitVec:
    return symbol_factory.BitVecVal(v, 256)


def to_bitvec(item: Union[int, BitVec, Bool]) -> BitVec:
    """The pop-coercion applied by util.pop_bitvec (minus the stack pop):
    Bool -> If(b, 1, 0), int -> BitVecVal, BitVec -> simplified in
    place. util.pop_bitvec delegates here so the interpreter and the
    lane-drain resolver coerce identically."""
    if isinstance(item, Bool):
        return If(item, _val(1), _val(0))
    if isinstance(item, int):
        return _val(item)
    item.raw = simplify(item).raw
    return item


def add(a: BitVec, b: BitVec) -> BitVec:
    return a + b


def sub(a: BitVec, b: BitVec) -> BitVec:
    return a - b


def mul(a: BitVec, b: BitVec) -> BitVec:
    return a * b


def div(a: BitVec, b: BitVec) -> BitVec:
    if b.value == 0:
        return _val(0)
    if b.symbolic:
        return If(b == 0, _val(0), UDiv(a, b))
    return UDiv(a, b)


def sdiv(a: BitVec, b: BitVec) -> BitVec:
    if b.value == 0:
        return _val(0)
    if b.symbolic:
        return If(b == 0, _val(0), a / b)
    return a / b


def mod(a: BitVec, b: BitVec) -> BitVec:
    return _val(0) if b.value == 0 else If(b == 0, _val(0), URem(a, b))


def smod(a: BitVec, b: BitVec) -> BitVec:
    return _val(0) if b.value == 0 else If(b == 0, _val(0), SRem(a, b))


def addmod(a: BitVec, b: BitVec, c: BitVec) -> BitVec:
    z = _val(0)
    total = URem(Concat(z, a) + Concat(z, b), Concat(z, c))
    return If(c == 0, _val(0), Extract(255, 0, total))


def mulmod(a: BitVec, b: BitVec, c: BitVec) -> BitVec:
    z = _val(0)
    total = URem(Concat(z, a) * Concat(z, b), Concat(z, c))
    return If(c == 0, _val(0), Extract(255, 0, total))


def exp(base: BitVec, exponent: BitVec) -> Tuple[BitVec, Optional[Bool]]:
    """Returns (result, extra_constraint). The constraint is non-None only
    on the uninterpreted-Power path; callers must append it to the state's
    constraints."""
    if not base.symbolic and base.value is not None:
        b = base.value
        if b in (0, 1):
            zero, one = _val(0), _val(1)
            return (one if b == 1 else If(exponent == zero, one, zero),
                    None)
        if b & (b - 1) == 0:
            m = b.bit_length() - 1
            shift = _val(m) * exponent
            return (
                If(
                    ULT(exponent, _val(256)),
                    _val(1) << shift,
                    _val(0),
                ),
                None,
            )
    exponentiation, constraint = (
        exponent_function_manager.create_condition(base, exponent)
    )
    return exponentiation, constraint


def exp_is_pure(base: BitVec) -> bool:
    """True when exp() takes a constraint-free path for this base (the
    lane stepper defers only these; others park for the host)."""
    return (
        not base.symbolic
        and base.value is not None
        and (base.value in (0, 1) or base.value & (base.value - 1) == 0)
    )


def signextend(a: BitVec, b: BitVec) -> BitVec:
    testbit = a * _val(8) + 7
    set_testbit = _val(1) << testbit
    sign_bit_set = (b & set_testbit) != 0
    extended = If(
        sign_bit_set,
        b | (TT256M1 - (set_testbit - 1)),
        b & (set_testbit - 1),
    )
    return If(ULT(a, _val(32)), extended, b)


def lt(a: BitVec, b: BitVec) -> Bool:
    return ULT(a, b)


def gt(a: BitVec, b: BitVec) -> Bool:
    return UGT(a, b)


def slt(a: BitVec, b: BitVec) -> Bool:
    return a < b


def sgt(a: BitVec, b: BitVec) -> Bool:
    return a > b


def eq(a: Union[BitVec, Bool], b: Union[BitVec, Bool]) -> Bool:
    """EQ takes raw (uncoerced) stack items like the handler does."""
    if isinstance(a, Bool):
        a = If(a, _val(1), _val(0))
    if isinstance(b, Bool):
        b = If(b, _val(1), _val(0))
    return a == b


def iszero(a: Union[BitVec, Bool]) -> Bool:
    """ISZERO takes the raw stack item (Bool stays in the Bool domain)."""
    exp_ = Not(a) if isinstance(a, Bool) else a == 0
    if hasattr(a, "annotations"):
        exp_.annotations = exp_.annotations | a.annotations
    return exp_


def and_(a: BitVec, b: BitVec) -> BitVec:
    return a & b


def or_(a: BitVec, b: BitVec) -> BitVec:
    return a | b


def xor(a: BitVec, b: BitVec) -> BitVec:
    return a ^ b


def not_(a: BitVec) -> BitVec:
    return TT256M1 - a


def byte_op(a: BitVec, b: BitVec) -> BitVec:
    """BYTE: a = byte index (top), b = word."""
    if a.value is not None:
        if a.value >= 32:
            return _val(0)
        offset = (31 - a.value) * 8
        return Concat(
            symbol_factory.BitVecVal(0, 248),
            Extract(offset + 7, offset, b),
        )
    shifted = LShR(b, (_val(31) - a) * _val(8))
    return If(ULT(a, _val(32)), shifted & 0xFF, _val(0))


def shl(a: BitVec, b: BitVec) -> BitVec:
    """SHL: a = shift (top), b = value."""
    return b << a


def shr(a: BitVec, b: BitVec) -> BitVec:
    return LShR(b, a)


def sar(a: BitVec, b: BitVec) -> BitVec:
    return b >> a
