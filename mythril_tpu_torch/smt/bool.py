"""Symbolic boolean facade (reference parity: mythril/laser/smt/bool.py)."""

from typing import Optional, Set, Union

from . import terms as T
from .expression import Expression


class Bool(Expression["T.Term"]):
    """A boolean expression over the term DAG."""

    @property
    def is_false(self) -> bool:
        return self.raw.op == T.FALSE

    @property
    def is_true(self) -> bool:
        return self.raw.op == T.TRUE

    @property
    def value(self) -> Union[bool, None]:
        if self.is_true:
            return True
        if self.is_false:
            return False
        return None

    def substitute(self, original_expression, new_expression) -> None:
        """In-place subterm replacement (parity: bool.py:82-92)."""
        self.raw = T.substitute_term(
            self.raw, {original_expression.raw.tid: new_expression.raw}
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Expression):
            return self.raw is other.raw
        return False

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return self.raw.tid

    def __bool__(self) -> bool:
        if self.value is not None:
            return self.value
        return False


def is_true(a: Bool) -> bool:
    return a.is_true


def is_false(a: Bool) -> bool:
    return a.is_false


def _union_annotations(*items) -> Optional[Set]:
    """None when no operand carries annotations — the common case; the
    Expression constructor treats None as empty without allocating."""
    out = None
    for it in items:
        ann = it._annotations
        if ann:
            out = set(ann) if out is None else (out | ann)
    return out


def And(*args: Union[Bool, bool]) -> Bool:
    wrapped = [a if isinstance(a, Bool) else Bool(T.bool_t(a)) for a in args]
    return Bool(
        T.mk_bool_and(*(a.raw for a in wrapped)), _union_annotations(*wrapped)
    )


def Or(*args: Union[Bool, bool]) -> Bool:
    wrapped = [a if isinstance(a, Bool) else Bool(T.bool_t(a)) for a in args]
    return Bool(
        T.mk_bool_or(*(a.raw for a in wrapped)), _union_annotations(*wrapped)
    )


def Xor(a: Bool, b: Bool) -> Bool:
    return Bool(T.mk_bool_xor(a.raw, b.raw), _union_annotations(a, b))


def Not(a: Bool) -> Bool:
    return Bool(T.mk_not(a.raw), a.annotations)
