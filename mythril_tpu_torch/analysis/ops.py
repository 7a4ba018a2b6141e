"""Helpers for representing EVM operations in the parsed statespace
(reference parity: mythril/analysis/ops.py:1-93)."""

from enum import Enum

from ..laser import util
from ..smt import simplify


class VarType(Enum):
    """Whether a value is symbolic or concrete."""

    SYMBOLIC = 1
    CONCRETE = 2


class Variable:
    """A value with its VarType."""

    def __init__(self, val, _type):
        self.val = val
        self.type = _type

    def __str__(self):
        return str(self.val)


def get_variable(i) -> Variable:
    try:
        return Variable(util.get_concrete_int(i), VarType.CONCRETE)
    except TypeError:
        return Variable(simplify(i), VarType.SYMBOLIC)


class Op:
    """Base op referencing its node and state."""

    def __init__(self, node, state, state_index):
        self.node = node
        self.state = state
        self.state_index = state_index


class Call(Op):
    """A parsed CALL-family operation."""

    def __init__(self, node, state, state_index, _type, to, gas,
                 value=None, data=None):
        super().__init__(node, state, state_index)
        self.to = to
        self.gas = gas
        self.type = _type
        self.value = (
            value if value is not None else Variable(0, VarType.CONCRETE)
        )
        self.data = data
