"""mythril_tpu_torch SMT abstraction layer.

Public surface parity with the reference package
(mythril/laser/smt/__init__.py:1-28): symbol_factory, BitVec, Bool, Array/K,
Function, Solver/Optimize/IndependenceSolver, Model, and the helper free
functions. The backend is this build's own stack — hash-consed term DAG,
interval propagation, bit-blasting onto a native CDCL core — instead of z3.
"""

from typing import Any, Optional, Set, Union

from . import terms
from .array import Array, BaseArray, K
from .bitvec import BitVec
from .bitvec_helper import (
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Concat,
    Extract,
    If,
    LShR,
    SRem,
    Sum,
    UDiv,
    UGE,
    UGT,
    ULE,
    ULT,
    URem,
)
from .bool import And, Bool, Not, Or, Xor, is_false, is_true
from .bool import Bool as SMTBool
from .expression import Expression, simplify
from .function import Function
from .model import Model
from .solver import (
    IndependenceSolver,
    Optimize,
    Solver,
    SolverStatistics,
    sat,
    unknown,
    unsat,
)

Annotations = Optional[Set[Any]]


class SymbolFactory:
    """Creation point for every symbol and value in the system (reference
    __init__.py:37-80). The pluggability seam: the TPU lane engine installs
    its own factory to mirror symbols into device-side abstract lanes."""

    @staticmethod
    def Bool(value: bool, annotations: Annotations = None) -> SMTBool:
        raise NotImplementedError

    @staticmethod
    def BoolSym(name: str, annotations: Annotations = None) -> SMTBool:
        raise NotImplementedError

    @staticmethod
    def BitVecVal(value: int, size: int,
                  annotations: Annotations = None) -> BitVec:
        raise NotImplementedError

    @staticmethod
    def BitVecSym(name: str, size: int,
                  annotations: Annotations = None) -> BitVec:
        raise NotImplementedError


class _SmtSymbolFactory(SymbolFactory):
    """Creates facade instances over the term DAG."""

    @staticmethod
    def Bool(value: bool, annotations: Annotations = None) -> SMTBool:
        return SMTBool(terms.bool_t(value), annotations)

    @staticmethod
    def BoolSym(name: str, annotations: Annotations = None) -> SMTBool:
        return SMTBool(terms.bool_var(name), annotations)

    @staticmethod
    def BitVecVal(value: int, size: int,
                  annotations: Annotations = None) -> BitVec:
        return BitVec(terms.bv_const(value, size), annotations)

    @staticmethod
    def BitVecSym(name: str, size: int,
                  annotations: Annotations = None) -> BitVec:
        return BitVec(terms.bv_var(name, size), annotations)


symbol_factory = _SmtSymbolFactory()

__all__ = [
    "Array",
    "BaseArray",
    "BitVec",
    "Bool",
    "SMTBool",
    "BVAddNoOverflow",
    "BVMulNoOverflow",
    "BVSubNoUnderflow",
    "Concat",
    "Expression",
    "Extract",
    "Function",
    "If",
    "IndependenceSolver",
    "K",
    "LShR",
    "Model",
    "Not",
    "Optimize",
    "Or",
    "And",
    "Xor",
    "SRem",
    "Solver",
    "SolverStatistics",
    "Sum",
    "UDiv",
    "UGE",
    "UGT",
    "ULE",
    "ULT",
    "URem",
    "is_false",
    "is_true",
    "sat",
    "simplify",
    "symbol_factory",
    "unknown",
    "unsat",
]
