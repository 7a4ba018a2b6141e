"""Uninterpreted-Power fallback for EXP terms the pure lowering cannot
reduce (capability parity: reference
mythril/laser/ethereum/function_managers/exponent_function_manager.py:10-63).

laser/alu.py exp() folds concrete pairs and lowers power-of-two bases
to guarded shifts — pure bitvector forms the CDCL core solves natively.
Only a symbolic or non-power-of-two base reaches the Power UF here,
constrained by the 256^i table plus positivity.  The axiom table is
built lazily on first symbolic use instead of at import."""

import logging
from typing import Tuple

from ...smt import And, BitVec, Bool, Function, URem, symbol_factory

log = logging.getLogger(__name__)


class ExponentFunctionManager:
    def __init__(self):
        self._axioms = None

    @property
    def power(self) -> Function:
        return Function("Power", [256, 256], 256)

    def _axiom_table(self) -> Bool:
        """power(256, i) == 256^i for i in [0, 32) — the byte-width
        exponents real contracts compute offsets with."""
        if self._axioms is None:
            n256 = symbol_factory.BitVecVal(256, 256)
            self._axioms = And(
                *(
                    self.power(n256, symbol_factory.BitVecVal(i, 256))
                    == symbol_factory.BitVecVal(256 ** i, 256)
                    for i in range(0, 32)
                )
            )
        return self._axioms

    def create_condition(self, base: BitVec,
                         exponent: BitVec) -> Tuple[BitVec, Bool]:
        """(result term, constraint to append to the state)."""
        applied = self.power(base, exponent)
        if not (base.symbolic or exponent.symbolic):
            folded = symbol_factory.BitVecVal(
                pow(base.value, exponent.value, 1 << 256),
                256,
                annotations=base.annotations.union(exponent.annotations),
            )
            return folded, folded == applied

        condition = And(applied > 0, self._axiom_table())
        if base.value == 256:
            condition = And(
                condition,
                self.power(
                    base,
                    URem(exponent, symbol_factory.BitVecVal(32, 256)),
                )
                == applied,
            )
        return applied, condition


exponent_function_manager = ExponentFunctionManager()
