"""Integer overflow/underflow detector (capability parity:
mythril/analysis/module/modules/integer.py:65-349).

Taint-based two-phase scheme: arithmetic ops annotate their results with an
overflow-possibility constraint; at sinks (SSTORE/JUMPI/CALL/RETURN) the
taint is promoted to the state; at transaction end each promoted taint is
solved together with the path constraints."""

import logging
from copy import copy
from math import ceil, log2
from typing import List, Set

from ....exceptions import UnsatError
from ....laser.state.annotation import StateAnnotation
from ....laser.state.global_state import GlobalState
from ....smt import (
    And,
    BitVec,
    Bool,
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Expression,
    If,
    Not,
    symbol_factory,
)
from ....support.model import get_model
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class OverUnderflowAnnotation:
    """Symbol annotation: this value may have over/underflowed."""

    def __init__(self, overflowing_state: GlobalState, operator: str,
                 constraint: Bool) -> None:
        self.overflowing_state = overflowing_state
        self.operator = operator
        self.constraint = constraint

    def __deepcopy__(self, memodict={}):
        return copy(self)


class OverUnderflowStateAnnotation(StateAnnotation):
    """State annotation: tainted value reached a sink on this path."""

    def __init__(self) -> None:
        self.overflowing_state_annotations: Set[OverUnderflowAnnotation] \
            = set()

    def __copy__(self):
        new_annotation = OverUnderflowStateAnnotation()
        new_annotation.overflowing_state_annotations = copy(
            self.overflowing_state_annotations
        )
        return new_annotation


def arithmetic_overflow_constraint(opname: str, op0: BitVec,
                                   op1: BitVec):
    """(constraint, operator-name) the pre-hooks attach for one
    arithmetic op, or (None, name) when the op can't overflow. Shared
    between the interpreter hooks below and the lane engine's drain-time
    adapter (lane_adapters.IntegerAdapter), so device-executed paths
    annotate identically."""
    if opname == "ADD":
        return Not(BVAddNoOverflow(op0, op1, False)), "addition"
    if opname == "SUB":
        return Not(BVSubNoUnderflow(op0, op1, False)), "subtraction"
    if opname == "MUL":
        return Not(BVMulNoOverflow(op0, op1, False)), "multiplication"
    if opname == "EXP":
        if (op1.symbolic is False and op1.value == 0) or (
            op0.symbolic is False and op0.value < 2
        ):
            return None, "exponentiation"
        if op0.symbolic and op1.symbolic:
            constraint = And(
                op1 > symbol_factory.BitVecVal(256, 256),
                op0 > symbol_factory.BitVecVal(1, 256),
            )
        elif op0.symbolic:
            constraint = op0 >= symbol_factory.BitVecVal(
                2 ** ceil(256 / op1.value), 256
            )
        else:
            constraint = op1 >= symbol_factory.BitVecVal(
                ceil(256 / log2(op0.value)), 256
            )
        return constraint, "exponentiation"
    raise ValueError(opname)


class IntegerArithmetics(DetectionModule):
    """Searches for integer over- and underflows."""

    name = "Integer overflow or underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = (
        "For every SUB instruction, check if there's a possible state "
        "where op1 > op0. For every ADD, MUL instruction, check if "
        "there's a possible state where op1 + op0 > 2^256 - 1"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = [
        "ADD", "MUL", "EXP", "SUB", "SSTORE", "JUMPI", "STOP", "RETURN",
        "CALL",
    ]

    def __init__(self) -> None:
        super().__init__()
        self._ostates_satisfiable: Set[GlobalState] = set()
        self._ostates_unsatisfiable: Set[GlobalState] = set()

    def reset_module(self):
        super().reset_module()
        self._ostates_satisfiable = set()
        self._ostates_unsatisfiable = set()

    def _execute(self, state: GlobalState) -> List[Issue]:
        opcode = state.get_current_instruction()["opcode"]
        funcs = {
            "ADD": [self._handle_add],
            "SUB": [self._handle_sub],
            "MUL": [self._handle_mul],
            "SSTORE": [self._handle_sstore],
            "JUMPI": [self._handle_jumpi],
            "CALL": [self._handle_call],
            "RETURN": [
                self._handle_return, self._handle_transaction_end,
            ],
            "STOP": [self._handle_transaction_end],
            "EXP": [self._handle_exp],
        }
        results = []
        for func in funcs[opcode]:
            result = func(state)
            if result and len(result) > 0:
                results += result
        return results

    def _get_args(self, state):
        stack = state.mstate.stack
        return (
            self._make_bitvec_if_not(stack, -1),
            self._make_bitvec_if_not(stack, -2),
        )

    def _handle_add(self, state):
        self._annotate_arith(state, "ADD")

    def _handle_mul(self, state):
        self._annotate_arith(state, "MUL")

    def _handle_sub(self, state):
        self._annotate_arith(state, "SUB")

    def _handle_exp(self, state):
        self._annotate_arith(state, "EXP")

    def _annotate_arith(self, state, opname):
        op0, op1 = self._get_args(state)
        constraint, operator = arithmetic_overflow_constraint(
            opname, op0, op1
        )
        if constraint is None:
            return
        op0.annotate(
            OverUnderflowAnnotation(state, operator, constraint)
        )

    @staticmethod
    def _make_bitvec_if_not(stack, index):
        value = stack[index]
        if isinstance(value, BitVec):
            return value
        if isinstance(value, Bool):
            return If(value, 1, 0)
        stack[index] = symbol_factory.BitVecVal(value, 256)
        return stack[index]

    @staticmethod
    def _handle_sstore(state: GlobalState) -> None:
        value = state.mstate.stack[-2]
        if not isinstance(value, Expression):
            return
        state_annotation = _get_overflowunderflow_state_annotation(state)
        for annotation in value.annotations:
            if isinstance(annotation, OverUnderflowAnnotation):
                state_annotation.overflowing_state_annotations.add(
                    annotation
                )

    @staticmethod
    def _handle_jumpi(state):
        value = state.mstate.stack[-2]
        state_annotation = _get_overflowunderflow_state_annotation(state)
        for annotation in value.annotations:
            if isinstance(annotation, OverUnderflowAnnotation):
                state_annotation.overflowing_state_annotations.add(
                    annotation
                )

    @staticmethod
    def _handle_call(state):
        value = state.mstate.stack[-3]
        state_annotation = _get_overflowunderflow_state_annotation(state)
        for annotation in value.annotations:
            if isinstance(annotation, OverUnderflowAnnotation):
                state_annotation.overflowing_state_annotations.add(
                    annotation
                )

    @staticmethod
    def _handle_return(state: GlobalState) -> None:
        stack = state.mstate.stack
        offset, length = stack[-1], stack[-2]
        state_annotation = _get_overflowunderflow_state_annotation(state)
        for element in state.mstate.memory[offset : offset + length]:
            if not isinstance(element, Expression):
                continue
            for annotation in element.annotations:
                if isinstance(annotation, OverUnderflowAnnotation):
                    state_annotation.overflowing_state_annotations.add(
                        annotation
                    )

    def _handle_transaction_end(self, state: GlobalState) -> List[Issue]:
        from ....support.support_args import args
        from ....support.support_utils import get_code_hash

        state_annotation = _get_overflowunderflow_state_annotation(state)
        issues = []
        for annotation in state_annotation.overflowing_state_annotations:
            ostate = annotation.overflowing_state
            if ostate in self._ostates_unsatisfiable:
                continue
            # site-level dedup BEFORE the solver: a later tx-end state
            # re-carries every promoted annotation, so without this an
            # already-reported site pays a second feasibility + full
            # tx-sequence optimize whose Issue the report dedup then
            # discards (the reference avoids the rerun only incidentally,
            # via its dependency pruner dropping the revisit path)
            if (
                self.cache
                and self.auto_cache
                and not args.use_issue_annotations
                and (
                    ostate.get_current_instruction()["address"],
                    get_code_hash(ostate.environment.code.bytecode),
                )
                in self.cache
            ):
                continue
            if ostate not in self._ostates_satisfiable:
                try:
                    constraints = ostate.world_state.constraints + [
                        annotation.constraint
                    ]
                    get_model(constraints)
                    self._ostates_satisfiable.add(ostate)
                except Exception:
                    self._ostates_unsatisfiable.add(ostate)
                    continue

            log.debug(
                "Checking overflow at transaction end address %s, "
                "ostate address %s",
                state.get_current_instruction()["address"],
                ostate.get_current_instruction()["address"],
            )
            try:
                constraints = state.world_state.constraints + [
                    annotation.constraint
                ]
                transaction_sequence = get_transaction_sequence(
                    state, constraints
                )
            except UnsatError:
                continue

            description_head = (
                "The arithmetic operator can {}.".format(
                    "underflow"
                    if annotation.operator == "subtraction"
                    else "overflow"
                )
            )
            description_tail = (
                "It is possible to cause an integer overflow or "
                "underflow in the arithmetic operation. Prevent this by "
                "constraining inputs using the require() statement or "
                "use the OpenZeppelin SafeMath library for integer "
                "arithmetic operations. Refer to the transaction trace "
                "generated for this issue to reproduce the issue."
            )
            issue = Issue(
                contract=ostate.environment.active_account.contract_name,
                function_name=ostate.environment.active_function_name,
                address=ostate.get_current_instruction()["address"],
                swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                bytecode=ostate.environment.code.bytecode,
                title="Integer Arithmetic Bugs",
                severity="High",
                description_head=description_head,
                description_tail=description_tail,
                gas_used=(
                    state.mstate.min_gas_used,
                    state.mstate.max_gas_used,
                ),
                transaction_sequence=transaction_sequence,
            )
            state.annotate(
                IssueAnnotation(
                    issue=issue,
                    detector=self,
                    conditions=[And(*constraints)],
                )
            )
            issues.append(issue)
        return issues


detector = IntegerArithmetics()


def _get_overflowunderflow_state_annotation(
    state: GlobalState,
) -> OverUnderflowStateAnnotation:
    state_annotations = list(
        state.get_annotations(OverUnderflowStateAnnotation)
    )
    if len(state_annotations) == 0:
        state_annotation = OverUnderflowStateAnnotation()
        state.annotate(state_annotation)
        return state_annotation
    return state_annotations[0]
