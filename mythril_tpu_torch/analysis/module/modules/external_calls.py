"""Reentrancy-precondition detector: external calls with unrestricted gas
to user-supplied addresses (capability parity:
mythril/analysis/module/modules/external_calls.py:46-121)."""

import logging
from copy import copy

from ....exceptions import UnsatError
from ....laser.natives import PRECOMPILE_COUNT
from ....laser.state.constraints import Constraints
from ....laser.state.global_state import GlobalState
from ....laser.transaction.symbolic import ACTORS
from ....smt import Or, UGT, symbol_factory
from ....support.model import get_model
from ...potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from ...solver import get_transaction_sequence
from ...swc_data import REENTRANCY
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


def _is_precompile_call(global_state: GlobalState):
    to = global_state.mstate.stack[-2]
    constraints = copy(global_state.world_state.constraints)
    constraints += [
        Or(
            to < symbol_factory.BitVecVal(1, 256),
            to > symbol_factory.BitVecVal(PRECOMPILE_COUNT, 256),
        )
    ]
    try:
        get_model(constraints)
        return False
    except UnsatError:
        return True


class ExternalCalls(DetectionModule):
    """Searches for low-level calls that forward all gas to the callee."""

    name = "External call to another contract"
    swc_id = REENTRANCY
    description = (
        "Search for external calls with unrestricted gas to a "
        "user-specified address."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]

    def _execute(self, state: GlobalState) -> None:
        potential_issues = self._analyze_state(state)
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(potential_issues)

    def _analyze_state(self, state: GlobalState):
        if state.environment.active_function_name == "constructor":
            return []

        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        address = state.get_current_instruction()["address"]

        try:
            constraints = Constraints(
                [
                    UGT(gas, symbol_factory.BitVecVal(2300, 256)),
                    to == ACTORS.attacker,
                ]
            )
            get_transaction_sequence(
                state, constraints + state.world_state.constraints
            )
            issue = PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=address,
                swc_id=REENTRANCY,
                title="External Call To User-Supplied Address",
                bytecode=state.environment.code.bytecode,
                severity="Low",
                description_head=(
                    "A call to a user-supplied address is executed."
                ),
                description_tail=(
                    "An external message call to an address specified by "
                    "the caller is executed. Note that the callee account "
                    "might contain arbitrary code and could re-enter any "
                    "function within this contract. Reentering the "
                    "contract in an intermediate state may lead to "
                    "unexpected behaviour. Make sure that no state "
                    "modifications are executed after this call and/or "
                    "reentrancy guards are in place."
                ),
                constraints=constraints,
                detector=self,
            )
        except UnsatError:
            log.debug("[EXTERNAL_CALLS] No model found.")
            return []
        return [issue]


detector = ExternalCalls()
