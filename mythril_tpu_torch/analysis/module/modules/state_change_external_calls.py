"""State-change-after-external-call detector (capability parity:
mythril/analysis/module/modules/state_change_external_calls.py:104-205
— restructured around a shared call-gate constraint builder and a
single sat-probe helper instead of the reference's three inline
get_model/UnsatError blocks)."""

import logging
from copy import copy
from typing import List, Optional

from ....exceptions import UnsatError
from ....laser.state.annotation import StateAnnotation
from ....laser.state.constraints import Constraints
from ....laser.state.global_state import GlobalState
from ....smt import BitVec, Or, UGT, symbol_factory
from ....support.model import get_model
from ...potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from ...solver import get_transaction_sequence
from ...swc_data import REENTRANCY
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)

CALL_LIST = ["CALL", "DELEGATECALL", "CALLCODE"]
STATE_READ_WRITE_LIST = ["SSTORE", "SLOAD", "CREATE", "CREATE2"]

def _attacker_address():
    """The attacker-controlled callee the user-defined-address
    refinement pins the target to — read from the ACTORS registry so a
    reconfigured attacker address keeps the probe and the entry-state
    caller constraints in lockstep."""
    from ....laser.transaction import ACTORS

    return ACTORS.attacker


def _call_gate(call_state: GlobalState) -> List:
    """Constraints under which a CALL forwards enough gas to re-enter
    (more than the 2300 stipend) to a non-precompile target."""
    gas = call_state.mstate.stack[-1]
    to = call_state.mstate.stack[-2]
    return [
        UGT(gas, symbol_factory.BitVecVal(2300, 256)),
        Or(
            to > symbol_factory.BitVecVal(16, 256),
            to == symbol_factory.BitVecVal(0, 256),
        ),
    ]


def _satisfiable(constraints) -> bool:
    try:
        get_model(constraints)
        return True
    except UnsatError:
        return False


class StateChangeCallsAnnotation(StateAnnotation):
    """Rides a state from an open call site; collects the state
    accesses that follow it."""

    def __init__(self, call_state: GlobalState,
                 user_defined_address: bool) -> None:
        self.call_state = call_state
        self.state_change_states: List[GlobalState] = []
        self.user_defined_address = user_defined_address

    def __copy__(self):
        clone = StateChangeCallsAnnotation(
            self.call_state, self.user_defined_address
        )
        clone.state_change_states = self.state_change_states[:]
        return clone

    def get_issue(self, global_state: GlobalState,
                  detector) -> Optional[PotentialIssue]:
        if not self.state_change_states:
            return None
        constraints = Constraints(_call_gate(self.call_state))
        if self.user_defined_address:
            to = self.call_state.mstate.stack[-2]
            constraints += [to == _attacker_address()]
        try:
            get_transaction_sequence(
                global_state,
                constraints + global_state.world_state.constraints,
            )
        except UnsatError:
            return None

        instruction = global_state.get_current_instruction()
        access = (
            "Read of" if instruction["opcode"] == "SLOAD"
            else "Write to"
        )
        address_type = (
            "user defined" if self.user_defined_address else "fixed"
        )
        log.debug(
            "[STATE_CHANGE] Detected state changes at address: %s",
            instruction["address"],
        )
        return PotentialIssue(
            contract=global_state.environment.active_account
            .contract_name,
            function_name=global_state.environment.active_function_name,
            address=instruction["address"],
            title="State access after external call",
            severity="Medium" if self.user_defined_address else "Low",
            description_head=(
                f"{access} persistent state following external call"
            ),
            description_tail=(
                "The contract account state is accessed after an "
                f"external call to a {address_type} address. To "
                "prevent reentrancy issues, consider accessing the "
                "state only before the call, especially if the callee "
                "is untrusted. Alternatively, a reentrancy lock can be "
                "used to prevent untrusted callees from re-entering "
                "the contract in an intermediate state."
            ),
            swc_id=REENTRANCY,
            bytecode=global_state.environment.code.bytecode,
            constraints=constraints,
            detector=detector,
        )


class StateChangeAfterCall(DetectionModule):
    """Searches for state changes after low-level calls that forward gas
    to the callee."""

    name = "State change after an external call"
    swc_id = REENTRANCY
    description = (
        "Check whether the account state is accessed after the execution "
        "of an external call"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = CALL_LIST + STATE_READ_WRITE_LIST

    def _execute(self, state: GlobalState) -> None:
        issues = self._analyze_state(state)
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(issues)

    def _analyze_state(self, global_state: GlobalState
                       ) -> List[PotentialIssue]:
        if (
            global_state.environment.active_function_name
            == "constructor"
        ):
            return []

        annotations = list(
            global_state.get_annotations(StateChangeCallsAnnotation)
        )
        op_code = global_state.get_current_instruction()["opcode"]

        if op_code in STATE_READ_WRITE_LIST:
            if not annotations:
                return []
            for annotation in annotations:
                annotation.state_change_states.append(global_state)
        elif op_code in CALL_LIST:
            # value transfers count as state changes too
            if self._transfers_value(global_state):
                for annotation in annotations:
                    annotation.state_change_states.append(global_state)
            self._open_call_site(global_state)

        issues = []
        for annotation in annotations:
            issue = annotation.get_issue(global_state, self)
            if issue:
                issues.append(issue)
        return issues

    @staticmethod
    def _open_call_site(global_state: GlobalState) -> None:
        """Annotate a call that can forward gas to a re-entering
        callee; severity refines on whether the target can be the
        attacker's own address."""
        base = copy(global_state.world_state.constraints)
        if not _satisfiable(base + _call_gate(global_state)):
            return
        to = global_state.mstate.stack[-2]
        user_defined = _satisfiable(base + [to == _attacker_address()])
        global_state.annotate(
            StateChangeCallsAnnotation(global_state, user_defined)
        )

    @staticmethod
    def _transfers_value(global_state: GlobalState) -> bool:
        value: BitVec = global_state.mstate.stack[-3]
        if not value.symbolic:
            return value.value > 0
        return _satisfiable(
            copy(global_state.world_state.constraints)
            + [value > symbol_factory.BitVecVal(0, 256)]
        )


detector = StateChangeAfterCall()
