"""Unchecked return-value detector (capability parity:
mythril/analysis/module/modules/unchecked_retval.py:38-145)."""

import logging
from copy import copy
from typing import Dict, List

from ....exceptions import UnsatError
from ....laser.state.annotation import StateAnnotation
from ....laser.state.global_state import GlobalState
from ....smt import And
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import UNCHECKED_RET_VAL
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class UncheckedRetvalAnnotation(StateAnnotation):
    def __init__(self) -> None:
        self.retvals: List[Dict] = []

    def __copy__(self):
        result = UncheckedRetvalAnnotation()
        result.retvals = copy(self.retvals)
        return result


class UncheckedRetval(DetectionModule):
    """Tests whether CALL return values are ever constrained on the path:
    if both retval==0 and retval==1 stay satisfiable at transaction end,
    the value was never checked."""

    name = "Return value of an external call is not checked"
    swc_id = UNCHECKED_RET_VAL
    description = (
        "Test whether CALL return value is checked. For direct calls the "
        "Solidity compiler auto-generates this check; for "
        "low-level-calls the check is omitted."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP", "RETURN"]
    post_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _execute(self, state: GlobalState) -> List[Issue]:
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> list:
        instruction = state.get_current_instruction()

        annotations = [
            a for a in state.get_annotations(UncheckedRetvalAnnotation)
        ]
        if len(annotations) == 0:
            state.annotate(UncheckedRetvalAnnotation())
            annotations = [
                a
                for a in state.get_annotations(UncheckedRetvalAnnotation)
            ]
        retvals = annotations[0].retvals

        if instruction["opcode"] in ("STOP", "RETURN"):
            issues = []
            for retval in retvals:
                try:
                    # unconstrained iff both 0 and 1 remain satisfiable
                    get_transaction_sequence(
                        state,
                        state.world_state.constraints
                        + [retval["retval"] == 1],
                    )
                    transaction_sequence = get_transaction_sequence(
                        state,
                        state.world_state.constraints
                        + [retval["retval"] == 0],
                    )
                except UnsatError:
                    continue

                description_tail = (
                    "External calls return a boolean value. If the callee "
                    "halts with an exception, 'false' is returned and "
                    "execution continues in the caller. The caller should "
                    "check whether an exception happened and react "
                    "accordingly to avoid unexpected behavior. For "
                    "example it is often desirable to wrap external calls "
                    "in require() so the transaction is reverted if the "
                    "call fails."
                )
                issue = Issue(
                    contract=state.environment.active_account
                    .contract_name,
                    function_name=state.environment.active_function_name,
                    address=retval["address"],
                    bytecode=state.environment.code.bytecode,
                    title="Unchecked return value from external call.",
                    swc_id=UNCHECKED_RET_VAL,
                    severity="Medium",
                    description_head=(
                        "The return value of a message call is not "
                        "checked."
                    ),
                    description_tail=description_tail,
                    gas_used=(
                        state.mstate.min_gas_used,
                        state.mstate.max_gas_used,
                    ),
                    transaction_sequence=transaction_sequence,
                )
                conditions = [
                    And(
                        *(
                            state.world_state.constraints
                            + [retval["retval"] == 1]
                        )
                    ),
                    And(
                        *(
                            state.world_state.constraints
                            + [retval["retval"] == 0]
                        )
                    ),
                ]
                state.annotate(
                    IssueAnnotation(
                        conditions=conditions, issue=issue, detector=self
                    )
                )
                issues.append(issue)
            return issues

        log.debug("End of call, extracting retval")
        if state.environment.code.instruction_list[state.mstate.pc - 1][
            "opcode"
        ] not in ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]:
            return []
        return_value = state.mstate.stack[-1]
        retvals.append(
            {
                "address": state.instruction["address"] - 1,
                "retval": return_value,
            }
        )
        return []


detector = UncheckedRetval()
