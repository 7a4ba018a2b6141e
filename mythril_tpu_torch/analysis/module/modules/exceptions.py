"""Reachable-exception detector (capability parity:
mythril/analysis/module/modules/exceptions.py:36-153 — restructured:
jump tracking, dedup, and issue building are separate steps, and the
Panic(uint256) REVERT classifier sits beside the selector constant)."""

import logging
from typing import List, Optional

from ....exceptions import UnsatError
from ....laser import util
from ....laser.state.annotation import StateAnnotation
from ....laser.state.global_state import GlobalState
from ....smt import And
from ....support.support_utils import get_code_hash
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import ASSERT_VIOLATION
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)

#: function selector of Panic(uint256)
PANIC_SIGNATURE = [78, 72, 123, 113]

_TAIL = (
    "It is possible to trigger an assertion violation. Note "
    "that Solidity assert() statements should only be used to "
    "check invariants. Review the transaction trace generated "
    "for this issue and either make sure your program logic "
    "is correct, or use require() instead of assert() if your "
    "goal is to constrain user inputs or enforce "
    "preconditions. Remember to validate inputs from both "
    "callers (for instance, via passed arguments) and callees "
    "(for instance, via return values)."
)


def is_assertion_failure(global_state) -> bool:
    """True when a REVERT's return data is Panic(0x01) — the shape
    solc compiles assert() failures to."""
    mstate = global_state.mstate
    offset, length = mstate.stack[-1], mstate.stack[-2]
    try:
        data = mstate.memory[
            util.get_concrete_int(offset):
            util.get_concrete_int(offset + length)
        ]
    except TypeError:  # symbolic offset/length: not a solc panic shape
        return False
    return data[:4] == PANIC_SIGNATURE and data[-1] == 1


class LastJumpAnnotation(StateAnnotation):
    """Tracks the address of the last JUMP (issue location anchor)."""

    def __init__(self, last_jump: Optional[int] = None) -> None:
        self.last_jump: Optional[int] = last_jump

    def __copy__(self):
        return LastJumpAnnotation(self.last_jump)


class Exceptions(DetectionModule):
    """Checks whether any exception states (ASSERT/Panic) are
    reachable."""

    name = "Assertion violation"
    swc_id = ASSERT_VIOLATION
    description = "Checks whether any exception states are reachable."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["INVALID", "JUMP", "REVERT"]

    def __init__(self):
        super().__init__()
        self.auto_cache = False

    def _execute(self, state: GlobalState) -> List[Issue]:
        issues = self._analyze_state(state)
        for issue in issues:
            self.cache.add((issue.source_location, issue.bytecode_hash))
        return issues

    @staticmethod
    def _jump_tracker(state: GlobalState) -> LastJumpAnnotation:
        for annotation in state.get_annotations(LastJumpAnnotation):
            return annotation
        state.annotate(LastJumpAnnotation())
        return next(iter(state.get_annotations(LastJumpAnnotation)))

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        instruction = state.get_current_instruction()
        tracker = self._jump_tracker(state)

        if instruction["opcode"] == "JUMP":
            tracker.last_jump = instruction["address"]
            return []
        if instruction["opcode"] == "REVERT" \
                and not is_assertion_failure(state):
            return []

        anchor = tracker.last_jump
        code = state.environment.code.bytecode
        if (anchor, get_code_hash(code)) in self.cache:
            return []

        log.debug(
            "ASSERT_FAIL/REVERT in function %s",
            state.environment.active_function_name,
        )
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            log.debug("no model found")
            return []

        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=instruction["address"],
            swc_id=ASSERT_VIOLATION,
            title="Exception State",
            severity="Medium",
            description_head="An assertion violation was triggered.",
            description_tail=_TAIL,
            bytecode=code,
            transaction_sequence=transaction_sequence,
            gas_used=(
                state.mstate.min_gas_used,
                state.mstate.max_gas_used,
            ),
            source_location=anchor,
        )
        state.annotate(
            IssueAnnotation(
                conditions=[And(*state.world_state.constraints)],
                issue=issue,
                detector=self,
            )
        )
        return [issue]


detector = Exceptions()
