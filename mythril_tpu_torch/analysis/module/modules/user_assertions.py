"""User-defined assertion detector: AssertionFailed events and mstore
marker patterns (capability parity:
mythril/analysis/module/modules/user_assertions.py:31-129)."""

import logging

from ....exceptions import UnsatError
from ....laser.state.global_state import GlobalState
from ....smt import And, Extract
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import ASSERT_VIOLATION
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)

assertion_failed_hash = (
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
)

mstore_pattern = (
    "0xcafecafecafecafecafecafecafecafecafecafecafecafecafecafecafe"
)


def _decode_abi_string(data: bytes) -> str:
    """Minimal ABI string decoding (offset + length + bytes)."""
    if len(data) < 32:
        return ""
    length = int.from_bytes(data[:32], "big")
    return data[32 : 32 + length].decode("utf8", errors="replace")


class UserAssertions(DetectionModule):
    """Searches for user-supplied exceptions: emit AssertionFailed."""

    name = "A user-defined assertion has been triggered"
    swc_id = ASSERT_VIOLATION
    description = (
        "Search for reachable user-supplied exceptions; report a warning "
        "if an 'AssertionFailed' event can be emitted."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["LOG1", "MSTORE"]

    def _execute(self, state: GlobalState):
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState):
        opcode = state.get_current_instruction()["opcode"]
        message = None
        if opcode == "MSTORE":
            value = state.mstate.stack[-2]
            if value.symbolic:
                return []
            if mstore_pattern not in hex(value.value)[:126]:
                return []
            message = "Failed property id {}".format(
                Extract(15, 0, value).value
            )
        else:
            topic, size, mem_start = state.mstate.stack[-3:]
            if topic.symbolic or topic.value != assertion_failed_hash:
                return []
            if not mem_start.symbolic and not size.symbolic:
                try:
                    raw = bytes(
                        state.mstate.memory[
                            mem_start.value
                            + 32 : mem_start.value
                            + size.value
                        ]
                    )
                    message = _decode_abi_string(raw)
                except Exception:
                    pass
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
            if message:
                description_tail = (
                    "A user-provided assertion failed with the message "
                    "'{}'".format(message)
                )
            else:
                description_tail = "A user-provided assertion failed."
            log.debug("Assertion emitted: %s", description_tail)
            address = state.get_current_instruction()["address"]
            issue = Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=address,
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                description_head="A user-provided assertion failed.",
                description_tail=description_tail,
                bytecode=state.environment.code.bytecode,
                transaction_sequence=transaction_sequence,
                gas_used=(
                    state.mstate.min_gas_used,
                    state.mstate.max_gas_used,
                ),
            )
            state.annotate(
                IssueAnnotation(
                    detector=self,
                    issue=issue,
                    conditions=[And(*state.world_state.constraints)],
                )
            )
            return [issue]
        except UnsatError:
            log.debug("no model found")
        return []


detector = UserAssertions()
