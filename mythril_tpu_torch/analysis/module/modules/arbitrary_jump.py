"""Arbitrary-jump detector (capability parity:
mythril/analysis/module/modules/arbitrary_jump.py:43-115)."""

import logging

from ....exceptions import UnsatError
from ....laser.state.global_state import GlobalState
from ....smt import And, BitVec, symbol_factory
from ....support.model import get_model
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import ARBITRARY_JUMP
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


def is_unique_jumpdest(jump_dest: BitVec, state: GlobalState) -> bool:
    """True when the symbolic destination can only take one value under
    the path constraints."""
    try:
        model = get_model(state.world_state.constraints)
    except UnsatError:
        return True
    concrete_jump_dest = model.eval(jump_dest, model_completion=True)
    try:
        get_model(
            state.world_state.constraints
            + [
                symbol_factory.BitVecVal(concrete_jump_dest.value, 256)
                != jump_dest
            ]
        )
    except UnsatError:
        return True
    return False


class ArbitraryJump(DetectionModule):
    """Searches for JUMPs to a user-specified location."""

    name = "Caller can redirect execution to arbitrary bytecode locations"
    swc_id = ARBITRARY_JUMP
    description = "Search for jumps to arbitrary locations in the bytecode"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMP", "JUMPI"]

    def _execute(self, state: GlobalState):
        return self._analyze_state(state)

    def _analyze_state(self, state):
        jump_dest = state.mstate.stack[-1]
        if jump_dest.symbolic is False:
            return []
        if is_unique_jumpdest(jump_dest, state) is True:
            return []
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            return []
        log.info("Detected arbitrary jump dest")
        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=state.get_current_instruction()["address"],
            swc_id=ARBITRARY_JUMP,
            title="Jump to an arbitrary instruction",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head=(
                "The caller can redirect execution to arbitrary bytecode "
                "locations."
            ),
            description_tail=(
                "It is possible to redirect the control flow to arbitrary "
                "locations in the code. This may allow an attacker to "
                "bypass security controls or manipulate the business "
                "logic of the smart contract. Avoid using "
                "low-level-operations and assembly to prevent this issue."
            ),
            gas_used=(
                state.mstate.min_gas_used, state.mstate.max_gas_used
            ),
            transaction_sequence=transaction_sequence,
        )
        state.annotate(
            IssueAnnotation(
                conditions=[And(*state.world_state.constraints)],
                issue=issue,
                detector=self,
            )
        )
        return [issue]


detector = ArbitraryJump()
