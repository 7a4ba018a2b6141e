"""Arbitrary storage-write detector (capability parity:
mythril/analysis/module/modules/arbitrary_write.py:21-78)."""

import logging

from ....laser.state.global_state import GlobalState
from ....smt import symbol_factory
from ...potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from ...swc_data import WRITE_TO_ARBITRARY_STORAGE
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class ArbitraryStorage(DetectionModule):
    """Searches for a feasible write to an arbitrary storage slot."""

    name = "Caller can write to arbitrary storage locations"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = "Search for any writes to an arbitrary storage slot"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]

    def _execute(self, state: GlobalState) -> None:
        potential_issues = self._analyze_state(state)
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(potential_issues)

    def _analyze_state(self, state):
        from ....support.eth_constants import ARB_PROBE_SLOT

        write_slot = state.mstate.stack[-1]
        # a write is arbitrary if the slot can equal a random probe
        # value (single source: support/eth_constants.py; the device
        # stepper mints a sink record for a concrete write to it)
        constraints = state.world_state.constraints + [
            write_slot == symbol_factory.BitVecVal(ARB_PROBE_SLOT, 256)
        ]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=state.get_current_instruction()["address"],
            swc_id=WRITE_TO_ARBITRARY_STORAGE,
            title="Write to an arbitrary storage location",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head=(
                "The caller can write to arbitrary storage locations."
            ),
            description_tail=(
                "It is possible to write to arbitrary storage locations. "
                "By modifying the values of storage variables, attackers "
                "may bypass security controls or manipulate the business "
                "logic of the smart contract."
            ),
            detector=self,
            constraints=constraints,
        )
        return [potential_issue]


detector = ArbitraryStorage()
