"""Unprotected ether withdrawal detector (capability parity:
mythril/analysis/module/modules/ether_thief.py:27-99)."""

import logging
from copy import copy

from ....exceptions import UnsatError
from ....laser.state.global_state import GlobalState
from ....laser.transaction.symbolic import ACTORS
from ....smt import UGT
from ....support.model import get_model
from ...potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from ...swc_data import UNPROTECTED_ETHER_WITHDRAWAL
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class EtherThief(DetectionModule):
    """Searches for valid end states where the attacker's balance strictly
    increased."""

    name = "Any sender can withdraw ETH from the contract account"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = (
        "Search for cases where Ether can be withdrawn to a "
        "user-specified address."
    )
    entry_point = EntryPoint.CALLBACK
    post_hooks = ["CALL", "STATICCALL"]

    def _execute(self, state: GlobalState) -> None:
        potential_issues = self._analyze_state(state)
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(potential_issues)

    def _analyze_state(self, state):
        state = copy(state)
        instruction = state.get_current_instruction()
        constraints = copy(state.world_state.constraints)

        constraints += [
            UGT(
                state.world_state.balances[ACTORS.attacker],
                state.world_state.starting_balances[ACTORS.attacker],
            ),
            state.environment.sender == ACTORS.attacker,
            state.current_transaction.caller
            == state.current_transaction.origin,
        ]

        try:
            # pre-solve: only queue the potential issue when an
            # attacker-profit model exists at all
            get_model(constraints)
            potential_issue = PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                # post hook: anchor at the previous instruction's offset
                address=instruction["address"] - 1,
                swc_id=UNPROTECTED_ETHER_WITHDRAWAL,
                title="Unprotected Ether Withdrawal",
                severity="High",
                bytecode=state.environment.code.bytecode,
                description_head=(
                    "Any sender can withdraw Ether from the contract "
                    "account."
                ),
                description_tail=(
                    "Arbitrary senders other than the contract creator "
                    "can profitably extract Ether from the contract "
                    "account. Verify the business logic carefully and "
                    "make sure that appropriate security controls are in "
                    "place to prevent unexpected loss of funds."
                ),
                detector=self,
                constraints=constraints,
            )
            return [potential_issue]
        except UnsatError:
            return []


detector = EtherThief()
