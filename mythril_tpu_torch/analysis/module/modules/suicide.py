"""Unprotected SELFDESTRUCT detector (capability parity:
mythril/analysis/module/modules/suicide.py:25-126)."""

import logging

from ....exceptions import UnsatError
from ....laser.state.global_state import GlobalState
from ....laser.transaction.symbolic import ACTORS
from ....laser.transaction.transaction_models import (
    ContractCreationTransaction,
)
from ....smt import And
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import UNPROTECTED_SELFDESTRUCT
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class AccidentallyKillable(DetectionModule):
    """Checks whether anyone can kill the contract; tries to also steer the
    balance to the attacker."""

    name = "Contract can be accidentally killed by anyone"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = (
        "Check if the contract can be killed by anyone; for killable "
        "contracts, also check whether the balance can be sent to the "
        "attacker."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SELFDESTRUCT"]

    def _execute(self, state: GlobalState):
        return self._analyze_state(state)

    def _analyze_state(self, state):
        log.info("Suicide module: Analyzing suicide instruction")
        instruction = state.get_current_instruction()
        to = state.mstate.stack[-1]
        log.debug(
            "SELFDESTRUCT in function %s",
            state.environment.active_function_name,
        )

        description_head = (
            "Any sender can cause the contract to self-destruct."
        )

        attacker_constraints = []
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                attacker_constraints.append(
                    And(
                        tx.caller == ACTORS.attacker,
                        tx.caller == tx.origin,
                    )
                )
        try:
            try:
                constraints = (
                    state.world_state.constraints
                    + [to == ACTORS.attacker]
                    + attacker_constraints
                )
                transaction_sequence = get_transaction_sequence(
                    state, constraints
                )
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT "
                    "instruction to destroy this contract account and "
                    "withdraw its balance to an arbitrary address. Review "
                    "the transaction trace generated for this issue and "
                    "make sure that appropriate security controls are in "
                    "place to prevent unrestricted access."
                )
            except UnsatError:
                constraints = (
                    state.world_state.constraints + attacker_constraints
                )
                transaction_sequence = get_transaction_sequence(
                    state, constraints
                )
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT "
                    "instruction to destroy this contract account. Review "
                    "the transaction trace generated for this issue and "
                    "make sure that appropriate security controls are in "
                    "place to prevent unrestricted access."
                )

            issue = Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=instruction["address"],
                swc_id=UNPROTECTED_SELFDESTRUCT,
                bytecode=state.environment.code.bytecode,
                title="Unprotected Selfdestruct",
                severity="High",
                description_head=description_head,
                description_tail=description_tail,
                transaction_sequence=transaction_sequence,
                gas_used=(
                    state.mstate.min_gas_used,
                    state.mstate.max_gas_used,
                ),
            )
            state.annotate(
                IssueAnnotation(
                    conditions=[And(*constraints)],
                    issue=issue,
                    detector=self,
                )
            )
            return [issue]
        except UnsatError:
            log.debug("No model found")
        return []


detector = AccidentallyKillable()
