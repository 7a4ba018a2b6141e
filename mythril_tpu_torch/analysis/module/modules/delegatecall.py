"""Insecure delegatecall detector (capability parity:
mythril/analysis/module/modules/delegatecall.py:22-99)."""

import logging
from typing import List

from ....laser.state.global_state import GlobalState
from ....laser.transaction.symbolic import ACTORS
from ....laser.transaction.transaction_models import (
    ContractCreationTransaction,
)
from ....smt import UGT, symbol_factory
from ...potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from ...swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class ArbitraryDelegateCall(DetectionModule):
    """Detects delegatecall to a user-supplied address."""

    name = "Delegatecall to a user-specified address"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = (
        "Check for invocations of delegatecall to a user-supplied address."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["DELEGATECALL"]

    def _execute(self, state: GlobalState) -> None:
        potential_issues = self._analyze_state(state)
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(potential_issues)

    def _analyze_state(self, state: GlobalState) -> List[PotentialIssue]:
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]

        constraints = [
            to == ACTORS.attacker,
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
            state.new_bitvec(
                "retval_{}".format(
                    state.get_current_instruction()["address"]
                ),
                256,
            )
            == 1,
        ]
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                constraints.append(tx.caller == ACTORS.attacker)

        address = state.get_current_instruction()["address"]
        log.debug(
            "[DELEGATECALL] Detected potential delegatecall to a "
            "user-supplied address: %s",
            address,
        )
        return [
            PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=address,
                swc_id=DELEGATECALL_TO_UNTRUSTED_CONTRACT,
                bytecode=state.environment.code.bytecode,
                title="Delegatecall to user-supplied address",
                severity="High",
                description_head=(
                    "The contract delegates execution to another contract "
                    "with a user-supplied address."
                ),
                description_tail=(
                    "The smart contract delegates execution to a "
                    "user-supplied address. This could allow an attacker "
                    "to execute arbitrary code in the context of this "
                    "contract account and manipulate the state of the "
                    "contract account or execute actions on its behalf."
                ),
                constraints=constraints,
                detector=self,
            )
        ]


detector = ArbitraryDelegateCall()
