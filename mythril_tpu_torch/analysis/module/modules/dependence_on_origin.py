"""tx.origin control-flow dependence detector (capability parity:
mythril/analysis/module/modules/dependence_on_origin.py:25-112)."""

import logging
from copy import copy
from typing import List

from ....exceptions import UnsatError
from ....laser.state.global_state import GlobalState
from ....smt import And
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import TX_ORIGIN_USAGE
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class TxOriginAnnotation:
    """Taint marker placed on values produced by ORIGIN."""


class TxOrigin(DetectionModule):
    """Detects control-flow decisions based on the transaction origin."""

    name = "Control flow depends on tx.origin"
    swc_id = TX_ORIGIN_USAGE
    description = (
        "Check whether control flow decisions are influenced by tx.origin"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]

    def _execute(self, state: GlobalState) -> List[Issue]:
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        issues = []
        if state.get_current_instruction()["opcode"] == "JUMPI":
            # JUMPI pre-hook: check the branch condition for origin taint
            for annotation in state.mstate.stack[-2].annotations:
                if isinstance(annotation, TxOriginAnnotation):
                    constraints = copy(state.world_state.constraints)
                    try:
                        transaction_sequence = (
                            get_transaction_sequence(state, constraints)
                        )
                    except UnsatError:
                        continue
                    description = (
                        "The tx.origin environment variable has been "
                        "found to influence a control flow decision. Note "
                        "that using tx.origin as a security control might "
                        "cause a situation where a user inadvertently "
                        "authorizes a smart contract to perform an action "
                        "on their behalf. It is recommended to use "
                        "msg.sender instead."
                    )
                    issue = Issue(
                        contract=state.environment.active_account
                        .contract_name,
                        function_name=state.environment
                        .active_function_name,
                        address=state.get_current_instruction()[
                            "address"
                        ],
                        swc_id=TX_ORIGIN_USAGE,
                        bytecode=state.environment.code.bytecode,
                        title="Dependence on tx.origin",
                        severity="Low",
                        description_head=(
                            "Use of tx.origin as a part of authorization "
                            "control."
                        ),
                        description_tail=description,
                        gas_used=(
                            state.mstate.min_gas_used,
                            state.mstate.max_gas_used,
                        ),
                        transaction_sequence=transaction_sequence,
                    )
                    state.annotate(
                        IssueAnnotation(
                            conditions=[And(*constraints)],
                            issue=issue,
                            detector=self,
                        )
                    )
                    issues.append(issue)
        else:
            # ORIGIN post-hook: taint the pushed value
            state.mstate.stack[-1].annotate(TxOriginAnnotation())
        return issues


detector = TxOrigin()
