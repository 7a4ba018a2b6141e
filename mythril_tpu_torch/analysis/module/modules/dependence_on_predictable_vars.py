"""Predictable-variable dependence detector (capability parity:
mythril/analysis/module/modules/dependence_on_predictable_vars.py:36-195)."""

import logging
from typing import List

from ....exceptions import UnsatError
from ....laser.state.annotation import StateAnnotation
from ....laser.state.global_state import GlobalState
from ....smt import And, ULT, symbol_factory
from ....support.model import get_model
from ...issue_annotation import IssueAnnotation
from ...module.module_helpers import is_prehook
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)

predictable_ops = ["COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER"]


class PredictableValueAnnotation:
    """Taint marker for values derived from predictable env variables."""

    def __init__(self, operation: str) -> None:
        self.operation = operation


class OldBlockNumberUsedAnnotation(StateAnnotation):
    """Marks states where BLOCKHASH was called on an old block number."""


class PredictableVariables(DetectionModule):
    """Detects control flow decided by predictable block parameters."""

    name = "Control flow depends on a predictable environment variable"
    swc_id = "{} {}".format(TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS)
    description = (
        "Check whether control flow decisions are influenced by "
        "block.coinbase, block.gaslimit, block.timestamp or block.number."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI", "BLOCKHASH"]
    post_hooks = ["BLOCKHASH"] + predictable_ops

    def _execute(self, state: GlobalState) -> List[Issue]:
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        issues = []
        if is_prehook():
            opcode = state.get_current_instruction()["opcode"]
            if opcode == "JUMPI":
                for annotation in state.mstate.stack[-2].annotations:
                    if not isinstance(
                        annotation, PredictableValueAnnotation
                    ):
                        continue
                    constraints = state.world_state.constraints
                    try:
                        transaction_sequence = (
                            get_transaction_sequence(state, constraints)
                        )
                    except UnsatError:
                        continue
                    description = (
                        annotation.operation
                        + " is used to determine a control flow "
                        "decision. Note that the values of variables "
                        "like coinbase, gaslimit, block number and "
                        "timestamp are predictable and can be "
                        "manipulated by a malicious miner. Also keep in "
                        "mind that attackers know hashes of earlier "
                        "blocks. Don't use any of those environment "
                        "variables as sources of randomness and be "
                        "aware that use of these variables introduces a "
                        "certain level of trust into miners."
                    )
                    swc_id = (
                        TIMESTAMP_DEPENDENCE
                        if "timestamp" in annotation.operation
                        else WEAK_RANDOMNESS
                    )
                    issue = Issue(
                        contract=state.environment.active_account
                        .contract_name,
                        function_name=state.environment
                        .active_function_name,
                        address=state.get_current_instruction()[
                            "address"
                        ],
                        swc_id=swc_id,
                        bytecode=state.environment.code.bytecode,
                        title=(
                            "Dependence on predictable environment "
                            "variable"
                        ),
                        severity="Low",
                        description_head=(
                            "A control flow decision is made based on "
                            "{}.".format(annotation.operation)
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
            elif opcode == "BLOCKHASH":
                param = state.mstate.stack[-1]
                constraint = [
                    ULT(param, state.environment.block_number),
                    ULT(
                        state.environment.block_number,
                        symbol_factory.BitVecVal(2**255, 256),
                    ),
                ]
                try:
                    # the bound on block_number avoids overflow artifacts
                    get_model(
                        state.world_state.constraints + constraint
                    )
                    state.annotate(OldBlockNumberUsedAnnotation())
                except UnsatError:
                    pass
        else:
            # post hook
            opcode = state.environment.code.instruction_list[
                state.mstate.pc - 1
            ]["opcode"]
            if opcode == "BLOCKHASH":
                annotations = list(
                    state.get_annotations(OldBlockNumberUsedAnnotation)
                )
                if len(annotations):
                    state.mstate.stack[-1].annotate(
                        PredictableValueAnnotation(
                            "The block hash of a previous block"
                        )
                    )
            else:
                state.mstate.stack[-1].annotate(
                    PredictableValueAnnotation(
                        "The block.{} environment variable".format(
                            opcode.lower()
                        )
                    )
                )
        return issues


detector = PredictableVariables()
