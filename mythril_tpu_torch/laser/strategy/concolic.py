"""Concolic strategy: follow a recorded trace, flipping chosen JUMPI
branches and emitting new concrete inputs (capability parity:
mythril/laser/ethereum/strategy/concolic.py:37-131)."""

import logging
from typing import Dict, List

from ...analysis.solver import get_transaction_sequence
from ...exceptions import UnsatError
from ...smt import Not, simplify
from ..state.annotation import StateAnnotation
from ..state.global_state import GlobalState
from ..transaction import tx_id_manager
from . import CriterionSearchStrategy

log = logging.getLogger(__name__)


class TraceAnnotation(StateAnnotation):
    """Annotation tracking the (pc-address) trace of a state."""

    def __init__(self, trace=None):
        self.trace = trace or []

    @property
    def persist_over_calls(self) -> bool:
        return True

    def __copy__(self):
        return TraceAnnotation(list(self.trace))


class ConcolicStrategy(CriterionSearchStrategy):
    """Follows a recorded trace; at flip addresses, negates the last
    constraint and records a new concrete transaction sequence."""

    def __init__(self, work_list, max_depth, trace, flip_branch_addresses):
        super().__init__(work_list, max_depth)
        self.trace: List = []
        for trx_trace in trace:
            self.trace.extend(trx_trace)
        self.last_tx_count = len(trace)
        self.flip_branch_addresses = flip_branch_addresses
        self.results: Dict[str, Dict] = {}

    def check_completion_criterion(self):
        if len(self.flip_branch_addresses) == len(self.results):
            self.set_criterion_satisfied()

    def get_strategic_global_state(self) -> GlobalState:
        while len(self.work_list) > 0:
            state = self.work_list.pop()
            annotations = [
                a for a in state.annotations
                if isinstance(a, TraceAnnotation)
            ]
            if annotations:
                annotation = annotations[0]
            else:
                annotation = TraceAnnotation()
                state.annotate(annotation)

            address = state.get_current_instruction()["address"]
            annotation.trace.append(address)

            # deviated from the recorded trace?
            if (
                len(annotation.trace) > len(self.trace)
                or annotation.trace[-1]
                != self.trace[len(annotation.trace) - 1]
            ):
                # this is a flipped branch path: solve for inputs
                flip_addr = str(annotation.trace[-2]) if len(
                    annotation.trace
                ) >= 2 else str(address)
                if (
                    flip_addr in map(str, self.flip_branch_addresses)
                    and flip_addr not in self.results
                ):
                    try:
                        self.results[flip_addr] = get_transaction_sequence(
                            state, state.world_state.constraints
                        )
                    except UnsatError:
                        log.debug("branch flip unsat at %s", flip_addr)
                    self.check_completion_criterion()
                continue
            return state
        raise StopIteration
