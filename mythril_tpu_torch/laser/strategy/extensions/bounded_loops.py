"""Loop-bound strategy wrapper: prunes states that revisit the same
JUMPDEST trace cycle more than `loop_bound` times (capability parity:
mythril/laser/ethereum/strategy/extensions/bounded_loops.py:27-145)."""

import logging
from copy import copy
from typing import Dict, List

from ...state.annotation import StateAnnotation
from ...state.global_state import GlobalState
from ...transaction import ContractCreationTransaction
from .. import BasicSearchStrategy

log = logging.getLogger(__name__)


class JumpdestCountAnnotation(StateAnnotation):
    """Tracks the sequence of executed instruction addresses."""

    def __init__(self) -> None:
        self._reached_count: Dict[int, int] = {}
        self.trace: List[int] = []

    def __copy__(self):
        result = JumpdestCountAnnotation()
        result._reached_count = copy(self._reached_count)
        result.trace = copy(self.trace)
        return result


def _cycle_count(trace: List[int]) -> int:
    """Number of consecutive repetitions of the trailing cycle in the
    trace. The trailing cycle is located by searching backwards for the
    most recent re-occurrence of the last two entries."""
    n = len(trace)
    if n < 4:
        return 0
    start = -1
    for i in range(n - 3, -1, -1):
        if trace[i] == trace[n - 2] and trace[i + 1] == trace[n - 1]:
            start = i
            break
    if start < 0:
        return 0
    size = (n - 2) - start
    if size <= 0:
        return 0
    # count repetitions of the *trailing* window (the found window itself
    # counts as one — matches reference get_loop_count,
    # strategy/extensions/bounded_loops.py:102-145)
    cycle = trace[n - size : n]
    count = 1
    i = n - 2 * size
    while i >= 0 and trace[i : i + size] == cycle:
        count += 1
        i -= size
    return count


class BoundedLoopsStrategy(BasicSearchStrategy):
    """Wraps another strategy, skipping states beyond the loop bound."""

    def __init__(self, super_strategy: BasicSearchStrategy,
                 **kwargs) -> None:
        self.super_strategy = super_strategy
        self.bound = kwargs["loop_bound"]
        log.info(
            "Loaded search strategy extension: Loop bounds (limit = %d)",
            self.bound,
        )
        BasicSearchStrategy.__init__(
            self, super_strategy.work_list, super_strategy.max_depth,
            **kwargs
        )

    def get_strategic_global_state(self) -> GlobalState:
        while True:
            state = self.super_strategy.get_strategic_global_state()

            annotations = list(
                state.get_annotations(JumpdestCountAnnotation)
            )
            if len(annotations) == 0:
                annotation = JumpdestCountAnnotation()
                state.annotate(annotation)
            else:
                annotation = annotations[0]

            cur_instr = state.get_current_instruction()
            annotation.trace.append(cur_instr["address"])

            if cur_instr["opcode"].upper() != "JUMPDEST":
                return state

            # verified loop-summary application (docs/static_pass.md,
            # MTPU_LOOPSUM): a state at a recognized counter-loop head
            # whose closed form is solver-verified jumps straight to
            # the loop exit with the summarized counter/gas/depth
            # effects instead of unrolling; an instance the bound
            # would have pruned retires without burning bound+1
            # iterations first. Declined/unverified instances fall
            # through to the cycle scan below bit-for-bit.
            action = self._loopsum_apply(state)
            if action == "applied":
                return state
            if action == "retire":
                log.debug("loop summary: bound-exceeded head retired")
                continue

            # static loop-head feed (analysis/static_pass, MTPU_STATIC):
            # a JUMPDEST outside every non-trivial SCC of this code's
            # conservative CFG cannot sit on a repeating cycle of this
            # code, so the O(trace) backward scan below is skipped
            # there. Cross-code cycles (A calls B in a loop) still
            # prune — at A's own cycle JUMPDEST, at most a fraction of
            # one iteration later (PARITY.md).
            cycle_pcs = self._static_cycle_pcs(state)
            if cycle_pcs is not None \
                    and cur_instr["address"] not in cycle_pcs:
                return state

            count = _cycle_count(annotation.trace)

            # creation code gets a much higher bound: constructors often
            # loop over code-size-dependent counts
            if isinstance(
                state.current_transaction, ContractCreationTransaction
            ) and count < max(128, self.bound):
                return state
            if count > self.bound:
                log.debug("Loop bound reached, skipping state")
                continue
            return state

    def _loopsum_apply(self, state: GlobalState):
        """Summary application through the static pass's seam; any
        failure degrades to unrolling (None)."""
        try:
            from ....analysis.static_pass import loop_summary

            if not loop_summary.enabled():
                return None
            return loop_summary.maybe_apply(state,
                                            loop_bound=self.bound)
        except Exception as e:
            log.debug("loop-summary application failed: %s", e)
            return None

    @staticmethod
    def _static_cycle_pcs(state: GlobalState):
        """Cycle-candidate JUMPDESTs of the state's code, or None when
        the static pass is off/unavailable (scan everywhere)."""
        try:
            from ....analysis import static_pass

            return static_pass.cycle_pcs_for(state.environment.code)
        except Exception:
            return None

    def run_check(self):
        return self.super_strategy.run_check()
