"""Delayed-constraint strategy: defer states whose constraints don't pass a
quick model-cache check, solving them lazily only when the worklist runs dry
(capability parity:
mythril/laser/ethereum/strategy/constraint_strategy.py:20-46)."""

import logging
from typing import List

from ...smt import And, simplify
from ...support.model import model_cache
from ..state.global_state import GlobalState
from . import BasicSearchStrategy

log = logging.getLogger(__name__)


class DelayConstraintStrategy(BasicSearchStrategy):
    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth)
        self.model_cache = model_cache
        self.pending_worklist: List[GlobalState] = []
        log.info("Loaded search strategy extension: DelayConstraintStrategy")

    def get_strategic_global_state(self) -> GlobalState:
        """Pop states whose constraints re-evaluate true under a cached
        model; otherwise defer them. When everything is deferred, fall back
        to solving the first pending state."""
        while True:
            if len(self.work_list) == 0:
                if len(self.pending_worklist) == 0:
                    raise StopIteration
                state = self.pending_worklist.pop(0)
                return state
            state = self.work_list.pop(0)
            c_val = self.model_cache.check_quick_sat(
                simplify(
                    And(*state.world_state.constraints)
                ).raw
            )
            if c_val:
                return state
            self.pending_worklist.append(state)
