"""Search-strategy protocol (reference parity:
mythril/laser/ethereum/strategy/__init__.py:6-53 — restructured for the
lane engine: depth filtering is an iterative loop instead of recursion
(deep over-budget runs blew the recursion limit), and strategies expose
a batch-drain hook the TPU lane sweep uses to pull device-eligible
states without breaking strategy-specific ordering)."""

from abc import ABC, abstractmethod
from typing import Callable, List

from ..state.global_state import GlobalState


class BasicSearchStrategy(ABC):
    """Iterates the work list in strategy order, skipping states past
    the depth bound."""

    def __init__(self, work_list, max_depth, **kwargs):
        self.work_list: List[GlobalState] = work_list
        self.max_depth = max_depth

    def __iter__(self):
        return self

    @abstractmethod
    def get_strategic_global_state(self) -> GlobalState:
        raise NotImplementedError("Must be implemented by a subclass")

    def run_check(self) -> bool:
        return True

    def __next__(self) -> GlobalState:
        while True:
            try:
                state = self.get_strategic_global_state()
            except (IndexError, StopIteration):
                raise StopIteration
            if state.mstate.depth < self.max_depth:
                return state

    def drain_eligible(
        self, predicate: Callable[[GlobalState], bool]
    ) -> List[GlobalState]:
        """Remove and return every work-list state the predicate
        accepts, preserving work-list order for the rest.  The lane
        sweep (svm._lane_engine_sweep) uses this to claim the states
        the device can seed; strategies that keep auxiliary structures
        beside the work list should override it to stay consistent."""
        taken, kept = [], []
        for state in self.work_list:
            (taken if predicate(state) else kept).append(state)
        self.work_list[:] = kept
        return taken


class CriterionSearchStrategy(BasicSearchStrategy):
    """Halts the search once set_criterion_satisfied() is called."""

    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth, **kwargs)
        self._satisfied_criterion = False

    def get_strategic_global_state(self) -> GlobalState:
        if self._satisfied_criterion:
            raise StopIteration
        return super().get_strategic_global_state()

    def set_criterion_satisfied(self):
        self._satisfied_criterion = True
