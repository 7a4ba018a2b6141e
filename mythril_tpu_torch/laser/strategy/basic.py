"""Basic search strategies (reference parity:
mythril/laser/ethereum/strategy/basic.py:11-122)."""

from random import choices, randrange
from typing import List

from ..state.global_state import GlobalState
from . import BasicSearchStrategy


class DepthFirstSearchStrategy(BasicSearchStrategy):
    """Follow one path to a leaf, then continue with the next."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop()

    def view_strategic_global_state(self) -> GlobalState:
        return self.work_list[-1]


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    """Execute all states of a level before continuing."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(0)

    def view_strategic_global_state(self) -> GlobalState:
        return self.work_list[0]


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    """Uniform random choice from the worklist."""

    def get_strategic_global_state(self) -> GlobalState:
        if len(self.work_list) > 0:
            return self.work_list.pop(
                randrange(len(self.work_list))
            )
        raise IndexError

    def view_strategic_global_state(self) -> GlobalState:
        if len(self.work_list) > 0:
            return self.work_list[randrange(len(self.work_list))]
        raise IndexError


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """Random choice weighted by 1 / (depth + 1)."""

    def get_strategic_global_state(self) -> GlobalState:
        probability_distribution = [
            1 / (global_state.mstate.depth + 1)
            for global_state in self.work_list
        ]
        return self.work_list.pop(
            choices(
                range(len(self.work_list)),
                probability_distribution,
            )[0]
        )

    def view_strategic_global_state(self) -> GlobalState:
        probability_distribution = [
            1 / (global_state.mstate.depth + 1)
            for global_state in self.work_list
        ]
        return self.work_list[
            choices(
                range(len(self.work_list)), probability_distribution
            )[0]
        ]
