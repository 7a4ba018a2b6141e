"""Coverage-guided strategy wrapper (capability parity:
mythril/laser/plugin/plugins/coverage/coverage_strategy.py:6-41)."""

from ....state.global_state import GlobalState
from ....strategy import BasicSearchStrategy
from .coverage_plugin import InstructionCoveragePlugin


class CoverageStrategy(BasicSearchStrategy):
    """Prefers states standing on not-yet-covered instructions."""

    def __init__(self, super_strategy: BasicSearchStrategy,
                 coverage_plugin: InstructionCoveragePlugin):
        self.super_strategy = super_strategy
        self.coverage_plugin = coverage_plugin
        BasicSearchStrategy.__init__(
            self, super_strategy.work_list, super_strategy.max_depth
        )

    def get_strategic_global_state(self) -> GlobalState:
        for state in self.work_list:
            if not self._is_covered(state):
                self.work_list.remove(state)
                return state
        return self.super_strategy.get_strategic_global_state()

    def _is_covered(self, global_state: GlobalState) -> bool:
        bytecode = global_state.environment.code.bytecode
        index = global_state.mstate.pc
        return self.coverage_plugin.is_instruction_covered(
            bytecode, index
        )
