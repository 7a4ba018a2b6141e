"""Instruction coverage plugin (capability parity:
mythril/laser/plugin/plugins/coverage/coverage_plugin.py:20-115 —
extended with a device leg: the TPU lane engine executes instructions
without firing execute_state hooks, so this plugin also subscribes to
the lane_coverage hook and merges the device's per-byte-address visited
bitmap, keeping coverage numbers — and the coverage-driven search
strategy that reads them — correct whichever engine ran the step)."""

import logging
from typing import Dict, List, Tuple

from ....state.global_state import GlobalState
from ...builder import PluginBuilder
from ...interface import LaserPlugin

log = logging.getLogger(__name__)


class CoveragePluginBuilder(PluginBuilder):
    name = "coverage"

    def __call__(self, *args, **kwargs):
        return InstructionCoveragePlugin()


class InstructionCoveragePlugin(LaserPlugin):
    """Executed / total instructions per bytecode, from both engines."""

    def __init__(self):
        #: code -> (instruction count, per-instruction-index hit flags)
        self.coverage: Dict[str, Tuple[int, List[bool]]] = {}
        self.initial_coverage = 0
        self.tx_id = 0

    def initialize(self, symbolic_vm):
        self.coverage = {}
        self.initial_coverage = 0
        self.tx_id = 0

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(global_state: GlobalState):
            code = global_state.environment.code.bytecode
            bitmap = self._bitmap(
                code, global_state.environment.code.instruction_list
            )
            if global_state.mstate.pc < len(bitmap):
                bitmap[global_state.mstate.pc] = True

        @symbolic_vm.laser_hook("lane_coverage")
        def lane_coverage_hook(code, instruction_list, visited):
            # visited is byte-addressed; the host bitmap is indexed by
            # instruction position
            bitmap = self._bitmap(code, instruction_list)
            limit = len(visited)
            for i, instruction in enumerate(instruction_list):
                address = instruction["address"]
                if address < limit and visited[address]:
                    bitmap[i] = True

        @symbolic_vm.laser_hook("start_sym_trans")
        def start_sym_trans_hook():
            self.initial_coverage = self._get_covered_instructions()

        @symbolic_vm.laser_hook("stop_sym_trans")
        def stop_sym_trans_hook():
            end_coverage = self._get_covered_instructions()
            log.info(
                "Number of new instructions covered in tx %d: %d",
                self.tx_id,
                end_coverage - self.initial_coverage,
            )
            self.tx_id += 1

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            for code, (total, hits) in self.coverage.items():
                percentage = (
                    sum(hits) / float(total) * 100 if total else 0.0
                )
                if isinstance(code, tuple):
                    try:
                        code = bytearray(code).hex()
                    except TypeError:
                        code = "<symbolic code>"
                log.info(
                    "Achieved %.2f%% coverage for code: %s",
                    percentage,
                    code,
                )

    def _bitmap(self, code, instruction_list) -> List[bool]:
        """The hit-flag list for this code, allocating on first sight."""
        entry = self.coverage.get(code)
        if entry is None:
            entry = (
                len(instruction_list),
                [False] * len(instruction_list),
            )
            self.coverage[code] = entry
        return entry[1]

    def _get_covered_instructions(self) -> int:
        return sum(sum(hits) for _, hits in self.coverage.values())

    def is_instruction_covered(self, bytecode, index):
        entry = self.coverage.get(bytecode)
        if entry is None or index >= len(entry[1]):
            return False
        return entry[1][index]
