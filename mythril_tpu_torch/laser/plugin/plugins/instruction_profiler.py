"""Per-opcode wall-clock profiler plugin (capability parity:
mythril/laser/plugin/plugins/instruction_profiler.py:41-115)."""

import logging
from collections import namedtuple
from datetime import datetime
from typing import Dict, List, Tuple

from ..builder import PluginBuilder
from ..interface import LaserPlugin

Record = namedtuple("Record", ["opcode", "total_time", "min_time",
                               "max_time", "count"])
log = logging.getLogger(__name__)


class InstructionProfilerBuilder(PluginBuilder):
    name = "instruction-profiler"

    def __call__(self, *args, **kwargs):
        return InstructionProfiler()


class InstructionProfiler(LaserPlugin):
    """Measures min/avg/max wall time per opcode via universal pre/post
    instruction hooks."""

    def __init__(self):
        self.records: Dict[str, Record] = {}
        self.start_time = None

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.instr_hook("pre", None)
        def pre_hook(op_code: str):
            def start_profile(_state):
                self.start_time = datetime.now()

            # telemetry-only: the lane-engine sweep may skip these for
            # device-executed instructions (svm._lane_engine_sweep)
            start_profile.lane_engine_safe = True
            return start_profile

        @symbolic_vm.instr_hook("post", None)
        def post_hook(op_code: str):
            def stop_profile(_state):
                end_time = datetime.now()
                seconds = (
                    end_time - self.start_time
                ).total_seconds()
                r = self.records.get(
                    op_code, Record(op_code, 0, 10**9, 0, 0)
                )
                self.records[op_code] = Record(
                    op_code,
                    r.total_time + seconds,
                    min(r.min_time, seconds),
                    max(r.max_time, seconds),
                    r.count + 1,
                )

            stop_profile.lane_engine_safe = True
            return stop_profile

        @symbolic_vm.laser_hook("stop_sym_exec")
        def print_results():
            log.info(self._make_summary())

    def _make_summary(self) -> str:
        total = sum(r.total_time for r in self.records.values())
        lines = [
            "Total: {} s".format(total),
        ]
        try:
            from ....smt.solver.solver_statistics import (
                SolverStatistics,
            )
            from ....support.telemetry import render

            # thin renderer over the shared counter-line spec
            # (support/telemetry/render.py) — identical grouping to
            # the benchmark plugin, drift-guarded by
            # tests/test_counter_drift.py
            counters = SolverStatistics().batch_counters()
            lines.append("Solver batch/pipeline: {}".format(counters))
            lines.extend(render.counter_lines(counters))
        except Exception:  # telemetry only
            pass
        for r in sorted(
            self.records.values(), key=lambda x: -x.total_time
        ):
            lines.append(
                "[{:12s}] {:>8.4f} %, nr {:>6d}, total {:>8.4f} s, "
                "avg {:>8.6f} s, min {:>8.6f} s, max {:>8.6f} s".format(
                    r.opcode,
                    100 * r.total_time / total if total else 0.0,
                    r.count,
                    r.total_time,
                    r.total_time / r.count,
                    r.min_time,
                    r.max_time,
                )
            )
        return "\n".join(lines)
