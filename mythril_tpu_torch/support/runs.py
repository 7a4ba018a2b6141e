"""In-process runs of the analyzer that ``chip_smoke.py``,
``tools/prof_torch_port.py`` and the tests share: ``analyze`` (a
``myth analyze`` of bytecode through ``MythrilAnalyzer``), ``explore``
(the engine alone over every path, as ``bench.py``'s ``_explore``),
``merge_run`` (``bench.py``'s window-merge rig), ``entry_states``
(the states an analysis hands the lane engine first) and ``pack_codes``
(the members of the packed checks).

Each run resets the analysis state first and reports what the lane
engine did (``lane_engine.RUN_STATS_TOTAL`` over the run) beside its
result, so a caller can show that the device path ran.
"""

import time
from contextlib import contextmanager

from ..laser import lane_engine
from ..laser import merge as merge_mod
from ..orchestration.mythril_analyzer import (
    MythrilAnalyzer, reset_analysis_state,
)
from ..orchestration.mythril_disassembler import MythrilDisassembler
from ..smt.solver.solver_statistics import SolverStatistics
from ..support.analysis_args import make_cmd_args
from ..support.support_args import args

#: merge counters of the window-merge rig (SolverStatistics)
MERGE_COUNTERS = ("lanes_merged", "lanes_subsumed", "merge_rounds",
                  "gas_widened_lanes")


@contextmanager
def _engine_stats(out: dict):
    lane_engine.RUN_STATS_TOTAL.clear()
    try:
        yield
    finally:
        out.update(lane_engine.RUN_STATS_TOTAL)


def analyze(code: str, bin_runtime: bool = True, modules=None,
            tx_count: int = 1, tpu_lanes: int = 64, **cmd):
    """Analyze hex bytecode; returns (report, engine stats, wall s).
    ``cmd`` overrides the analyzer arguments (``make_cmd_args``). The
    analyzer records an exception of a contract's analysis in the
    report (as the CLI prints it); here it raises."""
    reset_analysis_state()
    dis = MythrilDisassembler(eth=None)
    address, _ = dis.load_from_bytecode(code, bin_runtime=bin_runtime)
    stats: dict = {}
    t0 = time.perf_counter()
    with _engine_stats(stats):
        analyzer = MythrilAnalyzer(
            disassembler=dis,
            cmd_args=make_cmd_args(tpu_lanes=tpu_lanes, **cmd),
            strategy="bfs", address=address)
        report = analyzer.fire_lasers(modules=modules,
                                      transaction_count=tx_count)
    if report.exceptions:
        raise RuntimeError("analysis failed:\n"
                           + "\n".join(report.exceptions))
    return report, stats, time.perf_counter() - t0


def explore(code: bytes, tpu_lanes: int):
    """Explore every path of ``code`` with no detectors (one
    transaction); returns (open states, engine stats, wall s)."""
    from ..analysis.symbolic import SymExecWrapper
    from ..ethereum.evmcontract import EVMContract

    reset_analysis_state()
    args.tpu_lanes = tpu_lanes
    contract = EVMContract(code=code.hex(), name="bench_sym")
    stats: dict = {}
    t0 = time.perf_counter()
    try:
        with _engine_stats(stats):
            sym = SymExecWrapper(
                contract, address=0xDEADBEEF, strategy="bfs",
                max_depth=8192, execution_timeout=600, create_timeout=10,
                transaction_count=1, compulsory_statespace=False,
                run_analysis_modules=False)
    finally:
        args.tpu_lanes = 0
    return len(sym.laser.open_states), stats, time.perf_counter() - t0


#: the corpus fixtures of the packed arena checks (runtime code)
PACK_FIXTURES = ("calls.sol.o", "kinds_of_calls.sol.o")


def pack_codes(k: int):
    """The four members of the packed checks (chip_smoke.py,
    tools/prof_torch_port.py): the k-branch symbolic contract,
    bench.py's diamond (k=6) and the runtime code of the two
    PACK_FIXTURES."""
    from .contracts import build_diamond_contract, build_symbolic_contract
    from .lane_compare import INPUTS

    return [build_symbolic_contract(k)[0], build_diamond_contract(k=6)] + [
        bytes.fromhex((INPUTS / name).read_text().strip())
        for name in PACK_FIXTURES]


def entry_states(code: str, bin_runtime: bool = True, tpu_lanes: int = 64):
    """The transaction-entry states the first lane sweep of an analysis
    of hex ``code`` hands the engine (every detector, one transaction).
    The sweep is cut there: it parks nothing, so the analysis ends at
    once and the states stay as they were seeded."""
    captured = []

    def spy(self, code_bytes, states):
        if not captured:
            captured.extend(states)
        return []

    orig = lane_engine.LaneEngine.explore
    lane_engine.LaneEngine.explore = spy
    try:
        analyze(code, bin_runtime=bin_runtime, tpu_lanes=tpu_lanes)
    finally:
        lane_engine.LaneEngine.explore = orig
    if not captured:
        raise RuntimeError("the analysis never reached the lane engine")
    return captured


def merge_run(code: bytes, merge_on: bool, width: int = 64,
              window: int = 32):
    """The lane seam of ``bench.py``'s merge gate: the analyzer (every
    detector, one transaction) at ``width`` lanes with ``window``-step
    windows, so boundaries land mid-storm, merge on or off. Returns
    {"issues", "counters" (the merge counters), "engine" (stats)}."""
    ss = SolverStatistics()
    old = (lane_engine.DEFAULT_WINDOW, lane_engine.FORCE_WIDTH)
    lane_engine.PATH_HISTORY[code] = width
    lane_engine.FORCE_WIDTH = width
    lane_engine.DEFAULT_WINDOW = window
    merge_mod.FORCE = merge_on
    try:
        c0 = dict(ss.batch_counters())
        report, stats, _ = analyze(code.hex(), tpu_lanes=width,
                                   execution_timeout=120)
        c1 = ss.batch_counters()
    finally:
        merge_mod.FORCE = None
        lane_engine.DEFAULT_WINDOW, lane_engine.FORCE_WIDTH = old
    return {
        "issues": sorted((i.swc_id, i.address, i.title)
                         for i in report.issues.values()),
        "counters": {k: c1[k] - c0.get(k, 0) for k in MERGE_COUNTERS},
        "engine": stats,
    }
