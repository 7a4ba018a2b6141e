"""The window-boundary lane merge through the port's analyzer on the
CPU, on ``bench.py``'s merge rig (the diamond contract, 64 lanes,
32-step windows, every detector): lanes merge and subsume, the counters
equal the JAX engine's on the same rig, and the issue set is the one the
port reports with the merge off (``MTPU_MERGE=0``)."""

import pytest

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.laser import merge as j_merge
from mythril_tpu.orchestration.mythril_analyzer import (
    MythrilAnalyzer as JA, reset_analysis_state as j_reset,
)
from mythril_tpu.orchestration.mythril_disassembler import (
    MythrilDisassembler as JD,
)
from mythril_tpu.smt.solver.solver_statistics import (
    SolverStatistics as JSS,
)
from mythril_tpu.support.analysis_args import make_cmd_args as j_cmd
from mythril_tpu_torch import _build
from mythril_tpu_torch.support import contracts, runs
from mythril_tpu_torch.support.support_args import args as p_args

from .torch_isolation import isolated_analysis

CODE = contracts.build_diamond_contract(k=6, dup_levels=2)


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def _jax_merge_run(merge_on):
    """The JAX engine on the same rig (bench.py's _smoke_merge lane
    seam)."""
    ss = JSS()
    old = (JL.DEFAULT_WINDOW, JL.FORCE_WIDTH, JL.PATH_HISTORY.get(CODE))
    JL.PATH_HISTORY[CODE] = 64
    JL.FORCE_WIDTH = 64
    JL.DEFAULT_WINDOW = 32
    j_merge.FORCE = merge_on
    try:
        j_reset()
        c0 = dict(ss.batch_counters())
        dis = JD(eth=None)
        address, _ = dis.load_from_bytecode(CODE.hex(), bin_runtime=True)
        report = JA(disassembler=dis, strategy="bfs", address=address,
                    cmd_args=j_cmd(execution_timeout=120, tpu_lanes=64)
                    ).fire_lasers(modules=None, transaction_count=1)
        c1 = ss.batch_counters()
    finally:
        j_merge.FORCE = None
        JL.DEFAULT_WINDOW, JL.FORCE_WIDTH = old[:2]
        if old[2] is None:
            JL.PATH_HISTORY.pop(CODE, None)
        else:
            JL.PATH_HISTORY[CODE] = old[2]
    return {
        "issues": sorted((i.swc_id, i.address, i.title)
                         for i in report.issues.values()),
        "counters": {k: c1[k] - c0.get(k, 0) for k in runs.MERGE_COUNTERS},
    }


def test_merge_counters_equal_the_jax_engine_and_keep_the_issues():
    on = runs.merge_run(CODE, True)
    c = on["counters"]
    assert c["lanes_merged"] > 0 and c["lanes_subsumed"] > 0
    assert on["engine"]["lanes_merged"] == c["lanes_merged"]
    assert on["engine"]["windows"] > 1
    want = _jax_merge_run(True)
    assert c == want["counters"]
    assert on["issues"] == want["issues"]
    off = runs.merge_run(CODE, False)
    assert off["counters"]["lanes_merged"] == 0
    assert off["issues"] == on["issues"]
    # the fingerprint ran through its dispatcher (the plain version on
    # the CPU: no kernel launch is counted here)
    assert _build.LAUNCHES["merge_fingerprint"] == 0
