"""``myth analyze`` end to end through the port on the CPU: the port's
``MythrilAnalyzer`` with the lane engine on (``tpu_lanes=64``, plain
PyTorch versions, ``args.device = "cpu"``) against the JAX package's on
vendored fixtures. The canonical issue lists
(``support/lane_compare.canon``) must be equal, the port's lane run
must equal its own host run, and the lane engine must really have run
windows (``lane_engine.RUN_STATS_TOTAL``).

The reference file the card's run is held to
(``tests/torch_data/lane_issues.json``, written by
``tools/make_torch_reference.py``) is checked here too: it covers the 18
fixtures and its lists are canonical."""

import json

import pytest

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.orchestration.mythril_analyzer import (
    reset_analysis_state as j_reset,
)
from mythril_tpu.orchestration.mythril_analyzer import MythrilAnalyzer as JA
from mythril_tpu.orchestration.mythril_disassembler import (
    MythrilDisassembler as JD,
)
from mythril_tpu.support.analysis_args import make_cmd_args as j_cmd
from mythril_tpu_torch.support import lane_compare, runs
from mythril_tpu_torch.support.support_args import args as p_args

from .fixture_paths import INPUTS
from .torch_isolation import isolated_analysis

# (fixture, runtime bytecode, detectors): each detector leaves the
# device free to fork (no JUMPI hook, or one its lane adapter lifts)
CASES = [
    ("flag_array.sol.o", False, ["EtherThief"]),
    ("origin.sol.o", True, ["TxOrigin"]),
    ("suicide.sol.o", True, ["AccidentallyKillable"]),
    ("returnvalue.sol.o", True, ["UncheckedRetval"]),
]


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def _jax(code, bin_runtime, modules, tpu_lanes):
    j_reset()
    dis = JD(eth=None)
    address, _ = dis.load_from_bytecode(code, bin_runtime=bin_runtime)
    JL.RUN_STATS_TOTAL.clear()
    report = JA(disassembler=dis, strategy="bfs", address=address,
                cmd_args=j_cmd(tpu_lanes=tpu_lanes)).fire_lasers(
        modules=modules, transaction_count=1)
    return lane_compare.canon(json.loads(report.as_json()))


def _port(code, bin_runtime, modules, tpu_lanes):
    report, stats, _ = runs.analyze(code, bin_runtime=bin_runtime,
                                    modules=modules, tpu_lanes=tpu_lanes)
    return lane_compare.canon(json.loads(report.as_json())), stats


@pytest.mark.parametrize("name,bin_runtime,modules", CASES,
                         ids=[c[0] for c in CASES])
def test_port_issues_equal_the_jax_package(name, bin_runtime, modules):
    code = (INPUTS / name).read_text().strip()
    want = _jax(code, bin_runtime, modules, 64)
    assert JL.RUN_STATS_TOTAL.get("windows", 0) > 0
    got, stats = _port(code, bin_runtime, modules, 64)
    assert got == want
    assert stats.get("windows", 0) > 0 and stats.get("device_steps", 0) > 0
    host, host_stats = _port(code, bin_runtime, modules, 0)
    assert host == got
    assert host_stats.get("windows", 0) == 0


def test_a_calldata_word_at_a_symbolic_offset_runs_on_the_device():
    """environments.sol.o stores a CALLDATALOAD at a symbolic offset, a
    zero-width word that ``Memory.write_word_at`` pads to 256 bits. The
    JAX engine's materialize does not pad it, its sweep raises and the
    JAX package goes on on the host; the port pads it as the host does
    and runs the window, with the JAX package's issues."""
    code = (INPUTS / "environments.sol.o").read_text().strip()
    want = _jax(code, True, None, 64)
    got, stats = _port(code, True, None, 64)
    assert got == want
    assert stats.get("windows", 0) > 0
    host, _ = _port(code, True, None, 0)
    assert host == got


def test_the_card_reference_covers_the_corpus():
    ref = json.loads((INPUTS.parents[2] / "torch_data"
                      / "lane_issues.json").read_text())
    assert sorted(ref) == sorted(p.name for p in INPUTS.glob("*.sol.o"))
    assert sum(len(v["issues"]) for v in ref.values()) == 40
    for v in ref.values():
        assert v["issues"] == sorted(
            v["issues"], key=lambda i: json.dumps(i, sort_keys=True))
        for issue in v["issues"]:
            assert "tx_sequence" not in issue
            assert "discoveryTime" not in issue
            assert "has_tx_sequence" in issue
    # the JAX engine's run stats, which chip_smoke.py holds the port's
    # windows to fixture by fixture
    windows = [v["run_stats"].get("windows", 0) for v in ref.values()]
    assert all(isinstance(w, int) for w in windows) and sum(windows) > 0
    assert all(isinstance(v["engine_failures"], int) for v in ref.values())
    assert lane_compare.INPUTS == INPUTS
