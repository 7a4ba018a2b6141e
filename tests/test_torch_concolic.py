"""The port's concolic pipeline (``mythril_tpu_torch/concolic``, the
counterpart of ``tests/test_concolic.py``): record a concrete trace,
flip a requested JUMPI, and replay the solved input concretely to see
it drive the flipped branch; and the same through ``python3 -m
mythril_tpu_torch concolic``. Each test starts from the default
analysis flags and lane-engine settings and leaves them as it found
them, so no earlier test's configuration reaches it; the analyses run
on the CPU (``args.device = "cpu"``), the lane engine at its default
width (the trace recorder and the concolic strategy keep their states
on the host: ``LaserEVM._lane_engine_sweep``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from .test_concolic import build_branchy_code, make_concrete_data
from .torch_isolation import isolated_analysis

REPO = Path(__file__).resolve().parent.parent

#: ``python3 -m mythril_tpu_torch`` after the analyses are sent to the CPU
PORT_CLI = (
    "import runpy, sys\n"
    "from mythril_tpu_torch.support.support_args import args\n"
    "args.device = 'cpu'\n"
    "sys.argv = ['mythril_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('mythril_tpu_torch', run_name='__main__',\n"
    "                 alter_sys=True)\n")


@pytest.fixture(autouse=True)
def _default_settings():
    """Default flags (``support_args``) and lane-engine settings, on
    the CPU; restored afterwards."""
    from mythril_tpu_torch.laser import lane_engine
    from mythril_tpu_torch.support.support_args import Args, args

    saved = (lane_engine.DEFAULT_WINDOW, lane_engine.FORCE_WIDTH,
             dict(lane_engine.PATH_HISTORY))
    with isolated_analysis():
        fresh = object.__new__(Args)
        Args.__init__(fresh)
        vars(args).clear()
        vars(args).update(vars(fresh))
        args.device = "cpu"
        lane_engine.DEFAULT_WINDOW = 256
        lane_engine.FORCE_WIDTH = None
        lane_engine.PATH_HISTORY.clear()
        try:
            yield
        finally:
            (lane_engine.DEFAULT_WINDOW, lane_engine.FORCE_WIDTH) = saved[:2]
            lane_engine.PATH_HISTORY.clear()
            lane_engine.PATH_HISTORY.update(saved[2])


def _flip(data, jumpi_addr):
    from mythril_tpu_torch.concolic.concolic_execution import (
        concolic_execution,
    )

    return concolic_execution(data, [jumpi_addr])


def _trace(data):
    from mythril_tpu_torch.concolic.find_trace import concrete_execution

    return concrete_execution(data)[1][0]


def test_flip_branch_drives_other_side():
    code_hex, jumpi_addr, then_addr = build_branchy_code()
    data = make_concrete_data(code_hex)
    # the original input (0) takes the fall-through
    trace0 = _trace(data)
    assert then_addr not in trace0
    assert jumpi_addr in trace0

    out = _flip(data, jumpi_addr)
    assert len(out) == 1, "the requested branch must be flipped"
    new_input = out[0]["steps"][-1]["input"]
    assert new_input.startswith("0x")
    # replayed concretely, the solved input takes the then-branch
    trace1 = _trace(make_concrete_data(code_hex, tx_input=new_input[2:]))
    assert then_addr in trace1, (new_input, trace1)
    assert int(new_input[2:66], 16) == 42


def test_flip_already_taken_branch_finds_fallthrough():
    code_hex, jumpi_addr, then_addr = build_branchy_code()
    taken = make_concrete_data(
        code_hex, tx_input=(42).to_bytes(32, "big").hex())
    assert then_addr in _trace(taken)

    out = _flip(taken, jumpi_addr)
    assert len(out) == 1
    new_input = out[0]["steps"][-1]["input"]
    trace1 = _trace(make_concrete_data(code_hex, tx_input=new_input[2:]))
    assert then_addr not in trace1, (new_input, trace1)


def test_concolic_cli_surface(tmp_path):
    """``python3 -m mythril_tpu_torch concolic FILE --branches ADDR``
    prints the flipped transaction sequence; its input, replayed,
    drives the other branch."""
    code_hex, jumpi_addr, then_addr = build_branchy_code()
    input_file = tmp_path / "concrete.json"
    input_file.write_text(json.dumps(make_concrete_data(code_hex)))
    proc = subprocess.run(
        [sys.executable, "-c", PORT_CLI, "concolic", str(input_file),
         "--branches", str(jumpi_addr)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert len(out) == 1
    new_input = out[0]["steps"][-1]["input"]
    assert int(new_input[2:66], 16) == 42
    trace1 = _trace(make_concrete_data(code_hex, tx_input=new_input[2:]))
    assert then_addr in trace1, (new_input, trace1)


def test_the_lane_engine_runs_the_concrete_replay_without_hooks():
    """The gate is narrow: the same concrete transaction with no trace
    recorder goes through the lane engine."""
    from mythril_tpu_torch.laser import lane_engine
    from mythril_tpu_torch.concolic.find_trace import (
        setup_concrete_initial_state,
    )
    from mythril_tpu_torch.laser.svm import LaserEVM
    from mythril_tpu_torch.laser.transaction.concolic import (
        execute_transaction,
    )
    from mythril_tpu_torch.smt import symbol_factory

    code_hex, _, _ = build_branchy_code()
    data = make_concrete_data(code_hex)
    laser = LaserEVM(execution_timeout=100, requires_statespace=False,
                     use_reachability_check=False)
    laser.open_states = [setup_concrete_initial_state(data).__copy__()]
    step = data["steps"][0]
    before = lane_engine.RUN_STATS_TOTAL.get("windows", 0)
    execute_transaction(
        laser, callee_address=step["address"],
        caller_address=symbol_factory.BitVecVal(int(step["origin"], 16),
                                                256),
        origin_address=symbol_factory.BitVecVal(int(step["origin"], 16),
                                                256),
        code=None, gas_limit=0x7FFFFFF, data=[0] * 32, gas_price=0,
        value=0, track_gas=False)
    assert lane_engine.RUN_STATS_TOTAL.get("windows", 0) > before
