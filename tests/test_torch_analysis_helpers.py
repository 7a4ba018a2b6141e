"""The port's analysis-layer helpers (``analysis/call_helpers.py``,
``support/start_time.py``): the counterpart of
``tests/test_analysis_helpers.py``, driven through the port's engine
(``tests/torch_harness.py``)."""

import time

import pytest

from .torch_isolation import isolated_analysis


@pytest.fixture(autouse=True)
def _on_the_cpu():
    from mythril_tpu_torch.support.support_args import args

    with isolated_analysis():
        args.device = "cpu"
        yield


def test_call_helpers_parses_call_stack():
    """``get_call_from_state`` parses a CALL's stack into an
    ``ops.Call`` record."""
    from mythril_tpu_torch.analysis.call_helpers import get_call_from_state
    from mythril_tpu_torch.analysis.ops import VarType
    from mythril_tpu_torch.laser.svm import LaserEVM

    from .torch_harness import asm, push, run_concrete

    seen = {}
    orig = LaserEVM.execute_state

    def patched(self, gs):
        if gs.get_current_instruction()["opcode"] == "CALL":
            seen["call"] = get_call_from_state(gs)
        return orig(self, gs)

    LaserEVM.execute_state = patched
    try:
        program = (
            push(0, 1) + push(0, 1) + push(0, 1) + push(0, 1)
            + push(0, 1)          # value
            + push(0xBEEF)        # to
            + push(300000, 3)     # gas
            + asm("CALL", "STOP")
        )
        run_concrete(bytes(program))
    finally:
        LaserEVM.execute_state = orig
    call = seen["call"]
    assert call.to.type == VarType.CONCRETE
    assert call.to.val == 0xBEEF


def test_issue_discovery_time_is_elapsed_not_epoch():
    """``Issue.discovery_time`` is seconds since the analysis began."""
    from mythril_tpu_torch.analysis.report import Issue
    from mythril_tpu_torch.support.start_time import StartTime

    StartTime()
    issue = Issue(
        contract="C", function_name="f", address=1, swc_id="106",
        title="t", bytecode="00", severity="High",
    )
    assert 0 <= issue.discovery_time < time.time() - 1e6
