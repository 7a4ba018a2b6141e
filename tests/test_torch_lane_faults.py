"""A device or kernel failure on the analysis path raises to the caller:
the port never lets the host interpreter or a host screen stand in for
it (where the JAX package logs the failure and continues on the host).
Each test breaks one seam and expects the error out of
``LaneEngine.explore``, out of ``LaserEVM._lane_engine_sweep`` and out
of the analysis."""

import pytest
import torch

from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.laser import svm
from mythril_tpu_torch.models import pruner
from mythril_tpu_torch.ops import propagate as P
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.smt.solver import batch
from mythril_tpu_torch.support import contracts, runs
from mythril_tpu_torch.support.screen_waves import layered_sets
from mythril_tpu_torch.support.support_args import args as p_args

from .torch_isolation import isolated_analysis

CODE = contracts.build_diamond_contract(k=6, dup_levels=2)


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def _broken(*_a, **_k):
    raise RuntimeError("launch failed")


@pytest.fixture
def seen(monkeypatch):
    """Records the exceptions that pass out of the engine's explore and
    the svm's lane sweep."""
    out = {"explore": [], "sweep": []}

    def spy(cls, name, key):
        orig = getattr(cls, name)

        def wrapped(*a, **k):
            try:
                return orig(*a, **k)
            except Exception as e:
                out[key].append(e)
                raise

        monkeypatch.setattr(cls, name, wrapped)

    spy(TL.LaneEngine, "explore", "explore")
    spy(svm.LaserEVM, "_lane_engine_sweep", "sweep")
    return out


def _raised_through(seen):
    assert seen["explore"] and seen["sweep"]
    assert "launch failed" in str(seen["explore"][0])
    assert seen["sweep"][0] is seen["explore"][0]


def test_a_failing_fingerprint_kernel_raises(monkeypatch, seen):
    monkeypatch.setattr(TL, "merge_fingerprint", _broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        runs.merge_run(CODE, True)
    _raised_through(seen)


def test_a_failing_window_dispatch_raises(monkeypatch, seen):
    monkeypatch.setattr(TL, "window_exec", _broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        runs.explore(CODE, 64)
    _raised_through(seen)


def test_no_card_is_an_error_not_a_host_run(monkeypatch):
    """Asked for the card (the default) without one, the analysis raises
    instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(p_args, "device", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runs.analyze(CODE.hex(), tpu_lanes=64)


def test_a_failing_prescreen_raises_out_of_the_discharge(monkeypatch):
    """The batched discharge (the fork screen's and the solver pool's
    path to the device screens) lets a device failure through."""
    monkeypatch.setattr(p_args, "tpu_lanes", 8)
    monkeypatch.setattr(P, "FORCE", True)
    monkeypatch.setattr(P, "prefilter_feasible", _broken)
    sets = layered_sets(T)
    before = pruner.STATS["device_failures"]
    with pytest.raises(RuntimeError, match="launch failed"):
        batch.discharge(sets, timeout_s=1.0)
    assert pruner.STATS["device_failures"] == before + 1


def test_a_failing_merge_abstraction_raises_out_of_the_round(monkeypatch):
    """With the opt-in propagation abstraction source, a device failure
    in the round-boundary open-state merge of a two-transaction analysis
    reaches the caller instead of skipping the merge."""
    from mythril_tpu_torch.laser import merge

    monkeypatch.setenv("MTPU_MERGE_PROPAGATE", "1")
    monkeypatch.setattr(P, "FORCE", True)
    monkeypatch.setattr(P, "abstraction_sets", _broken)
    calls = []
    orig = merge.merge_open_states

    def spy(states):
        calls.append(len(states))
        return orig(states)

    monkeypatch.setattr(merge, "merge_open_states", spy)
    with pytest.raises(RuntimeError, match="launch failed"):
        runs.analyze(CODE.hex(), tx_count=2, tpu_lanes=0,
                     execution_timeout=120)
    assert calls and calls[0] > 1


def test_a_failed_background_screen_raises_at_the_round_top():
    """The round top collects the open-state screen that ran in the
    background; its failure raises there instead of being redone."""
    from concurrent.futures import Future

    class Laser:
        def _screen_open_states(self, states):
            return states

    states = [object(), object()]
    fut = Future()
    fut.set_exception(RuntimeError("launch failed"))
    laser = Laser()
    laser._screen_prefetch = (list(states), fut)
    with pytest.raises(RuntimeError, match="launch failed"):
        svm.LaserEVM._prune_unreachable_states(laser, states)
    assert laser._screen_prefetch is None
