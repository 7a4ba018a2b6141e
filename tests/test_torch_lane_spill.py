"""The port's lane engine where lanes run out and where retired lanes
stream back in chunks, on the CPU: the spill/refill regime (more paths
than lanes: over-budget forks park to the host and their descendants
re-enter the device mid-path), chunked escalation retires against the
monolithic gather, the retire ring's two workers against one, and the
merge-before-spill pass on an overflowing rejoin storm. Every variant
reports the issues of the port's host-only run, and the spill run those
of the JAX package's host-only run."""

import json

import pytest

from mythril_tpu.orchestration.mythril_analyzer import (
    MythrilAnalyzer as JA, reset_analysis_state as j_reset,
)
from mythril_tpu.orchestration.mythril_disassembler import (
    MythrilDisassembler as JD,
)
from mythril_tpu.support.analysis_args import make_cmd_args as j_cmd
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.laser import merge as merge_mod
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics
from mythril_tpu_torch.support import contracts, lane_compare, runs
from mythril_tpu_torch.support.opcodes import ADDRESS, OPCODES
from mythril_tpu_torch.support.support_args import args as p_args

from .torch_isolation import isolated_analysis

OP = {name: data[ADDRESS] for name, data in OPCODES.items()}


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    monkeypatch.setattr(TL, "FORCE_STREAM", None)
    monkeypatch.setattr(TL, "FORCE_RETIRE_CHUNK", None)
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def _push(v, n=1):
    return bytes([0x5F + n]) + v.to_bytes(n, "big")


def _fork_tree(k, sstore_every=1):
    """k sequential symbolic branches (2**k paths), an SSTORE on every
    ``sstore_every``-th level."""
    c = bytearray(_push(0))
    for i in range(k):
        c += _push(i) + bytes([OP["CALLDATALOAD"]])
        c += _push(1) + bytes([OP["AND"], OP["ISZERO"]])
        j = len(c)
        c += _push(0, 2) + bytes([OP["JUMPI"]])
        c += _push(7) + bytes([OP["ADD"], OP["DUP1"]])
        c += (_push(i) + bytes([OP["SSTORE"]]) if i % sstore_every == 0
              else bytes([OP["POP"]]))
        c[j + 1:j + 3] = len(c).to_bytes(2, "big")
        c += bytes([OP["JUMPDEST"]])
    c += _push(0) + bytes([OP["SSTORE"], OP["STOP"]])
    return bytes(c)


def _lane(code, width, monkeypatch, chunk=None, workers=None):
    """(canonical issues, engine stats, solver counters' delta) of the
    analyzer at ``width`` lanes under the given retire knobs."""
    monkeypatch.setattr(TL, "FORCE_RETIRE_CHUNK", chunk)
    if workers is not None:
        monkeypatch.setenv("MTPU_MAT_WORKERS", str(workers))
    monkeypatch.setattr(TL, "FORCE_WIDTH", width)
    TL.PATH_HISTORY[code] = 256
    ss = SolverStatistics()
    c0 = dict(ss.batch_counters())
    report, stats, _ = runs.analyze(code.hex(), tpu_lanes=width,
                                    execution_timeout=600)
    c1 = ss.batch_counters()
    return (lane_compare.canon(json.loads(report.as_json())), stats,
            {k: v - c0.get(k, 0) for k, v in c1.items()
             if isinstance(v, (int, float))})


def _host(code):
    report, stats, _ = runs.analyze(code.hex(), tpu_lanes=0,
                                    execution_timeout=600)
    assert not stats.get("windows")
    return lane_compare.canon(json.loads(report.as_json()))


def _jax_host(code):
    j_reset()
    dis = JD(eth=None)
    address, _ = dis.load_from_bytecode(code.hex(), bin_runtime=True)
    report = JA(disassembler=dis, strategy="bfs", address=address,
                cmd_args=j_cmd(tpu_lanes=0, execution_timeout=600)
                ).fire_lasers(modules=None, transaction_count=1)
    return lane_compare.canon(json.loads(report.as_json()))


def test_spill_refill_capacity_stress(monkeypatch):
    """64 paths through an 8-lane engine: mid-path states re-enter."""
    code = _fork_tree(6)
    issues, stats, _ = _lane(code, 8, monkeypatch)
    assert stats.get("device_steps", 0) > 0 and stats.get("reseeded", 0) > 0
    assert issues == _host(code) == _jax_host(code)


@pytest.mark.parametrize("k,sstore_every,width,chunk", [
    (5, 1, 64, 4),   # the fast retire's 16 rows, then 4-row chunks
    (5, 2, 64, 8),   # mixed row shapes across chunks
    (6, 1, 32, 4),   # the spill regime: 64 paths through 32 lanes
])
def test_chunked_retire_equals_the_monolithic_gather(
        monkeypatch, k, sstore_every, width, chunk):
    code = _fork_tree(k, sstore_every)
    mono, mono_stats, _ = _lane(code, width, monkeypatch, chunk=0)
    got, stats, _ = _lane(code, width, monkeypatch, chunk=chunk)
    assert got == mono
    assert stats["parked"] == mono_stats["parked"]
    assert stats.get("retire_chunks", 0) > 0
    assert mono_stats.get("retire_chunks", 0) == 0


def test_two_ring_workers_equal_one(monkeypatch):
    """Materializing on two pool threads (their pulls on other threads)
    delivers what one does, in the same order."""
    code = _fork_tree(5)
    one, one_stats, _ = _lane(code, 64, monkeypatch, chunk=8, workers=1)
    two, two_stats, _ = _lane(code, 64, monkeypatch, chunk=8, workers=2)
    assert two == one
    assert two_stats["parked"] == one_stats["parked"]


def test_merge_before_spill_keeps_the_issue_set(monkeypatch):
    """The rejoin storm overflowing 8 lanes: spill candidates collapse
    (the fingerprint's second caller), and the issue set equals the
    runs with that pass off and with the whole merge off."""
    code = contracts.build_diamond_contract(k=5, dup_levels=0)

    def sig(issues):
        return sorted((i["swc-id"], i["address"], i["title"])
                      for i in issues)

    on, _, on_delta = _lane(code, 8, monkeypatch, chunk=4)
    monkeypatch.setenv("MTPU_SPILL_MERGE", "0")
    off, _, off_delta = _lane(code, 8, monkeypatch, chunk=4)
    monkeypatch.delenv("MTPU_SPILL_MERGE")
    monkeypatch.setattr(merge_mod, "FORCE", False)
    none, _, _ = _lane(code, 8, monkeypatch, chunk=4)
    assert on_delta["spill_merged_lanes"] > 0
    assert off_delta["spill_merged_lanes"] == 0
    assert sig(on) == sig(off) == sig(none) == sig(_host(code))
    assert on
