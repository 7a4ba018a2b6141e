"""In-place SHA3 resume through the port's lane engine on the CPU: a
lane parked at a hash outside the device's defer envelope is patched in
place with the host-built keccak term (``LaneEngine._try_resume``)
instead of being retired and re-seeded, with the host-only run's
results; and ``_try_resume`` gives the JAX engine's patch on the same
slim row."""

import numpy as np
import pytest

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.native import keccak256
from mythril_tpu_torch.support import contracts, runs
from mythril_tpu_torch.support.support_args import args as p_args

from .torch_isolation import isolated_analysis

@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def test_sha3_odd_length_parks_and_resumes_in_place():
    """A 33-byte hash (the device defers only 32- and 64-byte words)
    parks the lane at SHA3; the resume patches it on the device."""
    code = contracts.build_sha3_resume_contract()
    lane, stats, _ = runs.explore(code, 16)
    host, _, _ = runs.explore(code, 0)
    assert lane == host
    assert stats.get("resumed", 0) >= 1 and stats.get("windows", 0) > 0


def _row(payload: bytes, kind: int):
    """A slim resume row (``_unpack_resume``'s layout) of a 32-byte
    hash at offset 0 over ``payload`` with memory kind ``kind``."""
    pad = TL.RESUME_MEM - len(payload)
    return {
        "sid_sub": np.zeros(1, np.int32), "sid_top": np.zeros(1, np.int32),
        "sub": np.asarray([TL.bv256.int_to_limbs(len(payload))], np.uint32),
        "top": np.asarray([TL.bv256.int_to_limbs(0)], np.uint32),
        "msize": np.asarray([32], np.int32),
        "min_gas": np.asarray([100], np.int32),
        "max_gas": np.asarray([100], np.int32),
        "gas_limit": np.asarray([10 ** 6], np.int32),
        "mlog_count": np.asarray([0], np.int32),
        "mlog_off": np.zeros((1, 8), np.int32),
        "mlog_len": np.zeros((1, 8), np.int32),
        "mlog_sid": np.zeros((1, 8), np.int32),
        "memory": np.concatenate([np.frombuffer(payload, np.uint8),
                                  np.zeros(pad, np.uint8)])[None, :],
        "mkind": np.concatenate([np.full(len(payload), kind, np.uint8),
                                 np.zeros(pad, np.uint8)])[None, :],
    }


@pytest.mark.parametrize("kind", [1, 2], ids=["int-bytes", "word-bytes"])
def test_try_resume_matches_the_jax_engine(kind):
    """The concrete hash of the row's memory, the gas and the msize of
    the patch equal the JAX engine's, and the hash is the keccak of the
    bytes."""
    payload = bytes(range(32))
    want = JL.LaneEngine(n_lanes=8)._try_resume(_row(payload, kind), 0,
                                                byte_pc=7, sp=4)
    got = TL.LaneEngine(n_lanes=8)._try_resume(_row(payload, kind), 0,
                                               byte_pc=7, sp=4)
    assert got is not None and want is not None
    assert got[:6] == want[:6]
    np.testing.assert_array_equal(np.asarray(got[6]), np.asarray(want[6]))
    pc, sp, _msize, ming, maxg, sid, limbs = got
    assert (pc, sp, sid) == (8, 3, 0)
    assert TL.bv256.limbs_to_int(np.asarray(limbs)) == int.from_bytes(
        keccak256(payload), "big")
    assert ming == maxg == 136  # 100 + the 32-byte hash's 30 + 6


def test_try_resume_declines_a_symbolic_length():
    rows = {"sid_sub": np.asarray([7], np.int32)}
    assert TL.LaneEngine(n_lanes=8)._try_resume(rows, 0, byte_pc=1,
                                                sp=2) is None


def test_resume_is_off_when_a_detector_hooks_sha3():
    assert TL.LaneEngine(n_lanes=8, blocked_ops=("SHA3",)).resume_on \
        is False
    assert TL.LaneEngine(n_lanes=8).resume_on is True
