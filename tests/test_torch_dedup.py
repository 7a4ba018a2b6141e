"""K3's functions on the CPU: the port's plain ``dedup_plain``,
``unique_table_big_plain`` and ``gather_full_flog_plain`` against the
JAX package's ``_dedup_canon`` + ``_canon_remap``, ``_unique_table_big``
and ``_gather_full_flog`` on ``device_loop.k3_edge_cases`` (chip_smoke.py
holds the kernels to the plain versions on the same inputs), bit for
bit: every output is an integer plane, so the tolerance is 0. Also the
record order K3's cursor relies on: every path appends a lane's records
in step order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.support import device_loop as DL

_CASES = {c.name: c for c in DL.k3_edge_cases()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_dedup(jst, d_recs):
    dlog_sid, canon = JL._dedup_canon(jst, d_recs)
    out = JL._canon_remap(jst._replace(dlog_sid=dlog_sid), canon, d_recs)
    return out, canon


def _jax_state(st):
    return JS.SymLaneState(**{k: jnp.asarray(v) for k, v in
                              interop.state_to_numpy(st).items()})


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    got, want = (x.view(np.int32) if x.dtype == np.uint32 else x
                 for x in (got, want))
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_dedup_matches_the_jax_package(name):
    """``dedup_plain`` (canon and every plane after the remap) against
    JAX ``_dedup_canon`` + ``_canon_remap``."""
    case = _CASES[name]
    st = DL.k3_case_state(case, "cpu")
    jst = _jax_state(st)
    t_st, t_canon = TL.dedup_plain(st)
    j_st, j_canon = _jax_dedup(jst, case.records)
    _equal(t_canon, j_canon, "canon")
    got = interop.state_to_numpy(t_st)
    for f in TS.FIELDS:
        _equal(got[f], np.asarray(getattr(j_st, f)), f)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_unique_table_big_matches_the_jax_package(name):
    case = _CASES[name]
    st = DL.k3_case_state(case, "cpu")
    tab, count = TL.unique_table_big_plain(st, case.urb)
    j_tab, j_count = JL._unique_table_big(_jax_state(st), case.urb)
    _equal(tab, j_tab, "table")
    assert int(count) == int(j_count)
    if name == "wide":
        assert int(count) > TL.URB


@pytest.mark.parametrize("name", sorted(_CASES))
def test_gather_full_flog_matches_the_jax_package(name):
    case = _CASES[name]
    st = DL.k3_case_state(case, "cpu")
    _equal(TL.gather_full_flog_plain(st),
           JL._gather_full_flog(_jax_state(st)), "fork table")
    if name == "wide":
        assert st.flog_parent.shape[0] > TL.FB


def _pid(lane, slot, r):
    return -(lane * r + slot + 1)


def test_rules_case_holds_the_rules():
    """What the ``rules`` case is for, on the plain canon (equal to the
    JAX package's above)."""
    case = _CASES["rules"]
    r = case.records
    _, canon = TL.dedup_plain(DL.k3_case_state(case, "cpu"))
    c = canon.numpy()
    # one bucket, two distinct records: each keeps its own; lane 9 equals
    # lane 7 but meets lane 2, the bucket's winner
    assert c[2, 0] == _pid(2, 0, r) and c[7, 0] == _pid(7, 0, r)
    assert c[9, 0] == _pid(9, 0, r)
    # equal records: the lowest lane wins
    assert c[5, 0] == _pid(3, 1, r) and c[3, 1] == _pid(3, 1, r)
    # SSTORE and REC_SLOAD_RW keep their own identity
    for lane in (10, 11):
        assert list(c[lane, :2]) == [_pid(lane, 0, r), _pid(lane, 1, r)]
    # the chain of three
    assert c[21, 0] == _pid(20, 0, r)
    assert c[23, 0] == _pid(22, 0, r) and c[25, 0] == _pid(24, 0, r)
    # a repeated step: only its first record counts
    assert c[30, 0] == _pid(30, 0, r) and c[30, 1] == 0
    # out of step order: the first slot of each step
    assert c[31, 1] == _pid(31, 1, r) and c[31, 2] == 0
    assert c[31, 0] == _pid(31, 0, r) and c[31, 3] == _pid(31, 3, r)
    # lanes without records keep a zero row
    assert not c[0].any() and not c[32].any()


def test_full_log_case_dedups_the_siblings():
    case = _CASES["full_log"]
    r = case.records
    st = DL.k3_case_state(case, "cpu")
    assert int(st.dlog_count[3]) > r
    _, canon = TL.dedup_plain(st)
    c = canon.numpy()
    want = np.array([_pid(0, s, r) for s in range(r)])
    for lane in range(16):
        np.testing.assert_array_equal(c[lane], want)


_ORDER_CASES = ("odd_lanes", "fork_budget", "packed")


@pytest.mark.parametrize("name", _ORDER_CASES)
def test_records_are_appended_in_step_order(name):
    """K3 keeps a cursor into each lane's records: every lane's live
    records after a run (forks' children included, on a packed arena
    too) have non-decreasing steps, at most one a step."""
    case = {c.name: c for c in DL.k1_edge_cases(64)}[name]
    st, cc = DL.k1_case_state(case, "cpu", stack_depth=16,
                              memory_bytes=128, mem_records=8,
                              storage_slots=8, calldata_bytes=64,
                              dlog_records=16)
    st, _ = TS.sym_run(cc, st, case.steps)
    r = st.dlog_op.shape[1]
    count = st.dlog_count.clamp(max=r)
    assert int(count.sum()) > 0
    steps = st.dlog_step.numpy()
    for lane in range(st.pc.shape[0]):
        live = steps[lane, :int(count[lane])]
        assert (np.diff(live) >= 0).all(), lane
        # a full log overwrites its last slot: below it, one a step
        assert (np.diff(live[:-1]) > 0).all(), lane
