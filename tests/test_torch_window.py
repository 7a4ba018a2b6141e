"""The port's window dispatch (mythril_tpu_torch/laser/lane_engine.py,
plain PyTorch on the CPU) against the JAX package's ``_window_exec`` and
its escalations, window after window.

``drive`` runs the JAX engine's window loop with the port's numpy
bookkeeping (seed packing, free slots, provisional-sid resolutions,
escalation retires) and feeds both packages the same buffers; after
every dispatch all 12 outputs, every lane-state plane and the visited
bitmap must be equal, and so must every escalation's result."""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench
from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import stepper as JST
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.support import contracts

KW = dict(stack_depth=16, memory_bytes=128, mem_records=8, storage_slots=8,
          calldata_bytes=64, dlog_records=16)
N = 64
WINDOW = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tiny tensors: one intra-op thread is
    faster there and leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(jax_arrays, torch_arrays, what):
    assert len(jax_arrays) == len(torch_arrays), what
    for i, (a, b) in enumerate(zip(jax_arrays, torch_arrays)):
        np.testing.assert_array_equal(b.numpy(), _np(a),
                                      err_msg=f"{what}[{i}]")


def _same_state(jst, tst, what):
    got = interop.state_to_numpy(tst)
    for name in TS.FIELDS:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jst, name)),
                                      err_msg=f"{what}: {name}")


def seed(objs, group, words=None):
    s = TL.tx_entry_seed(objs, group, KW["calldata_bytes"])
    if words is not None:
        data = b"".join(int(w).to_bytes(32, "big") for w in words)
        s["calldata"][:len(data)] = np.frombuffer(data, np.uint8)
        s.update(cd_sym=0, cd_size_sid=0, cd_size=len(data))
    return s


def drive(code, seeds, n=N, window=WINDOW, resume_on=0, kill_at=None,
          max_windows=12):
    """Run windows until no lane is RUNNING and no seed waits; returns
    counters of what the run exercised."""
    cc = JST.compile_code(code)
    tcc = interop.code_from_numpy(np.asarray(cc.packed), cc.size, "cpu")
    jst = JS.init_sym_lanes(n, **KW)
    tst = TS.init_sym_lanes(n, device="cpu", **KW)
    jvis = jnp.zeros(cc.packed.shape[0], bool)
    tvis = torch.zeros(cc.packed.shape[0], dtype=torch.bool)
    ex, ta = TS.SYM_EXECUTABLE, np.zeros(256, bool)
    objs = TL.ObjectTable()
    queue = deque(seeds)
    free = list(range(n - 1, -1, -1))
    small = min(16, n)
    prov, kill = {}, []
    seen = {"windows": 0, "forks": 0, "fast": 0, "escalated": 0,
            "held": 0, "big_records": 0, "full_flog": 0, "killed": 0}
    for w in range(max_windows):
        seed_cap = n if len(queue) > small else small
        entries = []
        while queue and free and len(entries) < seed_cap:
            entries.append((free.pop(), queue.popleft()))
        i32b, u8b, k, pv = TL.pack_window(
            n, TS.N_ENV, KW, entries, free, kill, prov,
            KW["calldata_bytes"], big=seed_cap > small)
        for lane in kill:
            free.append(lane)
        seen["killed"] += len(kill)
        kill = []
        n_free_written = len(free)
        jst, jvis, jout = JL._window_exec(
            jst, cc, jnp.asarray(i32b), jnp.asarray(u8b), jnp.asarray(ex),
            jnp.asarray(ta), window, k, TL.DEFAULT_STEP_BUDGET, pv, jvis,
            jnp.asarray(resume_on, jnp.int32))
        tst, tvis, tout = TL.window_exec(
            tst, tcc, torch.from_numpy(i32b), torch.from_numpy(u8b), ex, ta,
            window, k, TL.DEFAULT_STEP_BUDGET, pv, tvis, resume_on)
        _same(jout, tout, f"window {w} outputs")
        _same_state(jst, tst, f"window {w}")
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
        seen["windows"] += 1

        misc, scal, utab, ftab, ridx = [x.numpy() for x in tout[:5]]
        nf, free_count, ucount = (int(x) for x in scal)
        if ucount > utab.shape[0]:
            urb = utab.shape[0]
            while urb < ucount:
                urb *= 2
            jt = JL._unique_table_big(jst, urb)
            tt = TL._unique_table_big(tst, urb)
            _same(jt, tt, f"window {w} _unique_table_big")
            utab = tt[0].numpy()
            seen["big_records"] += 1
        if nf > ftab.shape[0]:
            jf = JL._gather_full_flog(jst)
            tf = TL._gather_full_flog(tst)
            _same([jf], [tf], f"window {w} _gather_full_flog")
            ftab = tf.numpy()
            seen["full_flog"] += 1
        assert ftab[:nf].shape[0] == nf
        seen["forks"] += nf
        status = misc[:, 1].copy()
        consumed = n_free_written - free_count
        if consumed:
            free = free[:n_free_written - consumed]
        fast = [int(x) for x in ridx if x < n]
        seen["fast"] += len(fast)
        seen["held"] += int((tout[8].numpy() < n).sum())
        rest = np.nonzero((status == 5) | ((status == 0) & (
            misc[:, 2] >= TL.DEFAULT_STEP_BUDGET)))[0].tolist()
        for i in range(0, len(rest), 32):
            part = rest[i:i + 32]
            idx = np.full(32, n, np.int32)
            idx[:len(part)] = part
            floors = (16, 128, 8, 8) if i % 64 == 0 else (8, 64, 8, 8)
            jst, jrows = JL._retire_rows(jst, jnp.asarray(idx), *floors)
            tst, trows = TL._retire_rows(tst, torch.from_numpy(idx),
                                         *floors)
            _same(jrows, trows, f"window {w} _retire_rows")
            _same_state(jst, tst, f"window {w} after _retire_rows")
            status[part] = TS.DEAD
            free.extend(part)
            seen["escalated"] += len(part)
        prov = {(int(r[0]), int(r[1])): objs.add(r.copy())
                for r in utab[:ucount]}
        free.extend(fast)
        running = np.nonzero(status == 0)[0]
        if kill_at == w and len(running):
            kill = [int(running[0])]
        if not len(running) and not queue and not kill:
            break
    return seen


def test_symbolic_branches_over_many_windows():
    """k=8 branches on 64 lanes: forks overflow the pool (parks), the
    fast retire fills its budget, the rest escalate, a kill lands."""
    code, _ = bench.build_symbolic_contract(k=8)
    objs = TL.ObjectTable()
    seen = drive(code, [seed(objs, 1), seed(objs, 2)], kill_at=1)
    assert seen["windows"] >= 3
    assert seen["forks"] > 0 and seen["escalated"] > 0
    assert seen["fast"] > 0 and seen["killed"] == 1


def test_more_unique_records_than_the_pull_budget():
    """64 lanes in 64 groups each fill their record log in one window:
    more than URB distinct records, so the table escalates."""
    code = contracts.assemble([0, "CALLDATALOAD"] + [1, "ADD"] * 20
                              + ["STOP"])
    objs = TL.ObjectTable()
    seen = drive(code, [seed(objs, g) for g in range(1, N + 1)])
    assert seen["big_records"] >= 1


def test_hold_selection_with_resume_on():
    """Lanes parked at an out-of-envelope SHA3 are held (in lane order,
    up to HOLD_CAP) instead of fast-retired."""
    objs = TL.ObjectTable()
    seeds = [seed(objs, g, [6, g]) for g in range(1, 21)]
    seeds += [seed(objs, 21)]
    seen = drive(contracts.build_coverage_contract(), seeds, resume_on=1)
    assert seen["held"] >= 20


def test_dispatcher_loop_windows():
    code = contracts.build_dispatcher_loop()
    objs = TL.ObjectTable()
    seen = drive(code, [seed(objs, i + 1, [i % 13]) for i in range(24)])
    assert seen["windows"] >= 4


def test_lane_engine_runs_every_path():
    code, paths = contracts.build_symbolic_contract(6)
    eng = TL.LaneEngine(n_lanes=64, window=WINDOW, device="cpu", **KW)
    res = eng.explore(code, [TL.tx_entry_seed(eng.objects, 1, 64)])
    assert res["paths"] == paths and res["forks"] == paths - 1
    assert len(res["windows"]) >= 2
    assert len(eng.objects) - 1 > res["records"]


def test_contract_builders_are_the_repo_workloads():
    for k in (1, 4, 12, 17):
        assert contracts.build_symbolic_contract(k) == \
            bench.build_symbolic_contract(k)
    cc, _ = __graft_entry__._build_fixture(4)
    ours = JST.compile_code(contracts.build_dispatcher_loop())
    np.testing.assert_array_equal(np.asarray(ours.packed),
                                  np.asarray(cc.packed))
    assert ours.size == cc.size
