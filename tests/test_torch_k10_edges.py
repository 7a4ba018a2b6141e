"""K10's plain version (``ops/stepper.run_plain``) against the JAX
package's ``run_jit`` on ``device_loop.k10_edge_cases`` (chip_smoke.py
holds the kernel to the plain version on the same inputs), bit for bit:
every plane is an integer plane, so the tolerance is 0. Also K10's
launch plan (``stepper.lane_run_plan``) at every case's sizes and at the
card's paths' sizes, and the arms contract's coverage of every result
class and status cause."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.ops import stepper as J
from mythril_tpu_torch import interop
from mythril_tpu_torch.ops import stepper as T
from mythril_tpu_torch.support import contracts
from mythril_tpu_torch.support import device_loop as DL

_CASES = {c.name: c for c in DL.k10_edge_cases()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run(case, planes):
    jcc = J.compile_code(case.code)
    st = J.LaneState(**{f: jnp.asarray(planes[f]) for f in J.LaneState._fields})
    out = J.run_jit(jcc, st, case.max_steps)
    return {f: np.asarray(getattr(out, f)) for f in J.LaneState._fields}


def _planes(case):
    """The planes the run takes: the view's lanes, or the whole batch."""
    if case.view is None:
        return case.planes
    a, k = case.view
    return {f: v[a:a + k] for f, v in case.planes.items()}


_PLAIN = {}


def _plain(name):
    """run_plain of a case on the CPU (through its view where it has
    one), as numpy; the batch's other lanes must stay as they were."""
    if name not in _PLAIN:
        case = _CASES[name]
        cc, st = DL.k10_case_inputs(case, "cpu")
        whole = T.clone_lanes(st)
        x = DL.view_of(st, case.view)
        T.run(cc, x, case.max_steps)
        got = interop.state_to_numpy(st)
        if case.view is not None:
            a, k = case.view
            before = interop.state_to_numpy(whole)
            for f in T.LANE_FIELDS:
                np.testing.assert_array_equal(got[f][:a], before[f][:a])
                np.testing.assert_array_equal(got[f][a + k:],
                                              before[f][a + k:])
            got = {f: v[a:a + k] for f, v in got.items()}
        _PLAIN[name] = got
    return _PLAIN[name]


@pytest.mark.parametrize("name", sorted(_CASES))
def test_k10_edge_case_matches_the_jax_package(name):
    case = _CASES[name]
    want = _jax_run(case, _planes(case))
    got = _plain(name)
    for f in T.LANE_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{name}: plane {f}")


def test_the_arms_reach_every_status_and_result_class():
    """arms_33 ends lanes in every status, and its arms run every result
    class of the op table."""
    got = _plain("arms_33")
    statuses = set(np.unique(got["status"]).tolist())
    assert statuses == set(range(7)), statuses
    code, _ = DL.k10_arms(**{k: v for k, v in zip(
        ("depth", "mem", "slots", "cd"),
        DL.K10_SHAPES["arms"].values())})
    ops = set(T.pack_code(code)[:len(code), 0].tolist())
    classes = {int(T.RESULT_CLASS_TABLE[op]) for op in ops}
    assert classes == set(range(len(T.RESULT_CLASSES))), \
        set(range(len(T.RESULT_CLASSES))) - classes


def test_the_cases_cover_their_edges():
    """Loop counts differ inside every 4-lane warp group, lanes start
    outside RUNNING, max_steps 0 leaves the batch as it was, one step
    moves every running lane once, and the view's memory rows start off
    a 16-byte boundary."""
    lc = _CASES["loop_counts"].planes
    words = [int.from_bytes(bytes(r), "big") % 97 for r in lc["calldata"]]
    assert len(set(words)) == 33
    assert (lc["status"] != 0).sum() == 3
    np.testing.assert_array_equal(_plain("steps_0")["steps"],
                                  _CASES["steps_0"].planes["steps"])
    one = _plain("steps_1")
    running = _CASES["steps_1"].planes["status"] == 0
    assert (one["steps"][running] == 1).all()
    assert (one["steps"][~running] == 0).all()
    a, _ = _CASES["shard_view"].view
    assert (a * DL.K10_SHAPES["odd"]["memory_bytes"]) % 16


def test_the_cases_take_every_kernel_branch():
    """Across the card's cases, K10's plan takes each of the kernel's
    four branches: the code's rows in shared memory or read in place
    (the ``long_code`` cases pass the code budget), crossed with the
    lanes' rows on chip or in place; and the long code's lanes reach
    arms past the budget."""
    branches = {}
    for name, *size in DL.k10_case_sizes(full=True):
        p = T.lane_run_plan(*size)
        branches.setdefault((p["code_shared"], p["local"]), []).append(name)
    assert set(branches) == {(0, 0), (0, 1), (1, 0), (1, 1)}, branches
    assert branches[(0, 1)] == ["long_code"]
    assert branches[(0, 0)] == ["long_code_default"]
    budget_pc = T.K10_CODE_BUDGET // 8
    for name in ("long_code", "long_code_default"):
        assert (_plain(name)["pc"] >= budget_pc).sum() > 10, name


def test_sharded_run_takes_a_mesh_of_two_cards(monkeypatch):
    """A Mesh of two distinct CUDA indices passes sharded_run's argument
    path, and each shard runs with its own card made current (K10 opts
    in to its shared memory once a device): here the cards are named
    and the shards run the plain version on the CPU, equal to one run
    of the whole batch."""
    from mythril_tpu_torch.parallel import mesh as M

    mesh = M.Mesh(["cuda:0", "cuda:1"])
    assert mesh.size == 2 and mesh.one_device is None
    case = _CASES["arms_33"]
    cc, st = DL.k10_case_inputs(case, "cpu")
    half = st.pc.shape[0] // 2
    shards = (DL.view_of(st, (0, half)), DL.view_of(st, (half, half)))
    current, ran = [None], []

    @contextlib.contextmanager
    def on(dev):
        before, current[0] = current[0], dev
        yield
        current[0] = before

    plain_run = T.run
    monkeypatch.setattr(M, "_on", on)
    monkeypatch.setattr(M.stepper, "run", lambda c, shard, k: (
        ran.append((current[0], shard)), plain_run(c, shard, k)))
    out = M.sharded_run((cc, cc), M.ShardedLanes(mesh, shards),
                        case.max_steps, mesh)
    assert [d for d, _ in ran] == list(mesh.devices)
    assert all(a is b for (_, a), b in zip(ran, shards))
    assert out.shards == shards
    got = interop.state_to_numpy(st)
    want = _plain("arms_33")
    for f in T.LANE_FIELDS:
        np.testing.assert_array_equal(got[f][:2 * half], want[f][:2 * half],
                                      err_msg=f)


_SIZES = [size[1:] for size in DL.k10_case_sizes(full=True)]
_SIZES += [(32768, 16, 64, 4, len(contracts.build_bench_contract())),
           (4096, 16, 64, 4, len(contracts.build_bench_contract())),
           (131072, 64, 4096, 64, len(contracts.build_lane_mix_contract())),
           (1, 1, 1, 1, 0), (5, 2000, 33, 3, 70000)]


@pytest.mark.parametrize("n,d,m,s,code", _SIZES)
def test_lane_run_plan(n, d, m, s, code):
    """A block's shared memory holds its lanes' rows and a word of
    scratch each, stack rows start 16-byte aligned clear of the
    previous lane's bank groups, storage rows have an odd stride, rows
    past the on-chip budget stay in place, the grid covers every lane,
    and the batch's blocks leave no SM idle where it has the lanes."""
    p = T.lane_run_plan(n, d, m, s, code)
    lpb = p["lanes_per_block"]
    assert T.K10_MIN_LPB <= lpb <= T.K10_MAX_LPB
    assert p["blocks"] * lpb >= n > (p["blocks"] - 1) * lpb
    assert p["stack_words"] == 8 * d + 4 and p["stack_words"] % 8 == 4
    assert p["store_words"] == 8 * s + 1
    assert p["mem_bytes"] >= m and p["mem_bytes"] % 16 == 0
    assert p["head_bytes"] % 16 == 0
    assert p["head_bytes"] == (-(-(code + 1) * 8 // 16) * 16
                               if p["code_shared"] else T.K10_HEAD)
    on_chip = 4 * p["stack_words"] + 8 * p["store_words"] + p["mem_bytes"]
    assert p["smem"] == p["head_bytes"] + lpb * (
        T.K10_SCRATCH + p["local"] * on_chip) <= T.H100_SMEM_OPTIN
    assert p["local"] == int(p["head_bytes"] + lpb * (T.K10_SCRATCH + on_chip)
                             <= T.K10_LOCAL_BUDGET)
    assert p["code_shared"] == int((code + 1) * 8 <= T.K10_CODE_BUDGET)
    if n >= 2 * T.H100_SMS * T.K10_MAX_LPB:
        assert lpb == T.K10_MAX_LPB
    elif lpb > T.K10_MIN_LPB:
        assert p["blocks"] >= 2 * T.H100_SMS


def test_bench_batch_runs_in_one_wave():
    """bench_device's batch (32768 lanes of BENCH_LANE_KW planes): every
    row on chip, 4 blocks of 64 lanes share an SM (each block also
    holds 1 KB the card reserves), so the 512 blocks fit 132 SMs at
    once."""
    p = T.lane_run_plan(32768, 16, 64, 4,
                        len(contracts.build_bench_contract()))
    assert p["local"] and p["code_shared"] and p["lanes_per_block"] == 64
    assert 4 * (p["smem"] + 1024) <= 233472
    assert p["blocks"] <= 4 * T.H100_SMS


def test_lane_run_plan_raises_on_what_it_does_not_take():
    """Empty planes raise; a stack past the shared memory of a block
    runs in place."""
    with pytest.raises(ValueError):
        T.lane_run_plan(8, 0, 64, 4, 10)
    assert T.lane_run_plan(8, 8000, 64, 4, 10)["local"] == 0
