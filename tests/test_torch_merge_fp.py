"""The window-merge fingerprint (kernel K9's plain version,
``lane_engine.merge_fingerprint_plain``) against the JAX package's
``_merge_fingerprint``, bit for bit: on lane states after a 32-step
window of the merge rig (the diamond contract) and of the
``bench_symbolic`` contract, with the window's real resolution pairs,
and on seeded random planes with provisional sids, padded pairs, tied
write stamps and full storage tables. The JAX state is the port's,
carried across with ``interop.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.support import device_loop as DL
from mythril_tpu_torch.ops import stepper as TST
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.support import contracts

KW = dict(stack_depth=16, memory_bytes=128, mem_records=8, storage_slots=8,
          calldata_bytes=64, dlog_records=16)
N = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(planes):
    return JS.SymLaneState(**{f: jnp.asarray(planes[f]) for f in TS.FIELDS})


def _same_fp(tst, pairs):
    got = TL.merge_fingerprint_plain(tst, torch.from_numpy(pairs))
    want = np.asarray(JL._merge_fingerprint(
        _jax_state(interop.state_to_numpy(tst)), jnp.asarray(pairs)))
    assert want.dtype == np.uint32 and want.shape == (tst.pc.shape[0], 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    return want


def _after_window(code, seeds):
    """The port's lane state after one 32-step window from ``seeds``,
    and the window's resolution pairs (each canonical record gets the
    next object id, as the drain assigns them), padded to a bucket."""
    st = TS.init_sym_lanes(N, device="cpu", **KW)
    cc = TST.compile_code(code, device="cpu")
    vis = torch.zeros(cc.packed.shape[0], dtype=torch.bool)
    entries = [(N - 1 - i, s) for i, s in enumerate(seeds)]
    free = list(range(N - 1 - len(seeds), -1, -1))
    i32b, u8b, k, pv = TL.pack_window(N, TS.N_ENV, KW, entries, free, [],
                                      {}, KW["calldata_bytes"])
    st, _, out = TL.window_exec(
        st, cc, torch.from_numpy(i32b), torch.from_numpy(u8b),
        TS.SYM_EXECUTABLE, np.zeros(256, bool), 32, k,
        TL.DEFAULT_STEP_BUDGET, pv, vis, 0)
    utab, ucount = out[2].numpy(), int(out[1][2])
    d = KW["dlog_records"]
    pairs = np.full((max(8, 2 * ucount), 2), N * d, np.int32)
    for j, row in enumerate(utab[:ucount]):
        pairs[j] = (int(row[0]) * d + int(row[1]), 1000 + j)
    return st, pairs, ucount


def test_diamond_state_after_a_window():
    objs = TL.ObjectTable()
    code = contracts.build_diamond_contract(k=6, dup_levels=2)
    seeds = [DL.tx_entry_seed(objs, g, KW["calldata_bytes"])
             for g in (1, 2)]
    st, pairs, ucount = _after_window(code, seeds)
    live = int((st.status == 0).sum())
    assert live > 4 and ucount > 0
    fp = _same_fp(st, pairs)
    # the rig's point: rejoined twins of one seed share a fingerprint
    running = np.nonzero(st.status.numpy() == 0)[0]
    keys = {(int(fp[i, 0]), int(fp[i, 1])) for i in running}
    assert len(keys) < len(running)


def test_symbolic_contract_state_after_a_window():
    """Storage writes (ranks), memory words and provisional sids in the
    stack and storage planes."""
    objs = TL.ObjectTable()
    code, _ = contracts.build_symbolic_contract(5)
    st, pairs, ucount = _after_window(
        code, [DL.tx_entry_seed(objs, 1, KW["calldata_bytes"])])
    assert ucount > 0 and int(st.scount.max()) > 0
    assert bool((st.ssid < 0).any() | (st.sval_sid < 0).any())
    _same_fp(st, pairs)


def _random_planes(rng, n=N):
    """Seeded random planes of every field, in the JAX dtypes."""
    st = interop.state_to_numpy(TS.init_sym_lanes(n, device="cpu", **KW))
    d = KW["dlog_records"]
    out = {}
    for name, arr in st.items():
        if arr.dtype == np.uint8:
            out[name] = rng.integers(0, 256, arr.shape, dtype=np.uint8)
        elif arr.dtype == np.uint32:
            out[name] = rng.integers(0, 1 << 32, arr.shape,
                                     dtype=np.uint64).astype(np.uint32)
        else:
            out[name] = rng.integers(-50, 50, arr.shape).astype(np.int32)

    def sids(shape):
        """0 (concrete), object ids, provisional ids of real and
        unresolved slots, and the unresolved marker int32 min."""
        kind = rng.integers(0, 5, shape)
        prov = -(rng.integers(0, n * d, shape) + 1)
        vals = np.select(
            [kind == 0, kind == 1, kind == 2, kind == 3],
            [0, rng.integers(1, 5000, shape), prov, -(n * d + 5)],
            np.iinfo(np.int32).min)
        return vals.astype(np.int32)

    for f in ("ssid", "mlog_sid", "skey_sid", "sval_sid"):
        out[f] = sids(out[f].shape)
    out["mkind"] = rng.integers(0, 4, out["mkind"].shape, dtype=np.uint8)
    out["sp"] = rng.integers(0, KW["stack_depth"] + 1, n).astype(np.int32)
    out["mlog_count"] = rng.integers(
        0, KW["mem_records"] + 1, n).astype(np.int32)
    s = KW["storage_slots"]
    out["scount"] = np.where(rng.random(n) < 0.5, s,
                             rng.integers(0, s + 1, n)).astype(np.int32)
    out["s_written"] = rng.integers(0, 2, out["s_written"].shape,
                                    dtype=np.int32)
    # write stamps drawn from a few values: many ties within a lane
    out["s_wstep"] = rng.integers(0, 4, out["s_wstep"].shape,
                                  dtype=np.int32)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_planes(seed):
    rng = np.random.default_rng(seed)
    planes = _random_planes(rng)
    st = interop.state_from_numpy(planes, "cpu")
    d = KW["dlog_records"]
    np_real = 300
    pairs = np.full((512, 2), N * d, np.int32)
    slots = rng.choice(N * d, np_real, replace=False)
    pairs[:np_real, 0] = slots
    pairs[:np_real, 1] = rng.integers(1, 1 << 20, np_real)
    # a negative slot counts from the end, one past the table drops
    pairs[np_real:np_real + 3, 0] = (-1, N * d + 7, -N * d)
    fp = _same_fp(st, pairs)
    assert len({(int(a), int(b)) for a, b in fp[:, :2]}) == N


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(7)
    st = interop.state_from_numpy(_random_planes(rng), "cpu")
    pairs = torch.full((8, 2), N * KW["dlog_records"], dtype=torch.int32)
    from mythril_tpu_torch import _build

    before = _build.LAUNCHES["merge_fingerprint"]
    got = TL.merge_fingerprint(st, pairs)
    assert _build.LAUNCHES["merge_fingerprint"] == before
    np.testing.assert_array_equal(
        got.numpy(), TL.merge_fingerprint_plain(st, pairs).numpy())


def test_resolution_pairs_count_negative_slots_from_the_end():
    """The JAX ``.at[slot].set(mode="drop")`` scatter of the resolution
    pairs wraps a negative slot and drops one out of range either way;
    the window prologue's remap (K2's plain version) and K9's table do
    the same."""
    rng = np.random.default_rng(11)
    planes = _random_planes(rng)
    st = interop.state_from_numpy(planes, "cpu")
    size = N * KW["dlog_records"]
    pairs = np.array([[-1, 7], [-size, 8], [-size - 1, 9], [size, 10],
                      [5, 11]], np.int32)
    want = JL._remap_reset_core(_jax_state(planes), jnp.asarray(pairs))
    got = interop.state_to_numpy(
        TL._remap_reset_core(st, torch.from_numpy(pairs)))
    for f in ("ssid", "sval_sid", "skey_sid", "mlog_sid"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    table = TL.prov_table(st, torch.from_numpy(pairs)).reshape(-1)
    assert table[size - 1] == 7 and table[0] == 8 and table[5] == 11
    _same_fp(st, pairs)
