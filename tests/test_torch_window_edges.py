"""K2's and K4's plain versions on the CPU against the JAX package, on
``device_loop.k2_edge_cases`` and ``k4_edge_cases`` (chip_smoke.py
holds the kernels to the plain versions on the same inputs), bit for
bit: every output is an integer plane, so the tolerance is 0.

The JAX side of K2 is the first stage of ``_window_exec`` (the remap and
log reset ``_remap_reset_core``, the kill scatter, the SHA3 resume
scatters, ``_prologue_core``), of K4 its last (the hold and retire
selection, ``_resume_gather_core``, ``_retire_gather_core``, the DEAD
scatter, ``_counts_core``, ``_unique_table``, ``_fork_table``), each
written out here as ``_window_exec`` runs it. Also K4's outputs as views
of one buffer, and the one-copy pull of such views."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import stepper as JST
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.support import device_loop as DL

_K2 = {c.name: c for c in DL.k2_edge_cases()}
_K4 = {c.name: c for c in DL.k4_edge_cases()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(planes):
    return JS.SymLaneState(**{k: jnp.asarray(v) for k, v in planes.items()})


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _equal(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_state(t_st, j_st, what):
    got = interop.state_to_numpy(t_st)
    for f in TS.FIELDS:
        _equal(got[f], getattr(j_st, f), f"{what}: {f}")


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_prologue(st, i32buf, u8buf, k, pv):
    """``_window_exec``'s stage 1 (``mythril_tpu/laser/lane_engine.py``
    :1143-1184), as it runs it."""
    n, n_env = st.pc.shape[0], st.env.shape[1]
    n_depth = st.stack.shape[1]
    sd = min(JL.SEED_STACK, n_depth)
    mc = min(JL.SEED_MEM, st.memory.shape[1])
    ccw = min(JL.SEED_CD, st.calldata.shape[1])
    a = JL._unpack_i32_sections(i32buf, JL._seed_sections(n, k, n_env, sd,
                                                          pv))
    u8p = u8buf[:k * ccw].reshape(k, ccw)
    mem_v = u8buf[k * ccw:k * (ccw + mc)].reshape(k, mc)
    mem_k = u8buf[k * (ccw + mc):k * (ccw + 2 * mc)].reshape(k, mc)
    st = JL._remap_reset_core(st, a["prov"])
    st = st._replace(status=st.status.at[a["kill"]].set(JS.DEAD,
                                                       mode="drop"))
    r, ri = a["r_idx"], a["r_i32"]
    slot = jnp.clip(ri[:, 1] - 1, 0, n_depth - 1)
    st = st._replace(
        pc=st.pc.at[r].set(ri[:, 0], mode="drop"),
        sp=st.sp.at[r].set(ri[:, 1], mode="drop"),
        msize=st.msize.at[r].set(ri[:, 2], mode="drop"),
        min_gas=st.min_gas.at[r].set(ri[:, 3].astype(st.min_gas.dtype),
                                     mode="drop"),
        max_gas=st.max_gas.at[r].set(ri[:, 4].astype(st.max_gas.dtype),
                                     mode="drop"),
        ssid=st.ssid.at[r, slot].set(ri[:, 5], mode="drop"),
        stack=st.stack.at[r, slot].set(a["r_limbs"], mode="drop"),
        status=st.status.at[r].set(JST.Status.RUNNING, mode="drop"))
    return JL._prologue_core(st, a["idx"], a["i32p"], a["u32p"], u8p,
                             a["stack_v"], a["stack_s"], mem_v, mem_k,
                             a["fs"], a["fcount"])


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_epilogue(st, cc, canon, budget, resume_on):
    """``_window_exec``'s stages 5 and 6 (:1186-1233), as it runs
    them."""
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    dstack, dmem, dmlog, dslot = JL.RETIRE_FLOORS
    rcap = min(JL.RCAP, n)
    parked = (st.status == JST.Status.NEEDS_HOST) | (
        (st.status == JST.Status.RUNNING) & (st.steps >= budget))
    fits = ((st.sp <= dstack) & (st.msize <= dmem)
            & (st.mlog_count <= dmlog) & (st.scount <= dslot))
    hcap = min(JL.HOLD_CAP, n)
    op_at_pc = cc.opcode[jnp.clip(st.pc, 0, cc.packed.shape[0] - 1)]
    hold = ((resume_on != 0) & (st.status == JST.Status.NEEDS_HOST)
            & (op_at_pc == JL._SHA3_BYTE) & (st.sp >= 2)
            & (st.msize <= JL.RESUME_MEM) & (st.mlog_count <= JL.RESUME_MLOG))
    horder = jnp.cumsum(hold.astype(jnp.int32)) - 1
    hold = hold & (horder < hcap)
    hidx = jnp.sort(jnp.where(hold, jnp.arange(n), n).astype(jnp.int32))[
        :hcap]
    hrows = JL._resume_gather_core(st, jnp.clip(hidx, 0, n - 1))
    elig = parked & fits & ~hold
    order = jnp.cumsum(elig.astype(jnp.int32)) - 1
    take = elig & (order < rcap)
    ridx = jnp.sort(jnp.where(take, jnp.arange(n), n).astype(jnp.int32))[
        :rcap]
    rows = JL._retire_gather_core(st, jnp.clip(ridx, 0, n - 1), rcap,
                                  dstack, dmem, dmlog, dslot)
    st = st._replace(status=st.status.at[ridx].set(JS.DEAD, mode="drop"))
    misc, scal = JL._counts_core(st)
    utab, ucount = JL._unique_table(st, canon, d_recs,
                                    min(JL.URB, n * d_recs))
    ftab = JL._fork_table(st, min(JL.FB, n))
    scal = jnp.concatenate([scal, ucount[None]])
    return st, (misc, scal, utab, ftab, ridx) + rows + (hidx,) + hrows


@pytest.mark.parametrize("name", sorted(_K2))
def test_k2_edge_case_matches_the_jax_package(name):
    case = _K2[name]
    st, i32b, u8b, k, pv = DL.k2_case_state(case, "cpu")
    got = TL.prologue_plain(st, i32b, u8b, k, pv)
    want = _jax_prologue(_jax_state(case.planes), jnp.asarray(case.i32buf),
                         jnp.asarray(case.u8buf), k, pv)
    _same_state(got, want, name)


@pytest.mark.parametrize("name", sorted(_K4))
def test_k4_edge_case_matches_the_jax_package(name):
    case = _K4[name]
    st, cc, canon, budget, resume_on = DL.k4_case_inputs(case, "cpu")
    got_st, got = TL.epilogue_plain(st, cc, canon, budget, resume_on)
    want_st, want = _jax_epilogue(
        _jax_state(case.planes), JST.compile_code(case.code),
        jnp.asarray(case.canon), budget, jnp.asarray(resume_on, jnp.int32))
    _same_state(got_st, want_st, name)
    assert len(got) == len(want) == 12
    for i, (x, y) in enumerate(zip(got, want)):
        _equal(x, y, f"{name} output {i}")


def test_k2_indices_case_holds_the_rules():
    """What the ``indices`` case is for, on the plain version (equal to
    the JAX package's above)."""
    case = _K2["indices"]
    st, i32b, u8b, k, pv = DL.k2_case_state(case, "cpu")
    out = TL.prologue_plain(st, i32b, u8b, k, pv)
    n, r = case.lanes, case.widths["dlog_records"]
    a = TL._unpack_i32_sections(
        case.i32buf, TL._seed_sections(n, k, TS.N_ENV, 16, pv))
    status = out.status.numpy()
    # a kill at -1 is lane n-1's, a resume at -2 lane n-2's, a seed at -n
    # lane 0's; killed, then resumed or seeded: RUNNING
    assert status[n - 1] == TS.DEAD and status[7] == TS.DEAD
    assert status[n - 2] == 0 and status[4] == 0
    assert status[0] == 0 and status[6] == 0
    # seeded twice (entries 3 and 4): the last wins; -3 seeds lane n-3
    assert int(out.pc[12]) == int(a["i32p"][4, 4])
    assert int(out.pc[n - 3]) == int(a["i32p"][2, 4])
    # a lane resumed and seeded takes the seed
    assert int(out.pc[10]) == int(a["i32p"][1, 4])
    # resumed twice: the last entry's pc
    assert int(out.pc[9]) == int(a["r_i32"][3, 0])
    # the last pair of a slot wins (slot 5; slot n*R-1, named -1 first);
    # slot 0 from -n*R; one no pair names: unresolved
    table = TL.prov_table(st, torch.from_numpy(a["prov"])).reshape(-1)
    assert int(table[5]) == 17 and int(table[0]) == 12
    assert int(table[n * r - 1]) == 18 and int(table[1]) == -(1 << 31)


def test_k4_edge_cases_hold_the_rules():
    """The caps: HOLD_CAP holds, RCAP retires and no held lane among
    them; the unique and fork tables past their budgets."""
    case = _K4["caps_over"]
    st, cc, canon, budget, resume_on = DL.k4_case_inputs(case, "cpu")
    _, out = TL.epilogue_plain(st, cc, canon, budget, resume_on)
    hidx, ridx = out[8].numpy(), out[4].numpy()
    n = case.lanes
    assert (hidx < n).sum() == TL.HOLD_CAP and (ridx < n).sum() == TL.RCAP
    assert not set(hidx.tolist()) & set(ridx.tolist())
    assert (np.diff(hidx) > 0).all() and (np.diff(ridx) > 0).all()
    off = _K4["resume_off"]
    _, out = TL.epilogue_plain(*DL.k4_case_inputs(off, "cpu"))
    assert (out[8].numpy() == n).all()
    case = _K4["urb_over"]
    _, out = TL.epilogue_plain(*DL.k4_case_inputs(case, "cpu"))
    assert int(out[1][2]) == case.lanes * case.widths["dlog_records"] \
        > TL.URB
    case = _K4["fb_over"]
    _, out = TL.epilogue_plain(*DL.k4_case_inputs(case, "cpu"))
    assert int(out[1][0]) > TL.FB == out[3].shape[0]


@pytest.mark.parametrize("name", ["lanes_33", "caps_over", "fb_over"])
def test_k4_outputs_as_views_of_one_buffer(name):
    """K4's outputs are views of one allocation (``_k4_plan``'s
    sections, 16-byte aligned), with the 12 arrays' shapes and dtypes;
    written with the plain outputs, the views (and ``Outputs``, the
    wrapper's sequence of them) read them back, and ``_one_buffer`` /
    ``_host_views`` (the one-copy pull) give the same arrays from the
    buffer's bytes."""
    st, cc, canon, budget, resume_on = DL.k4_case_inputs(_K4[name], "cpu")
    _, want = TL.epilogue_plain(st, cc, canon, budget, resume_on)
    lay, sections, nbytes, _ = TL._k4_plan(st, (1, 1024, 0, 1))
    offsets = [off * (1 if u8 else 4) for u8, _, _, off in sections]
    assert all(off % 16 == 0 for off in offsets)
    base = torch.zeros(nbytes // 4, dtype=torch.int32)
    views = TL._views(base, sections)
    assert len(views) == 12
    for v, w in zip(views, want):
        assert v.shape == w.shape and v.dtype == w.dtype
        v.copy_(w)
    assert list(lay)[10:] == offsets
    outs = TL.Outputs(base, sections)
    assert len(outs) == 12
    for v, w in zip(outs, want):
        np.testing.assert_array_equal(v.numpy(), w.numpy())
    raw, parts = TL._one_buffer(outs)
    assert raw.data_ptr() == base.data_ptr() and raw.numel() == nbytes
    for h, w in zip(TL._host_views(raw.numpy(), parts), want):
        assert h.dtype == w.numpy().dtype
        np.testing.assert_array_equal(h, w.numpy())


def test_one_copy_pull_equals_separate_tensors():
    """``Outputs`` of mixed int32 and uint8 sections (odd byte counts,
    16-byte aligned) read back from one copy of their buffer's bytes
    (``_one_buffer``, ``_host_views``) equal the same arrays as separate
    tensors."""
    rng = np.random.default_rng(9)
    shapes = [(torch.int32, (5, 3)), (torch.uint8, (7, 6)),
              (torch.int32, (2,)), (torch.uint8, (3,))]
    sections, nbytes = TL._layout(shapes)
    assert [off * (1 if u8 else 4) for u8, _, _, off in sections] == \
        [0, 64, 112, 128] and nbytes == 144
    base = torch.zeros(nbytes // 4, dtype=torch.int32)
    outs = TL.Outputs(base, sections)
    apart = []
    for v, (dtype, shape) in zip(outs, shapes):
        x = torch.from_numpy(rng.integers(0, 200, shape).astype(
            np.int32 if dtype is torch.int32 else np.uint8))
        v.copy_(x)
        apart.append(x.clone())
    raw, parts = TL._one_buffer(outs)
    for h, x in zip(TL._host_views(raw.numpy().copy(), parts), apart):
        assert h.dtype == x.numpy().dtype
        np.testing.assert_array_equal(h, x.numpy())
