"""K5 ``interval_levels`` (mythril_tpu_torch/ops/intervals.py) against
the JAX package on the CPU.

On every edge input of ``support/screen_waves.k5_edge_cases`` the plain
version (``seed_tables``, then ``eval_level_plain`` level by level)
gives the JAX tables (the seeds scattered with ``mode="drop"``, then
``_eval_level_jit`` level by level) after every level, bit for bit, and
so does the plain version on K5's layout (``eval_levels_plain``, the
levels' real entries in kernel order). The layout keeps every real
entry once, resolves every index by JAX's rules, and its flags hold on
the JAX tables: an operand it reads from the init tables equals them in
every state. JAX's index rules themselves: a negative operand row wraps once
and then clamps, a negative node wraps once and is dropped when still
out of range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.ops import intervals as JI
from mythril_tpu_torch.ops import bv256
from mythril_tpu_torch.ops import intervals as I
from mythril_tpu_torch.support.screen_waves import k5_edge_cases

CASES = k5_edge_cases()
#: a class table of the kind the card's layout takes from csrc/screen.cu
#: (``fwd_classes``): bool-valued ops 0, the heavy transfers 2
CLASSES = [0 if op in (I.EQ, I.ULT, I.ULE, I.BAND2, I.BOR2, I.BNOT1, I.BXOR2,
                       I.BITE) else 2 if op in (
    I.MUL, I.UDIV, I.UREM, I.BOR, I.BXOR) else 1 for op in range(32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(t):
    return t.numpy().view(np.uint32)


def jax_tables(enc):
    """The JAX tables after the seeds and after every level: [(lo, hi)]
    as numpy."""
    shape = (enc.seed_idx.shape[0],) + enc.init_lo.shape
    lo = jnp.broadcast_to(jnp.asarray(enc.init_lo), shape)
    hi = jnp.broadcast_to(jnp.asarray(enc.init_hi), shape)
    rows = jnp.arange(shape[0])[:, None]
    seed_idx = jnp.asarray(enc.seed_idx)
    lo = lo.at[rows, seed_idx].set(jnp.asarray(enc.seed_lo), mode="drop")
    hi = hi.at[rows, seed_idx].set(jnp.asarray(enc.seed_hi), mode="drop")
    out = [(np.asarray(lo), np.asarray(hi))]
    for level in enc.levels:
        arrays = {k: jnp.asarray(v) for k, v in level.items()
                  if k != "ops_present"}
        lo, hi = JI._eval_level_jit(arrays, lo, hi,
                                    ops_present=level["ops_present"])
        out.append((np.asarray(lo), np.asarray(hi)))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(jax_runs, name):
    if name not in jax_runs:
        jax_runs[name] = jax_tables(CASES[name])
    return jax_runs[name]


def _layout(enc, bound=False):
    lay = I.interval_layout(enc.levels, enc.init_lo.shape[0], CLASSES,
                            (enc.init_lo, enc.init_hi), enc.seed_idx)
    if not bound:
        return lay
    return I.bind_layout(lay, "cpu", init_lo=enc.init_lo,
                         init_hi=enc.init_hi, seed_idx=enc.seed_idx,
                         seed_lo=enc.seed_lo, seed_hi=enc.seed_hi)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_plain_version_gives_the_jax_tables_after_every_level(
        jax_runs, name):
    enc = CASES[name]
    want = _jax(jax_runs, name)
    lo, hi = I.seed_tables(
        I.words_to_device(enc.init_lo, "cpu"),
        I.words_to_device(enc.init_hi, "cpu"),
        I.ints_to_device(enc.seed_idx, "cpu"),
        I.words_to_device(enc.seed_lo, "cpu"),
        I.words_to_device(enc.seed_hi, "cpu"))
    for i, level in enumerate([None] + enc.levels):
        if level is not None:
            I.eval_level_plain(I.level_to_device(level, "cpu"), lo, hi)
        np.testing.assert_array_equal(_u32(lo), want[i][0],
                                      err_msg=f"{name}: lo after {i} levels")
        np.testing.assert_array_equal(_u32(hi), want[i][1],
                                      err_msg=f"{name}: hi after {i} levels")


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_layout_in_kernel_order_gives_the_jax_tables(jax_runs, name):
    """The plain version on K5's bound layout, from the init tables as
    K5 takes them (the seeds scattered by the call), and the driver
    (``_run_tables``) give the JAX tables."""
    enc = CASES[name]
    want = _jax(jax_runs, name)[-1]
    lay = _layout(enc, bound=True)
    shape = (enc.seed_idx.shape[0],) + enc.init_lo.shape
    lo = lay["init_lo"].expand(shape).clone()
    hi = lay["init_hi"].expand(shape).clone()
    I.eval_levels_plain(lay, lo, hi)
    np.testing.assert_array_equal(_u32(lo), want[0])
    np.testing.assert_array_equal(_u32(hi), want[1])
    lo, hi, _, _ = I._run_tables(enc, "cpu")
    np.testing.assert_array_equal(_u32(lo), want[0])
    np.testing.assert_array_equal(_u32(hi), want[1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_layout_keeps_every_real_entry_once_in_kernel_order(name):
    enc = CASES[name]
    n_rows = enc.init_lo.shape[0]
    lay = _layout(enc)
    ent, start = lay["ent"], 0
    for li, (level, klv) in enumerate(zip(enc.levels, lay["levels"])):
        node = level["node"].astype(np.int64)
        rows = np.where(node < 0, node + n_rows, node)
        real = [(int(r), int(o)) for r, o in zip(rows, level["op"])
                if o != I.NOP and 0 <= r < n_rows]
        n = len(real)
        e = ent[start:start + n]
        assert lay["lv"][li, :2].tolist() == [start, start + n]
        got = list(zip(e[:, 0].tolist(), e[:, 1].tolist()))
        assert sorted(got) == sorted(real)
        assert len({r for r, _ in got}) == n  # distinct rows
        key = [(CLASSES[o], o) for _, o in got]
        assert key == sorted(key)
        assert lay["counts"][li] == [sum(c == k for c, _ in key)
                                     for k in range(3)]
        assert klv["op"].tolist() == e[:, 1].tolist()
        args = klv["args"].numpy().astype(np.int64)
        want = np.clip(np.where(args < 0, args + n_rows, args), 0, n_rows - 1)
        np.testing.assert_array_equal(e[:, 2:5], want)
        np.testing.assert_array_equal(e[:, 5:7], args[:, 1:])
        start += n
    assert start == ent.shape[0] == lay["mask"].shape[0]
    hazards = [bool(h) for h in lay["lv"][:, 2]]
    assert hazards == [name == "reads_own_level" and li == 1
                       for li in range(len(enc.levels))]
    assert lay["stage_words"] == (16 * int(np.diff(lay["lv"][1, :2])[0])
                                  if any(hazards) else 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_layouts_static_rows_hold_on_the_jax_tables(jax_runs, name):
    """Where the layout reads an operand from the init tables, every
    state's row equals the init row when its level runs."""
    enc = CASES[name]
    tabs = _jax(jax_runs, name)
    lay = _layout(enc)
    init = (enc.init_lo.view(np.uint32), enc.init_hi.view(np.uint32))
    nread = I.operand_reads(lay["ent"][:, 1])
    flagged = 0
    for li, (a, b, _, _) in enumerate(lay["lv"]):
        lo, hi = tabs[li]
        for j in range(a, b):
            e = lay["ent"][j]
            for k, flag in enumerate((I.IV_SA, I.IV_SB, I.IV_SC)):
                if e[7] & flag:
                    assert k < nread[j]
                    r = e[2 + k]
                    assert (lo[:, r] == init[0][r]).all()
                    assert (hi[:, r] == init[1][r]).all()
                    flagged += 1
    assert flagged or name == "pads_only"


def test_a_negative_operand_row_wraps_once_and_a_negative_node_too():
    """One ADD over rows lo = [1, 2, 3, 4], hi = [1, 2, 3, 40]: its
    first operand -1 reads row 3 (JAX wraps once), its node -3 writes
    row 1, so row 1 becomes [5, 41]; an operand -9 wraps to -5 and
    clamps to row 0, a node -9 is dropped."""
    def word(v):
        return bv256.int_to_limbs(v).astype(np.uint32)

    lo0 = np.stack([word(v) for v in (1, 2, 3, 4)])[None]
    hi0 = np.stack([word(v) for v in (1, 2, 3, 40)])[None]
    full = word((1 << 256) - 1)
    level = dict(node=np.array([-3, -9], np.int32),
                 op=np.array([I.ADD, I.ADD], np.int32),
                 args=np.array([[-1, 0, 0], [-9, -9, 0]], np.int32),
                 mask=np.stack([full, full]),
                 aux=np.zeros((2, 8), np.uint32))
    arrays = {k: jnp.asarray(v) for k, v in level.items()}
    jlo, jhi = JI._eval_level_jit(arrays, jnp.asarray(lo0), jnp.asarray(hi0),
                                  ops_present=I._canonical_ops({I.ADD}))
    jlo, jhi = np.asarray(jlo), np.asarray(jhi)
    assert jlo[0, :, 0].tolist() == [1, 5, 3, 4]
    assert jhi[0, :, 0].tolist() == [1, 41, 3, 40]
    lo = torch.from_numpy(lo0.view(np.int32).copy())
    hi = torch.from_numpy(hi0.view(np.int32).copy())
    I.eval_level_plain(I.level_to_device(dict(
        level, ops_present=(I.ADD,)), "cpu"), lo, hi)
    np.testing.assert_array_equal(_u32(lo), jlo)
    np.testing.assert_array_equal(_u32(hi), jhi)
    lay = I.interval_layout([level], 4)
    assert lay["ent"][:, :5].tolist() == [[1, I.ADD, 3, 0, 0]]


@pytest.mark.parametrize("states", [1, 7, 33, 8192])
@pytest.mark.parametrize("resident", [1, 5, 1056])
@pytest.mark.parametrize("name", ["wide_level", "reads_own_level",
                                  "every_class"])
def test_the_launches_run_every_entry_once_a_state(states, resident, name):
    """K5's launches under ``iv_launch_shape``, as the kernels index
    them: a level's class launch thread i takes state i // n, entry base
    + i % n (``iv_level_kernel``); a staged level's block b the states b,
    b + blocks, ..., its thread t the entries t, t + threads, ... with
    their slots inside the block's staging (``iv_staged_kernel``): every
    (state, entry) once, class launches in layout order."""
    lay = _layout(CASES[name])
    launches, (threads, blocks) = I.iv_launch_shape(lay, states, resident)
    assert threads % 32 == 0 and 32 <= threads <= I.IV_THREADS
    assert blocks == min(states, resident)
    n_all = lay["ent"].shape[0]
    seen = np.zeros((states, n_all), np.int64)
    todo = list(launches)
    for li, (a, e, hazard, _) in enumerate(lay["lv"]):
        if hazard:
            assert threads >= min(I.IV_THREADS, e - a)
            for b in range(blocks):
                for s in range(b, states, blocks):
                    for t in range(threads):
                        for j in range(t, e - a, threads):
                            assert 16 * j + 16 <= lay["stage_words"]
                            seen[s, a + j] += 1
            continue
        base = a
        for c, n in enumerate(lay["counts"][li]):
            if not n:
                continue
            assert todo.pop(0) == (li, c, -(-n * states // I.IV_LEVEL_THREADS))
            i = np.arange(n * states)
            np.add.at(seen, (i // n, base + i % n), 1)
            assert all(CLASSES[o] == c for o in lay["ent"][base:base + n, 1])
            base += n
        assert base == e
    assert not todo and (seen == 1).all()


def test_the_bound_layout_is_one_allocation_of_aligned_sections():
    enc = CASES["negative_index"]
    lay = _layout(enc, bound=True)
    buf = lay["buf"]
    for key in ("ent", "mask", "aux", "init_lo", "init_hi",
                "seed_idx", "seed_lo", "seed_hi"):
        t = lay[key]
        assert t.untyped_storage().data_ptr() == buf.untyped_storage(
        ).data_ptr()
        assert (t.data_ptr() - buf.data_ptr()) % 16 == 0
    np.testing.assert_array_equal(lay["ent"].numpy(), _layout(enc)["ent"])
    np.testing.assert_array_equal(lay["seed_lo"].numpy().view(np.uint32),
                                  enc.seed_lo)


def test_k6_and_k7_layouts_follow_the_jax_index_rules():
    """K6's and K7's layouts (``propagate.level_layout``,
    ``round_layout``) and their plain versions on the same kind of
    input as ``negative_index``: on the all-opcode wave's plan, a level
    whose operand rows wrap (-T + r) or wrap and clamp (-T - 5), whose
    node wraps onto itself (-T + r) or is dropped (-T - 1), and a round
    whose parent and target wrap and one of whose targets is dropped;
    the JAX ``_fwd_level_jit`` and ``_back_round_jit`` give the same
    tables, and the layouts hold the rows the JAX rules resolve."""
    from mythril_tpu.ops import propagate as JP
    from mythril_tpu.smt import terms as JT
    from mythril_tpu_torch import interop
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import layered_sets

    plan = JP.build_plan(JI.linearize(layered_sets(JT)))
    arrays = plan.arrays
    n_rows = np.asarray(arrays["init_lo"]).shape[0]
    level = {k: np.array(v) for k, v in arrays["levels"][1].items()}
    by_op = {int(o): j for j, o in enumerate(level["op"]) if o}
    leaf = int(np.asarray(arrays["levels"][0]["args"])[0, 0])
    level["args"][by_op[I.CONCAT2], 0] = leaf - n_rows
    level["args"][by_op[I.MUL], 1] = -n_rows - 5
    level["node"][by_op[I.EQ]] -= n_rows
    level["node"][by_op[I.ULT]] = -n_rows - 1
    li, rnd = next((li, {k: np.array(v) for k, v in r.items()})
                   for li, rs in enumerate(arrays["back"]) for r in rs
                   if int((np.asarray(r["tgt"]) < n_rows).sum()) > 2)
    real = np.nonzero(rnd["tgt"] < n_rows)[0]
    rnd["parent"][real[0]] -= n_rows
    rnd["tgt"][real[0]] -= n_rows
    rnd["tgt_c"][real[0]] -= n_rows
    rnd["tgt"][real[1]] = -n_rows - 1
    rnd["tgt_c"][real[1]] = -n_rows - 1
    init = tuple(np.asarray(t) for t in JP._init_tables_jit(
        {k: v for k, v in arrays.items() if k not in ("levels", "back")}))
    _, level_ops, back_ops = plan.statics
    want_f = JP._fwd_level_jit({k: jnp.asarray(v) for k, v in level.items()},
                               *map(jnp.asarray, init),
                               ops_present=level_ops[1])
    ri = [i for i, r in enumerate(arrays["back"][li])
          if np.array_equal(np.asarray(r["op"]), rnd["op"])][0]
    want_b = JP._back_round_jit({k: jnp.asarray(v) for k, v in rnd.items()},
                                *map(jnp.asarray, init),
                                ops_present=back_ops[li][ri])
    arrays = dict(arrays, levels=list(arrays["levels"]),
                  back=[list(rs) for rs in arrays["back"]])
    arrays["levels"][1] = level
    arrays["back"][li][ri] = rnd
    core = P.plan_to_device(interop.plan_from_numpy(arrays, plan.statics),
                            "cpu")
    lay = P.kernel_layout(core)

    def port(tabs):
        return tuple(torch.from_numpy(t.view(np.int32).copy()) for t in tabs)

    for step, want in ((lambda t: P.fwd_level_plain(lay["levels"][1], t),
                        want_f),
                       (lambda t: P.back_round_plain(lay["back"][li][ri], t),
                        want_b)):
        tabs = port(init)
        step(tabs)
        for g, w in zip(tabs, want):
            np.testing.assert_array_equal(_u32(g), np.asarray(w))
    ent = lay["levels"][1]["ent"]
    assert int(ent[:, 0].min()) >= 0 and int(ent[:, 2:5].min()) >= 0
    rent = lay["back"][li][ri]["ent"]
    assert int(rent[:, :5].min()) >= 0 and int(rent[:, :5].max()) < n_rows
    assert rent.shape[0] == len(real) - 1
