"""K6's and K11's staged level (mythril_tpu_torch/ops/propagate.py)
against the JAX package on the CPU.

A level that reads a row it writes (only a wrapped negative index makes
one): ``screen_waves.k5_edge_cases()["reads_own_level"]``, the all-opcode
wave's level 1 with MUL's second operand wrapped onto CONCAT's node. The
JAX ``_fwd_level`` reads every operand before it scatters; so do the
port's plain forward level (on the plan and on K6's layout) and its plain
fixpoints (``_run_host(..., plain=True)``, ``_fixpoint_plain``), bit for
bit with the JAX ones, from seeded tables and from the plan's own init,
while the level's op classes stored one after another (K6's class
launches before this repair) give other tables. K6's layout flags that
level (``level_layout``'s ``hazard``, K5's rule: ``reads_own_rows``) and
no level of any ``linearize`` output of ``screen_waves``; K11's fused
plan flags it and stages enough for it. A replay of the staged launch's
indexing (K6's ``fwd_staged_kernel``, K11's ``fwd_block``) runs every
(state, node) once, every operand read of a state's level before its
barrier, and each node's meet and store after it. And the plain init and verdicts follow JAX's index rules on
negative seed and assertion slots (``negative_index``'s plan)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.ops import intervals as JI
from mythril_tpu.ops import propagate as JP
from mythril_tpu.smt import terms as JT
from mythril_tpu_torch import interop
from mythril_tpu_torch.ops import intervals as I
from mythril_tpu_torch.ops import propagate as P
from mythril_tpu_torch.support.screen_waves import (
    edge_sets, k5_edge_cases, k5_edge_plans, layered_sets, prefilter_wave,
    propagation_mix)

#: the seed of the random tables
SEED = 20261013
#: a class table of the kind the card's layout takes from csrc/screen.cu
#: (``fwd_classes``): bool-valued ops 0, the heavy transfers 2
CLASSES = [0 if op in (I.EQ, I.ULT, I.ULE, I.BAND2, I.BOR2, I.BNOT1, I.BXOR2,
                       I.BITE) else 2 if op in (
    I.MUL, I.UDIV, I.UREM, I.BOR, I.BXOR) else 1 for op in range(32)]
#: K11's block (``fixpoint_kernel``)
K11_THREADS = 128
#: the edge plans with a level that reads a row it writes: that level
STAGED = {"reads_own_level": 1, "staged_wide": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def jax_plan():
    """The JAX plan of the all-opcode wave with level 1 edited as
    ``reads_own_level`` edits the encoding: (arrays, statics)."""
    plan = JP.build_plan(JI.linearize(layered_sets(JT)))
    arrays = dict(plan.arrays, levels=list(plan.arrays["levels"]))
    n_rows = np.asarray(arrays["init_lo"]).shape[0]
    level = {k: np.array(v) for k, v in arrays["levels"][1].items()}
    real = np.nonzero(level["op"] != I.NOP)[0]
    by_op = {int(level["op"][j]): j for j in real}
    level["args"][by_op[I.MUL], 1] = int(level["node"][by_op[I.CONCAT2]]) \
        - n_rows
    arrays["levels"][1] = level
    return arrays, plan.statics


def _port_core(arrays, statics):
    return P.plan_to_device(interop.plan_from_numpy(arrays, statics), "cpu")


def _port(tabs):
    return tuple(torch.from_numpy(np.asarray(t).view(np.int32).copy())
                 for t in tabs)


def _random_tables(shape):
    """Seeded (lo, hi, k0, k1) words: every row an interval of values
    below 2^12 (limb 0; so MUL's product over it does not wrap and
    depends on its operands' rows), no bit known."""
    rng = np.random.default_rng(SEED)
    ends = rng.integers(0, 1 << 12, (2,) + shape[:2])
    tabs = [np.zeros(shape, np.uint32) for _ in range(4)]
    tabs[0][..., 0] = ends.min(axis=0)
    tabs[1][..., 0] = ends.max(axis=0)
    return tuple(tabs)


def _wrapped_onto_concat(level, n_rows):
    """Whether MUL's second operand is CONCAT's node wrapped (minus the
    rows): ``reads_own_level``'s edit."""
    real = np.nonzero(np.asarray(level["op"]) != I.NOP)[0]
    by_op = {int(level["op"][j]): j for j in real}
    return int(level["args"][by_op[I.MUL]][1]) + n_rows == int(
        level["node"][by_op[I.CONCAT2]])


def test_the_jax_plan_has_the_edge_cases_edit(jax_plan):
    """The JAX plan's level 1 carries ``reads_own_level``'s edit, as
    the port's plan of that encoding (``k5_edge_plans``) does, over the
    same ops (each package numbers the wave's rows itself)."""
    arrays, _ = jax_plan
    port = k5_edge_plans()["reads_own_level"].arrays
    for what, a in (("JAX", arrays), ("port", port)):
        n_rows = np.asarray(a["init_lo"]).shape[0]
        assert _wrapped_onto_concat(a["levels"][1], n_rows), what
    assert sorted(np.asarray(arrays["levels"][1]["op"]).tolist()) == sorted(
        np.asarray(port["levels"][1]["op"]).tolist())


@pytest.mark.parametrize("start", ["init", "random"])
def test_the_plain_forward_level_reads_before_it_writes(jax_plan, start):
    arrays, statics = jax_plan
    _, level_ops, _ = statics
    init = tuple(np.asarray(t) for t in JP._init_tables_jit(
        {k: v for k, v in arrays.items() if k not in ("levels", "back")}))
    tabs = init if start == "init" else _random_tables(init[0].shape)
    level = {k: jnp.asarray(v) for k, v in arrays["levels"][1].items()}
    want = [np.asarray(w) for w in JP._fwd_level_jit(
        level, *map(jnp.asarray, tabs), ops_present=level_ops[1])]
    core = _port_core(arrays, statics)
    lay = P.kernel_layout(core)
    assert [lv["hazard"] for lv in lay["levels"]] == [False, True, False,
                                                      False]
    for what, lv in (("the plan", core["levels"][1]),
                     ("K6's layout", lay["levels"][1])):
        got = _port(tabs)
        P.fwd_level_plain(lv, got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u32(g), w, err_msg=what)
    # the level's op classes stored one after another, as K6's class
    # launches ran it in place before this repair: MUL (class 2) then
    # reads CONCAT's (class 1) new row; from the random tables the
    # tables differ, from the init tables (the rows at their full
    # ranges) MUL's result is the same either way
    n_rows = init[0].shape[1]
    ordered = P.level_layout(core["levels"][1], n_rows, CLASSES)
    got, base = _port(tabs), 0
    for n in ordered["counts"]:
        part = {k: (v[base:base + n] if torch.is_tensor(v) and v.dim()
                    else v) for k, v in ordered.items()}
        P.fwd_level_plain(part, got)
        base += n
    differs = any((_u32(g) != w).any() for g, w in zip(got, want))
    assert differs == (start == "random")


def test_the_plain_fixpoints_equal_the_jax_fixpoint(jax_plan):
    arrays, statics = jax_plan
    lo, hi, k0, k1, ok, contra, sweeps = JP._run_host(arrays, statics)
    want = [np.asarray(x) for x in (lo, hi, k0, k1)]
    cap = statics[0]
    core = _port_core(arrays, statics)
    host = P._run_host(core, cap, plain=True)
    fused = P._fixpoint_plain(core, cap)
    for what, (tabs, g_ok, g_contra, g_sweeps) in (
            ("_run_host", host), ("_fixpoint_plain", fused[:4])):
        for g, w in zip(tabs, want):
            np.testing.assert_array_equal(_u32(g), w, err_msg=what)
        np.testing.assert_array_equal(g_ok.numpy(), np.asarray(ok))
        np.testing.assert_array_equal(g_contra.numpy(), np.asarray(contra))
        assert g_sweeps == int(sweeps), what


def test_negative_slots_follow_the_jax_index_rules():
    """The plain init and verdicts (K8's plain versions) on a plan with
    ``negative_index``'s edits (level 1's operand rows and nodes wrapped,
    wrapped and clamped, or dropped; a seed slot -T + r, which wraps,
    and one -T - 3, which is dropped) and two assertion slots edited
    the same way: the JAX tables, verdicts and sweeps, through the
    init alone and through both fixpoints."""
    plan = JP.build_plan(JI.linearize(layered_sets(JT)))
    arrays = dict(plan.arrays, levels=list(plan.arrays["levels"]))
    n_rows = np.asarray(arrays["init_lo"]).shape[0]
    level = {k: np.array(v) for k, v in arrays["levels"][1].items()}
    by_op = {int(o): j for j, o in enumerate(level["op"]) if o}
    leaf = int(np.asarray(arrays["levels"][0]["args"])[0, 0])
    level["args"][by_op[I.CONCAT2], 0] = leaf - n_rows
    level["args"][by_op[I.MUL], 1] = -n_rows - 5
    level["args"][by_op[I.ITE], 2] = leaf - n_rows
    level["node"][by_op[I.EQ]] -= n_rows
    level["node"][by_op[I.ULT]] = -n_rows - 1
    arrays["levels"][1] = level
    seed_idx = np.array(arrays["seed_idx"])
    seeded = np.nonzero(seed_idx[:, 0] < n_rows)[0]
    seed_idx[seeded[0], 0] -= n_rows
    seed_idx[seeded[-1], 0] = -n_rows - 3
    assert_idx = np.array(arrays["assert_idx"])
    live = np.argwhere(np.asarray(arrays["assert_mask"]))
    assert_idx[tuple(live[0])] -= n_rows
    assert_idx[tuple(live[-1])] = -n_rows - 2
    arrays.update(seed_idx=seed_idx, assert_idx=assert_idx)
    core_arrays = {k: v for k, v in arrays.items()
                   if k not in ("levels", "back")}
    want_init = [np.asarray(t) for t in JP._init_tables_jit(core_arrays)]
    port = _port_core(arrays, plan.statics)
    for g, w in zip(P.init_tables_plain(port), want_init):
        np.testing.assert_array_equal(_u32(g), w)
    ok, contra = JP._verdicts_jit(core_arrays, *want_init)
    got = P.verdicts_plain(port, _port(want_init))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ok))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(contra))
    lo, hi, k0, k1, ok, contra, sweeps = JP._run_host(arrays, plan.statics)
    cap = plan.statics[0]
    for what, (tabs, g_ok, g_contra, g_sweeps) in (
            ("_run_host", P._run_host(port, cap, plain=True)),
            ("_fixpoint_plain", P._fixpoint_plain(port, cap)[:4])):
        for g, w in zip(tabs, (lo, hi, k0, k1)):
            np.testing.assert_array_equal(_u32(g), np.asarray(w),
                                          err_msg=what)
        np.testing.assert_array_equal(g_ok.numpy(), np.asarray(ok))
        np.testing.assert_array_equal(g_contra.numpy(), np.asarray(contra))
        assert g_sweeps == int(sweeps), what


def _flags(plan):
    lay = P.kernel_layout(P.plan_to_device(plan, "cpu"))
    return [lv["hazard"] for lv in lay["levels"]]


def test_only_the_level_that_reads_a_row_it_writes_is_flagged():
    """K6's flag on every plan of ``k5_edge_plans`` (level 1 of
    ``reads_own_level`` and level 0 of ``staged_wide`` alone), where
    K5's layout flags the same levels of the same encodings, and on the
    plans of the other waves of ``screen_waves`` (none)."""
    cases = k5_edge_cases()
    for name, plan in k5_edge_plans().items():
        flags = _flags(plan)
        assert flags == [li == STAGED.get(name) for li in range(len(flags))
                         ], name
        if name in cases:
            enc = cases[name]
            k5 = I.interval_layout(enc.levels, enc.init_lo.shape[0])
            assert [bool(h) for h in k5["lv"][:, 2]] == flags, name
    waves = dict(layered=layered_sets(), prefilter=prefilter_wave(256)[0],
                 mix=propagation_mix(256)[0],
                 **{f"edge {k}": v for k, v in edge_sets().items()})
    for name, sets in waves.items():
        flags = _flags(P.build_plan(I.linearize(sets)))
        assert flags and not any(flags), name


def test_the_layouts_stage_the_flagged_level():
    """K6's staging for the flagged level (32 words a node: every slot
    16-byte aligned), and K11's fused plan: the level's flag, its
    staging instance (no other plan takes it), and a staging at least
    as large as the level's and every round's."""
    core = P.plan_to_device(k5_edge_plans()["reads_own_level"], "cpu")
    lay = P.kernel_layout(core)
    lv = lay["levels"][1]
    n = lv["ent"].shape[0]
    assert lv["stage_words"] == 32 * n
    assert lv["stage_words"] % 4 == 0 and lv["threads"] % 32 == 0
    assert lv["threads"] >= min(P.BACK_THREADS, n)
    assert all(x["stage_words"] == 0 for i, x in enumerate(lay["levels"])
               if i != 1)
    # staged_wide's level stages past a block's 227 KB (K6's global
    # buffer on an H100)
    wide = P.kernel_layout(P.plan_to_device(k5_edge_plans()["staged_wide"],
                                            "cpu"))["levels"][0]
    assert wide["hazard"] and 4 * wide["stage_words"] > 232448
    fp = P._fused_plan(core)
    assert fp["lhaz"].tolist() == [0, 1, 0, 0] and fp["haz"]
    other = P.plan_to_device(k5_edge_plans()["negative_index"], "cpu")
    assert not P._fused_plan(other)["haz"]
    assert fp["stage_w"] % 4 == 0
    assert fp["stage_w"] >= max([lv["stage_words"]] + [
        r["stage_words"] for rs in lay["back"] for r in rs])


def _replay(ent, lo, hi, threads, blocks, states, stage_words):
    """The staged launch as ``fwd_block`` indexes it, nodes [lo, hi) of
    ``ent``: block b takes the states b, b + blocks, ...; in phase 1 its
    thread t each node t, t + threads, ... (reading the node's operand
    rows, staging its candidate into its slot), one barrier, then in
    phase 2 the same thread the same nodes (reading its slot and the
    node's row, writing the node's row). Returns each (state, node)'s
    phase-1 runs and the states' event logs [(kind, row)]."""
    seen = np.zeros((states, hi - lo), np.int64)
    logs = {}
    nread = I.operand_reads(ent[:, 1])
    for b in range(blocks):
        for s in range(b, states, blocks):
            log = logs.setdefault(s, [])
            slots = {}
            for t in range(threads):
                for j in range(lo + t, hi, threads):
                    slot = 32 * (j - lo)
                    assert slot % 4 == 0 and slot + 32 <= stage_words
                    slots[j] = t
                    seen[s, j - lo] += 1
                    log += [("operand", int(r)) for r in ent[j, 2:2 + nread[j]]]
            log.append(("barrier", b))
            for t in range(threads):
                for j in range(lo + t, hi, threads):
                    assert slots[j] == t  # a thread reads its own slot
                    log += [("own", int(ent[j, 0])), ("write", int(ent[j, 0]))]
    return seen, logs


@pytest.mark.parametrize("states", [1, 7, 33])
@pytest.mark.parametrize("resident", [1, 5, 1056])
def test_the_staged_launches_read_every_operand_before_the_barrier(
        states, resident):
    """K6's staged launch (its layout's block, a grid of as many blocks
    as states or as are resident, the fewer) and K11's (128 threads,
    the level's nodes at their offsets in the fused layout)."""
    core = P.plan_to_device(k5_edge_plans()["reads_own_level"], "cpu")
    lay = P.kernel_layout(core)
    lv = lay["levels"][1]
    ent = lv["ent"].numpy()
    fp = P._fused_plan(core)
    lo, hi = fp["loff"][1:3].tolist()
    fused = fp["lv"][0].numpy()
    np.testing.assert_array_equal(fused[lo:hi], ent)
    blocks = min(states, resident)
    for what, (e, a, z, threads, words) in {
            "K6": (ent, 0, len(ent), lv["threads"], lv["stage_words"]),
            "K11": (fused, lo, hi, K11_THREADS, fp["stage_w"])}.items():
        seen, logs = _replay(e, a, z, threads, blocks, states, words)
        assert (seen == 1).all(), what
        for s, log in logs.items():
            cut = log.index(next(x for x in log if x[0] == "barrier"))
            assert all(kind == "operand" for kind, _ in log[:cut]), what
            assert all(kind != "operand" for kind, _ in log[cut:]), what
            writes = [r for kind, r in log[cut:] if kind == "write"]
            assert sorted(writes) == sorted(set(writes)), what
            assert len(writes) == z - a, what
        # the level reads as an operand a row it writes: in place, a
        # write could come before a read of its row
        nread = I.operand_reads(e[a:z, 1])
        operands = {int(r) for j in range(z - a)
                    for r in e[a + j, 2:2 + nread[j]]}
        assert operands & set(e[a:z, 0].tolist()), what
