"""The port's product-domain fixpoint screen
(mythril_tpu_torch/ops/propagate.py, plain PyTorch on the CPU) against
the JAX package's, bit for bit.

The wave is torch_screen_common.layered_sets, built with each package's
terms. Table-level tests run both packages on the JAX encoding and plan
carried across by mythril_tpu_torch/interop.py, step by step through
every sweep of the fixpoint; the screen as a whole compares keep masks
set by set, sweep counts, and harvested facts and abstractions by their
printed terms (term ids differ between the two term tables)."""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import intervals as JI
from mythril_tpu.ops import propagate as JP
from mythril_tpu.smt import terms as JT
from mythril_tpu.smt.solver.solver_statistics import SolverStatistics as JSS
from mythril_tpu.support.support_args import args as j_args
from mythril_tpu_torch import interop
from mythril_tpu_torch.models import pruner
from mythril_tpu_torch.ops import intervals as I
from mythril_tpu_torch.ops import propagate as P
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.smt.interval import state_infeasible
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics
from mythril_tpu_torch.support import screen_waves
from mythril_tpu_torch.support.support_args import args as p_args

from .torch_screen_common import canon, layered_sets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tabs):
    return tuple(np.asarray(t) for t in tabs)


@pytest.fixture(scope="module")
def wave():
    """(JAX sets, port sets, JAX encoding, JAX plan, the JAX fixpoint
    replayed step by step: [(step name, tables after it)], sweeps,
    verdicts)."""
    j_sets, p_sets = layered_sets(JT), layered_sets(T)
    enc = JI.linearize(j_sets)
    plan = JP.build_plan(enc)
    cap, level_ops, back_ops = plan.statics
    arrays = plan.arrays
    core = {k: v for k, v in arrays.items() if k not in ("levels", "back")}
    tabs = JP._init_tables_jit(core)
    steps = [("init", _np(tabs))]
    sweeps = 0
    for sweep in range(cap):
        prev = tabs
        for li, level in enumerate(arrays["levels"]):
            tabs = JP._fwd_level_jit(level, *tabs, ops_present=level_ops[li])
            steps.append((f"sweep {sweep} fwd {li}", _np(tabs)))
        tabs = JP._exchange_all_jit(*tabs, arrays["numeric"])
        steps.append((f"sweep {sweep} exchange", _np(tabs)))
        for li in range(len(arrays["levels"]) - 1, -1, -1):
            for ri, rnd in enumerate(arrays["back"][li]):
                tabs = JP._back_round_jit(rnd, *tabs,
                                          ops_present=back_ops[li][ri])
                steps.append((f"sweep {sweep} back {li}.{ri}", _np(tabs)))
        tabs = JP._exchange_all_jit(*tabs, arrays["numeric"])
        steps.append((f"sweep {sweep} exchange 2", _np(tabs)))
        sweeps += 1
        if not bool(JP._changed_jit(prev, tabs)):
            break
    ok, contra = JP._verdicts_jit(core, *tabs)
    return (j_sets, p_sets, enc, plan, steps, sweeps,
            (np.asarray(ok), np.asarray(contra)))


def port_core(plan):
    return P.plan_to_device(
        interop.plan_from_numpy(plan.arrays, plan.statics), "cpu")


def as_u32(tabs):
    return tuple(t.numpy().view(np.uint32) for t in tabs)


def assert_tables(got, want, what):
    for name, g, w in zip(("lo", "hi", "k0", "k1"), as_u32(got), want):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} after {what}")


def test_tables_equal_after_every_level_and_round(wave):
    _, _, _, plan, steps, sweeps, (ok, contra) = wave
    core = port_core(plan)
    tabs = P.init_tables(core)
    it = iter(steps)
    name, want = next(it)
    assert_tables(tabs, want, name)
    flag = torch.zeros(1, dtype=torch.int32)
    for sweep in range(sweeps):
        prev = tuple(t.clone() for t in tabs)
        flag.zero_()
        for level in core["levels"]:
            P.fwd_level(level, tabs, flag)
            name, want = next(it)
            assert_tables(tabs, want, name)
        P.exchange(tabs, core["numeric"], flag)
        name, want = next(it)
        assert_tables(tabs, want, name)
        for rounds in reversed(core["back"]):
            for rnd in rounds:
                P.back_round(rnd, tabs, flag)
                name, want = next(it)
                assert_tables(tabs, want, name)
        P.exchange(tabs, core["numeric"], flag)
        name, want = next(it)
        assert_tables(tabs, want, name)
        changed = P.changed_plain(prev, tabs)
        assert bool(flag.item()) == changed, f"sweep {sweep}'s flag"
        if sweep + 1 < sweeps:
            assert changed, f"sweep {sweep}"
        elif sweeps < plan.statics[0]:
            assert not changed, "the last sweep"
    assert next(it, None) is None
    got_ok, got_contra = P.verdicts(core, tabs)
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    np.testing.assert_array_equal(got_contra.numpy(), contra)


def test_the_driver_gives_the_jax_sweeps_and_verdicts(wave):
    _, _, _, plan, steps, sweeps, (ok, _) = wave
    tabs, got_ok, _, got_sweeps = P._run_host(port_core(plan),
                                              plan.statics[0])
    assert got_sweeps == sweeps
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert_tables(tabs, steps[-1][1], "the fixpoint")


def test_the_plan_copies_the_jax_plan(wave):
    """build_plan on the JAX encoding carried across gives the JAX
    plan's arrays."""
    _, _, enc, plan, _, _, _ = wave
    fields = {k: getattr(enc, k) for k in (
        "init_lo", "init_hi", "seed_idx", "seed_lo", "seed_hi", "dead",
        "assert_idx", "assert_mask", "n_nodes", "n_real")}
    fields["levels"] = enc.levels
    fields["host"] = enc.host
    got = P.build_plan(interop.encoded_from_numpy(fields))
    want = interop.plan_from_numpy(plan.arrays, plan.statics)
    assert got.statics == want.statics
    flat_g, flat_w = _flatten(got.arrays), _flatten(want.arrays)
    assert flat_g.keys() == flat_w.keys()
    for key in flat_w:
        np.testing.assert_array_equal(flat_g[key], flat_w[key], err_msg=key)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)) and not (
            tree and isinstance(tree[0], (int, np.integer))):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree)}


def _facts(facts):
    return {s: (sorted(map(canon, f)),
                sorted((canon(v), lo, hi) for v, lo, hi in b.values()))
            for s, (f, b) in facts.items()}


def test_the_screen_as_a_whole_matches_jax(wave):
    """prefilter_feasible: keep masks, sweep counts (the counters), and
    the harvested facts."""
    j_sets, p_sets, enc, _, _, sweeps, _ = wave
    j0, p0 = dict(JSS().batch_counters()), SolverStatistics().batch_counters()
    want = JP.prefilter_feasible(j_sets)
    got = P.prefilter_feasible(p_sets, device="cpu")
    np.testing.assert_array_equal(got, want)
    j1, p1 = JSS().batch_counters(), SolverStatistics().batch_counters()
    for key in ("propagate_kills", "propagate_sweeps", "facts_harvested"):
        assert p1[key] - p0[key] == j1[key] - j0[key], key
    assert p1["propagate_sweeps"] - p0["propagate_sweeps"] == sweeps
    # propagation refutes sets 2 and 6, which the interval pass keeps
    inter = I.prefilter_feasible(p_sets, device="cpu")
    assert inter[2] and inter[6] and not got[2] and not got[6]

    keep, (lo, hi, k0, k1), _ = JP.run(enc)
    want_facts = JP.harvest(enc, lo, hi, k0, k1, keep)
    screened = P.screen(p_sets, device="cpu")
    assert screened.sweeps == sweeps
    assert _facts(screened.facts) == _facts(want_facts)
    assert screened.facts


def test_abstraction_sets_match_jax(wave):
    j_sets, p_sets, _, _, _, _, _ = wave

    def by_name(sets, absd):
        names = {}
        for s in sets:
            for t in s:
                stack = [t]
                while stack:
                    cur = stack.pop()
                    if cur.op == "bv_var":
                        names[cur.tid] = cur.name
                    stack.extend(cur.args)
        return [None if d is None else {names[k]: v for k, v in d.items()}
                for d in absd]

    want = by_name(j_sets, JP.abstraction_sets(j_sets))
    got = by_name(p_sets, P.abstraction_sets(p_sets, device="cpu"))
    assert got == want


def test_prescreen_matches_jax(wave, monkeypatch):
    j_sets, p_sets, _, _, _, _, _ = wave
    monkeypatch.setattr(j_args, "tpu_lanes", 8)
    monkeypatch.setattr(p_args, "tpu_lanes", 8)
    monkeypatch.setattr(JP, "FORCE", True)
    monkeypatch.setattr(P, "FORCE", True)
    from mythril_tpu.models import pruner as j_pruner

    monkeypatch.setattr(j_pruner, "_device_skip", 0)
    undecided = list(range(8))
    want = JP.prescreen(j_sets, undecided)
    got = P.prescreen(p_sets, undecided, device="cpu")
    assert got == want and got
    # below the batch threshold the screen stays off
    assert P.prescreen(p_sets, undecided[:4], device="cpu") == {}
    monkeypatch.setattr(P, "FORCE", False)
    assert P.prescreen(p_sets, undecided, device="cpu") == {}


def test_a_failing_prescreen_raises(wave, monkeypatch):
    """prescreen counts a device call that raises and raises it: the
    wave is never left unscreened without a word."""
    _, p_sets, _, _, _, _, _ = wave
    monkeypatch.setattr(p_args, "tpu_lanes", 8)
    monkeypatch.setattr(P, "FORCE", True)

    def broken(assertion_sets, device=None):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(P, "prefilter_feasible", broken)
    before = pruner.STATS["device_failures"]
    with pytest.raises(RuntimeError, match="launch failed"):
        P.prescreen(p_sets, list(range(8)), device="cpu")
    assert pruner.STATS["device_failures"] == before + 1


def test_seed_and_assertion_slots_past_the_table_are_dropped(wave):
    """Init: a seed at the pad row n is written (as JAX writes it), one
    past the table dropped; a padded assertion slot pins nothing."""
    _, _, enc, plan, _, _, _ = wave
    arrays = dict(plan.arrays)
    n_rows = np.asarray(arrays["init_lo"]).shape[0]
    seed_idx = np.asarray(arrays["seed_idx"]).copy()
    seed_idx[1, 0] = n_rows
    seed_idx[2, 0] = enc.n_nodes
    seed_idx[3, 0] = n_rows + 7
    arrays["seed_idx"] = seed_idx
    core = {k: v for k, v in arrays.items() if k not in ("levels", "back")}
    want = _np(JP._init_tables_jit(core))
    got = P.init_tables(port_core(type(plan)(arrays, plan.statics)))
    assert_tables(got, want, "init")


def test_the_propagation_mix():
    """The propagation mix: propagation refutes the bit conflicts and
    the unit chains, which the interval pass keeps, and harvests facts
    from the satisfiable tails."""
    sets, keep = screen_waves.propagation_mix(2 * screen_waves.MIX_PERIOD)
    got = P.screen(sets, device="cpu")
    assert list(got.keep) == keep
    assert I.prefilter_feasible(sets, device="cpu").all()
    assert set(got.facts) == {i for i, k in enumerate(keep) if k}
    assert not any(state_infeasible(s) for s in sets)


def test_an_all_dead_wave():
    x = T.bv_var("dead_px", 64)
    sets = [[T.mk_ule(T.bv_const(100 + i, 64), x),
             T.mk_ult(x, T.bv_const(50, 64)),
             T.mk_eq(T.mk_and(x, T.bv_const(0xFF, 64)),
                     T.bv_const(7, 64))] for i in range(5)]
    got = P.screen(sets, device="cpu")
    assert not got.keep.any() and got.facts == {}
    assert all(state_infeasible(s) for s in sets)
