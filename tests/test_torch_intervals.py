"""The port's forward interval screen (mythril_tpu_torch/ops/intervals.py,
plain PyTorch on the CPU) against the JAX package's, bit for bit.

One wave (torch_screen_common.layered_sets: every opcode, four levels of
one padded width) is built with each package's terms. Table-level tests
run both packages on the JAX encoding carried across by
mythril_tpu_torch/interop.py (term ids differ between the two term
tables, so the two linearizations may order rows differently); the
screens as a whole compare keep masks set by set."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mythril_tpu.models import pruner as j_pruner
from mythril_tpu.ops import intervals as JI
from mythril_tpu.ops import propagate as JP
from mythril_tpu.smt import terms as JT
from mythril_tpu.smt.bool import Bool
from mythril_tpu.support.support_args import args as j_args
from mythril_tpu_torch import _build, interop
from mythril_tpu_torch.models import pruner
from mythril_tpu_torch.ops import intervals as I
from mythril_tpu_torch.ops import propagate as P
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.smt.interval import state_infeasible
from mythril_tpu_torch.support.support_args import args as p_args

from .torch_screen_common import _COMMUTATIVE, canon, layered_sets

PINS_BV = {"la": 7, "lb": 0x1234, "le": 0x45, "lf": 3, "lg": 0x42}
PINS_BOOL = {"lp": True, "lq": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wave():
    """(JAX sets, port sets, JAX encoding, the same encoding in the
    port, JAX tables before and after every level)."""
    j_sets, p_sets = layered_sets(JT), layered_sets(T)
    enc = JI.linearize(j_sets)
    lo = jnp.broadcast_to(enc.init_lo, (enc.seed_idx.shape[0],)
                          + enc.init_lo.shape)
    hi = jnp.broadcast_to(enc.init_hi, lo.shape)
    rows = jnp.arange(lo.shape[0])[:, None]
    lo = lo.at[rows, enc.seed_idx].set(enc.seed_lo, mode="drop")
    hi = hi.at[rows, enc.seed_idx].set(enc.seed_hi, mode="drop")
    tables = [(np.asarray(lo), np.asarray(hi))]
    for level in enc.levels:
        arrays = {k: v for k, v in level.items() if k != "ops_present"}
        lo, hi = JI._eval_level_jit(arrays, lo, hi,
                                    ops_present=level["ops_present"])
        tables.append((np.asarray(lo), np.asarray(hi)))
    return j_sets, p_sets, enc, port_encoding(enc), tables


def port_encoding(enc):
    fields = {k: getattr(enc, k) for k in (
        "init_lo", "init_hi", "seed_idx", "seed_lo", "seed_hi", "dead",
        "assert_idx", "assert_mask", "n_nodes", "n_real")}
    fields["levels"] = enc.levels
    return interop.encoded_from_numpy(fields)


def as_u32(t):
    return t.numpy().view(np.uint32)


def seeded(enc):
    return I.seed_tables(*(I.words_to_device(x, "cpu")
                           for x in (enc.init_lo, enc.init_hi)),
                         I.ints_to_device(enc.seed_idx, "cpu"),
                         *(I.words_to_device(x, "cpu")
                           for x in (enc.seed_lo, enc.seed_hi)))


def test_the_wave_reaches_every_opcode(wave):
    _, _, enc, _, _ = wave
    ops = set()
    for level in enc.levels:
        ops |= set(np.asarray(level["op"]).tolist())
    assert ops - {I.NOP} == set(range(1, 26))
    assert {np.asarray(lv["op"]).shape[0] for lv in enc.levels} == {16}


def test_tables_equal_after_every_level(wave):
    _, _, _, penc, tables = wave
    lo, hi = seeded(penc)
    np.testing.assert_array_equal(as_u32(lo), tables[0][0])
    np.testing.assert_array_equal(as_u32(hi), tables[0][1])
    for i, level in enumerate(penc.levels):
        I.eval_level(I.level_to_device(level, "cpu"), lo, hi)
        np.testing.assert_array_equal(as_u32(lo), tables[i + 1][0],
                                      err_msg=f"lo after level {i}")
        np.testing.assert_array_equal(as_u32(hi), tables[i + 1][1],
                                      err_msg=f"hi after level {i}")


def test_linearize_copies_the_jax_encoding(wave):
    """The port's linearize on its own terms gives the JAX encoding,
    row for row once both are keyed by the printed term."""
    j_sets, p_sets, enc, _, _ = wave
    assert describe(I.linearize(p_sets)) == describe(enc)


def describe(enc):
    """An encoding with every node index replaced by its term's key
    (``canon``: term ids, and with them the operand order of commutative
    ops, differ between the two packages' term tables)."""
    order = enc.host["terms"]
    memo = {}
    names = [canon(t, memo) for t in order]

    def arg_names(i):
        t = order[i]
        k_terms = 1 if t.op == "extract" else min(len(t.args), 3)
        got = [names[int(enc.host["args"][i, k])] if k < k_terms
               else int(enc.host["args"][i, k]) for k in range(3)]
        if t.op in _COMMUTATIVE:
            got[:k_terms] = sorted(got[:k_terms])
        return tuple(got)

    rows = {names[i]: (int(enc.host["op"][i]), arg_names(i),
                       np.asarray(enc.init_lo)[i].tobytes(),
                       np.asarray(enc.init_hi)[i].tobytes(),
                       np.asarray(enc.host["mask"])[i].tobytes(),
                       np.asarray(enc.host["aux"])[i].tobytes())
            for i in range(enc.n_nodes)}
    levels = [(sorted(names[i] for i in np.asarray(lv["node"])
                      if i < enc.n_nodes), np.asarray(lv["op"]).shape[0],
               tuple(lv["ops_present"])) for lv in enc.levels]
    seed_idx = np.asarray(enc.seed_idx)
    states = []
    for s in range(seed_idx.shape[0]):
        seeds = {names[int(i)]: (np.asarray(enc.seed_lo)[s, v].tobytes(),
                                 np.asarray(enc.seed_hi)[s, v].tobytes())
                 for v, i in enumerate(seed_idx[s]) if i < enc.n_nodes}
        asserts = [names[int(i)] for i, m in zip(
            np.asarray(enc.assert_idx)[s], np.asarray(enc.assert_mask)[s])
            if m]
        states.append((seeds, asserts, bool(np.asarray(enc.dead)[s])))
    shapes = (np.asarray(enc.init_lo).shape, seed_idx.shape,
              np.asarray(enc.assert_idx).shape, enc.n_real)
    return rows, levels, states, shapes


def test_prefilter_matches_jax(wave):
    j_sets, p_sets, _, _, _ = wave
    want = JI.prefilter_feasible(j_sets)
    got = I.prefilter_feasible(p_sets, device="cpu")
    np.testing.assert_array_equal(got, want)
    # the host domain agrees where it decides (wide terms are topped on
    # the device, so the device may keep more)
    assert all(g or state_infeasible(s) for g, s in zip(got, p_sets))
    assert not got[0] and got[5]  # dead on arrival; wide unsat kept


def test_shadow_prefilter_matches_jax(wave):
    j_sets, p_sets, _, _, _ = wave
    want = JI.shadow_prefilter(j_sets, PINS_BV, PINS_BOOL)
    got = I.shadow_prefilter(p_sets, PINS_BV, PINS_BOOL, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[1].any()


def test_wide_constants_are_topped_not_truncated(wave):
    _, p_sets, _, _, _ = wave
    enc = I.linearize(p_sets)
    wide = [i for i, t in enumerate(enc.host["terms"])
            if t.op == "bv_const" and t.width > 256]
    assert wide
    for i in wide:
        assert not enc.init_lo[i].any()
        assert (enc.init_hi[i] == 0xFFFFFFFF).all()


def test_seeds_past_the_table_are_dropped(wave):
    """A seed slot at the pad row n is written (as JAX writes it); one
    at a row past the table is dropped, not clamped onto the last."""
    _, _, enc, penc, _ = wave
    seed_idx = np.asarray(enc.seed_idx).copy()
    n_rows = np.asarray(enc.init_lo).shape[0]
    seed_idx[1, 0] = n_rows
    seed_idx[2, 0] = enc.n_nodes
    seed_idx[3, 0] = n_rows + 5
    lo = jnp.broadcast_to(enc.init_lo, (seed_idx.shape[0],)
                          + enc.init_lo.shape)
    rows = jnp.arange(lo.shape[0])[:, None]
    want = lo.at[rows, seed_idx].set(enc.seed_lo, mode="drop")
    got, _ = I.seed_tables(
        I.words_to_device(penc.init_lo, "cpu"),
        I.words_to_device(penc.init_hi, "cpu"),
        torch.from_numpy(seed_idx), I.words_to_device(penc.seed_lo, "cpu"),
        I.words_to_device(penc.seed_hi, "cpu"))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_an_all_dead_wave():
    x = T.bv_var("dead_x", 64)
    sets = [[T.mk_ule(T.bv_const(100 + i, 64), x),
             T.mk_ult(x, T.bv_const(50, 64))] for i in range(5)]
    enc = I.linearize(sets)
    assert enc.dead.all()
    assert not I.eval_feasible(enc, "cpu").any()
    assert all(state_infeasible(s) for s in sets)
    assert not P.prefilter_feasible(sets, device="cpu").any()


def test_pruner_with_propagation_off_matches_jax(wave, monkeypatch):
    """models/pruner._screen_interval with MTPU_PROPAGATE off screens
    on the device path with the interval pass, as the JAX pruner
    does."""
    j_sets, p_sets, _, _, _ = wave
    monkeypatch.setattr(JP, "FORCE", False)
    monkeypatch.setattr(P, "FORCE", False)
    monkeypatch.setattr(j_args, "tpu_lanes", 8)
    monkeypatch.setattr(p_args, "tpu_lanes", 8)
    monkeypatch.setattr(j_pruner, "_device_skip", 0)
    j0, p0 = dict(j_pruner.STATS), dict(pruner.STATS)
    want = j_pruner._screen_interval(
        list(range(8)), lambda i: [Bool(t) for t in j_sets[i]])
    got = pruner._screen_interval(list(range(8)), lambda i: p_sets[i],
                                  device="cpu")
    assert got == want
    for stats, before in ((j_pruner.STATS, j0), (pruner.STATS, p0)):
        assert stats["device_screened"] - before["device_screened"] == 8
        assert stats["pruned"] - before["pruned"] == 8 - len(got)
    assert pruner.STATS["device_failures"] == p0["device_failures"]


def test_a_failing_device_call_is_counted(monkeypatch):
    """A device call that raises is counted and raised to the caller:
    the host screen never answers for it. Below the batch threshold the
    host screen answers without a device call."""
    monkeypatch.setattr(p_args, "tpu_lanes", 8)
    sets = layered_sets(T)

    def broken(assertion_sets, device=None):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(pruner, "_device_prefilter", broken)
    before = dict(pruner.STATS)
    with pytest.raises(RuntimeError, match="launch failed"):
        pruner._screen_interval(list(range(8)), lambda i: sets[i])
    assert pruner.STATS["device_failures"] == before["device_failures"] + 1
    assert pruner.STATS["screened"] == before["screened"]
    got = pruner._screen_interval(list(range(4)), lambda i: sets[i])
    assert got == [i for i in range(4) if not state_infeasible(sets[i])]
    assert pruner.STATS["device_failures"] == before["device_failures"] + 1
    assert pruner.STATS["device_screened"] == before["device_screened"]


def test_the_default_device_is_the_card(monkeypatch):
    """With no device named the screen runs on the card; without one it
    raises (no fall-through to the host screen or the plain versions),
    and the failure is counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(p_args, "tpu_lanes", -1)
    sets = layered_sets(T)
    before = pruner.STATS["device_failures"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pruner._screen_interval(list(range(8)), lambda i: sets[i])
    assert pruner.STATS["device_failures"] == before + 1


def test_kernel_wrappers_take_only_card_tensors(wave):
    _, _, _, penc, _ = wave
    lo, hi = seeded(penc)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        I.eval_level_kernel(I.level_to_device(penc.levels[0], "cpu"),
                            lo, hi)
    with pytest.raises(ValueError):
        P.exchange_kernel((lo, hi, lo, hi), torch.zeros(
            lo.shape[1], dtype=torch.uint8))
    assert _build.LAUNCHES == before
