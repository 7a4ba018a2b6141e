"""The kernel layout of K6 and K7 (mythril_tpu_torch/ops/propagate.py
``kernel_layout``: each level's and round's real entries only, ordered
by op) against the JAX package, on the CPU.

The plain ``fwd_level`` and ``back_round`` run on the layout give the
JAX ``_fwd_level_jit`` and ``_back_round_jit`` tables after every level
and round, bit for bit, with the changed flag set exactly where a step
changed the tables: on the all-opcode wave (``layered_sets``) from its
init tables and from tables made from a numpy seed, and on the edge
inputs the card holds the kernels to (``screen_waves.edge_sets``). The
layout's invariants: every real entry exactly once, distinct nodes in a
level, distinct targets in a round, no pad, the order and the staging
slots the kernels rely on."""

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
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.support import screen_waves

from .torch_screen_common import layered_sets

#: the edge inputs' states: each set of a case this many times
EDGE_REPEAT = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tabs):
    return tuple(np.asarray(t) for t in tabs)


def _port(tabs):
    return tuple(torch.from_numpy(np.array(t, dtype=np.uint32).view(np.int32))
                 for t in tabs)


def _u32(tabs):
    return tuple(t.numpy().view(np.uint32).copy() for t in tabs)


def port_core(plan):
    return P.plan_to_device(
        interop.plan_from_numpy(plan.arrays, plan.statics), "cpu")


def seeded_tables(arrays, seed):
    """(lo, hi, k0, k1) uint32 tables of the plan's shape from a numpy
    seed: each numeric row that is not a constant holds a random value x
    within its width as an interval around x (a third of the states
    each: bits of x cleared and set at random, the point x, an aligned
    range of up to 2^30 around x) and a random part of x's bits as
    known; each bool row is may-be-both, only-true or only-false (limb
    0; the limbs above stay zero, as in every table the screen makes)."""
    rng = np.random.default_rng(seed)
    ilo, ihi, ik0, ik1 = (np.asarray(arrays[k], dtype=np.uint32) for k in
                          ("init_lo", "init_hi", "init_k0", "init_k1"))
    n_s, n_t = np.asarray(arrays["seed_idx"]).shape[0], ilo.shape[0]

    def rnd():
        return rng.integers(0, 1 << 32, (n_s, n_t, 8), dtype=np.uint32)

    width = ~ik0
    x = rnd() & width
    low = np.zeros_like(x)
    low[..., 0] = (np.uint32(1) << rng.integers(
        0, 31, (n_s, n_t)).astype(np.uint32)) - np.uint32(1)
    mode = rng.integers(0, 3, (n_s, 1, 1))
    lo = np.where(mode == 0, x & rnd(), np.where(mode == 1, x, x & ~low))
    hi = np.where(mode == 0, x | (rnd() & width),
                  np.where(mode == 1, x, (x | low) & width))
    k1 = np.where(mode == 1, x, x & rnd())
    k0 = np.where(mode == 1, ~x, (~x & width & rnd()) | ik0)
    point = np.all(ilo == ihi, axis=-1)
    vary = (np.asarray(arrays["numeric"]) & ~point)[None, :, None]
    tabs = [np.where(vary, new, np.broadcast_to(init, new.shape)).copy()
            for new, init in ((lo, ilo), (hi, ihi), (k0, ik0), (k1, ik1))]
    v = rng.integers(0, 4, (n_s, n_t))
    isbool = np.asarray(arrays["isbool"])[None, :]
    tabs[0][..., 0] = np.where(isbool, (v != 2), tabs[0][..., 0])
    tabs[1][..., 0] = np.where(isbool, (v != 3), tabs[1][..., 0])
    return tuple(t.astype(np.uint32) for t in tabs)


def jax_steps(plan, tabs, sweeps):
    """[(step, tables)] after every level, exchange and round of
    ``sweeps`` JAX sweeps from the numpy tables ``tabs``."""
    _cap, level_ops, back_ops = plan.statics
    arrays = plan.arrays
    tabs = tuple(jnp.asarray(t) for t in tabs)
    out = []
    for sweep in range(sweeps):
        for li, level in enumerate(arrays["levels"]):
            tabs = JP._fwd_level_jit(level, *tabs, ops_present=level_ops[li])
            out.append((f"sweep {sweep} fwd {li}", _np(tabs)))
        tabs = JP._exchange_all_jit(*tabs, arrays["numeric"])
        out.append((f"sweep {sweep} exchange", _np(tabs)))
        for li in range(len(arrays["levels"]) - 1, -1, -1):
            for ri, rnd in enumerate(arrays["back"][li]):
                tabs = JP._back_round_jit(rnd, *tabs,
                                          ops_present=back_ops[li][ri])
                out.append((f"sweep {sweep} back {li}.{ri}", _np(tabs)))
        tabs = JP._exchange_all_jit(*tabs, arrays["numeric"])
        out.append((f"sweep {sweep} exchange 2", _np(tabs)))
    return out


def port_steps(core, tabs, sweeps):
    """The same passes, the plain versions on the kernel layout:
    [(step, tables, changed flag)]."""
    lay = P.kernel_layout(core)
    out = []

    def step(name, fn):
        flag = torch.zeros(1, dtype=torch.int32)
        fn(flag)
        out.append((name, _u32(tabs), bool(flag.item())))

    def exchange(flag):
        P.exchange_plain(tabs, core["numeric"], flag)

    for sweep in range(sweeps):
        for li, level in enumerate(lay["levels"]):
            step(f"sweep {sweep} fwd {li}",
                 lambda f, lv=level: P.fwd_level_plain(lv, tabs, f))
        step(f"sweep {sweep} exchange", exchange)
        for li in range(len(lay["back"]) - 1, -1, -1):
            for ri, rnd in enumerate(lay["back"][li]):
                step(f"sweep {sweep} back {li}.{ri}",
                     lambda f, r=rnd: P.back_round_plain(r, tabs, f))
        step(f"sweep {sweep} exchange 2", exchange)
    return out


def assert_steps(plan, start, sweeps, what):
    """The port on the layout equals JAX after every step from the numpy
    tables ``start``; its flag is set exactly where a step changed a
    table. Returns the number of steps that changed a table."""
    want = jax_steps(plan, start, sweeps)
    got = port_steps(port_core(plan), _port(start), sweeps)
    assert [g[0] for g in got] == [w[0] for w in want]
    prev, moved = start, 0
    for (name, tabs, flag), (_, jtabs) in zip(got, want):
        for tab, g, w in zip(("lo", "hi", "k0", "k1"), tabs, jtabs):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {tab} "
                                          f"after {name}")
        changed = any(not np.array_equal(a, b) for a, b in zip(prev, jtabs))
        assert flag == changed, f"{what}: the changed flag after {name}"
        moved += changed
        prev = jtabs
    return moved


@pytest.fixture(scope="module")
def layered():
    plan = JP.build_plan(JI.linearize(layered_sets(JT)))
    return plan, _np(JP._init_tables_jit(
        {k: v for k, v in plan.arrays.items() if k not in ("levels", "back")}))


@pytest.mark.parametrize("start", ["init", "seed 1", "seed 2"])
def test_the_layout_gives_the_jax_tables_on_the_all_opcode_wave(layered,
                                                                 start):
    plan, init = layered
    tabs = init if start == "init" else seeded_tables(
        plan.arrays, int(start.split()[1]))
    sweeps = 2 if start == "init" else 1
    assert assert_steps(plan, tabs, sweeps, f"all-opcode wave, {start}") > 3


#: the edge inputs' names
EDGE_CASES = sorted(screen_waves.edge_sets(T))


@pytest.mark.parametrize("name", EDGE_CASES)
def test_the_layout_gives_the_jax_tables_on_the_edge_inputs(name):
    sets = screen_waves.edge_sets(JT)[name]
    plan = JP.build_plan(JI.linearize(sets * EDGE_REPEAT))
    init = _np(JP._init_tables_jit({k: v for k, v in plan.arrays.items()
                                    if k not in ("levels", "back")}))
    assert assert_steps(plan, init, 2, f"{name}, init") > 0
    assert_steps(plan, seeded_tables(plan.arrays, 11), 1, f"{name}, seeded")


def _waves():
    sets, _ = screen_waves.prefilter_wave(64)
    out = {"all-opcode": layered_sets(T), "prefilter": sets}
    out.update(screen_waves.edge_sets(T))
    return out


@pytest.mark.parametrize("name", ["all-opcode", "prefilter"] + EDGE_CASES)
def test_the_layout_keeps_every_real_entry_once_in_kernel_order(name):
    core = P.plan_to_device(P.build_plan(I.linearize(_waves()[name])), "cpu")
    lay = P.kernel_layout(core)
    assert P.kernel_layout(core) is lay  # built once a plan
    n_rows = core["init_lo"].shape[0]
    for level, klv in zip(core["levels"], lay["levels"]):
        assert klv["counts"] == [klv["ent"].shape[0], 0, 0]  # one class
        assert_level(level, P.level_layout(level, n_rows, CLASSES), n_rows)
        assert_level(level, klv, n_rows, [0] * 32)
    for rounds, krounds in zip(core["back"], lay["back"]):
        for rnd, krnd in zip(rounds, krounds):
            keys = ("parent", "role", "tgt", "op")
            real = [e for e in zip(*(rnd[k].tolist() for k in keys))
                    if e[2] < n_rows]
            got = list(zip(*(krnd[k].tolist() for k in keys)))
            assert sorted(got) == sorted(real)
            tgts = [e[2] for e in got]
            assert len(set(tgts)) == len(tgts) and max(tgts) < n_rows
            key = [(o, r, b) for (_, r, _, o), b in
                   zip(got, krnd["tbool"].tolist())]
            assert key == sorted(key)
            _assert_slots(krnd)


#: a class table of the kind the card's layout takes from csrc/screen.cu
#: (``fwd_classes``), three classes mixed over the opcodes
CLASSES = [op % 3 for op in range(32)]


def assert_level(level, klv, n_rows, classes=CLASSES):
    """The level's real nodes once each, distinct, ordered by (class,
    op) under ``classes``, with their counts a class."""
    real = [(n, o) for n, o in zip(level["node"].tolist(),
                                   level["op"].tolist())
            if o != I.NOP and n < n_rows]
    got = list(zip(klv["node"].tolist(), klv["op"].tolist()))
    assert sorted(got) == sorted(real) and len(set(got)) == len(got)
    assert len({n for n, _ in got}) == len(got)  # distinct nodes
    cls = [classes[o] for _, o in got]
    assert [(c, o) for c, (_, o) in zip(cls, got)] == sorted(
        (c, o) for c, (_, o) in zip(cls, got))
    assert klv["counts"] == [cls.count(c) for c in range(3)]
    ent = klv["ent"]
    assert ent[:, 0].tolist() == klv["node"].tolist()
    assert bool(((ent[:, 2:5] >= 0) & (ent[:, 2:5] < n_rows)).all())


def _assert_slots(krnd):
    """Flags first (a word an entry), numeric slots 16-byte aligned,
    no two slots overlapping, all inside the staging, and the staging a
    multiple of 4 words (a block's part of a global buffer starts
    16-byte aligned)."""
    n = krnd["ent"].shape[0]
    assert krnd["stage_words"] % 4 == 0
    soff = krnd["ent"][:, 6].tolist()
    l0 = (krnd["tbool"] != 0) | ((krnd["tnum"] != 0) & torch.isin(
        krnd["op"], torch.tensor([I.BAND2, I.BOR2, I.BNOT1])))
    spans = []
    for j in range(n):
        if l0[j]:
            size = 2
        elif krnd["tnum"][j]:
            size = {I.EQ: 32, I.COPY: 32, I.ITE: 32}.get(
                int(krnd["op"][j]), 16)
            assert soff[j] % 4 == 0
        else:
            continue
        spans.append((soff[j], soff[j] + size))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert not spans or (spans[0][0] >= n
                         and spans[-1][1] <= krnd["stage_words"])


def test_the_staging_edge_case_outgrows_a_blocks_shared_memory():
    """``staging`` is the K7 input that stages in global memory: its
    round 0 needs more than the 232448 bytes of shared memory an H100
    block can take, and holds an odd count of 2-word (bool target)
    slots, so its staging would leave every other block's part of the
    global buffer off 16-byte alignment were it not rounded to 4
    words."""
    sets = screen_waves.edge_sets(T)["staging"]
    core = P.plan_to_device(P.build_plan(I.linearize(sets)), "cpu")
    big = max((r for rs in P.kernel_layout(core)["back"] for r in rs),
              key=lambda r: r["stage_words"])
    assert 4 * big["stage_words"] > 232448
    assert int((big["tbool"] != 0).sum()) % 2 == 1
    assert big["stage_words"] % 4 == 0


def test_a_level_and_a_round_of_pads_only_are_empty_and_change_nothing():
    core = P.plan_to_device(P.build_plan(I.linearize(layered_sets(T))),
                            "cpu")
    n_rows = core["init_lo"].shape[0]
    level = dict(core["levels"][0])
    level["op"] = torch.zeros_like(level["op"])
    rnd = dict(core["back"][0][0])
    rnd["tgt"] = torch.full_like(rnd["tgt"], n_rows)
    klv, krnd = P.level_layout(level, n_rows), P.round_layout(rnd, n_rows)
    assert klv["ent"].shape[0] == 0 and klv["counts"] == [0, 0, 0]
    assert krnd["ent"].shape[0] == 0 and krnd["stage_words"] == 0
    tabs = P.init_tables(core)
    before = tuple(t.clone() for t in tabs)
    flag = torch.zeros(1, dtype=torch.int32)
    P.fwd_level_plain(klv, tabs, flag)
    P.back_round_plain(krnd, tabs, flag)
    assert not flag.item()
    assert all(torch.equal(a, b) for a, b in zip(before, tabs))


def test_the_kernel_wrappers_take_only_a_bound_layout():
    """A CPU plan's layout has no launch arguments: the kernel wrappers
    refuse it (and any level of the plan itself) before touching the
    card."""
    core = P.plan_to_device(P.build_plan(I.linearize(layered_sets(T))),
                            "cpu")
    lay = P.kernel_layout(core)
    n_rows = core["init_lo"].shape[0]
    for entry, what in ((lay["levels"][0], "K6"), (lay["back"][0][0], "K7"),
                        (core["levels"][0], "K6")):
        with pytest.raises(ValueError, match=what):
            P._bound(entry, n_rows, what)
