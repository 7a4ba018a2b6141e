"""The port's meshed lane engine (``LaneEngine(mesh=...)``: the lane
planes over a mesh's devices, ``parallel/mesh.SymShards``, and every
window's phases a shard, ``laser/lane_engine.window_exec_mesh`` and
``ops/symstep.sym_run_mesh``) on CPU shards, the plain versions of each
phase under the same exchange code the card runs.

It is held to the JAX package's meshed engine on the 8 virtual CPU
devices ``tests/conftest.py`` forces (the same windows, each window's
outputs bit for bit, and the materialized paths), to the port's own
unsharded engine (the same windows, paths and states), and to the JAX
``pick_mesh`` policy; the window's K1 over a mesh is held to the
unsharded plain run on forks whose children land in other shards and
on a step past the fork budget."""

from copy import deepcopy

import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.parallel import mesh as JM
from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.laser.evm_exceptions import VmException
from mythril_tpu_torch.laser.instructions import Instruction
from mythril_tpu_torch.laser.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.transaction.transaction_models import (
    MessageCallTransaction,
)
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.parallel.mesh import Mesh, shard_sym_lanes
from mythril_tpu_torch.smt import Or, symbol_factory
from mythril_tpu_torch.support import contracts
from mythril_tpu_torch.support import device_loop as DL

from . import test_lane_engine as JT
from .harness import ADDR, asm, push
from .torch_isolation import isolated_analysis


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's analyses on the CPU, one intra-op thread (tiny
    tensors), the lane-engine settings restored afterwards. Both
    packages' pools of idle batches start empty: a pooled batch keeps
    its step counter, which the records and fork log carry."""
    from mythril_tpu_torch.support.support_args import args

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TL._STATE_POOL.clear()
    JL._STATE_POOL.clear()
    saved = (TL.DEFAULT_WINDOW, TL.FORCE_WIDTH, dict(TL.PATH_HISTORY))
    with isolated_analysis():
        args.device = "cpu"
        try:
            yield
        finally:
            torch.set_num_threads(threads)
            TL.DEFAULT_WINDOW, TL.FORCE_WIDTH = saved[:2]
            TL.PATH_HISTORY.clear()
            TL.PATH_HISTORY.update(saved[2])


def cpu_mesh(d):
    return Mesh(["cpu"] * d)


def make_entry(code: bytes, tx_id: str = "ltest"):
    """The port's counterpart of ``test_lane_engine.make_entry``."""
    ws = WorldState()
    acct = ws.create_account(address=ADDR, concrete_storage=True)
    acct.code = Disassembly(code.hex())
    sender = symbol_factory.BitVecSym(f"sender_{tx_id}", 256)
    tx = MessageCallTransaction(
        world_state=ws, identifier=tx_id,
        gas_price=symbol_factory.BitVecSym(f"gas_price{tx_id}", 256),
        gas_limit=8000000, origin=sender, caller=sender,
        callee_account=acct, call_data=SymbolicCalldata(tx_id),
        call_value=symbol_factory.BitVecSym(f"call_value{tx_id}", 256))
    gs = tx.initial_global_state()
    gs.transaction_stack.append((tx, None))
    gs.world_state.constraints.append(
        Or(*[tx.caller == actor for actor in ACTORS.addresses.values()]))
    gs.world_state.transaction_sequence.append(tx)
    return gs


def mini_run(states, max_steps=20000):
    """The port's counterpart of ``test_lane_engine.mini_run``."""
    work, done, steps = list(states), [], 0
    while work:
        gs = work.pop()
        steps += 1
        assert steps < max_steps, "mini interpreter did not terminate"
        try:
            op = gs.get_current_instruction()["opcode"]
        except IndexError:
            done.append(("end", gs))
            continue
        if op in JT.TERMINAL:
            done.append((op, gs))
            continue
        try:
            work.extend(Instruction(op, dynamic_loader=None).evaluate(gs))
        except VmException:
            done.append(("error", gs))
    return done


def text_sig(tag, gs):
    """A state's observational signature with every term written out
    (comparable across the two packages, whose term ids differ)."""
    ms = gs.mstate
    storage = gs.environment.active_account.storage
    return (tag, ms.pc, tuple(map(repr, ms.stack)),
            tuple(repr(c) for c in gs.world_state.constraints),
            tuple(sorted(repr(k) + "=" + repr(v)
                         for k, v in ms.memory._memory.items())),
            tuple(sorted(map(repr, storage.keys_set))),
            len(ms.memory), ms.min_gas_used, ms.max_gas_used, ms.depth)


def fork_code():
    """``test_sharded_engine_differential``'s contract: a fork, a
    mapping-slot SHA3 and symbolic-key stores."""
    c = bytearray()
    c += push(0, 1) + asm("CALLDATALOAD", "ISZERO")
    j = len(c)
    c += push(0, 1) + asm("JUMPI")
    c += push(1, 1) + push(64, 1) + asm("MSTORE")
    d = len(c)
    c += asm("JUMPDEST")
    c += push(32, 1) + asm("CALLDATALOAD") + push(0, 1) + asm("MSTORE")
    c += push(0, 1) + push(32, 1) + asm("MSTORE")
    c += push(64, 1) + push(0, 1) + asm("SHA3")
    c += asm("DUP1") + push(7, 1) + asm("SWAP1", "SSTORE")
    c += asm("SLOAD") + push(5, 1) + asm("SSTORE")
    c += asm("STOP")
    c[j + 1] = d
    return bytes(c)


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


class Windows:
    """Records every window's 12 outputs of the port's meshed and
    unsharded dispatches and the JAX engine's while installed."""

    def __init__(self, monkeypatch):
        self.out = {"jax": [], "mesh": [], "one": []}
        for mod, name, key in ((JL, "_window_exec", "jax"),
                               (TL, "window_exec_mesh", "mesh"),
                               (TL, "window_exec", "one")):
            monkeypatch.setattr(mod, name, self._spy(getattr(mod, name),
                                                     key))

    def _spy(self, fn, key):
        def spy(*a, **kw):
            st, vis, out = fn(*a, **kw)
            self.out[key].append([_np(x).copy() for x in out])
            return st, vis, out
        return spy

    def same(self, a, b):
        wa, wb = self.out[a], self.out[b]
        assert len(wa) == len(wb) and wa, (a, len(wa), b, len(wb))
        for w, (x, y) in enumerate(zip(wa, wb)):
            assert len(x) == len(y) == 12
            for i, (p, q) in enumerate(zip(x, y)):
                np.testing.assert_array_equal(
                    q, p, err_msg=f"window {w} output {i}: {a} vs {b}")


def test_sharded_engine_differential(monkeypatch):
    """32 lanes, window 64: the JAX engine on 8 virtual devices and the
    port's on 8 CPU shards run the same windows with the same outputs,
    bit for bit; the port's equal its unsharded engine's too; and each
    materializes the paths its own host interpreter finds."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")
    code = fork_code()
    rec = Windows(monkeypatch)

    jentry = JT.make_entry(code)
    jhost = sorted(map(lambda p: JT.state_sig(*p),
                       JT.mini_run([deepcopy(jentry)])), key=repr)
    jeng = JL.LaneEngine(n_lanes=32, window=64, mesh=JM.make_mesh(8))
    jdone = JT.mini_run(jeng.explore(code, [deepcopy(jentry)]))
    assert sorted(map(lambda p: JT.state_sig(*p), jdone), key=repr) == jhost

    entry = make_entry(code)
    host = mini_run([deepcopy(entry)])
    eng = TL.LaneEngine(n_lanes=32, window=64, mesh=cpu_mesh(8))
    st = eng._acquire_state()
    assert len(st.shards) == 8
    assert all(s.pc.shape[0] == 4 for s in st.shards)
    assert len({s.pc.data_ptr() for s in st.shards}) == 8
    eng._release_state(st)
    done = mini_run(eng.explore(code, [deepcopy(entry)]))
    one = TL.LaneEngine(n_lanes=32, window=64)
    one_done = mini_run(one.explore(code, [deepcopy(entry)]))

    rec.same("jax", "mesh")
    rec.same("one", "mesh")
    sigs = sorted(map(lambda p: JT.state_sig(*p), done), key=repr)
    assert sigs == sorted(map(lambda p: JT.state_sig(*p), host), key=repr)
    assert sigs == sorted(map(lambda p: JT.state_sig(*p), one_done),
                          key=repr)
    assert sorted(map(lambda p: text_sig(*p), done)) == sorted(
        map(lambda p: text_sig(*p), jdone))
    assert eng.stats["windows"] == jeng.stats["windows"]
    assert eng.stats["forks"] == jeng.stats["forks"] >= 1


def test_dryrun_lane_engine_part():
    """``__graft_entry__.dryrun_multichip``'s lane-engine part on 8 CPU
    shards of 4 lanes: two symbolic branches, a mapping-slot SHA3 and a
    symbolic-key store give 4 paths."""
    op = TL._OPB
    c = bytearray()
    for i in range(2):
        c += push(32 * i, 1) + bytes([op["CALLDATALOAD"], op["ISZERO"]])
        j = len(c)
        c += push(0, 1) + bytes([op["JUMPI"]])
        c += push(i + 1, 1) + push(i, 1) + bytes([op["SSTORE"]])
        c[j + 1] = len(c)
        c += bytes([op["JUMPDEST"]])
    c += push(64, 1) + bytes([op["CALLDATALOAD"]])
    c += push(0, 1) + bytes([op["MSTORE"]])
    c += push(0, 1) + push(32, 1) + bytes([op["MSTORE"]])
    c += push(64, 1) + push(0, 1) + bytes([op["SHA3"]])
    c += push(9, 1) + bytes([op["SWAP1"], op["SSTORE"], op["STOP"]])
    engine = TL.LaneEngine(n_lanes=32, window=32, mesh=cpu_mesh(8))
    parked = engine.explore(bytes(c), [make_entry(bytes(c), "dry")])
    assert len(parked) == 4
    assert engine.stats["forks"] >= 3
    assert engine.stats["records"] >= 4


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_k12_contract_at_256_lanes_equals_the_unsharded_engine(
        monkeypatch, shards):
    """The k=12 symbolic contract's sweep at 256 lanes: over 2, 4 and 8
    shards the same windows (outputs bit for bit) and the same states
    handed back as the port's unsharded engine."""
    code, _ = contracts.build_symbolic_contract(12)
    rec = Windows(monkeypatch)
    entry = make_entry(code)
    one = TL.LaneEngine(n_lanes=256)
    want = one.explore(code, [deepcopy(entry)])
    eng = TL.LaneEngine(n_lanes=256, mesh=cpu_mesh(shards))
    got = eng.explore(code, [deepcopy(entry)])
    rec.same("one", "mesh")
    assert len(got) == len(want) == 256
    assert [JT.state_sig("open", gs) for gs in got] == [
        JT.state_sig("open", gs) for gs in want]
    assert eng.stats["forks"] == one.stats["forks"] > 0
    assert eng.stats["windows"] == one.stats["windows"]


def _run_both(case, shards, steps):
    """A case's batch after the prologue run ``steps`` steps unsharded
    (``sym_run_plain``) and over a CPU mesh (``sym_run_mesh``); returns
    the two global states and visited bitmaps."""
    kw = dict(calldata_bytes=64, dlog_records=16, stack_depth=32,
              memory_bytes=128, mem_records=8, storage_slots=8)
    st, cc = DL.k1_case_state(case, "cpu", **kw)
    vis = torch.zeros(cc.packed.shape[0], dtype=torch.bool)
    want, wvis = TS.sym_run_plain(cc, st, steps, visited=vis)
    ss = shard_sym_lanes(cpu_mesh(shards), st.pc.shape[0], **kw)
    per = ss.per
    for i, shard in enumerate(ss.shards):
        ss.shards[i] = shard.replace(**{
            f: getattr(st, f)[i * per:(i + 1) * per].clone()
            for f in TS.FIELDS if f not in TS.NO_COPY})
    ss.home = ss.home.replace(**{f: getattr(st, f).clone()
                                 for f in TS.NO_COPY})
    ss, gvis = TS.sym_run_mesh({torch.device("cpu"): cc}, ss, steps,
                               visited=vis)
    return want, wvis, ss.lanes(), gvis


def _same_state(a, b):
    for f in TS.FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      getattr(a, f).numpy(), err_msg=f)


def test_forks_land_in_other_shards():
    """Children take the top of the batch's free stack, wherever it
    lies: 24 symbolic seeds over 4 shards of 16 lanes fork into lanes
    of the other shards; the run equals the unsharded one, state and
    visited bitmap."""
    objs = TL.ObjectTable()
    case = DL.K1Case("cross", contracts.build_symbolic_contract(3)[0], None,
                     [DL.tx_entry_seed(objs, g + 1, 64) for g in range(24)],
                     64, 40)
    want, wvis, got, gvis = _run_both(case, 4, case.steps)
    _same_state(want, got)
    np.testing.assert_array_equal(gvis.numpy(), wvis.numpy())
    nf = int(got.flog_count)
    parents = got.flog_parent[:nf].numpy() // 16
    children = got.flog_child[:nf].numpy() // 16
    assert nf > 0 and (parents != children).any()


def test_a_step_past_the_fork_budget(monkeypatch):
    """More lanes request a fork in one step than the step's budget
    (``MAX_FORKS_PER_STEP``, cut to 8 here for both runs): the first 8
    in global lane order fork, the rest stall while free slots remain
    and fork at the next step, across shards as unsharded."""
    monkeypatch.setattr(TS, "MAX_FORKS_PER_STEP", 8)
    objs = TL.ObjectTable()
    case = DL.K1Case("budget", contracts.build_symbolic_contract(2)[0], None,
                     [DL.tx_entry_seed(objs, g + 1, 64) for g in range(20)],
                     64, 30)
    want, wvis, got, gvis = _run_both(case, 8, case.steps)
    _same_state(want, got)
    np.testing.assert_array_equal(gvis.numpy(), wvis.numpy())
    steps = got.flog_step[:int(got.flog_count)].numpy()
    assert np.bincount(steps).max() == 8


def test_a_narrow_meshed_engine_seeds_half_its_width(monkeypatch):
    """A 16-lane engine on 2 shards seeds at most 8 lanes a window, as
    the JAX engine's full bucket stays below the plane width under a
    mesh."""
    seeds = []
    orig = TL.window_exec_mesh

    def spy(ss, codes, i32buf, u8buf, ex, ta, window, k, *rest):
        seeds.append(k)
        return orig(ss, codes, i32buf, u8buf, ex, ta, window, k, *rest)

    monkeypatch.setattr(TL, "window_exec_mesh", spy)
    eng = TL.LaneEngine(n_lanes=16, window=8, mesh=cpu_mesh(2))
    assert eng._full_bucket() == 8
    code = fork_code()
    entries = [make_entry(code, f"n{i}") for i in range(12)]
    eng.explore(code, entries)
    assert seeds and max(seeds) == 8
    assert eng.stats["seeded"] == 12
    assert JL.LaneEngine(n_lanes=16, mesh=JM.make_mesh(2))._full_bucket() \
        == 8


@pytest.mark.parametrize("tpu_mesh", [-1, 0, 1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("cards", [1, 2, 3, 4, 8])
def test_pick_mesh_follows_the_jax_policy(monkeypatch, tpu_mesh, cards):
    """``pick_mesh`` over widths 8-4096 with ``args.tpu_mesh`` and a
    faked device count gives the JAX function's shard count (None
    where that gives None)."""
    import jax

    from mythril_tpu.support.support_args import args as jargs
    from mythril_tpu_torch.parallel import mesh as TM
    from mythril_tpu_torch.support import devices
    from mythril_tpu_torch.support.support_args import args

    monkeypatch.setattr(jargs, "tpu_mesh", tpu_mesh, raising=False)
    monkeypatch.setattr(args, "tpu_mesh", tpu_mesh, raising=False)
    monkeypatch.setattr(args, "device", None)
    monkeypatch.setattr(jax, "device_count", lambda: cards)
    monkeypatch.setattr(JM, "make_mesh", lambda nd: nd)
    monkeypatch.setattr(devices, "device_count", lambda: cards)
    monkeypatch.setattr(TM, "make_mesh", lambda nd: nd)
    for width in (8, 12, 16, 24, 32, 48, 64, 256, 4096):
        assert TL.pick_mesh(width) == JL.pick_mesh(width), width


def test_pick_mesh_is_none_on_one_card_and_on_the_cpu(monkeypatch):
    """One device, whatever the host holds: a one-card host, an
    analysis on the CPU (``args.device = "cpu"``) and one on a card
    named by its index, each beside four faked cards where they can
    be; an unnamed card does shard over them."""
    from mythril_tpu_torch.parallel import mesh as TM
    from mythril_tpu_torch.support import devices
    from mythril_tpu_torch.support.support_args import args

    monkeypatch.setattr(TM, "make_mesh", lambda nd: nd)
    for cards, device in ((1, None), (1, "cuda"), (4, "cpu"),
                          (4, torch.device("cpu")), (4, "cuda:2"),
                          (4, "cuda:0")):
        monkeypatch.setattr(devices, "device_count", lambda: cards)
        monkeypatch.setattr(args, "device", device)
        for setting in (-1, 0, 1, 8):
            args.tpu_mesh = setting
            assert all(TL.pick_mesh(w) is None for w in (16, 64, 4096)), \
                (cards, device, setting)
    monkeypatch.setattr(args, "device", "cuda")
    args.tpu_mesh = -1
    assert TL.pick_mesh(4096) == 4


def test_an_uneven_width_raises():
    with pytest.raises(ValueError, match="not divisible"):
        TL.LaneEngine(n_lanes=36, mesh=cpu_mesh(8))
    with pytest.raises(ValueError, match="not divisible"):
        JL.LaneEngine(n_lanes=36, mesh=JM.make_mesh(8))


def test_packed_explore_refuses_a_mesh():
    eng = TL.LaneEngine(n_lanes=32, mesh=cpu_mesh(8))
    code = fork_code()
    with pytest.raises(ValueError, match="do not shard"):
        eng.explore_packed([(code, [make_entry(code, "a")], "a"),
                            (code, [make_entry(code, "b")], "b")])


def test_the_mesh_answers_size_and_flat():
    """``Mesh.devices`` answers ``size`` and ``flat`` as the JAX mesh's
    device array does (``svm._lane_engine_sweep`` and the state pool's
    key read them)."""
    mesh = cpu_mesh(4)
    assert mesh.devices.size == 4 == mesh.size
    assert list(mesh.devices.flat) == [torch.device("cpu")] * 4
    eng = TL.LaneEngine(n_lanes=32, mesh=mesh)
    assert eng._shape_key() != TL.LaneEngine(n_lanes=32)._shape_key()
