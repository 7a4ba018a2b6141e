"""The port's symbolic stepper (mythril_tpu_torch/ops/symstep.py, plain
PyTorch on the CPU) against the JAX package's ``sym_run_jit``: the same
seeded lane batch runs the same number of steps through both, and every
``SymLaneState`` plane (and the visited bitmap) must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mythril_tpu.ops import stepper as JST
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.support import device_loop as DL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.support import contracts
from mythril_tpu_torch.support.eth_constants import ARB_PROBE_SLOT

KW = dict(stack_depth=16, memory_bytes=128, mem_records=8, storage_slots=8,
          calldata_bytes=64, dlog_records=16)
N = 32
STEPS = 256
_OPB = {name: d["address"] for name, d in JS.OPCODES.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tiny tensors: one intra-op thread is
    faster there and leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(names, base=None):
    t = np.zeros(256, bool) if base is None else base.copy()
    for name in names:
        t[_OPB[name]] = base is None
    return t


def symbolic_seed(objs, group, **over):
    s = DL.tx_entry_seed(objs, group, KW["calldata_bytes"])
    s.update(over)
    return s


def concrete_seed(objs, group, words, **over):
    """A seed with concrete calldata: the given 32-byte words."""
    s = symbolic_seed(objs, group)
    data = b"".join(int(w).to_bytes(32, "big") for w in words)
    s["calldata"][:len(data)] = np.frombuffer(data, np.uint8)
    s.update(cd_sym=0, cd_size_sid=0, cd_size=len(data))
    s.update(over)
    return s


def seeded_planes(seeds, n=N):
    """numpy planes of an n-lane batch with the seeds written by the
    port's window prologue (free slots: every other lane)."""
    st = TS.init_sym_lanes(n, device="cpu", **KW)
    free = list(range(n - 1, -1, -1))
    entries = [(free.pop(), s) for s in seeds]
    i32b, u8b, k, pv = TL.pack_window(
        n, TS.N_ENV, KW, entries, free, [], {}, KW["calldata_bytes"],
        big=len(entries) > 16)
    st = TL.prologue_plain(st, torch.from_numpy(i32b),
                           torch.from_numpy(u8b), k, pv)
    return interop.state_to_numpy(st)


def run_both(code, planes, exec_table=None, taint_table=None,
             visited=False):
    ex = TS.SYM_EXECUTABLE if exec_table is None else exec_table
    ta = np.zeros(256, bool) if taint_table is None else taint_table
    cc = JST.compile_code(code)
    jst = JS.SymLaneState(**{k: jnp.asarray(v) for k, v in planes.items()})
    jvis = jnp.zeros(cc.packed.shape[0], bool) if visited else None
    jout, jvis = JS.sym_run_jit(cc, jst, STEPS, jnp.asarray(ex),
                                jnp.asarray(ta), jvis)
    tcc = interop.code_from_numpy(np.asarray(cc.packed), cc.size, "cpu")
    tvis = torch.zeros(cc.packed.shape[0], dtype=torch.bool) \
        if visited else None
    tout, tvis = TS.sym_run(tcc, interop.state_from_numpy(planes, "cpu"),
                            STEPS, ex, ta, tvis)
    got = interop.state_to_numpy(tout)
    for name in TS.FIELDS:
        want = np.asarray(getattr(jout, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    if visited:
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    return got


def test_fields_match_the_jax_state():
    assert TS.FIELDS == JS.SymLaneState._fields
    jst = JS.init_sym_lanes(4, **KW)
    tst = interop.state_to_numpy(TS.init_sym_lanes(4, device="cpu", **KW))
    for name in TS.FIELDS:
        want = np.asarray(getattr(jst, name))
        assert tst[name].dtype == want.dtype and \
            tst[name].shape == want.shape, name
        np.testing.assert_array_equal(tst[name], want, err_msg=name)


def test_compile_code_matches_jax():
    from mythril_tpu_torch.ops.stepper import compile_code

    code = contracts.build_coverage_contract()
    entries = (0, 5, 40)
    det = np.arange(len(code) + 1, dtype=np.uint32) * 2654435761
    loops = (np.arange(len(code) + 1) % 7) == 0
    want = JST.compile_code(code, entries, det, loops)
    got = compile_code(code, entries, det, loops, device="cpu")
    assert got.size == want.size
    np.testing.assert_array_equal(got.packed.numpy(),
                                  np.asarray(want.packed))
    packed, size = interop.code_to_numpy(got)
    again = interop.code_from_numpy(packed, size, "cpu")
    assert torch.equal(again.packed, got.packed) and again.size == size


def test_symbolic_branch_contract():
    code, _ = bench.build_symbolic_contract(k=4)
    objs = TL.ObjectTable()
    got = run_both(code, seeded_planes([symbolic_seed(objs, 1)]))
    assert int(got["flog_count"]) == 15
    assert (got["status"] == 5).sum() == 16


def test_fork_storm_past_the_free_pool():
    """More lanes reach a symbolic JUMPI in one step than there are free
    slots: forks fill the pool in lane order, the rest stall or park,
    and the fork log fills up across steps."""
    code, _ = bench.build_symbolic_contract(k=4)
    objs = TL.ObjectTable()
    seeds = [symbolic_seed(objs, g) for g in range(1, 21)]
    got = run_both(code, seeded_planes(seeds))
    assert int(got["free_count"]) == 0
    assert int(got["flog_count"]) == 12


def test_dispatcher_loop_contract():
    code = contracts.build_dispatcher_loop()
    objs = TL.ObjectTable()
    seeds = [concrete_seed(objs, i + 1, [i % 13]) for i in range(16)]
    got = run_both(code, seeded_planes(seeds))
    assert (got["status"] == 5).sum() >= 8


def test_coverage_contract_symbolic_switch():
    """One symbolic entry forks into every arm: overlay hit, mixed-byte
    park, symbolic-key storage mode and its park, concrete division and
    exponent families, SHA3 defer and park, a full record log, env and
    misc ops, BALANCE."""
    objs = TL.ObjectTable()
    got = run_both(contracts.build_coverage_contract(),
                   seeded_planes([symbolic_seed(objs, 1)]))
    assert int(got["flog_count"]) == 9
    assert (got["s_mode"] == 1).any()
    assert (got["dlog_count"] == KW["dlog_records"]).any()


def test_coverage_contract_concrete_arms():
    """Concrete calldata picks each arm; one seed enters mid-path with
    stack items (some symbolic) and concrete memory bytes."""
    objs = TL.ObjectTable()
    rng = np.random.default_rng(7)
    seeds = [concrete_seed(objs, i + 1,
                           [i, int.from_bytes(rng.bytes(32), "big")])
             for i in range(10)]
    stack_v = np.zeros((TL.SEED_STACK, 8), np.uint32)
    stack_v[0, 0], stack_v[2, 3] = 77, 0xDEAD
    stack_s = np.zeros(TL.SEED_STACK, np.int32)
    stack_s[1] = objs.add("sym")
    mem_v = np.zeros(TL.SEED_MEM, np.uint8)
    mem_k = np.zeros(TL.SEED_MEM, np.uint8)
    mem_v[:40], mem_k[:40] = 0x11, TS.KIND_CONC_WORD
    mem_v[40], mem_k[40] = 0x22, TS.KIND_BYTE_INT
    seeds.append(concrete_seed(objs, 11, [3, 5], sp=3, msize=64,
                               stack_v=stack_v, stack_s=stack_s,
                               mem_v=mem_v, mem_k=mem_k))
    got = run_both(contracts.build_coverage_contract(), seeded_planes(seeds))
    assert (got["status"] == 5).sum() >= 8


def _taint_contract():
    pat = int("cafe" * 15, 16)
    return contracts.assemble([
        (1 << 256) - 1, 1, "ADD", "POP",            # wraps
        1, 0, "SUB", "POP",                          # 0 - 1 wraps
        1 << 200, 1 << 100, "MUL", "POP",            # 2**300 wraps
        3, 5, "MUL", "POP",                          # no wrap
        300, 2, "EXP", "POP",                        # 2**300 wraps
        7, ARB_PROBE_SLOT, "SSTORE",                 # probe-slot sink
        0, "CALLDATALOAD", 5, "SSTORE",              # symbolic sink
        (pat << 16) | 0x1234, 0, "MSTORE",           # user-assertion park
        "STOP",
    ])


def test_taint_records_and_blocked_ops():
    """The drain-side taint table (wrap records, SSTORE sinks, the
    0xcafe... MSTORE park) and an exec table with SHA3 blocked."""
    objs = TL.ObjectTable()
    taint = _table("ADD SUB MUL EXP SSTORE MSTORE".split())
    ex = _table(["SHA3"], base=TS.SYM_EXECUTABLE)
    seeds = [symbolic_seed(objs, 1), symbolic_seed(objs, 2)]
    got = run_both(_taint_contract(), seeded_planes(seeds),
                   exec_table=ex, taint_table=taint)
    # four wraps, the probe sink, the CALLDATALOAD, the symbolic sink
    assert got["dlog_count"][0] == 7
    got = run_both(contracts.build_coverage_contract(),
                   seeded_planes([symbolic_seed(objs, 3)]),
                   exec_table=ex, taint_table=taint)
    assert (got["status"] == 5).sum() >= 8


def test_visited_bitmap():
    objs = TL.ObjectTable()
    seeds = [symbolic_seed(objs, 1), concrete_seed(objs, 2, [5, 9])]
    run_both(contracts.build_coverage_contract(), seeded_planes(seeds),
             visited=True)


@pytest.mark.parametrize("op", ["DIV", "SDIV", "MOD", "SMOD", "EXP",
                                "ADDMOD", "MULMOD", "SIGNEXTEND", "BYTE",
                                "SHL", "SHR", "SAR"])
def test_concrete_alu_op(op):
    """One concrete op over edge operands in every lane."""
    edge = [0, 1, 2, 7, 31, 255, 256, (1 << 255), (1 << 255) - 1,
            (1 << 256) - 1, (1 << 256) - 2, 1 << 128]
    objs = TL.ObjectTable()
    seeds = [concrete_seed(objs, i + 1,
                           [edge[i % 12], edge[(5 * i + 3) % 12]])
             for i in range(N)]
    # operands: a = word 0, b = word 1, c = a ^ b
    code = contracts.assemble([
        0x20, "CALLDATALOAD", 0, "CALLDATALOAD", "XOR", 0x20,
        "CALLDATALOAD", 0, "CALLDATALOAD", op, 0, "SSTORE", "STOP"])
    run_both(code, seeded_planes(seeds))


# -- K1's edge inputs (device_loop.k1_edge_cases; chip_smoke.py holds the
# kernel to the plain version on the same inputs at 64 times the lanes)

_EDGE = {c.name: c for c in DL.k1_edge_cases(KW["calldata_bytes"])}


@pytest.mark.parametrize("name", sorted(_EDGE))
def test_k1_edge_case_matches_the_jax_package(name):
    """Each edge input through the JAX ``sym_run_jit`` and the port's
    plain ``sym_run``, from the same planes: every plane and the visited
    bitmap equal, bit for bit."""
    case = _EDGE[name]
    st, tcc = DL.k1_case_state(case, "cpu", **KW)
    planes = interop.state_to_numpy(st)
    if case.members is not None:
        jcc, _ = JST.compile_packed_code(case.members)
    else:
        jcc = JST.compile_code(case.code)
    np.testing.assert_array_equal(tcc.packed.numpy(), np.asarray(jcc.packed))
    ex, ta = TS.SYM_EXECUTABLE, np.zeros(256, bool)
    jst = JS.SymLaneState(**{k: jnp.asarray(v) for k, v in planes.items()})
    jout, jvis = JS.sym_run_jit(jcc, jst, case.steps, jnp.asarray(ex),
                                jnp.asarray(ta),
                                jnp.zeros(jcc.packed.shape[0], bool))
    tout, tvis = TS.sym_run(tcc, st, case.steps, ex, ta,
                            torch.zeros(tcc.packed.shape[0],
                                        dtype=torch.bool))
    got = interop.state_to_numpy(tout)
    for f in TS.FIELDS:
        want = np.asarray(getattr(jout, f))
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    ran = int(got["step_no"]) - int(planes["step_no"])
    if name == "odd_lanes":
        assert case.lanes % 32 and int(got["flog_count"]) > 0
    if name == "fork_budget":
        # 2048 fork in the storm step, 52 stall and fork the next step,
        # the rest park
        assert len(case.seeds) > TS.MAX_FORKS_PER_STEP
        assert int(got["flog_count"]) == TS.MAX_FORKS_PER_STEP + 52
        assert (got["flog_step"][:TS.MAX_FORKS_PER_STEP]
                == got["flog_step"][0]).all()
    if name == "mid_window_stop":
        assert ran < case.steps and ran % TS.SYNC_EVERY
        assert not (got["status"] == 0).any()
    if name == "corpus_width":
        assert case.lanes == 64
    if name == "packed":
        assert tcc.seg_tab is not None and int(got["flog_count"]) > 0
