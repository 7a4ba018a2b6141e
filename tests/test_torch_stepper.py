"""The port's concrete lane stepper (mythril_tpu_torch/ops/stepper.py:
``step_plain``/``run_plain`` on the CPU) against the JAX package's
``step``/``run_jit``: the same numpy planes run through both, and every
plane of ``LaneState`` must be equal, bit for bit.

Covered: every case of tests/test_stepper.py (each a case of one
parametrised test, run at one lane shape so the JAX side compiles
once), seeded random programs over every supported opcode family and
every park, INVALID and out-of-gas cause, single steps and short runs
from seeded random states, ``max_steps`` cutting lanes mid-run, the
``bench.py`` contract at 256 lanes through 1800 steps (also against its
closed form), the host builders and extractors, ``interop``'s round
trip, and the copies of the contract builders byte for byte."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench
from mythril_tpu.ops import stepper as J
from mythril_tpu_torch import interop
from mythril_tpu_torch.ops import bv256
from mythril_tpu_torch.ops import stepper as T
from mythril_tpu_torch.support import contracts

from .test_stepper import M, asm, push

FIELDS = J.LaneState._fields
#: the shape of the test_stepper cases (init_lanes' defaults) and their
#: step cap: one JAX compile for all of them
CASE_LANES, CASE_STEPS = 8, 512
#: the shape of the random states and programs
RND = dict(stack_depth=16, memory_bytes=96, storage_slots=4,
           calldata_bytes=40)
RND_LANES, RND_STEPS = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors: one intra-op thread is
    faster there and leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_state(planes: dict):
    return J.LaneState(**{f: jnp.asarray(planes[f]) for f in FIELDS})


def planes_of(jst) -> dict:
    return {f: np.asarray(getattr(jst, f)) for f in FIELDS}


def assert_same(want: dict, tst, what=""):
    got = interop.state_to_numpy(tst)
    assert tuple(got) == FIELDS
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, (what, f)
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{what}: plane {f}")


def codes(code: bytes):
    jcc = J.compile_code(code)
    tcc = interop.code_from_numpy(np.asarray(jcc.packed), jcc.size, "cpu")
    return jcc, tcc


def run_both(code: bytes, planes: dict, max_steps: int, what=""):
    """Run both packages from the same planes; returns the JAX result's
    planes and the port's state."""
    jcc, tcc = codes(code)
    want = planes_of(J.run_jit(jcc, jax_state(planes), max_steps))
    got = T.run(tcc, interop.state_from_numpy(planes, "cpu"), max_steps)
    assert_same(want, got, what)
    return want, got


# ---------------------------------------------------------------------------
# the cases of tests/test_stepper.py
# ---------------------------------------------------------------------------

def _words(*vals):
    return [int.to_bytes(v, 32, "big") for v in vals]


def _case_alu():
    code = asm(push(0), "CALLDATALOAD", push(7), "ADD", push(3), "MUL",
               push(1), "SWAP1", "SUB", push(2), "SWAP1", "DIV", "DUP1",
               push(0xFF), "AND", "DUP2", push(4), "SHL", "XOR")
    return code, _words(0, 1, 5, 1 << 255, M - 1, M - 7,
                        12345678901234567890), None, None


def _case_expensive():
    code = asm(push(0), "CALLDATALOAD", "DUP1", "DUP1", push(97), "SWAP1",
               "MOD", "SWAP1", push(3), "EXP", "ADD", "DUP2", "DUP2",
               "ADDMOD", "DUP3", "SWAP1", "DUP2", "MULMOD", "SWAP2", "SDIV",
               "SMOD")
    return code, _words(2, 96, 97, (1 << 255) + 3, M - 2, 0), None, None


def _case_branching():
    code = bytearray()
    code += asm(push(0), "CALLDATALOAD", "DUP1", push(100), "SWAP1", "GT")
    code += asm(push(0), "JUMPI")
    jumpi_at = len(code) - 3
    code += asm(push(2), "SWAP1", "SSTORE", "STOP")
    then = len(code)
    code += asm("JUMPDEST", "POP", push(1), push(5), "SSTORE",
                push(0), push(0), "RETURN")
    code[jumpi_at + 1] = then
    return bytes(code), _words(0, 7, 100, 101, 5000, M - 1), None, None


def _case_memory():
    code = asm(push(0), "CALLDATALOAD", push(0), "MSTORE", push(0xAB),
               push(33), "MSTORE8", "MSIZE", push(0), "MSTORE", push(64),
               push(0), "RETURN")
    return code, _words(0, M - 1, 0xDEADBEEF), None, None


def _case_storage():
    code = asm(push(3), "SLOAD", push(9), "SLOAD", "ADD", push(3), "SSTORE",
               push(3), "SLOAD", push(9), "SLOAD")
    return code, [b"", b""], [{3: 111, 9: 222}, {}], None


def _case_env():
    code = asm("CALLER", "ORIGIN", "CALLVALUE", "TIMESTAMP", "NUMBER",
               "CALLDATASIZE", "CODESIZE", "PC")
    env = {"CALLER": 0xDEADBEEF, "ORIGIN": 0xAFFE, "CALLVALUE": 10**18,
           "TIMESTAMP": 1_700_000_000, "NUMBER": 19_000_000}
    return code, [b"", b"xyz"], None, env


def _case_error(kind):
    code = {"bad_jump": asm(push(3), "JUMP"), "underflow": asm("ADD"),
            "invalid": asm("INVALID"),
            "revert": asm(push(0), "CALLDATALOAD", push(0), "MSTORE",
                          push(32), push(0), "REVERT")}[kind]
    return code, _words(7), None, None


def _case_unsupported():
    return asm(push(0), push(0), "SHA3"), [b"", b""], None, None


def _case_loop():
    code = bytearray()
    code += asm(push(0), "CALLDATALOAD", push(0), push(0))
    loop = len(code)
    code += asm("JUMPDEST", "DUP1", "DUP4", "EQ", push(0), "JUMPI")
    exit_patch = len(code) - 3
    code += asm("DUP1", "SWAP2", "ADD", "SWAP1", push(1), "ADD",
                push(loop), "JUMP")
    done = len(code)
    code += asm("JUMPDEST", "POP", push(0), "SSTORE", "POP")
    code[exit_patch + 1] = done
    return bytes(code), _words(0, 1, 5, 23), None, None


def _case_straightline(trial):
    """test_random_programs_straightline's generator, seeded per trial."""
    rng = random.Random(99 + trial)
    binops = ["ADD", "MUL", "SUB", "DIV", "SDIV", "MOD", "SMOD", "AND",
              "OR", "XOR", "LT", "GT", "SLT", "SGT", "EQ", "SHL", "SHR",
              "SAR", "BYTE", "SIGNEXTEND", "EXP"]
    prog = [push(0), "CALLDATALOAD", push(32), "CALLDATALOAD"]
    depth = 2
    for _ in range(40):
        r = rng.random()
        if r < 0.45 and depth >= 2:
            prog.append(rng.choice(binops))
            depth -= 1
        elif r < 0.55 and depth >= 1:
            prog.append(rng.choice(["ISZERO", "NOT"]))
        elif r < 0.75:
            prog.append(push(rng.getrandbits(rng.choice([8, 64, 256]))))
            depth += 1
        elif r < 0.85 and depth >= 2:
            prog.append(f"SWAP{rng.randint(1, min(2, depth - 1))}")
        else:
            prog.append(f"DUP{rng.randint(1, min(3, depth))}")
            depth += 1
    cds = [rng.getrandbits(512).to_bytes(64, "big") for _ in range(8)]
    return asm(*prog), cds, None, None


def _case_return_past_buffer(i):
    code = [asm(push(32), push(0x2000, 2), "RETURN"),
            asm(push(32), push(2**32 + 5, 5), "RETURN"),
            asm(push(0), push(2**32 + 5, 5), "RETURN"),
            asm(push(32), push(64), "RETURN")][i]
    return code, [b""], None, None


CASES = {
    "alu": _case_alu, "expensive_ops": _case_expensive,
    "branching_divergent_lanes": _case_branching,
    "memory_roundtrip_and_return": _case_memory,
    "storage_read_over_write": _case_storage, "env_words": _case_env,
    "unsupported_parks_lane": _case_unsupported, "loop": _case_loop,
    **{f"error_lanes_{k}": (lambda k=k: _case_error(k))
       for k in ("bad_jump", "underflow", "invalid", "revert")},
    **{f"random_straightline_{t}": (lambda t=t: _case_straightline(t))
       for t in range(5)},
    **{f"return_beyond_buffer_{i}": (lambda i=i: _case_return_past_buffer(i))
       for i in range(4)},
}


def build_both(calldatas, storages=None, env=None):
    """The case's batch built by each package's host builders (lanes
    past the case's calldatas get none); the planes must be equal."""
    jst, tst = J.init_lanes(CASE_LANES), T.init_lanes(CASE_LANES,
                                                     device="cpu")
    for i, cd in enumerate(calldatas):
        jst = J.set_calldata(jst, i, cd)
        tst = T.set_calldata(tst, i, cd)
        if storages and storages[i]:
            jst = J.preload_storage(jst, i, storages[i])
            tst = T.preload_storage(tst, i, storages[i])
    for name, val in (env or {}).items():
        jst = J.set_env_word(jst, name, val)
        tst = T.set_env_word(tst, name, val)
    planes = planes_of(jst)
    assert_same(planes, tst, "the host builders")
    return planes


@pytest.mark.parametrize("case", sorted(CASES))
def test_stepper_cases(case):
    code, calldatas, storages, env = CASES[case]()
    want, got = run_both(code, build_both(calldatas, storages, env),
                         CASE_STEPS, case)
    jfinal = jax_state(want)
    for i in range(CASE_LANES):
        assert T.extract_stack(got, i) == J.extract_stack(jfinal, i)
        assert T.extract_storage(got, i) == J.extract_storage(jfinal, i)
        assert T.extract_return_data(got, i) == \
            J.extract_return_data(jfinal, i)
    assert not (want["status"] == T.Status.RUNNING).any()


# ---------------------------------------------------------------------------
# seeded random programs and states
# ---------------------------------------------------------------------------

_FAMILIES = {
    "alu": ("ADD MUL SUB DIV SDIV MOD SMOD EXP SIGNEXTEND LT GT SLT SGT EQ "
            "AND OR XOR BYTE SHL SHR SAR ADDMOD MULMOD ISZERO NOT").split(),
    "env": ("ADDRESS ORIGIN CALLER CALLVALUE GASPRICE COINBASE TIMESTAMP "
            "NUMBER DIFFICULTY GASLIMIT CHAINID SELFBALANCE BASEFEE PC "
            "MSIZE GAS CALLDATASIZE CODESIZE").split(),
    "park": ("SHA3 BALANCE CALL LOG0 EXTCODESIZE CALLDATACOPY CREATE "
             "RETURNDATASIZE").split(),
    "end": "STOP INVALID SELFDESTRUCT RETURN REVERT".split(),
}


def _word_pool(rng):
    return [0, 1, 2, 3, 7, 31, 32, 33, 64, 95, 96, 255, 256, 1 << 30,
            (1 << 30) - 1, 1 << 32, 1 << 40, 1 << 255, (1 << 255) - 1,
            M - 1, M - 2, int(rng.integers(0, 1 << 62)),
            int.from_bytes(rng.bytes(32), "big")]


def _random_body(rng, pool, name, n_instr, end):
    """One arm of ``random_program``: a few pushes, random instructions
    over every family, then ending ``end`` (0-4 a terminal opcode with
    its operands, 5 a host-only opcode, 6 a jump back to the arm's
    start)."""
    labels = [f"{name}.{i}" for i in range(3)]
    placed = set()
    items = [("label", name)] + [pool[i] for i in
                                 rng.integers(0, len(pool), 4)]
    for _ in range(n_instr):
        r = rng.random()
        if r < 0.06:
            # lanes part on a bit of their own calldata
            items += [int(rng.integers(0, 9)), "CALLDATALOAD",
                      1 << int(rng.integers(0, 8)), "AND",
                      ("ref", str(rng.choice(labels))), "JUMPI"]
        elif r < 0.24:
            items.append(pool[rng.integers(len(pool))])
        elif r < 0.42:
            items.append(str(rng.choice(_FAMILIES["alu"])))
        elif r < 0.52:
            k = rng.integers(1, 5) if rng.random() < 0.85 \
                else rng.integers(1, 17)
            items.append(f"DUP{k}" if rng.random() < 0.5 else f"SWAP{k}")
        elif r < 0.60:
            items += [int(rng.choice([0, 32, 64, 65, 90, 96, 1 << 40])),
                      str(rng.choice(["MLOAD", "MSTORE", "MSTORE8"]))]
        elif r < 0.66:
            items += [int(rng.choice([0, 4, 8, 9, 1 << 31, 1 << 200])),
                      "CALLDATALOAD"]
        elif r < 0.75:
            items += [int(rng.integers(0, 7)),
                      str(rng.choice(["SLOAD", "SSTORE"]))]
        elif r < 0.82:
            items.append(str(rng.choice(_FAMILIES["env"])))
        elif r < 0.87:
            label = str(rng.choice(labels))
            if label not in placed:
                placed.add(label)
                items.append(("label", label))
        elif r < 0.94:
            target = ("ref", str(rng.choice(labels))) \
                if rng.random() < 0.85 else int(rng.integers(0, 300))
            items += [target, str(rng.choice(["JUMP", "JUMPI"]))]
        else:
            items.append("POP")
    items += [("label", label) for label in labels if label not in placed]
    if end < 5:
        op = _FAMILIES["end"][end]
        if op in ("RETURN", "REVERT"):
            items += [int(rng.choice([0, 16, 32, 200])),
                      int(rng.choice([0, 32, 80, 1 << 33]))]
        elif op == "SELFDESTRUCT":
            items.append(1)
        items.append(op)
    elif end == 5:
        items.append(str(rng.choice(_FAMILIES["park"])))
    else:
        items += [("ref", name), "JUMP"]
    return items


def random_program(seed: int) -> bytes:
    """A dispatcher on lane calldata word 0 % 8 over eight random arms
    (``_random_body``), after a few pushes of edge words: the lanes of a
    batch run different arms, over every family, every ending and every
    park and INVALID cause."""
    rng = np.random.default_rng(seed)
    pool = _word_pool(rng)
    items = [pool[i] for i in rng.integers(0, len(pool), 6)]
    items += [0, "CALLDATALOAD", 7, "AND"]
    for k in range(1, 8):
        items += ["DUP1", k, "EQ", ("ref", f"B{k}"), "JUMPI"]
    for k in range(8):
        items += _random_body(rng, pool, f"B{k}", 20, (k + seed) % 7)
    return contracts.assemble(items)


def random_batch(seed: int, n: int = RND_LANES) -> dict:
    """Fresh RUNNING lanes at pc 0: random calldata and sizes (some past
    the buffer), env words, preloaded storage, and gas limits from
    plenty down to a few units (out of gas)."""
    rng = np.random.default_rng(seed)
    st = T.init_lanes(n, device="cpu", **RND)
    c = st.calldata.shape[1]
    st.calldata.copy_(torch.from_numpy(rng.integers(0, 256, (n, c),
                                                    dtype=np.uint8)))
    st.cd_size.copy_(torch.from_numpy(rng.integers(0, c + 9, n,
                                                   dtype=np.int32)))
    st.env.copy_(torch.from_numpy(rng.integers(
        0, 1 << 32, st.env.shape, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)))
    gas = np.where(rng.random(n) < 0.3, rng.integers(0, 120, n), 0xFFFFFFFF)
    st.gas_limit.copy_(torch.from_numpy(gas.astype(np.uint32)
                                        .view(np.int32)))
    for lane in range(0, n, 5):
        T.preload_storage(st, lane, {int(k): int(rng.integers(0, 1 << 62))
                                     for k in rng.integers(0, 6, 2)})
    return interop.state_to_numpy(st)


@pytest.mark.parametrize("seed", range(6))
def test_random_programs(seed):
    code = random_program(seed)
    run_both(code, random_batch(seed), RND_STEPS, f"seed {seed}")


_NAME = {v: k for k, v in T._OP.items()}


def test_random_programs_reach_every_cause():
    """Over the seeds of test_random_programs every status is reached,
    every cause of a park (host-only opcode, memory, calldata, a full
    storage log, stack overflow) and of INVALID (the opcode, a bad jump,
    stack underflow, out of gas): checked on the port's planes, which
    equal the JAX package's."""
    seen, parks, invalid = set(), set(), set()
    gas_of = torch.from_numpy(T.GAS_TABLE.astype(np.int64))
    npop = torch.from_numpy(T.NPOP_TABLE.astype(np.int64))
    npush = torch.from_numpy(T.NPUSH_TABLE.astype(np.int64))
    for seed in range(6):
        _, tcc = codes(random_program(seed))
        st = interop.state_from_numpy(random_batch(seed), "cpu")
        for _ in range(RND_STEPS):
            running = st.status == T.Status.RUNNING
            if not bool(running.any()):
                break
            nxt = T.step_plain(tcc, st)
            op = tcc.opcode[st.pc.long().clamp(0, tcc.size)].long()
            sp = st.sp.long()
            for lane in torch.nonzero(running
                                      & (nxt.status != T.Status.RUNNING)):
                i, o = int(lane), int(op[lane])
                name = _NAME.get(o, "?")
                if int(nxt.status[i]) == T.Status.NEEDS_HOST:
                    if int(npush[o]) == 1 and int(sp[i]) - int(npop[o]) \
                            + 1 > RND["stack_depth"]:
                        name = "overflow"
                    parks.add(name)
                elif int(nxt.status[i]) == T.Status.INVALID:
                    used = int(bv256.u32(st.gas_used[i]))
                    if used + int(gas_of[o]) > int(bv256.u32(
                            st.gas_limit[i])):
                        invalid.add("oog")
                    elif int(sp[i]) < (o - 0x7F if 0x80 <= o <= 0x8F else
                                       o - 0x8E if 0x90 <= o <= 0x9F else
                                       int(npop[o])):
                        invalid.add("underflow")
                    else:
                        invalid.add(name)
            st = nxt
        seen |= set(st.status.tolist())
    assert set(range(7)) <= seen, seen
    assert {"MLOAD", "MSTORE", "MSTORE8", "CALLDATALOAD", "SSTORE",
            "overflow"} <= parks and parks & set(_FAMILIES["park"]), parks
    assert {"oog", "underflow", "INVALID", "JUMP", "JUMPI"} <= invalid, \
        invalid


def random_code(rng) -> bytes:
    """Every opcode byte once (PUSHes with their data), in a seeded
    order, and a few more JUMPDESTs."""
    out = bytearray()
    for op in list(rng.permutation(256)) + [0x5B] * 8:
        out.append(int(op))
        if 0x60 <= op <= 0x7F:
            out += rng.bytes(int(op) - 0x5F)
    return bytes(out)


def random_state(seed: int, code_size: int) -> dict:
    """Seeded random planes of every field: pcs around and past the
    code, stack pointers from 0 to full, stack words from a pool of edge
    values, code offsets and memory offsets, random memory, storage logs
    over a few keys, calldata sizes past the buffer, gas near the wrap,
    some lanes not RUNNING."""
    rng = np.random.default_rng(seed)
    n, d = RND_LANES, RND["stack_depth"]
    m, s, c = (RND["memory_bytes"], RND["storage_slots"],
               RND["calldata_bytes"])
    pool = _word_pool(rng) + [int(x) for x in rng.integers(0, code_size, 8)]

    def words(shape):
        idx = rng.integers(0, len(pool), shape)
        vals = np.array([[bv256.int_to_limbs(pool[i])] for i in
                         idx.reshape(-1)]).reshape(shape + (8,))
        return vals.astype(np.uint32)

    keys = words((6,))
    u32 = lambda shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64
                                     ).astype(np.uint32)
    return {
        "pc": rng.integers(-3, code_size + 4, n, dtype=np.int32),
        "sp": rng.integers(0, d + 1, n, dtype=np.int32),
        "stack": words((n, d)),
        "memory": rng.integers(0, 256, (n, m), dtype=np.uint8),
        "msize": (rng.integers(0, m // 32 + 1, n) * 32).astype(np.int32),
        "skeys": keys[rng.integers(0, 6, (n, s))],
        "svals": words((n, s)),
        "scount": rng.integers(0, s + 1, n, dtype=np.int32),
        "calldata": rng.integers(0, 256, (n, c), dtype=np.uint8),
        "cd_size": rng.integers(0, c + 9, n, dtype=np.int32),
        "env": u32((n, J.N_ENV, 8)),
        "gas_used": np.where(rng.random(n) < 0.2, 0xFFFFFFF0,
                             rng.integers(0, 1000, n)).astype(np.uint32),
        "gas_limit": np.where(rng.random(n) < 0.2, rng.integers(0, 1000, n),
                              0xFFFFFFFF).astype(np.uint32),
        "status": np.where(rng.random(n) < 0.85, 0,
                           rng.integers(1, 7, n)).astype(np.int32),
        "ret_offset": rng.integers(0, 64, n, dtype=np.int32),
        "ret_len": rng.integers(0, 64, n, dtype=np.int32),
        "steps": rng.integers(0, 100, n, dtype=np.int32),
    }


_STEP_JIT = jax.jit(J.step)


@pytest.mark.parametrize("seed", range(8))
def test_one_step_from_random_states(seed):
    rng = np.random.default_rng(1000 + seed)
    jcc, tcc = codes(random_code(rng))
    planes = random_state(seed, jcc.size)
    want = planes_of(_STEP_JIT(jcc, jax_state(planes)))
    st = interop.state_from_numpy(planes, "cpu")
    assert_same(want, T.step_plain(tcc, st), f"seed {seed}")
    assert_same(want, T.step(tcc, st), f"seed {seed}, step")
    assert_same(want, st, "the input")  # step updates in place, as K10


@pytest.mark.parametrize("seed", range(3))
def test_runs_from_random_states(seed):
    code = random_code(np.random.default_rng(2000 + seed))
    run_both(code, random_state(100 + seed, len(code)), RND_STEPS,
             f"seed {seed}")


# ---------------------------------------------------------------------------
# the bench.py workload, max_steps, the lane mix
# ---------------------------------------------------------------------------

def test_max_steps_cuts_lanes_mid_run():
    st = T.init_lanes(CASE_LANES, device="cpu")
    st.calldata[:, :32].copy_(torch.from_numpy(
        contracts.bench_calldata(CASE_LANES)))
    st.cd_size.fill_(32)
    want, _ = run_both(contracts.build_bench_contract(),
                       interop.state_to_numpy(st), CASE_STEPS)
    running = want["status"] == T.Status.RUNNING
    assert running.any() and (~running).any()
    assert (want["steps"][running] == CASE_STEPS).all()


def test_bench_contract_at_256_lanes():
    n = 256
    planes = interop.state_to_numpy(contracts.bench_batch(n, "cpu"))
    want, got = run_both(contracts.build_bench_contract(), planes,
                         contracts.BENCH_MAX_STEPS, "bench")
    words = [int.from_bytes(bytes(row), "big") for row in planes["calldata"]]
    steps, stored = zip(*contracts.bench_closed_form(words))
    assert (want["status"] == T.Status.STOPPED).all()
    assert want["steps"].tolist() == list(steps)
    assert (want["scount"] == 1).all()
    assert [T.extract_storage(got, i) for i in range(n)] == \
        [{0: v} for v in stored]


def test_lane_mix_contract():
    st = contracts.lane_mix_batch(CASE_LANES, seed=3, max_n=14,
                                  device="cpu")
    want, _ = run_both(contracts.build_lane_mix_contract(),
                       interop.state_to_numpy(st), CASE_STEPS, "lane mix")
    assert set(want["status"].tolist()) == {T.Status.STOPPED,
                                            T.Status.RETURNED}
    small = contracts.lane_mix_batch(CASE_LANES, seed=4, device="cpu",
                                     memory_bytes=128, storage_slots=4)
    out = T.run_plain(T.compile_code(contracts.build_lane_mix_contract(),
                                     device="cpu"), small, 4000)
    kinds = np.arange(CASE_LANES) % 3
    status = out.status.numpy()
    assert (status[kinds == 0] == T.Status.STOPPED).all()
    assert (status[kinds > 0] == T.Status.NEEDS_HOST).any()


# ---------------------------------------------------------------------------
# builders, extractors, interop, the copied contracts
# ---------------------------------------------------------------------------

def test_host_builders_and_interop_round_trip():
    jst, tst = J.init_lanes(4), T.init_lanes(4, device="cpu")
    jst = J.set_lane_word(jst, "stack", 1, M - 5)
    tst = T.set_lane_word(tst, "stack", 1, M - 5)
    jst = J.set_env_word(jst, "CALLER", 0xDEAD, lane=2)
    tst = T.set_env_word(tst, "CALLER", 0xDEAD, lane=2)
    jst = J.set_env_word(jst, "NUMBER", 1 << 200)
    tst = T.set_env_word(tst, "NUMBER", 1 << 200)
    jst = J.preload_storage(jst, 3, {5: 6, M - 1: 1 << 255})
    tst = T.preload_storage(tst, 3, {5: 6, M - 1: 1 << 255})
    jst = J.set_calldata(jst, 0, b"\x01\x02\x03")
    tst = T.set_calldata(tst, 0, b"\x01\x02\x03")
    planes = planes_of(jst)
    assert_same(planes, tst, "builders")
    back = interop.state_from_numpy(planes, "cpu")
    assert isinstance(back, T.LaneState)
    assert_same(planes, back, "round trip")
    for f in T.LANE_FIELDS:
        assert getattr(back, f).dtype == (torch.uint8 if f in T.LANE_U8
                                          else torch.int32)
    assert T.extract_storage(tst, 3) == J.extract_storage(jst, 3)
    assert T.lane_bytes(tst) == sum(planes[f][0].nbytes for f in FIELDS)


def test_init_lanes_matches_jax_defaults():
    assert_same(planes_of(J.init_lanes(3)), T.init_lanes(3, device="cpu"))
    assert_same(planes_of(J.init_lanes(2, 8, 32, 2, 16, gas_limit=77)),
                T.init_lanes(2, 8, 32, 2, 16, gas_limit=77, device="cpu"))


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_lanes(4)
    st = T.init_lanes(4, device="cpu")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        T.run_kernel(T.compile_code(b"\x00", device="cpu"), st, 1)


def test_contract_builders_are_the_repo_workloads(monkeypatch):
    assert contracts.build_bench_contract() == bench.build_contract()
    captured = []

    def fake_run(code, st, max_steps):
        captured.append(planes_of(st))
        return st._replace(status=jnp.full_like(st.status, 1))

    monkeypatch.setattr(J, "run", fake_run)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    bench.bench_device(bench.build_contract(), n_lanes=24, repeats=1)
    assert captured
    for planes in captured:
        assert_same(planes, contracts.bench_batch(24, "cpu"), "bench batch")
    cc, _ = __graft_entry__._build_fixture(4)
    np.testing.assert_array_equal(
        T.pack_code(contracts.build_dispatcher_loop()), np.asarray(cc.packed))
