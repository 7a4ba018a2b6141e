"""Bytecode of the contracts the port is driven and tested with.

``build_symbolic_contract`` is the port's copy of ``bench.py``'s
workload of the same name (the ``bench_symbolic`` cell: k sequential
symbolic branches, 2**k paths, an arithmetic arm and an SSTORE per
level, a SHA3 tail); ``build_dispatcher_loop`` is the dispatcher-with-
loop contract of ``__graft_entry__._build_fixture``. The port imports
neither, so it keeps these copies; tests check the bytes are equal.
``build_diamond_contract`` is ``bench.py``'s window-merge rig (a storm
of rejoining diamonds), ``build_sha3_resume_contract`` the JAX package's
in-place-resume rig (``tests/test_lane_resume.py``).
``build_coverage_contract`` is the port's own: a symbolic switch whose
arms each exercise one family of the symbolic stepper.

For the concrete stepper: ``build_bench_contract`` and ``bench_batch``
are the copies of ``bench.py``'s ``build_contract`` and of the batch
``bench_device`` runs (its headline "paths/sec/chip"), with
``bench_closed_form``, each lane's outcome from its calldata in Python
ints. ``build_lane_mix_contract`` is the port's own: per lane, the loop
of ``build_dispatcher_loop``, a memory loop or a storage loop
(``lane_mix_batch`` picks one per lane).
"""

from .opcodes import ADDRESS, OPCODES

_OP = {name: data[ADDRESS] for name, data in OPCODES.items()}


def _push(v: int, n: int = 1) -> bytes:
    return bytes([0x5F + n]) + v.to_bytes(n, "big")


def build_symbolic_contract(k: int = 12):
    """(bytecode, 2**k paths): k symbolic branches, each with an ADD and
    an SSTORE arm, then a SHA3 over scratch memory stored at slot 99."""
    op = _OP
    c = bytearray(_push(0))
    for i in range(k):
        c += _push(i) + bytes([op["CALLDATALOAD"]])
        c += _push(1) + bytes([op["AND"], op["ISZERO"]])
        j = len(c)
        c += _push(0, 2) + bytes([op["JUMPI"]])
        c += _push(7) + bytes([op["ADD"], op["DUP1"]])
        c += _push(i) + bytes([op["SSTORE"]])
        dest = len(c)
        c[j + 1:j + 3] = dest.to_bytes(2, "big")
        c += bytes([op["JUMPDEST"]])
    c += _push(0) + bytes([op["MSTORE"]])
    c += _push(32) + _push(0) + bytes([op["SHA3"]])
    c += _push(99) + bytes([op["SSTORE"], op["STOP"]])
    return bytes(c), 2 ** k




def build_sha3_resume_contract():
    """A 33-byte SHA3 over a symbolic word and one concrete byte: the
    device defers only 32- and 64-byte hashes, so the lane parks at the
    SHA3 and the engine resumes it in place with the host-built keccak
    term; the result is stored at slot 99."""
    op = _OP
    return (_push(0) + bytes([op["CALLDATALOAD"]])
            + _push(0) + bytes([op["MSTORE"]])
            + _push(7) + _push(32) + bytes([op["MSTORE8"]])
            + _push(33) + _push(0) + bytes([op["SHA3"]])
            + _push(99) + bytes([op["SSTORE"], op["STOP"]]))

def build_diamond_contract(k=6, dup_levels=2, tail=True, uneven_gas=0):
    """k gas- and step-balanced CFG diamonds: level i forks on a
    calldata bit, both arms run the same instruction count and gas
    (JUMPDEST, PUSH2 R, JUMP) and rejoin at R with identical
    stack/memory/storage, the exact-frontier-twin shape the window
    merge collapses. The first ``dup_levels`` levels re-test bit 0 (so
    superset subsumption fires), the rest fork on distinct bits. The
    optional tail forks on calldata word 31 == 0xdeadbeef into an
    INVALID (one Exception State issue). ``uneven_gas=p`` inserts
    p*2**i stack-neutral filler pairs into both arms of level i
    (PUSH1/POP on the fall side, CALLER/POP on the taken side)."""
    op = _OP
    c = bytearray()
    for i in range(k):
        bit = 0 if i < dup_levels else i
        c += _push(bit) + bytes([op["CALLDATALOAD"]])
        c += _push(1) + bytes([op["AND"]])
        j = len(c)
        c += _push(0, 2) + bytes([op["JUMPI"]])
        c += bytes([op["JUMPDEST"]])
        for _ in range(uneven_gas * (1 << i)):
            c += _push(0) + bytes([op["POP"]])
        jf = len(c)
        c += _push(0, 2) + bytes([op["JUMP"]])
        t = len(c)
        c[j + 1:j + 3] = t.to_bytes(2, "big")
        c += bytes([op["JUMPDEST"]])
        for _ in range(uneven_gas * (1 << i)):
            c += bytes([op["CALLER"], op["POP"]])
        jt = len(c)
        c += _push(0, 2) + bytes([op["JUMP"]])
        r = len(c)
        c[jf + 1:jf + 3] = r.to_bytes(2, "big")
        c[jt + 1:jt + 3] = r.to_bytes(2, "big")
        c += bytes([op["JUMPDEST"]])
    if tail:
        c += _push(31) + bytes([op["CALLDATALOAD"]])
        c += _push(0xDEADBEEF, 4) + bytes([op["EQ"]])
        j = len(c)
        c += _push(0, 2) + bytes([op["JUMPI"]])
        c += bytes([op["STOP"]])
        t = len(c)
        c[j + 1:j + 3] = t.to_bytes(2, "big")
        c += bytes([op["JUMPDEST"], 0xFE])
    else:
        c += bytes([op["STOP"]])
    return bytes(c)

def build_dispatcher_loop() -> bytes:
    """x = calldata[0]; acc = 0; while x: acc += x*x; x -= 1;
    sstore(0, acc)."""
    op = _OP
    code = bytearray()
    code += _push(0) + bytes([op["CALLDATALOAD"]])
    code += _push(0)
    loop = len(code)
    code += bytes([op["JUMPDEST"], op["DUP2"], op["ISZERO"]])
    code += _push(0, 2) + bytes([op["JUMPI"]])
    patch = len(code) - 4
    code += bytes([op["DUP2"], op["DUP3"], op["MUL"], op["ADD"]])
    code += bytes([op["SWAP1"]]) + _push(1) \
        + bytes([op["SWAP1"], op["SUB"], op["SWAP1"]])
    code += _push(loop) + bytes([op["JUMP"]])
    done = len(code)
    code += bytes([op["JUMPDEST"]]) + _push(0) \
        + bytes([op["SSTORE"], op["STOP"]])
    code[patch + 1:patch + 3] = done.to_bytes(2, "big")
    return bytes(code)


def assemble(items) -> bytes:
    """Tiny assembler: items are opcode names, ints (PUSH1..PUSH32 of
    the smallest width), ("label", name) and ("ref", name) (a PUSH2 of
    the label's address)."""
    out = bytearray()
    labels, refs = {}, []
    for it in items:
        if isinstance(it, str):
            out.append(_OP[it])
        elif isinstance(it, int):
            n = max(1, (it.bit_length() + 7) // 8)
            out += _push(it, n)
        elif it[0] == "label":
            labels[it[1]] = len(out)
            out.append(_OP["JUMPDEST"])
        else:
            refs.append((len(out) + 1, it[1]))
            out += _push(0, 2)
    for pos, name in refs:
        out[pos:pos + 2] = labels[name].to_bytes(2, "big")
    return bytes(out)


def build_coverage_contract() -> bytes:
    """A symbolic switch on calldata word 0: each arm exercises one
    family of the symbolic stepper and stops (or parks where the device
    must hand the lane to the host)."""
    arms = {
        # symbolic word store and an exact aligned reload (overlay hit),
        # symbolic arithmetic on the reloaded sid, a symbolic SSTORE
        "overlay": [0x20, "CALLDATALOAD", 0x40, "MSTORE", 0x40, "MLOAD",
                    5, "ADD", 7, "SSTORE", "MSIZE", "POP", "STOP"],
        # a reload mixing symbolic and never-written bytes parks
        "mixed": [0x20, "CALLDATALOAD", 0x40, "MSTORE", 0x50, "MLOAD",
                  "STOP"],
        # symbolic-key storage: mode on, read-over-write SLOAD record
        "symkey": [9, 0x20, "CALLDATALOAD", "SSTORE", 0x20,
                   "CALLDATALOAD", "SLOAD", 1, "SSTORE", 3, "SLOAD",
                   "POP", "STOP"],
        # a concrete write before the first symbolic key parks the lane
        "modepark": [1, 2, "SSTORE", 2, "SLOAD", "POP", 0x20,
                     "CALLDATALOAD", "SLOAD", "STOP"],
        # concrete division, modular, exponent, shift and byte families
        "alu": [(1 << 255) + 12345, 7, "SWAP1", "DIV",
                (1 << 256) - 3, 5, "SWAP1", "SDIV", "ADD",
                (1 << 255), (1 << 256) - 1, "SWAP1", "SDIV", "ADD",
                11, (1 << 200) + 9, "MOD", "ADD",
                (1 << 256) - 20, 7, "SWAP1", "SMOD", "ADD",
                99, 2 ** 200 + 1, 2 ** 255 + 3, "ADDMOD", "ADD",
                99, 2 ** 200 + 1, 2 ** 255 + 3, "MULMOD", "ADD",
                40, 2, "EXP", "ADD", 0, 0, "ADDMOD", "ADD",
                0x80, 0, "SIGNEXTEND", "ADD", 3, 0xABCDEF, "SWAP1", "BYTE",
                "ADD", 4, "SHL", 2, "SAR", 300, "SHR", "ISZERO", 0,
                "SSTORE", 3, 5, "EXP", "STOP"],
        # 64-byte SHA3 defers; a 33-byte one parks
        "sha3": [0x20, "CALLDATALOAD", 0, "MSTORE", 5, 0x20, "MSTORE",
                 0x40, 0, "SHA3", 0x60, "MSTORE", 33, 0, "SHA3", "STOP"],
        # symbolic arithmetic in a concrete loop fills the record log
        "dlog": [0x20, "CALLDATALOAD", 80, ("label", "loop"),
                 "SWAP1", 1, "ADD", "SWAP1", 1, "SWAP1", "SUB", "DUP1",
                 ("ref", "loop"), "JUMPI", "STOP"],
        # env, calldata size, code/pc/gas/msize, comparisons, bitwise,
        # MSTORE8, a symbolic JUMP target (parks)
        "misc": ["CALLER", "CALLVALUE", "EQ", "ADDRESS", "CALLDATASIZE",
                 "LT", "OR", "GAS", "PC", "CODESIZE", "MSIZE", "XOR",
                 "XOR", "XOR", "NOT", 0x41, 3, "MSTORE8", 2, 0x22,
                 "CALLDATALOAD", "SLT", "SGT", 0x20, "CALLDATALOAD",
                 "JUMP"],
        # a concrete BALANCE parks
        "balance": [5, "BALANCE", "STOP"],
    }
    items = [0, "CALLDATALOAD"]
    for i, name in enumerate(arms):
        items += ["DUP1", i + 1, "EQ", ("ref", name), "JUMPI"]
    items += ["STOP"]
    for name, body in arms.items():
        items += [("label", name)] + body
    return assemble(items)


# ---------------------------------------------------------------------------
# the concrete stepper's workloads
# ---------------------------------------------------------------------------

def build_bench_contract() -> bytes:
    """Dispatcher + arithmetic loop: selector-gated work(x) that
    iterates x % 97 times doing mul/add chains, then stores the
    result (``bench.build_contract``)."""
    op = _OP
    code = bytearray()
    code += _push(0) + bytes([op["CALLDATALOAD"]])
    code += _push(97) + bytes([op["SWAP1"], op["MOD"]])
    code += _push(1)
    loop = len(code)
    code += bytes([op["JUMPDEST"], op["DUP2"], op["ISZERO"]])
    code += _push(0, 2) + bytes([op["JUMPI"]])
    patch = len(code) - 4
    code += _push(3) + bytes([op["MUL"], op["DUP2"], op["ADD"]])
    code += bytes([op["SWAP1"]]) + _push(1) \
        + bytes([op["SWAP1"], op["SUB"], op["SWAP1"]])
    code += _push(loop) + bytes([op["JUMP"]])
    done = len(code)
    code += bytes([op["JUMPDEST"]]) + _push(0) \
        + bytes([op["SSTORE"], op["STOP"]])
    code[patch + 1:patch + 3] = done.to_bytes(2, "big")
    return bytes(code)


#: ``bench_device``'s batch: lane sizes and its run's step cap
BENCH_LANE_KW = dict(stack_depth=16, memory_bytes=64, storage_slots=4,
                     calldata_bytes=32)
BENCH_MAX_STEPS = 1800


def bench_calldata(n_lanes: int):
    """Lane i's calldata word, i * 2654435761 mod 2**256, as (n, 32)
    big-endian bytes."""
    import numpy as np

    cd = np.zeros((n_lanes, 32), dtype=np.uint8)
    for i in range(n_lanes):
        cd[i] = np.frombuffer(
            int.to_bytes(i * 2654435761 % (1 << 256), 32, "big"),
            dtype=np.uint8)
    return cd


def bench_batch(n_lanes: int, device=None):
    """``bench_device``'s batch: ``init_lanes`` at its sizes, lane i's
    calldata ``bench_calldata``, cd_size 32, on ``device``."""
    import torch

    from ..ops import stepper

    st = stepper.init_lanes(n_lanes, device=device, **BENCH_LANE_KW)
    st.calldata.copy_(torch.from_numpy(bench_calldata(n_lanes)))
    st.cd_size.fill_(32)
    return st


def bench_closed_form(words):
    """Each lane's outcome on ``build_bench_contract`` from its calldata
    word, in Python ints: (steps retired, the word stored at slot 0).
    n = x % 97; acc starts at 1 and takes acc * 3 + k for k = n..1;
    6 prologue steps, 16 a loop turn, 9 for the exit test and the
    SSTORE tail."""
    out, memo = [], {}
    for x in words:
        n = int(x) % 97
        if n not in memo:
            acc = 1
            for k in range(n, 0, -1):
                acc = (acc * 3 + k) % (1 << 256)
            memo[n] = (15 + 16 * n, acc)
        out.append(memo[n])
    return out


def build_lane_mix_contract() -> bytes:
    """Three arms on calldata word 1 % 3, each looping n = calldata
    word 0 times: 0, the dispatcher loop of
    ``__graft_entry__._build_fixture`` (acc += x*x, SSTORE at the end);
    1, a memory loop (MSTORE of i*i + n at 32*i, MSTORE8 at 31, an MLOAD
    back; RETURN of memory[0:MSIZE]), which parks once 32*i passes the
    lane's memory; 2, a storage loop (slot 7*i % 72 += i + 1, slot 0 :=
    i, updated in place), which parks once the log's 64 slots are
    full."""
    loop_test = ["DUP2", "DUP2", "LT", "ISZERO"]
    return assemble([
        0x20, "CALLDATALOAD", 3, "SWAP1", "MOD",
        "DUP1", 1, "EQ", ("ref", "mem"), "JUMPI",
        2, "EQ", ("ref", "sto"), "JUMPI",
        0, "CALLDATALOAD", 0,
        ("label", "l0"), "DUP2", "ISZERO", ("ref", "d0"), "JUMPI",
        "DUP2", "DUP3", "MUL", "ADD", "SWAP1", 1, "SWAP1", "SUB", "SWAP1",
        ("ref", "l0"), "JUMP",
        ("label", "d0"), 0, "SSTORE", "STOP",
        ("label", "mem"), "POP", 0, "CALLDATALOAD", 0,
        ("label", "lm"), *loop_test, ("ref", "dm"), "JUMPI",
        "DUP1", "DUP1", "MUL", "DUP3", "ADD", "DUP2", 32, "MUL", "MSTORE",
        "DUP1", 31, "MSTORE8", "DUP1", 32, "MUL", "MLOAD", "POP",
        1, "ADD", ("ref", "lm"), "JUMP",
        ("label", "dm"), "POP", "POP", "MSIZE", 0, "RETURN",
        ("label", "sto"), 0, "CALLDATALOAD", 0,
        ("label", "ls"), *loop_test, ("ref", "ds"), "JUMPI",
        "DUP1", 7, "MUL", 72, "SWAP1", "MOD",
        "DUP1", "SLOAD", "DUP3", "ADD", 1, "ADD", "SWAP1", "SSTORE",
        "DUP1", 0, "SSTORE", 1, "ADD", ("ref", "ls"), "JUMP",
        ("label", "ds"), "POP", "POP", 0, "SLOAD", "CALLER", "XOR", 1,
        "SSTORE", "STOP",
    ])


def lane_mix_batch(n_lanes: int, seed: int, max_n: int = 160,
                   device=None, **lane_kw):
    """A batch for ``build_lane_mix_contract``: ``init_lanes`` (its
    default sizes unless ``lane_kw`` names others), lane i's arm i % 3
    and a seeded loop count in [0, max_n), 64 bytes of calldata."""
    import numpy as np
    import torch

    from ..ops import stepper

    st = stepper.init_lanes(n_lanes, device=device, **lane_kw)
    rng = np.random.default_rng(seed)
    cd = np.zeros((n_lanes, st.calldata.shape[1]), dtype=np.uint8)
    loops = rng.integers(0, max_n, size=n_lanes)
    cd[:, 30] = loops >> 8
    cd[:, 31] = loops & 0xFF
    cd[:, 63] = np.arange(n_lanes) % 3
    st.calldata.copy_(torch.from_numpy(cd))
    st.cd_size.fill_(64)
    return st
