"""The EVM lane stepper: status codes, per-opcode tables, compiled code,
and the concrete lane path (``LaneState``, ``step``, ``run``).

The counterpart of ``mythril_tpu/ops/stepper.py``: ``Status``, the
``NPOP/NPUSH/SUPPORTED/ENV/RESULT_CLASS`` tables, ``CompiledCode`` with
its packed ``(L+1, 14)`` int32 plane and ``compile_code`` (which the
symbolic stepper shares), and the concrete batch: ``LaneState`` (the 17
JAX planes, uint32 limbs held as int32 bit patterns), ``init_lanes``,
the plain PyTorch ``step_plain``/``run_plain`` (a line-by-line mirror of
the JAX ``step``/``run``), and ``run``/``step``, which update the
planes in place, as the JAX ``run_jit`` may with its donated state: on
a CUDA state through one launch of kernel K10 (``csrc/stepper.cu``
``lane_run``), on a CPU state by copying the plain result back. The
host builders and extractors (``set_calldata``, ``extract_storage``,
...) update a state in place and return it. ``compile_packed_code``
builds the segment arena of a cross-tenant packed wave: several
contracts' planes in one table, with the ``seg_of``/``seg_tab`` lookup
the symbolic stepper resolves each lane's own member through.
"""

import ctypes
import math
from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..support.opcodes import ADDRESS, GAS, OPCODES
from . import bv256


class Status:
    RUNNING = 0
    STOPPED = 1
    RETURNED = 2
    REVERTED = 3
    INVALID = 4
    NEEDS_HOST = 5
    SELFDESTRUCT = 6


_OP = {name: data[ADDRESS] for name, data in OPCODES.items()}

ENV_SLOTS = {
    "ADDRESS": 0, "ORIGIN": 1, "CALLER": 2, "CALLVALUE": 3,
    "GASPRICE": 4, "COINBASE": 5, "TIMESTAMP": 6, "NUMBER": 7,
    "DIFFICULTY": 8, "GASLIMIT": 9, "CHAINID": 10, "SELFBALANCE": 11,
    "BASEFEE": 12,
}
N_ENV = len(ENV_SLOTS)

#: which computed word an opcode pushes; the order is the case order of
#: the result select in ops/symstep.sym_step and csrc/symstep.cu
RESULT_CLASSES = (
    "ZERO ADD MUL SUB DIV SDIV MOD SMOD ADDMOD MULMOD EXP SIGNEXTEND "
    "LT GT SLT SGT EQ ISZERO AND OR XOR NOT BYTE SHL SHR SAR MLOAD "
    "SLOAD PC MSIZE GAS CALLDATALOAD CALLDATASIZE CODESIZE ENV PUSH DUP"
).split()
RESULT_CLASS_ID = {name: i for i, name in enumerate(RESULT_CLASSES)}


def _build_tables():
    """Static (256,) per-opcode metadata tables."""
    npop = np.zeros(256, dtype=np.int32)
    npush = np.zeros(256, dtype=np.int32)
    static_gas = np.zeros(256, dtype=np.uint32)
    supported = np.zeros(256, dtype=bool)
    env_slot = np.full(256, -1, dtype=np.int32)
    result_class = np.zeros(256, dtype=np.int32)

    for name, data in OPCODES.items():
        static_gas[data[ADDRESS]] = data[GAS][0]

    def sup(name, pops, pushes):
        byte = _OP[name]
        supported[byte] = True
        npop[byte] = pops
        npush[byte] = pushes
        if name in RESULT_CLASS_ID:
            result_class[byte] = RESULT_CLASS_ID[name]

    for name in (
        "ADD MUL SUB DIV SDIV MOD SMOD EXP SIGNEXTEND LT GT SLT SGT EQ "
        "AND OR XOR BYTE SHL SHR SAR"
    ).split():
        sup(name, 2, 1)
    for name in ("ISZERO", "NOT"):
        sup(name, 1, 1)
    for name in ("ADDMOD", "MULMOD"):
        sup(name, 3, 1)
    sup("STOP", 0, 0)
    sup("POP", 1, 0)
    # SHA3 and BALANCE run only on the symbolic stepper, which needs
    # their stack effect
    npop[_OP["SHA3"]] = 2
    npush[_OP["SHA3"]] = 1
    npop[_OP["BALANCE"]] = 1
    npush[_OP["BALANCE"]] = 1
    sup("MLOAD", 1, 1)
    sup("MSTORE", 2, 0)
    sup("MSTORE8", 2, 0)
    sup("SLOAD", 1, 1)
    sup("SSTORE", 2, 0)
    sup("JUMP", 1, 0)
    sup("JUMPI", 2, 0)
    sup("JUMPDEST", 0, 0)
    sup("PC", 0, 1)
    sup("MSIZE", 0, 1)
    sup("GAS", 0, 1)
    sup("CALLDATALOAD", 1, 1)
    sup("CALLDATASIZE", 0, 1)
    sup("CODESIZE", 0, 1)
    sup("RETURN", 2, 0)
    sup("REVERT", 2, 0)
    sup("INVALID", 0, 0)
    sup("SELFDESTRUCT", 1, 0)
    for name, slot in ENV_SLOTS.items():
        sup(name, 0, 1)
        env_slot[_OP[name]] = slot
        result_class[_OP[name]] = RESULT_CLASS_ID["ENV"]
    for i in range(1, 33):
        b = 0x5F + i
        supported[b] = True
        npush[b] = 1
        result_class[b] = RESULT_CLASS_ID["PUSH"]
    for i in range(1, 17):
        b = 0x7F + i
        supported[b] = True
        npush[b] = 1
        result_class[b] = RESULT_CLASS_ID["DUP"]
    for i in range(1, 17):
        supported[0x8F + i] = True
    return npop, npush, static_gas, supported, env_slot, result_class


(NPOP_TABLE, NPUSH_TABLE, GAS_TABLE, SUPPORTED_TABLE, ENV_TABLE,
 RESULT_CLASS_TABLE) = _build_tables()


# ---------------------------------------------------------------------------
# compiled code
# ---------------------------------------------------------------------------

@dataclass
class CompiledCode:
    """Per-pc planes of one contract, packed into ONE ``(L+1, 14)`` int32
    tensor with the column layout of the JAX package: opcode, next_pc,
    is_jumpdest, is_func_entry, 8 PUSH-immediate limbs, det_mask,
    loopsum_park. ``size`` is the real code length (of a packed arena:
    its used length). ``seg_of`` (``(L+1,)`` int32, arena pc -> member)
    and ``seg_tab`` (``(S, 2)`` int32 [base, size] rows) are set only by
    ``compile_packed_code``; a plain compile leaves both None."""

    packed: torch.Tensor
    size: int
    seg_of: Optional[torch.Tensor] = None
    seg_tab: Optional[torch.Tensor] = None

    @property
    def opcode(self):
        return self.packed[:, 0]

    @property
    def next_pc(self):
        return self.packed[:, 1]

    @property
    def is_jumpdest(self):
        return self.packed[:, 2] != 0

    @property
    def is_func_entry(self):
        return self.packed[:, 3] != 0

    @property
    def push_value(self):  # (L+1, 8) limb bit patterns
        return self.packed[:, 4:4 + bv256.NLIMBS]

    @property
    def det_mask(self):  # (L+1,) uint32 bit patterns
        return self.packed[:, 12]

    @property
    def loopsum_park(self):
        return self.packed[:, 13] != 0


#: padded code lengths (the JAX package pads to share compiled
#: programs; the port keeps the same padding so planes compare equal)
_CODE_BUCKETS = (4096, 16384, 65536)


def _code_bucket(length: int) -> int:
    for b in _CODE_BUCKETS:
        if length <= b:
            return b
    return length


def pack_code(code: bytes, func_entries=(), det_mask=None,
              loopsum_pcs=None, padded=None) -> np.ndarray:
    """The packed ``(L+1, 14)`` int32 code plane, as numpy; ``L`` is
    ``padded``, by default the code's bucket."""
    length = len(code)
    if padded is None:
        padded = _code_bucket(length)
    opcode = np.full(padded + 1, _OP["STOP"], dtype=np.int32)
    push_value = np.zeros((padded + 1, bv256.NLIMBS), dtype=np.uint32)
    next_pc = np.arange(1, padded + 2, dtype=np.int32)
    is_jumpdest = np.zeros(padded + 1, dtype=np.int32)
    is_func_entry = np.zeros(padded + 1, dtype=np.int32)
    mask_col = np.zeros(padded + 1, dtype=np.uint32)
    loopsum_col = np.zeros(padded + 1, dtype=np.int32)
    for addr in func_entries:
        if 0 <= addr <= length:
            is_func_entry[addr] = 1
    i = 0
    while i < length:
        op = code[i]
        opcode[i] = op
        if 0x60 <= op <= 0x7F:
            n = op - 0x5F
            push_value[i] = bv256.int_to_limbs(
                int.from_bytes(code[i + 1:i + 1 + n], "big"))
            next_pc[i] = i + 1 + n
        elif op == _OP["JUMPDEST"]:
            is_jumpdest[i] = 1
        i = next_pc[i]
    if det_mask is not None:
        n = min(len(det_mask), length + 1)
        mask_col[:n] = np.asarray(det_mask[:n], dtype=np.uint32)
    if loopsum_pcs is not None:
        n = min(len(loopsum_pcs), length + 1)
        loopsum_col[:n] = np.asarray(loopsum_pcs[:n], dtype=bool)
    return np.concatenate([
        opcode[:, None], next_pc[:, None], is_jumpdest[:, None],
        is_func_entry[:, None], push_value.view(np.int32),
        mask_col[:, None].view(np.int32), loopsum_col[:, None],
    ], axis=1)


def compile_code(code: bytes, func_entries=(), det_mask=None,
                 loopsum_pcs=None, device=None) -> CompiledCode:
    """Compile bytecode to per-pc planes on ``device`` (``cuda`` unless
    the caller names another). ``func_entries``: byte addresses of
    function entry points; ``det_mask``/``loopsum_pcs``: the optional
    static-pass columns (zeros when absent)."""
    from ..support.devices import resolve

    packed = pack_code(code, func_entries, det_mask, loopsum_pcs)
    return CompiledCode(packed=torch.from_numpy(packed).to(resolve(device)),
                        size=len(code))


# -- cross-tenant wave packing ------------------------------------------------

#: STOP-filled guard bytes between packed segments: a lane walking off
#: its member's code end halts inside its own region before it reads a
#: neighbour's rows (the longest pc advance is a PUSH32's 33 bytes;
#: jumps are bounded by the member's own size)
SEG_GUARD = 64


def _seg_bucket(n: int) -> int:
    """pow2 segment-count bucket (the JAX package's, so the tables of
    both packages have equal shapes)."""
    return 1 << max(1, (max(1, n) - 1).bit_length())


def compile_packed_code(members, device=None):
    """One segment-arena ``CompiledCode`` for several member contracts
    on ``device``: each member's planes (``pack_code``) land at a
    STOP-guarded base offset with ``next_pc`` in arena coordinates, and
    ``seg_of``/``seg_tab`` let the symbolic stepper resolve each lane's
    jump bounds, CODESIZE and PC against its own member. ``members``:
    [(code_bytes, func_entries)] or [(code_bytes, func_entries,
    loopsum_pcs)], the optional per-member loop-summary park plane.
    ``size`` is the arena's used length. Returns (CompiledCode, [base
    offsets])."""
    from ..support.devices import resolve

    if not members:
        raise ValueError("packed compile needs at least one member")
    bases, off = [], 0
    for member in members:
        bases.append(off)
        off += len(member[0]) + SEG_GUARD
    padded = _code_bucket(off)
    arena = pack_code(b"", padded=padded)
    seg_of = np.zeros(padded + 1, dtype=np.int32)
    seg_tab = np.zeros((_seg_bucket(len(members)), 2), dtype=np.int32)
    for idx, (member, base) in enumerate(zip(members, bases)):
        code, fentries = member[0], member[1]
        loopsum_pcs = member[2] if len(member) > 2 else None
        rows = pack_code(code, fentries, loopsum_pcs=loopsum_pcs)
        rows = rows[:len(code) + 1]
        rows[:, 1] += base
        arena[base:base + len(rows)] = rows
        end = bases[idx + 1] if idx + 1 < len(bases) else padded + 1
        seg_of[base:end] = idx
        seg_tab[idx] = (base, len(code))
    dev = resolve(device)
    return CompiledCode(packed=torch.from_numpy(arena).to(dev), size=off,
                        seg_of=torch.from_numpy(seg_of).to(dev),
                        seg_tab=torch.from_numpy(seg_tab).to(dev)), bases


# ---------------------------------------------------------------------------
# word helpers (words in the int64 arithmetic form of ops/bv256)
# ---------------------------------------------------------------------------

def _lanes(x):
    return torch.arange(x.shape[0], device=x.device)


def _onehot_gather(arr, idx):
    """arr[lane, idx[lane]] (idx already in range)."""
    return arr[_lanes(arr), idx.long()]


def _peek(stack, sp, k):
    """Word at stack position sp-k, clip-guarded (the caller masks)."""
    return _onehot_gather(stack, (sp - k).clamp(0, stack.shape[1] - 1))


def _scatter_word(plane, lane_mask, idx, value):
    """plane[lane, idx[lane]] = value[lane] where lane_mask, on a copy."""
    out = plane.clone()
    lanes = _lanes(plane)[lane_mask]
    out[lanes, idx.long()[lane_mask]] = value[lane_mask].to(plane.dtype)
    return out


def _u32_of(word):
    """Low 32 bits, and whether the word exceeds 32 bits."""
    return word[..., 0], (word[..., 1:] != 0).any(dim=-1)


def word_to_bytes_be(w):
    """(..., 8) limbs -> (..., 32) uint8 big-endian bytes."""
    sh = torch.tensor([24, 16, 8, 0], device=w.device)
    parts = (w.flip(-1)[..., :, None] >> sh) & 0xFF
    return parts.reshape(w.shape[:-1] + (32,)).to(torch.uint8)


def bytes_be_to_word(b):
    """(..., 32) big-endian bytes -> (..., 8) limbs (int64 form)."""
    b = b.to(torch.int64).reshape(b.shape[:-1] + (bv256.NLIMBS, 4))
    limbs = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]
    return limbs.flip(-1)


# ---------------------------------------------------------------------------
# the concrete lane batch
# ---------------------------------------------------------------------------

@dataclass
class LaneState:
    """Struct-of-arrays state of N concurrently executing concrete paths,
    the 17 planes of the JAX ``LaneState`` in its field order. uint32
    planes (``LANE_U32``) hold their bit patterns in int32 tensors,
    uint8 planes (``LANE_U8``) are uint8, the rest int32."""

    pc: torch.Tensor          # (N,)
    sp: torch.Tensor          # (N,) stack item count
    stack: torch.Tensor       # (N, D, 8) u32
    memory: torch.Tensor      # (N, M) u8
    msize: torch.Tensor       # (N,) active memory bytes (x32)
    skeys: torch.Tensor       # (N, S, 8) u32 storage log keys
    svals: torch.Tensor       # (N, S, 8) u32 storage log values
    scount: torch.Tensor      # (N,)
    calldata: torch.Tensor    # (N, C) u8
    cd_size: torch.Tensor     # (N,)
    env: torch.Tensor         # (N, N_ENV, 8) u32
    gas_used: torch.Tensor    # (N,) u32 (static costs)
    gas_limit: torch.Tensor   # (N,) u32
    status: torch.Tensor      # (N,)
    ret_offset: torch.Tensor  # (N,) RETURN/REVERT memory slice
    ret_len: torch.Tensor     # (N,)
    steps: torch.Tensor       # (N,) instructions retired per lane

    def replace(self, **kw) -> "LaneState":
        return replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.pc.device


LANE_FIELDS = tuple(f.name for f in fields(LaneState))
LANE_U32 = frozenset(("stack", "skeys", "svals", "env", "gas_used",
                      "gas_limit"))
LANE_U8 = frozenset(("memory", "calldata"))


def init_lanes(n_lanes: int, stack_depth: int = 64, memory_bytes: int = 4096,
               storage_slots: int = 64, calldata_bytes: int = 512,
               gas_limit: int = 0xFFFFFFFF, device=None) -> LaneState:
    """A zeroed batch of RUNNING lanes at pc 0 on ``device`` (``cuda``
    unless the caller names another), every lane's gas limit
    ``gas_limit``: the JAX ``init_lanes``, which only fills, as
    ``torch.zeros``/``torch.full`` on the device."""
    from ..support.devices import resolve

    dev = resolve(device)
    shapes = dict.fromkeys(LANE_FIELDS, (n_lanes,))
    shapes.update(stack=(n_lanes, stack_depth, bv256.NLIMBS),
                  memory=(n_lanes, memory_bytes),
                  skeys=(n_lanes, storage_slots, bv256.NLIMBS),
                  svals=(n_lanes, storage_slots, bv256.NLIMBS),
                  calldata=(n_lanes, calldata_bytes),
                  env=(n_lanes, N_ENV, bv256.NLIMBS))
    planes = {f: torch.zeros(shapes[f], device=dev, dtype=torch.uint8
                             if f in LANE_U8 else torch.int32)
              for f in LANE_FIELDS}
    planes["gas_limit"] = torch.full((n_lanes,), int(bv256.i32(
        torch.tensor(gas_limit))), dtype=torch.int32, device=dev)
    return LaneState(**planes)


def clone_lanes(st: LaneState) -> LaneState:
    return LaneState(**{f: getattr(st, f).clone() for f in LANE_FIELDS})


def select_lanes(st: LaneState, idx: torch.Tensor) -> LaneState:
    """A new batch holding the lanes ``idx`` of ``st`` (copies)."""
    return LaneState(**{f: getattr(st, f)[idx].contiguous()
                        for f in LANE_FIELDS})


def lane_bytes(st: LaneState) -> int:
    """Bytes of every plane of one lane of ``st``."""
    return sum(getattr(st, f)[0].numel() * getattr(st, f).element_size()
               for f in LANE_FIELDS)


# ---------------------------------------------------------------------------
# the plain step and run (u32-form int64 words, as ops/bv256)
# ---------------------------------------------------------------------------

_LANE_TABLES = {}


def _lane_tables(dev):
    key = str(dev)
    if key not in _LANE_TABLES:
        def t(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x).astype(np.int64),
                                   device=dev).to(dtype)
        _LANE_TABLES[key] = dict(
            npop=t(NPOP_TABLE), npush=t(NPUSH_TABLE), gas=t(GAS_TABLE),
            supported=t(SUPPORTED_TABLE, torch.bool), env=t(ENV_TABLE),
            result_class=t(RESULT_CLASS_TABLE))
    return _LANE_TABLES[key]


def _set_rows(plane, mask, idx, value) -> None:
    """plane[lane, idx[lane]] = value[lane] where mask, in place."""
    lanes = torch.nonzero(mask).reshape(-1)
    plane[lanes, idx[lanes].long()] = value[lanes].to(plane.dtype)


def step_plain(code: CompiledCode, st: LaneState) -> LaneState:
    """Advance every RUNNING lane by one instruction (the JAX ``step``,
    its ``lax.cond`` gates included); returns a new state."""
    tb = _lane_tables(st.device)
    n, depth, _ = st.stack.shape
    mem_bytes = st.memory.shape[1]
    s_slots = st.skeys.shape[1]
    cd_bytes = st.calldata.shape[1]
    lanes = _lanes(st.pc)
    op_ = _OP

    running = st.status == Status.RUNNING
    pc = st.pc.long()
    sp = st.sp.long()
    pc_c = pc.clamp(0, code.size)
    op = torch.where(running, code.opcode[pc_c].long(), op_["STOP"])

    npop, npush = tb["npop"][op], tb["npush"][op]
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    dup_n = torch.where(is_dup, op - 0x7F, 1)
    swap_n = torch.where(is_swap, op - 0x8F, 1)
    eff_pop = torch.where(is_dup, dup_n,
                          torch.where(is_swap, swap_n + 1, npop))
    unsupported = ~tb["supported"][op]
    underflow = sp < eff_pop
    overflow = (sp - npop + npush) > depth

    def peek(k):
        return bv256.u32(_peek(st.stack, sp, k))

    a, b = peek(1), peek(2)
    zero_w = torch.zeros_like(a)
    zero_b = torch.zeros_like(running)

    def gated(mask):
        return bool(torch.any(running & mask))

    # ---- cheap ALU families (always computed, selected per lane)
    add_r, sub_r = bv256.add(a, b), bv256.sub(a, b)
    and_r, or_r, xor_r, not_r = a & b, a | b, a ^ b, bv256.M32 ^ a
    iszero_r = bv256.bool_to_word(bv256.is_zero(a))
    lt_r = bv256.bool_to_word(bv256.ult(a, b))
    gt_r = bv256.bool_to_word(bv256.ugt(a, b))
    slt_r = bv256.bool_to_word(bv256.slt(a, b))
    sgt_r = bv256.bool_to_word(bv256.sgt(a, b))
    eq_r = bv256.bool_to_word(bv256.eq(a, b))

    # ---- gated families
    shift_ops = ((op == op_["BYTE"]) | (op == op_["SHL"]) | (op == op_["SHR"])
                 | (op == op_["SAR"]) | (op == op_["SIGNEXTEND"]))
    byte_r = shl_r = shr_r = sar_r = sext_r = zero_w
    if gated(shift_ops):
        byte_r, shl_r = bv256.byte_op(a, b), bv256.shl(b, a)
        shr_r, sar_r = bv256.shr(b, a), bv256.sar(b, a)
        sext_r = bv256.signextend(a, b)
    mul_r = bv256.mul(a, b) if gated(op == op_["MUL"]) else zero_w
    div_ops = ((op == op_["DIV"]) | (op == op_["SDIV"]) | (op == op_["MOD"])
               | (op == op_["SMOD"]))
    div_r = mod_r = sdiv_r = smod_r = zero_w
    if gated(div_ops):
        div_r, mod_r = bv256.divmod_u(a, b)
        sdiv_r, smod_r = bv256.sdiv(a, b), bv256.smod(a, b)
    addmod_r = mulmod_r = zero_w
    if gated((op == op_["ADDMOD"]) | (op == op_["MULMOD"])):
        c = peek(3)
        addmod_r, mulmod_r = bv256.addmod(a, b, c), bv256.mulmod(a, b, c)
    exp_r = bv256.exp(a, b) if gated(op == op_["EXP"]) else zero_w

    # ---- memory
    is_mload = op == op_["MLOAD"]
    is_mstore = op == op_["MSTORE"]
    is_mstore8 = op == op_["MSTORE8"]
    mem_word_ops = is_mload | is_mstore
    memory, msize = st.memory, st.msize
    mload_r, mem_oob = zero_w, zero_b
    if gated(mem_word_ops | is_mstore8):
        mem_off, mem_hi = _u32_of(a)
        mem_big = mem_hi | (mem_off >= 1 << 30)
        off = torch.where(mem_big, 0, mem_off)
        mem_oob = ((mem_word_ops & (mem_big | (off + 32 > mem_bytes)))
                   | (is_mstore8 & (mem_big | (off >= mem_bytes))))
        byte_idx = off[:, None] + torch.arange(32, device=a.device)
        mload_r = bytes_be_to_word(torch.gather(
            st.memory, 1, byte_idx.clamp(0, mem_bytes - 1)))
        memory = st.memory.clone()
        do_mstore = running & is_mstore & ~mem_oob & ~underflow
        rows = torch.nonzero(do_mstore).reshape(-1)
        memory[rows[:, None], byte_idx[rows]] = word_to_bytes_be(b[rows])
        _set_rows(memory, running & is_mstore8 & ~mem_oob & ~underflow, off,
                  b[:, 0] & 0xFF)
        touched = (torch.where(mem_word_ops, off + 32, 0)
                   + torch.where(is_mstore8, off + 1, 0))
        touched_w = ((touched + 31) // 32) * 32
        msize = torch.where(
            running & (mem_word_ops | is_mstore8) & ~mem_oob,
            torch.maximum(st.msize.long(), touched_w),
            st.msize.long()).to(torch.int32)
    msize_r = bv256.from_u32(msize)

    # ---- storage (bounded read-over-write log)
    is_sload = op == op_["SLOAD"]
    is_sstore = op == op_["SSTORE"]
    skeys, svals, scount = st.skeys, st.svals, st.scount
    sload_r, storage_full = zero_w, zero_b
    if gated(is_sload | is_sstore):
        key = bv256.i32(a)
        slot_ids = torch.arange(s_slots, device=a.device)
        match = (st.skeys == key[:, None, :]).all(dim=-1) \
            & (slot_ids[None, :] < st.scount[:, None])
        best = torch.where(match, slot_ids + 1, 0).max(dim=1).values
        found = best > 0
        found_idx = (best - 1).clamp(0, s_slots - 1)
        sload_r = torch.where(found[:, None],
                              bv256.u32(st.svals[lanes, found_idx]), 0)
        count = st.scount.long()
        store_pos = torch.where(found, found_idx, count)
        storage_full = is_sstore & ~found & (count >= s_slots)
        do_sstore = running & is_sstore & ~storage_full & ~underflow
        pos_c = store_pos.clamp(0, s_slots - 1)
        skeys, svals = st.skeys.clone(), st.svals.clone()
        _set_rows(skeys, do_sstore, pos_c, key)
        _set_rows(svals, do_sstore, pos_c, bv256.i32(b))
        scount = torch.where(do_sstore & ~found, count + 1,
                             count).to(torch.int32)

    # ---- calldata
    is_cdl = op == op_["CALLDATALOAD"]
    cdl_r, cd_oob = zero_w, zero_b
    if gated(is_cdl):
        cd_off, cd_hi = _u32_of(a)
        cd_big = cd_hi | (cd_off >= 1 << 30)
        cd_off_i = torch.where(cd_big, cd_bytes, cd_off)
        cd_idx = cd_off_i[:, None] + torch.arange(32, device=a.device)
        cd_size = st.cd_size.long()
        cd_valid = (cd_idx < cd_size[:, None]) & (cd_idx < cd_bytes)
        cd_read = torch.gather(st.calldata, 1, cd_idx.clamp(0, cd_bytes - 1))
        cdl_r = bytes_be_to_word(torch.where(cd_valid, cd_read, 0))
        cd_oob = is_cdl & (cd_off_i < cd_size) & (cd_off_i + 32 > cd_bytes)

    # ---- env words and the other push-only results
    env_r = bv256.u32(st.env[lanes, tb["env"][op].clamp(0, N_ENV - 1)])
    pc_r = bv256.from_u32(st.pc)
    gas_r = bv256.from_u32(bv256.u32(st.gas_limit) - bv256.u32(st.gas_used))
    cds_r = bv256.from_u32(st.cd_size)
    codesize_r = bv256.from_u32(torch.full_like(pc, code.size))
    push_r = bv256.u32(code.push_value[pc_c])
    dup_r = peek(dup_n)

    cases = (
        zero_w, add_r, mul_r, sub_r, div_r, sdiv_r, mod_r, smod_r,
        addmod_r, mulmod_r, exp_r, sext_r, lt_r, gt_r, slt_r, sgt_r,
        eq_r, iszero_r, and_r, or_r, xor_r, not_r, byte_r, shl_r,
        shr_r, sar_r, mload_r, sload_r, pc_r, msize_r, gas_r, cdl_r,
        cds_r, codesize_r, env_r, push_r, dup_r,
    )
    assert len(cases) == len(RESULT_CLASSES)
    result = torch.stack(cases)[tb["result_class"][op], lanes]

    # ---- the stack: push, then SWAPn (top with top-n, sp unchanged)
    parked = unsupported | mem_oob | cd_oob | storage_full | overflow
    new_sp = sp - npop + npush
    stack = st.stack.clone()
    do_push = running & (npush == 1) & ~underflow & ~parked
    _set_rows(stack, do_push, (new_sp - 1).clamp(0, depth - 1),
              bv256.i32(result))
    do_swap = running & is_swap & ~underflow
    swap_val = _peek(st.stack, sp, swap_n + 1)
    _set_rows(stack, do_swap, (sp - 1).clamp(0, depth - 1), swap_val)
    _set_rows(stack, do_swap, (sp - 1 - swap_n).clamp(0, depth - 1),
              bv256.i32(a))

    # ---- control flow
    dest_u32, dest_hi = _u32_of(a)
    dest_small = ~dest_hi & (dest_u32 < code.size)
    dest = torch.where(dest_small, dest_u32, 0)
    dest_ok = dest_small & code.is_jumpdest[dest.clamp(0, code.size)]
    is_jump = op == op_["JUMP"]
    is_jumpi = op == op_["JUMPI"]
    jumpi_taken = ~bv256.is_zero(b)
    new_pc = code.next_pc[pc_c].long()
    new_pc = torch.where(is_jump, dest, new_pc)
    new_pc = torch.where(is_jumpi & jumpi_taken, dest, new_pc)
    bad_jump = (is_jump | (is_jumpi & jumpi_taken)) & ~dest_ok

    # ---- terminal ops
    is_return = op == op_["RETURN"]
    is_revert = op == op_["REVERT"]
    ret_off, ret_off_hi = _u32_of(a)
    ret_len_u, ret_len_hi = _u32_of(b)
    ret_big = (ret_off_hi | ret_len_hi | (ret_off >= 1 << 30)
               | (ret_len_u >= 1 << 30))
    ret_off_i = torch.where(ret_big, 0, ret_off)
    ret_len_i = torch.where(ret_big, 0, ret_len_u)
    ret_oob = ((is_return | is_revert) & ~bv256.is_zero(b)
               & (ret_big | (ret_off_i + ret_len_i > mem_bytes))
               & ~underflow)
    do_ret = running & (is_return | is_revert) & ~ret_oob
    ret_offset = torch.where(do_ret, ret_off_i, st.ret_offset.long())
    ret_len = torch.where(do_ret, ret_len_i, st.ret_len.long())

    # ---- status: later marks win
    gas = tb["gas"][op]
    gas_used = bv256.u32(st.gas_used)
    oog = ((gas_used + gas) & bv256.M32) > bv256.u32(st.gas_limit)
    status = st.status
    for cond, code_ in (
            (parked | ret_oob, Status.NEEDS_HOST),
            (underflow | bad_jump | (op == op_["INVALID"]) | oog,
             Status.INVALID),
            (op == op_["STOP"], Status.STOPPED),
            (is_return & ~ret_oob, Status.RETURNED),
            (is_revert & ~ret_oob, Status.REVERTED),
            (op == op_["SELFDESTRUCT"], Status.SELFDESTRUCT)):
        status = torch.where(running & cond, code_, status)
    advanced = status == Status.RUNNING
    gas_used = torch.where(running & ~parked, gas_used + gas, gas_used)

    return LaneState(
        pc=torch.where(advanced, new_pc, pc).to(torch.int32),
        sp=torch.where(advanced, new_sp, sp).to(torch.int32),
        stack=stack, memory=memory, msize=msize, skeys=skeys, svals=svals,
        scount=scount, calldata=st.calldata, cd_size=st.cd_size,
        env=st.env, gas_used=bv256.i32(gas_used), gas_limit=st.gas_limit,
        status=status.to(torch.int32), ret_offset=ret_offset.to(torch.int32),
        ret_len=ret_len.to(torch.int32),
        steps=st.steps + running.to(torch.int32))


def run_plain(code: CompiledCode, st: LaneState, max_steps: int) -> LaneState:
    """Step until no lane is RUNNING or ``max_steps`` batch steps (the
    JAX ``run``); returns a new state."""
    for _ in range(max_steps):
        if not bool(torch.any(st.status == Status.RUNNING)):
            break
        st = step_plain(code, st)
    return st


# ---------------------------------------------------------------------------
# kernel K10 (csrc/stepper.cu)
# ---------------------------------------------------------------------------

_LANE_SIGS = {
    "lane_run": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p],
}

#: K10's launch (``csrc/stepper.cu``, one thread a lane): lanes a
#: block at most and at least
K10_MAX_LPB, K10_MIN_LPB = 64, 32
#: the shared bytes of a block past which a lane's stack, memory and
#: storage log stay in place (global memory) instead of on chip: up to
#: it, at least 3 blocks share an SM (the bench batch's 57 KB: 4)
K10_LOCAL_BUDGET = 64 * 1024
#: the code's rows (8 bytes each) go to shared memory up to this size;
#: past it they are read through the read-only path
K10_CODE_BUDGET = 16 * 1024
#: the op table and each op's gas (where the code's rows are not in
#: shared memory, whose rows carry both); a lane's word of scratch
K10_HEAD = 2 * 256 * 4
K10_SCRATCH = 32
#: the order of the plan array the kernel reads (``P_*`` there)
K10_PLAN_KEYS = ("lanes_per_block", "local", "code_shared", "stack_words",
                 "store_words", "mem_bytes", "head_bytes", "smem", "vec")
#: the default dynamic shared memory of a block (an H100's opt-in limit)
#: and SM count, for a plan made without a card
H100_SMEM_OPTIN, H100_SMS = 232448, 132


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def lane_run_plan(n: int, depth: int, mem_bytes: int, slots: int,
                  code_size: int, smem_limit: int = H100_SMEM_OPTIN,
                  sms: int = H100_SMS) -> dict:
    """K10's launch shape for ``n`` lanes of these plane sizes, as a
    plain dict (``K10_PLAN_KEYS``; ``vec`` is the wrapper's). Lanes (a
    thread each) a block: ``K10_MAX_LPB``, halved down to
    ``K10_MIN_LPB`` while the batch would give fewer than two blocks an
    SM. A lane's stack, memory and storage log sit in shared memory for
    the whole run (``local``) where the block's rows fit
    ``K10_LOCAL_BUDGET``, otherwise the lane reads them in place; the
    code's rows go to shared memory where they fit ``K10_CODE_BUDGET``
    (else the op table does). A stack row is 4 words past a multiple of
    8 (8 lanes' 16-byte reads of one slot hit 8 bank groups), a storage
    row one word past its slots (read 4 bytes at a time, an odd
    stride); each lane has a word of scratch for the division family.
    Raises ValueError where the block's shared memory passes
    ``smem_limit``."""
    if min(depth, mem_bytes, slots) < 1 or n < 0 or code_size < 0:
        raise ValueError(f"K10 plan: unsupported sizes n={n} D={depth} "
                         f"M={mem_bytes} S={slots} code={code_size}")
    code_rows = code_size + 1
    code_shared = code_rows * 8 <= K10_CODE_BUDGET
    head = _up16(code_rows * 8) if code_shared else K10_HEAD
    stack_w = 8 * depth + 4
    store_w = 8 * slots + 1
    mem_b = _up16(mem_bytes)
    lpb = K10_MAX_LPB
    while lpb > K10_MIN_LPB and -(-n // lpb) < 2 * sms:
        lpb //= 2
    on_chip = 4 * stack_w + 8 * store_w + mem_b
    local = head + lpb * (K10_SCRATCH + on_chip) <= K10_LOCAL_BUDGET
    smem = head + lpb * (K10_SCRATCH + (on_chip if local else 0))
    if smem > smem_limit:
        raise ValueError(f"K10 plan: {smem} shared bytes a block pass the "
                         f"limit of {smem_limit}")
    return dict(lanes_per_block=lpb, local=int(local),
                code_shared=int(code_shared), stack_words=stack_w,
                store_words=store_w, mem_bytes=mem_b, head_bytes=head,
                smem=smem, vec=0, blocks=-(-n // lpb))


#: per-opcode table K10 reads, (256, 6) int32: npop, npush, static gas,
#: supported, env slot, result class
LANE_OP_TABLE = np.stack([
    NPOP_TABLE, NPUSH_TABLE, GAS_TABLE.astype(np.int64), SUPPORTED_TABLE,
    ENV_TABLE, RESULT_CLASS_TABLE], axis=1).astype(np.int32)

_OPTAB = {}


def _k10():
    from .. import _build

    lib = _build.lib("stepper.cu", _LANE_SIGS)
    lib.mtt_lane_fields.restype = ctypes.c_char_p
    built = lib.mtt_lane_fields().decode().rstrip(",").split(",")
    if tuple(built) != LANE_FIELDS:
        raise RuntimeError("csrc/stepper.cu LANE_FIELDS differs from "
                           "LaneState")
    if lib.mtt_lane_plan_len() != len(K10_PLAN_KEYS):
        raise RuntimeError("csrc/stepper.cu reads another plan layout")
    return lib


#: K10's plan arrays by (device, dims, code size, 16-byte rows)
_PLANS = {}


def _plan_args(st: LaneState, dims: tuple, code_size: int):
    """The C plan array of ``lane_run_plan`` for this batch, with the
    planes that 16-byte copies may move (``vec``: 1 the stack, 4
    memory), made once for each shape."""
    from .. import _build

    vec = 1 * _aligned(st.stack) + 4 * _aligned(st.memory)
    key = (st.device, dims, code_size, vec)
    if key not in _PLANS:
        smem_limit, sms = _build.device_limits(st.device)
        plan = lane_run_plan(dims[0], dims[1], dims[2], dims[3], code_size,
                             smem_limit, sms)
        plan["vec"] = vec
        _PLANS[key] = _build.int_array([plan[k] for k in K10_PLAN_KEYS])
    return _PLANS[key]


def _aligned(*tensors) -> bool:
    """Every tensor starts on a 16-byte boundary and its lane rows are
    whole multiples of 16 bytes: K10 may move them 16 bytes a thread."""
    return all(t.data_ptr() % 16 == 0
               and (math.prod(t.shape[1:]) * t.element_size()) % 16 == 0
               for t in tensors)


def lane_args(st: LaneState):
    """(void** array, int dims array) of a CUDA batch for K10; the
    caller keeps ``st`` alive while it runs."""
    from .. import _build

    for name in LANE_FIELDS:
        _build.need_cuda(getattr(st, name), torch.uint8 if name in LANE_U8
                         else torch.int32, name)
    n, d, _ = st.stack.shape
    dims = [n, d, st.memory.shape[1], st.skeys.shape[1],
            st.calldata.shape[1], st.env.shape[1]]
    if min(dims[1:]) < 1 or st.env.shape[1] != N_ENV:
        raise ValueError(f"lane planes: unsupported sizes {dims}")
    return (_build.ptr_array([getattr(st, f) for f in LANE_FIELDS]),
            _build.int_array(dims))


def run_kernel(code: CompiledCode, st: LaneState, max_steps: int
               ) -> LaneState:
    """``run`` through kernel K10: one launch, every lane stepping on
    its own thread until it leaves RUNNING or ``max_steps`` steps,
    shaped by ``lane_run_plan``; the planes are updated in place."""
    from .. import _build

    planes, dims = lane_args(st)
    packed = code.packed
    _build.need_cuda(packed, torch.int32, "code.packed")
    if packed.dim() != 2 or packed.shape[1] != 14 \
            or packed.shape[0] <= code.size:
        raise ValueError(f"code.packed: shape {tuple(packed.shape)} for "
                         f"size {code.size}")
    lib = _k10()
    key = str(st.device)
    if key not in _OPTAB:
        _OPTAB[key] = torch.from_numpy(LANE_OP_TABLE).to(st.device)
    rc = lib.lane_run(planes, dims, _build.ptr(packed), code.size,
                      _build.ptr(_OPTAB[key]), int(max_steps),
                      _plan_args(st, tuple(dims), code.size),
                      _build.stream(st.device))
    _build.LAUNCHES["lane_run"] += 1
    _build.check(lib, rc, "lane_run")
    return st


def _assign(st: LaneState, new: LaneState) -> LaneState:
    """Copy every plane of ``new`` into ``st``; returns ``st``."""
    for f in LANE_FIELDS:
        getattr(st, f).copy_(getattr(new, f))
    return st


def run(code: CompiledCode, st: LaneState, max_steps: int) -> LaneState:
    """Execute until every lane halts or ``max_steps`` steps, updating
    ``st`` in place and returning it: the plain loop for a CPU state,
    kernel K10 for a CUDA state."""
    if st.pc.device.type == "cpu":
        return _assign(st, run_plain(code, st, max_steps))
    return run_kernel(code, st, max_steps)


def step(code: CompiledCode, st: LaneState) -> LaneState:
    """One step of every RUNNING lane, in place: ``step_plain`` for a
    CPU state, K10 with ``max_steps`` 1 for a CUDA state."""
    if st.pc.device.type == "cpu":
        return _assign(st, step_plain(code, st))
    return run_kernel(code, st, 1)


# ---------------------------------------------------------------------------
# host-side batch builders and extractors (in place; each returns the state)
# ---------------------------------------------------------------------------

def _limbs(value: int, device) -> torch.Tensor:
    return torch.from_numpy(bv256.int_to_limbs(value).view(np.int32)).to(
        device)


def set_lane_word(state: LaneState, field: str, lane: int, value: int):
    getattr(state, field)[lane] = _limbs(value, state.device)
    return state


def set_env_word(state: LaneState, slot_name: str, value: int, lane=None):
    slot = ENV_SLOTS[slot_name]
    w = _limbs(value, state.device)
    if lane is None:
        state.env[:, slot] = w[None, :]
    else:
        state.env[lane, slot] = w
    return state


def set_calldata(state: LaneState, lane: int, data: bytes):
    cap = state.calldata.shape[1]
    assert len(data) <= cap, f"calldata {len(data)} exceeds buffer {cap}"
    buf = np.zeros(cap, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    state.calldata[lane] = torch.from_numpy(buf).to(state.device)
    state.cd_size[lane] = len(data)
    return state


def preload_storage(state: LaneState, lane: int, slots: dict):
    """Seed a lane's storage log from {key_int: val_int}."""
    for i, (k, v) in enumerate(slots.items()):
        state.skeys[lane, i] = _limbs(k, state.device)
        state.svals[lane, i] = _limbs(v, state.device)
    state.scount[lane] = len(slots)
    return state


def extract_stack(state: LaneState, lane: int) -> list:
    sp = int(state.sp[lane])
    items = state.stack[lane, :sp].cpu().numpy()
    return [bv256.limbs_to_int(items[i]) for i in range(sp)]


def extract_storage(state: LaneState, lane: int) -> dict:
    cnt = int(state.scount[lane])
    keys = state.skeys[lane, :cnt].cpu().numpy()
    vals = state.svals[lane, :cnt].cpu().numpy()
    out = {}
    for i in range(cnt):  # later writes overwrite earlier (log order)
        out[bv256.limbs_to_int(keys[i])] = bv256.limbs_to_int(vals[i])
    return out


def extract_return_data(state: LaneState, lane: int) -> bytes:
    off = int(state.ret_offset[lane])
    ln = int(state.ret_len[lane])
    mem = state.memory[lane].cpu().numpy()
    ln = max(0, min(ln, mem.shape[0] - off)) if off < mem.shape[0] else 0
    return bytes(mem[off:off + ln])
