"""Symbolic lane stepper: batched symbolic EVM execution, in PyTorch and
as one CUDA kernel family.

The counterpart of ``mythril_tpu/ops/symstep.py``; its docstring holds
the model (sid planes, deferred records, forks on symbolic JUMPI,
memory kinds and overlay, storage log and symbolic-storage mode, parks).
This module keeps the same ``SymLaneState`` planes, shapes and dtypes
(uint32 planes hold their bit patterns in int32 tensors) and gives:

- ``sym_step``: one step in plain PyTorch, a line-by-line mirror of the
  JAX ``sym_step`` and its fork phase ``_do_forks``;
- ``sym_run``: up to ``max_steps`` steps (stopping once no lane is
  RUNNING), with the optional ``visited`` coverage bitmap. On a CPU
  state it loops ``sym_step``; on a CUDA state it runs kernel K1,
  ``csrc/symstep.cu``, and never the plain version;
- ``sym_run_mesh``: the same run over a batch placed on a mesh
  (``parallel/mesh.SymShards``), each shard's step on its own device
  (K1's phases, a launch a device over its shards, on a card;
  ``sym_step`` with a ``ShardStep`` a CPU shard) under one exchange of
  fork counts, fork-log rows and child rows.

The JAX stepper gates each expensive family behind a ``lax.cond`` over
"any lane needs it"; per lane the result is the same whether or not a
gate ran, which is what lets K1 compute each lane on its own.
"""

import contextlib
import ctypes
import operator
import threading
import weakref
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..support.eth_constants import ARB_PROBE_SLOT
from ..support.opcodes import ADDRESS, GAS, OPCODES
from . import bv256
from .bv256 import M32, i32, u32
from .stepper import (
    ENV_SLOTS, ENV_TABLE, N_ENV, NPOP_TABLE, NPUSH_TABLE,
    RESULT_CLASS_ID, RESULT_CLASS_TABLE, RESULT_CLASSES, CompiledCode,
    Status, _onehot_gather, _peek, _scatter_word, _u32_of,
    bytes_be_to_word, word_to_bytes_be,
)

_OP = {name: data[ADDRESS] for name, data in OPCODES.items()}

DEAD = 7  # free slot (never executed / retired)

GAS_MEMORY = 3
GAS_MEMORY_QUAD_DENOM = 512

KIND_NONE = 0
KIND_BYTE_INT = 1    # MSTORE8 with a concrete value
KIND_CONC_WORD = 2   # MSTORE with a concrete value
KIND_SYM_WORD = 3    # MSTORE with a symbolic value (overlay log has sid)

#: pseudo-op of a deferred read-over-write SLOAD record (symbolic
#: storage mode); such records never dedup across lanes
REC_SLOAD_RW = 0x154

#: per-step fork budget, clamped to the lane count
MAX_FORKS_PER_STEP = 2048


def _build_sym_tables():
    gas_min = np.zeros(256, dtype=np.uint32)
    gas_max = np.zeros(256, dtype=np.uint32)
    for data in OPCODES.values():
        gas_min[data[ADDRESS]] = data[GAS][0]
        gas_max[data[ADDRESS]] = data[GAS][1]
    executable = np.zeros(256, dtype=bool)
    deferrable = np.zeros(256, dtype=bool)
    for name in (
        "ADD MUL SUB DIV SDIV MOD SMOD ADDMOD MULMOD EXP SIGNEXTEND "
        "LT GT SLT SGT EQ ISZERO AND OR XOR NOT BYTE SHL SHR SAR "
        "BALANCE"
    ).split():
        deferrable[_OP[name]] = True
        executable[_OP[name]] = True
    for name in (
        "POP MLOAD MSTORE MSTORE8 SLOAD SSTORE SHA3 JUMP JUMPI "
        "JUMPDEST PC MSIZE GAS CALLDATALOAD CALLDATASIZE CODESIZE"
    ).split():
        executable[_OP[name]] = True
    for name in ENV_SLOTS:
        executable[_OP[name]] = True
    executable[0x60:0xA0] = True  # PUSH1-32, DUP1-16, SWAP1-16
    return gas_min, gas_max, executable, deferrable


(GAS_MIN_TABLE, GAS_MAX_TABLE, SYM_EXECUTABLE, DEFERRABLE) = \
    _build_sym_tables()


def _build_mstore_pattern_masks():
    """(mask, expect) pairs of the user-assertions 0xcafe... pattern
    for values of 60..64 hex digits."""
    pat = int("cafe" * 15, 16)
    masks, expects = [], []
    for s in range(0, 20, 4):
        masks.append(bv256.int_to_limbs(((1 << 256) - 1) ^ ((1 << s) - 1)))
        expects.append(bv256.int_to_limbs((pat << s) & ((1 << 256) - 1)))
    return np.stack(masks), np.stack(expects)


MSTORE_PAT_MASK, MSTORE_PAT_EXPECT = _build_mstore_pattern_masks()
_ARB_PROBE_LIMBS = bv256.int_to_limbs(ARB_PROBE_SLOT)


@dataclass
class SymLaneState:
    """Struct-of-arrays symbolic lane batch: N lanes, D stack, M memory
    bytes, MR overlay records, S storage slots, C calldata bytes, R
    deferred records, F = N fork-log rows. Field order, shapes and
    meaning are those of the JAX ``SymLaneState``; ``(u32)`` planes hold
    uint32 bit patterns in int32 tensors."""

    pc: torch.Tensor            # (N,) i32
    sp: torch.Tensor            # (N,) i32
    depth: torch.Tensor         # (N,) i32
    group: torch.Tensor         # (N,) i32
    fentry: torch.Tensor        # (N,) i32
    last_jump: torch.Tensor     # (N,) i32
    stack: torch.Tensor         # (N, D, 8) u32
    ssid: torch.Tensor          # (N, D) i32
    memory: torch.Tensor        # (N, M) u8
    mkind: torch.Tensor         # (N, M) u8
    msize: torch.Tensor         # (N,) i32
    mlog_off: torch.Tensor      # (N, MR) i32
    mlog_len: torch.Tensor      # (N, MR) i32
    mlog_sid: torch.Tensor      # (N, MR) i32
    mlog_count: torch.Tensor    # (N,) i32
    skeys: torch.Tensor         # (N, S, 8) u32
    svals: torch.Tensor         # (N, S, 8) u32
    sval_sid: torch.Tensor      # (N, S) i32
    s_written: torch.Tensor     # (N, S) i32
    s_read: torch.Tensor        # (N, S) i32
    skey_sid: torch.Tensor      # (N, S) i32
    s_wstep: torch.Tensor       # (N, S) i32
    s_mode: torch.Tensor        # (N,) i32
    scount: torch.Tensor        # (N,) i32
    sbase: torch.Tensor         # (N,) i32
    calldata: torch.Tensor      # (N, C) u8
    cd_size: torch.Tensor       # (N,) i32
    cd_sym: torch.Tensor        # (N,) i32
    cd_size_sid: torch.Tensor   # (N,) i32
    env: torch.Tensor           # (N, N_ENV, 8) u32
    env_sid: torch.Tensor       # (N, N_ENV) i32
    min_gas: torch.Tensor       # (N,) u32
    max_gas: torch.Tensor       # (N,) u32
    gas_limit: torch.Tensor     # (N,) u32
    status: torch.Tensor        # (N,) i32
    steps: torch.Tensor         # (N,) i32
    dlog_op: torch.Tensor       # (N, R) i32
    dlog_pc: torch.Tensor       # (N, R) i32
    dlog_step: torch.Tensor     # (N, R) i32
    dlog_fentry: torch.Tensor   # (N, R) i32
    dlog_sid: torch.Tensor      # (N, R, 3) i32
    dlog_val: torch.Tensor      # (N, R, 3, 8) u32
    dlog_count: torch.Tensor    # (N,) i32
    flog_parent: torch.Tensor   # (F,) i32
    flog_child: torch.Tensor    # (F,) i32
    flog_step: torch.Tensor     # (F,) i32
    flog_pc: torch.Tensor       # (F,) i32
    flog_sid: torch.Tensor      # (F,) i32
    flog_gmin: torch.Tensor     # (F,) u32
    flog_gmax: torch.Tensor     # (F,) u32
    flog_fentry: torch.Tensor   # (F,) i32
    flog_dest: torch.Tensor     # (F,) i32
    flog_count: torch.Tensor    # () i32
    free_slots: torch.Tensor    # (N,) i32
    free_count: torch.Tensor    # () i32
    step_no: torch.Tensor       # () i32

    def replace(self, **kw) -> "SymLaneState":
        return replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.pc.device


FIELDS = tuple(f.name for f in fields(SymLaneState))
#: planes the JAX package holds as uint32 / uint8
U32_FIELDS = frozenset((
    "stack", "skeys", "svals", "env", "min_gas", "max_gas", "gas_limit",
    "dlog_val", "flog_gmin", "flog_gmax"))
U8_FIELDS = frozenset(("memory", "mkind", "calldata"))
#: fields whose leading axis is not the lane axis (fork and free-slot
#: bookkeeping): the fork phase never row-copies them
NO_COPY = frozenset((
    "flog_parent", "flog_child", "flog_step", "flog_pc", "flog_sid",
    "flog_gmin", "flog_gmax", "flog_fentry", "flog_dest", "flog_count",
    "free_slots", "free_count", "step_no"))


def _plane_shapes(n, stack_depth, memory_bytes, mem_records,
                  storage_slots, calldata_bytes, dlog_records):
    """{field: shape} of a batch of n lanes (dtypes: ``U8_FIELDS`` are
    uint8, every other plane int32)."""
    d, m, mr, s, c, r = (stack_depth, memory_bytes, mem_records,
                         storage_slots, calldata_bytes, dlog_records)
    shapes = dict.fromkeys(FIELDS, (n,))
    shapes.update(
        stack=(n, d, 8), ssid=(n, d), memory=(n, m), mkind=(n, m),
        mlog_off=(n, mr), mlog_len=(n, mr), mlog_sid=(n, mr),
        skeys=(n, s, 8), svals=(n, s, 8), calldata=(n, c),
        env=(n, N_ENV, 8), env_sid=(n, N_ENV),
        dlog_sid=(n, r, 3), dlog_val=(n, r, 3, 8),
        flog_count=(), free_count=(), step_no=())
    for f in ("sval_sid", "s_written", "s_read", "skey_sid", "s_wstep"):
        shapes[f] = (n, s)
    for f in ("dlog_op", "dlog_pc", "dlog_step", "dlog_fentry"):
        shapes[f] = (n, r)
    return shapes


def _init_values(n, gas_limit):
    """{field: value} of the planes a fresh batch does not zero;
    ``free_slots`` is the stack n-1, ..., 0 (slot 0 on top)."""
    return {"fentry": -1, "last_jump": -1,
            "gas_limit": int(i32(torch.tensor(gas_limit))),
            "status": DEAD, "free_count": n}


def init_sym_lanes(n_lanes: int, stack_depth: int = 64,
                   memory_bytes: int = 4096, mem_records: int = 64,
                   storage_slots: int = 64, calldata_bytes: int = 512,
                   dlog_records: int = 64, pc_records: int = 64,
                   gas_limit: int = 8_000_000,
                   device=None, plain: bool = False) -> SymLaneState:
    """A zeroed batch with every lane DEAD and every slot on the free
    stack, on ``device`` (``cuda`` unless the caller names another).
    On the card the planes are written by kernel K0 (``init_kernel``),
    on the CPU (or with ``plain``) by PyTorch fills. ``pc_records`` is
    accepted for the JAX signature and unused, as there."""
    from ..support.devices import resolve

    dev = resolve(device)
    shapes = _plane_shapes(n_lanes, stack_depth, memory_bytes, mem_records,
                           storage_slots, calldata_bytes, dlog_records)
    values = _init_values(n_lanes, gas_limit)

    def plane(f, fill):
        dtype = torch.uint8 if f in U8_FIELDS else torch.int32
        if not fill:
            return torch.empty(shapes[f], dtype=dtype, device=dev)
        if f == "free_slots":
            return torch.arange(n_lanes - 1, -1, -1, dtype=dtype,
                                device=dev)
        return torch.full(shapes[f], values.get(f, 0), dtype=dtype,
                          device=dev)

    fill = plain or dev.type == "cpu"
    st = SymLaneState(**{f: plane(f, fill) for f in FIELDS})
    if not fill:
        init_kernel(st, gas_limit)
    return st


def init_kernel(st: SymLaneState, gas_limit: int = 8_000_000) -> None:
    """Kernel K0 (``csrc/symstep.cu`` ``sym_init``): write every plane
    of a CUDA batch in place as ``init_sym_lanes`` makes it, whatever
    the planes held."""
    from .. import _build

    lib = _k1()
    planes, _ = state_args(st)
    values = _init_values(st.pc.shape[0], gas_limit)
    nbytes = (ctypes.c_longlong * len(FIELDS))(*(
        getattr(st, f).numel() * getattr(st, f).element_size()
        for f in FIELDS))
    vals = _build.int_array([values.get(f, 0) for f in FIELDS])
    desc = _build.int_array([f == "free_slots" for f in FIELDS])
    rc = lib.sym_init(planes, nbytes, vals, desc,
                      _build.stream(st.device))
    _build.LAUNCHES["sym_init"] += 1
    _build.check(lib, rc, "sym_init")


def lane_bytes(**lane_kwargs) -> int:
    """Bytes of lane planes per lane at the given ``init_sym_lanes``
    sizes (the fork log adds 40 bytes per lane)."""
    st = init_sym_lanes(1, device="cpu", **lane_kwargs)
    return sum(getattr(st, f).numel() * getattr(st, f).element_size()
               for f in FIELDS if getattr(st, f).dim() > 0)


# ---------------------------------------------------------------------------
# the plain step
# ---------------------------------------------------------------------------

_TABLES = {}


def _tables(dev):
    key = str(dev)
    if key not in _TABLES:
        def t(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x).astype(np.int64),
                                   device=dev).to(dtype)
        _TABLES[key] = dict(
            npop=t(NPOP_TABLE), npush=t(NPUSH_TABLE),
            gas_min=t(GAS_MIN_TABLE), gas_max=t(GAS_MAX_TABLE),
            deferrable=t(DEFERRABLE, torch.bool),
            result_class=t(RESULT_CLASS_TABLE), env=t(ENV_TABLE),
            pat_mask=t(MSTORE_PAT_MASK), pat_expect=t(MSTORE_PAT_EXPECT),
            probe=t(_ARB_PROBE_LIMBS),
        )
    return _TABLES[key]


def _gather_flat(arr, idx):
    """arr[lane, idx[lane]] for an (N, S) plane (idx in range)."""
    return arr[torch.arange(arr.shape[0], device=arr.device), idx.long()]


def _scatter_flat(arr, lane_mask, idx, value):
    """arr[lane, idx[lane]] = value[lane] where lane_mask, on a copy."""
    out = arr.clone()
    lanes = torch.arange(arr.shape[0], device=arr.device)[lane_mask]
    if isinstance(value, torch.Tensor) and value.dim() > 0:
        value = value[lane_mask]
    out[lanes, idx.long()[lane_mask]] = torch.as_tensor(
        value, device=arr.device).to(arr.dtype)
    return out


def _peek_sid(ssid, sp, k):
    return _gather_flat(ssid, (sp - k).clamp(0, ssid.shape[1] - 1))


def _overlay_exact_hit(st, woff, mem_recs):
    """(exact, sid) for the LAST overlay record overlapping the 32-byte
    window at woff (see the JAX function of the same name)."""
    rec_ids = torch.arange(mem_recs, device=woff.device)[None, :]
    live_rec = rec_ids < st.mlog_count[:, None]
    off = st.mlog_off.long()
    ov = (live_rec & (off < (woff + 32)[:, None])
          & ((off + st.mlog_len.long()) > woff[:, None]))
    last = torch.where(ov, rec_ids + 1, 0).amax(dim=1) - 1
    lc = last.clamp(0, mem_recs - 1)
    exact = ((last >= 0) & (_gather_flat(st.mlog_off, lc) == woff)
             & (_gather_flat(st.mlog_len, lc) == 32))
    sid = torch.where(exact, _gather_flat(st.mlog_sid, lc), 0)
    return exact, sid


def _mem_fee(old_bytes, new_bytes):
    ow = old_bytes // 32
    nw = new_bytes // 32
    old_fee = (ow * GAS_MEMORY + ((ow * ow) & M32) // GAS_MEMORY_QUAD_DENOM)
    new_fee = (nw * GAS_MEMORY + ((nw * nw) & M32) // GAS_MEMORY_QUAD_DENOM)
    return (new_fee - old_fee) & M32


def _nbits(x):
    """(..., 8) u32-form limbs -> number of significant bits."""
    _, e = torch.frexp(x.to(torch.float64))
    pos = e.to(torch.int64) + 32 * torch.arange(8, device=x.device)
    return torch.where(x != 0, pos, 0).amax(dim=-1)


def _popcount32(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _take(plane, idx):
    return torch.gather(plane, 1, idx.long())


class ShardStep:
    """What one shard's step needs of the batch it belongs to
    (``sym_run_mesh``): the global index of its first lane (``base``),
    and for the execution phase the step's global fork rank of its
    first request (``off``), the step's fork budget (``navail``), the
    batch's free-slot count, fork-log count and step number before the
    step. With ``decide`` set the step stops after each lane's fork
    request and returns the requests."""

    __slots__ = ("base", "off", "navail", "free_count", "flog_count",
                 "step_no", "decide")

    def __init__(self, base, off=0, navail=0, free_count=0, flog_count=0,
                 step_no=0, decide=False):
        self.base, self.off, self.navail = base, off, navail
        self.free_count, self.flog_count = free_count, flog_count
        self.step_no, self.decide = step_no, decide


#: the columns of a shard's fork stash (``sym_step`` with a
#: ``ShardStep``), a row a fork in the shard's fork order
STASH = ("parent", "fall_pc", "fentry", "pc", "sid", "gmin", "gmax",
         "dest")


def sym_step(code: CompiledCode, st: SymLaneState, exec_table=None,
             taint_table=None, shard: "ShardStep" = None):
    """Advance every running lane by one instruction, in plain PyTorch
    (the JAX ``sym_step``, op for op). ``exec_table``/``taint_table`` are
    optional (256,) bool tables with the meaning they have there.

    With ``shard`` the batch is one shard of a larger one
    (``sym_run_mesh``): provisional sids and fork parents carry global
    lane indices, the fork order and budget are the step's global ones,
    and instead of forking the step returns (state, stash): a (forks,
    8) int32 tensor of ``STASH`` columns for the shard's forking
    parents in fork order (their child rows are copied by the caller)."""
    dev = st.pc.device
    tab = _tables(dev)
    exec_t = torch.as_tensor(
        SYM_EXECUTABLE if exec_table is None else exec_table,
        device=dev).to(torch.bool)
    taint_t = torch.as_tensor(
        np.zeros(256, bool) if taint_table is None else taint_table,
        device=dev).to(torch.bool)
    I64 = torch.int64
    n, depth_cap, _ = st.stack.shape
    mem_bytes = st.memory.shape[1]
    mem_recs = st.mlog_off.shape[1]
    s_slots = st.skeys.shape[1]
    d_recs = st.dlog_op.shape[1]
    lanes = torch.arange(n, device=dev)
    glanes = lanes if shard is None else lanes + shard.base
    step_no = int(st.step_no) if shard is None else shard.step_no

    running = st.status == Status.RUNNING
    pc = st.pc.to(I64)
    sp = st.sp.to(I64)
    pc_c = pc.clamp(0, code.size)
    if code.seg_tab is not None:
        # packed arena (stepper.compile_packed_code): lane pcs are arena
        # coordinates; jump bounds, CODESIZE and PC resolve against the
        # lane's own member through its [base, size] row
        seg = code.seg_of[pc_c.clamp(0, code.seg_of.shape[0] - 1)].long()
        srow = code.seg_tab[seg.clamp(0, code.seg_tab.shape[0] - 1)].long()
        seg_base, seg_size = srow[:, 0], srow[:, 1]
    else:
        seg_base, seg_size = None, None
    op = code.opcode[pc_c].to(I64)
    op = torch.where(running, op, _OP["JUMPDEST"])

    npop = tab["npop"][op]
    npush = tab["npush"][op]
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    dup_n = torch.where(is_dup, op - 0x7F, 1)
    swap_n = torch.where(is_swap, op - 0x8F, 1)
    eff_pop = torch.where(is_dup, dup_n,
                          torch.where(is_swap, swap_n + 1, npop))
    underflow = sp < eff_pop
    overflow = (sp - npop + npush) > depth_cap

    stack_u = u32(st.stack)
    a = _peek(stack_u, sp, 1)
    b = _peek(stack_u, sp, 2)
    c = _peek(stack_u, sp, 3)
    sid_a = _peek_sid(st.ssid, sp, 1)
    sid_b = _peek_sid(st.ssid, sp, 2)
    sid_c = _peek_sid(st.ssid, sp, 3)
    sym_a, sym_b, sym_c = sid_a != 0, sid_b != 0, sid_c != 0
    any_sym = (((npop >= 1) & sym_a) | ((npop >= 2) & sym_b)
               | ((npop >= 3) & sym_c))

    zero_w = torch.zeros_like(a)
    zero_b = torch.zeros_like(running)
    zero_i = torch.zeros(n, dtype=torch.int32, device=dev)

    is_mload = op == _OP["MLOAD"]
    is_mstore = op == _OP["MSTORE"]
    is_mstore8 = op == _OP["MSTORE8"]
    is_sload = op == _OP["SLOAD"]
    is_sstore = op == _OP["SSTORE"]
    is_cdl = op == _OP["CALLDATALOAD"]
    is_jump = op == _OP["JUMP"]
    is_jumpi = op == _OP["JUMPI"]
    is_exp = op == _OP["EXP"]
    is_sha3 = op == _OP["SHA3"]
    is_balance = op == _OP["BALANCE"]

    # ---- memory offsets / fees ------------------------------------------
    sha3_len_u32, sha3_len_hi = _u32_of(b)
    sha3_lenok = (is_sha3 & ~sym_b & ~sha3_len_hi
                  & ((sha3_len_u32 == 32) | (sha3_len_u32 == 64)))
    sha3_len = torch.where(sha3_lenok, sha3_len_u32, 32)
    mem_off_u32, mem_off_hi = _u32_of(a)
    mem_big = mem_off_hi | (mem_off_u32 >= (1 << 30))
    mem_off = torch.where(mem_big, 0, mem_off_u32)
    mem_ops = is_mload | is_mstore | is_mstore8 | sha3_lenok
    acc_len = torch.where(is_mstore8, 1, torch.where(is_sha3, sha3_len, 32))
    mem_end = mem_off + acc_len
    mem_oob = mem_ops & ~sym_a & (mem_big | (mem_end > mem_bytes))
    msize = st.msize.to(I64)
    new_msize = torch.where(mem_ops & ~sym_a & ~mem_oob,
                            torch.maximum(msize, ((mem_end + 31) // 32) * 32),
                            msize)
    mem_fee = _mem_fee(msize & M32, new_msize & M32)

    # ---- jump destination -------------------------------------------------
    # `dest` stays member-local (what the program pushed: fork logs and
    # fentry record it); `dest_eff` is the arena pc control flow takes
    dest_u32, dest_hi = _u32_of(a)
    if seg_base is None:
        dest_small = ~dest_hi & (dest_u32 < code.size)
        dest = torch.where(dest_small, dest_u32, 0)
        dest_eff = dest
    else:
        dest_small = ~dest_hi & (dest_u32 < seg_size)
        dest = torch.where(dest_small, dest_u32, 0)
        dest_eff = torch.where(dest_small, dest + seg_base, 0)
    dest_ok = dest_small & code.is_jumpdest[dest_eff.clamp(0, code.size)]
    jumpi_taken_conc = ~sym_b & ~bv256.is_zero(b)

    a_popcount = _popcount32(a).sum(dim=-1)
    exp_pure = ~sym_a & (a_popcount <= 1)

    # ---- drain-side taint support -----------------------------------------
    is_add = op == _OP["ADD"]
    is_sub = op == _OP["SUB"]
    is_mul = op == _OP["MUL"]
    taint_op = taint_t[op]
    wrap_cand = (running & ~any_sym & taint_op
                 & (is_add | is_sub | is_mul | (is_exp & exp_pure)))
    if bool(wrap_cand.any()):
        w_add = is_add & bv256.ult(bv256.add(a, b), a)
        w_sub = is_sub & bv256.ult(a, b)
        nb_a, nb_b = _nbits(a), _nbits(b)
        w_mul_cand = is_mul & (nb_a + nb_b >= 257)
        w_mul = w_mul_cand & ~bv256.is_zero(bv256.mul_full(a, b)[1]) \
            if bool((wrap_cand & w_mul_cand).any()) else zero_b
        m_exp = nb_a - 1
        e_hi = (b[..., 1:] != 0).any(dim=-1)
        e0 = torch.minimum(b[..., 0], torch.tensor(1 << 20, device=dev))
        w_exp = (is_exp & exp_pure & (a_popcount == 1) & (m_exp >= 1)
                 & (e_hi | (m_exp * e0 >= 256)))
        wrap_rec = wrap_cand & (w_add | w_sub | w_mul | w_exp)
    else:
        wrap_rec = zero_b

    key_is_probe = (a == tab["probe"]).all(dim=-1)
    sink_want = is_sstore & taint_op & ((sid_b != 0) | key_is_probe)

    mstore_pat_cand = running & is_mstore & ~sym_b & taint_op
    if bool(mstore_pat_cand.any()):
        nd = (_nbits(b) + 3) // 4
        idx = (nd - 60).clamp(0, 4)
        hit = ((b & tab["pat_mask"][idx]) == tab["pat_expect"][idx]).all(-1)
        mstore_pat_park = mstore_pat_cand & (nd >= 60) & hit
    else:
        mstore_pat_park = zero_b

    # ---- memory overlay decisions (MLOAD) ---------------------------------
    ar32 = torch.arange(32, device=dev)
    byte_idx32 = mem_off[:, None] + ar32[None, :]
    byte_idx32_c = byte_idx32.clamp(0, mem_bytes - 1)
    sym_store_val = is_mstore & sym_b
    if bool((running & mem_ops).any()):
        kinds32 = _take(st.mkind, byte_idx32_c)
        any_sym_byte = (kinds32 == KIND_SYM_WORD).any(dim=1)
        all_sym_byte = (kinds32 == KIND_SYM_WORD).all(dim=1)
        hit, hit_sid = _overlay_exact_hit(st, mem_off, mem_recs)
        exact = all_sym_byte & hit
        mload_sym_sid = torch.where(exact, hit_sid, 0)
        mload_park = is_mload & ~sym_a & ~mem_oob & ~(exact | ~any_sym_byte)
    else:
        mload_sym_sid, mload_park = zero_i, zero_b
    mlog_full = sym_store_val & (st.mlog_count >= mem_recs)

    # ---- SHA3 word reads ---------------------------------------------------
    def word_read(woff):
        bidx = woff[:, None] + ar32[None, :]
        bidx_c = bidx.clamp(0, mem_bytes - 1)
        kinds = _take(st.mkind, bidx_c)
        any_symb = (kinds == KIND_SYM_WORD).any(dim=1)
        all_symb = (kinds == KIND_SYM_WORD).all(dim=1)
        hit, hit_sid = _overlay_exact_hit(st, woff, mem_recs)
        exact = all_symb & hit
        sid = torch.where(exact, hit_sid, 0)
        raw = _take(st.memory, bidx_c)
        val = bytes_be_to_word(torch.where(bidx < mem_bytes, raw, 0))
        val = torch.where(exact[:, None], 0, val)
        k2 = torch.where(exact[:, None], KIND_SYM_WORD, kinds.to(I64))
        shifts = (2 * torch.arange(16, device=dev))[None, :]
        klo = (k2[:, :16] << shifts).sum(dim=1)
        khi = (k2[:, 16:] << shifts).sum(dim=1)
        return exact | ~any_symb, sid, val, klo, khi

    sha3_cand = running & sha3_lenok & ~sym_a & ~mem_oob & ~mem_big
    zero_u = torch.zeros(n, dtype=I64, device=dev)
    if bool(sha3_cand.any()):
        s3_ok0, s3_sid0, s3_val0, s3_k0lo, s3_k0hi = word_read(mem_off)
        s3_ok1, s3_sid1, s3_val1, s3_k1lo, s3_k1hi = word_read(mem_off + 32)
    else:
        s3_ok0, s3_sid0, s3_val0, s3_k0lo, s3_k0hi = (
            zero_b, zero_i, zero_w, zero_u, zero_u)
        s3_ok1, s3_sid1, s3_val1, s3_k1lo, s3_k1hi = (
            zero_b, zero_i, zero_w, zero_u, zero_u)
    sha3_two = sha3_len == 64
    sha3_defer = sha3_cand & s3_ok0 & (~sha3_two | s3_ok1)

    # ---- storage decisions ---------------------------------------------------
    skeys_u = u32(st.skeys)
    if bool((running & (is_sload | is_sstore)).any()):
        slot_ids = torch.arange(s_slots, device=dev)[None, :]
        live = slot_ids < st.scount[:, None]
        conc_eq = ((skeys_u == a[:, None, :]).all(dim=-1)
                   & (st.skey_sid == 0) & ~sym_a[:, None])
        sym_eq = (st.skey_sid == sid_a[:, None]) & sym_a[:, None]
        key_match = (conc_eq | sym_eq) & live
        best = torch.where(key_match, slot_ids + 1, 0).amax(dim=1)
        s_found = best > 0
        s_idx = (best - 1).clamp(0, s_slots - 1)
        sload_hit_val = _onehot_gather(u32(st.svals), s_idx)
        sload_hit_sid = _gather_flat(st.sval_sid, s_idx)
        s_any_written = (live & (st.s_written > 0)).any(dim=1)
    else:
        s_found, s_idx, sload_hit_val, sload_hit_sid, s_any_written = (
            zero_b, zero_i.to(I64), zero_w, zero_i, zero_b)
    sym_key_op = (is_sload | is_sstore) & sym_a
    mode_on_now = sym_key_op & (st.s_mode == 0) & ~s_any_written
    mode_park = sym_key_op & (st.s_mode == 0) & s_any_written
    mode_eff = (st.s_mode != 0) | mode_on_now
    sload_rw = is_sload & mode_eff
    sload_miss = is_sload & ~s_found
    sload_miss_sym = sload_miss & ~mode_eff & (st.sbase != 0)
    storage_insert = (is_sstore & ~s_found) | sload_miss
    storage_full = storage_insert & (st.scount >= s_slots)

    # ---- calldata -------------------------------------------------------------
    cd_bytes = st.calldata.shape[1]
    cd_symbolic = st.cd_sym != 0
    cdl_defer = is_cdl & cd_symbolic
    cd_off_u32, cd_off_hi = _u32_of(a)
    cd_big = cd_off_hi | (cd_off_u32 >= (1 << 30))
    cd_off = torch.where(cd_big, cd_bytes, cd_off_u32)
    cd_size = st.cd_size.to(I64)
    cd_oob = is_cdl & ~cd_symbolic & ~sym_a & (
        (cd_off < cd_size) & (cd_off + 32 > cd_bytes))

    # ---- deferral ---------------------------------------------------------------
    defer = tab["deferrable"][op] & any_sym
    defer = defer & ~(is_exp & ~exp_pure)
    defer = defer | cdl_defer | sload_miss_sym | wrap_rec | sha3_defer \
        | sload_rw
    sstore_rec_want = sink_want | (is_sstore & mode_eff)
    dlog_full = (defer | sstore_rec_want) & (st.dlog_count >= d_recs)

    # ---- gas -----------------------------------------------------------------------
    gmin = (tab["gas_min"][op] + mem_fee) & M32
    gmax = (tab["gas_max"][op] + mem_fee) & M32
    sha3_fee = (30 + 6 * (sha3_len // 32) + mem_fee) & M32
    gmin = torch.where(sha3_defer, sha3_fee, gmin)
    gmax = torch.where(sha3_defer, sha3_fee, gmax)
    min_gas_u = u32(st.min_gas)
    max_gas_u = u32(st.max_gas)
    oog = ((min_gas_u + gmin) & M32) > u32(st.gas_limit)

    park0 = (
        ~exec_t[op] | underflow | overflow | oog | dlog_full
        | (is_exp & ~exp_pure)
        | (mem_ops & sym_a) | (is_mstore8 & sym_b) | mem_oob | mload_park
        | mlog_full
        | (is_sha3 & ~sha3_defer)
        | (is_balance & ~sym_a)
        | mode_park | storage_full
        | (is_cdl & ~cd_symbolic & sym_a) | cd_oob
        | mstore_pat_park
        | (is_jump & (sym_a | ~dest_ok))
        | (is_jumpi & ~sym_b & jumpi_taken_conc & (sym_a | ~dest_ok))
        | (is_jumpi & sym_b & (sym_a | ~dest_ok))
        | code.loopsum_park[pc_c]
    )

    # ---- fork request / slot allocation ----------------------------------------
    fork_req = running & is_jumpi & sym_b & ~sym_a & dest_ok & ~park0
    if shard is not None and shard.decide:
        return fork_req
    forder = torch.cumsum(fork_req.to(I64), 0) - 1
    if shard is None:
        maxf = min(MAX_FORKS_PER_STEP, n)
        free_count = int(st.free_count)
        flog_count = int(st.flog_count)
        navail = min(free_count, maxf, st.flog_parent.shape[0] - flog_count)
    else:
        forder = forder + shard.off
        free_count, navail = shard.free_count, shard.navail
    fork_can = fork_req & (forder < navail)
    fork_stall = fork_req & ~fork_can & (forder < free_count)
    fork_nocap = fork_req & ~fork_can & ~fork_stall

    park = park0 | fork_nocap
    ok = running & ~park & ~fork_stall
    defer = defer & ok
    sink_rec = sstore_rec_want & ok
    logrec = defer | sink_rec
    fork_can = fork_can & ok

    # ---- concrete ALU families -----------------------------------------------------
    live_alu = ok & ~defer
    add_r = bv256.add(a, b)
    sub_r = bv256.sub(a, b)
    and_r, or_r, xor_r, not_r = a & b, a | b, a ^ b, M32 ^ a
    iszero_r = bv256.bool_to_word(bv256.is_zero(a))
    lt_r = bv256.bool_to_word(bv256.ult(a, b))
    gt_r = bv256.bool_to_word(bv256.ugt(a, b))
    slt_r = bv256.bool_to_word(bv256.slt(a, b))
    sgt_r = bv256.bool_to_word(bv256.sgt(a, b))
    eq_r = bv256.bool_to_word(bv256.eq(a, b))

    def gated(mask, fn, count):
        if bool((live_alu & mask).any()):
            return fn()
        return (zero_w,) * count if count > 1 else zero_w

    shift_ops = ((op == _OP["BYTE"]) | (op == _OP["SHL"]) | (op == _OP["SHR"])
                 | (op == _OP["SAR"]) | (op == _OP["SIGNEXTEND"]))
    byte_r, shl_r, shr_r, sar_r, sext_r = gated(shift_ops, lambda: (
        bv256.byte_op(a, b), bv256.shl(b, a), bv256.shr(b, a),
        bv256.sar(b, a), bv256.signextend(a, b)), 5)
    mul_r = gated(op == _OP["MUL"], lambda: bv256.mul(a, b), 1)
    div_ops = ((op == _OP["DIV"]) | (op == _OP["SDIV"]) | (op == _OP["MOD"])
               | (op == _OP["SMOD"]))

    def _div_all():
        q, r = bv256.divmod_u(a, b)
        sa, sb = bv256.sign_bit(a), bv256.sign_bit(b)
        sq, sr = bv256.divmod_u(torch.where(sa[..., None], bv256.neg(a), a),
                                torch.where(sb[..., None], bv256.neg(b), b))
        return (q, r, torch.where((sa ^ sb)[..., None], bv256.neg(sq), sq),
                torch.where(sa[..., None], bv256.neg(sr), sr))

    div_r, mod_r, sdiv_r, smod_r = gated(div_ops, _div_all, 4)
    mod2_ops = (op == _OP["ADDMOD"]) | (op == _OP["MULMOD"])
    addmod_r, mulmod_r = gated(mod2_ops, lambda: (
        bv256.addmod(a, b, c), bv256.mulmod(a, b, c)), 2)
    exp_r = gated(is_exp, lambda: bv256.exp(a, b), 1)

    # ---- memory execution ----------------------------------------------------------
    memory, mkind2 = st.memory, st.mkind
    mlog_off2, mlog_len2, mlog_sid2 = st.mlog_off, st.mlog_len, st.mlog_sid
    mlog_count2 = st.mlog_count
    mload_r = zero_w
    if bool((ok & mem_ops).any()):
        mload_r = bytes_be_to_word(_take(st.memory, byte_idx32_c))
        memory = st.memory.clone()
        mkind2 = st.mkind.clone()
        do_mstore = ok & is_mstore & ~sym_b
        if bool(do_mstore.any()):
            rows = lanes[do_mstore][:, None].expand(-1, 32)
            memory[rows, byte_idx32[do_mstore]] = word_to_bytes_be(b[do_mstore])
        do_store_any = ok & is_mstore
        if bool(do_store_any.any()):
            rows = lanes[do_store_any][:, None].expand(-1, 32)
            kv = torch.where(sym_store_val, KIND_SYM_WORD, KIND_CONC_WORD)
            mkind2[rows, byte_idx32[do_store_any]] = \
                kv[do_store_any][:, None].expand(-1, 32).to(torch.uint8)
        do_mstore8 = ok & is_mstore8
        if bool(do_mstore8.any()):
            memory[lanes[do_mstore8], mem_off[do_mstore8]] = \
                (b[do_mstore8, 0] & 0xFF).to(torch.uint8)
            mkind2[lanes[do_mstore8], mem_off[do_mstore8]] = KIND_BYTE_INT
        do_rec = ok & sym_store_val
        rec_pos = st.mlog_count.clamp(0, mem_recs - 1)
        mlog_off2 = _scatter_flat(st.mlog_off, do_rec, rec_pos, mem_off)
        mlog_len2 = _scatter_flat(st.mlog_len, do_rec, rec_pos, acc_len)
        mlog_sid2 = _scatter_flat(st.mlog_sid, do_rec, rec_pos, sid_b)
        mlog_count2 = torch.where(do_rec, st.mlog_count + 1, st.mlog_count)
    msize2 = torch.where(ok & mem_ops, new_msize, msize)
    msize_r = bv256.from_u32(msize2)

    # ---- storage execution ------------------------------------------------------------
    prov_id = -(glanes * d_recs
                + st.dlog_count.to(I64).clamp(0, d_recs - 1) + 1)
    skeys2, skey_sid2, s_wstep2 = st.skeys, st.skey_sid, st.s_wstep
    svals2, sval_sid2, s_written2 = st.svals, st.sval_sid, st.s_written
    s_read2, scount2, sload_r = st.s_read, st.scount, zero_w
    if bool((ok & (is_sload | is_sstore)).any()):
        sload_r = torch.where(s_found[:, None], sload_hit_val, 0)
        ins_pos = torch.where(s_found, s_idx, st.scount.to(I64))
        pos_c = ins_pos.clamp(0, s_slots - 1)
        do_sstore = ok & is_sstore
        do_cache = ok & sload_miss
        do_write = do_sstore | do_cache
        new_val = torch.where(do_sstore[:, None], b, zero_w)
        new_sid = torch.where(
            do_sstore, sid_b.to(I64),
            torch.where(sload_miss_sym | (sload_rw & sload_miss), prov_id, 0))
        new_written = torch.where(do_sstore, 1, 0)
        skeys2 = _scatter_word(st.skeys, do_write, pos_c, i32(a))
        skey_sid2 = _scatter_flat(st.skey_sid, do_write, pos_c, sid_a)
        s_wstep2 = _scatter_flat(st.s_wstep, do_sstore, pos_c,
                                 torch.full((n,), step_no, device=dev))
        svals2 = _scatter_word(st.svals, do_write, pos_c, i32(new_val))
        sval_sid2 = _scatter_flat(st.sval_sid, do_write, pos_c, new_sid)
        prior_written = _gather_flat(st.s_written, pos_c)
        s_written2 = _scatter_flat(
            st.s_written, do_write, pos_c,
            torch.maximum(new_written, prior_written.to(I64)))
        rd_bit = torch.where(prior_written > 0, 2, 1)
        s_read2 = _scatter_flat(st.s_read, ok & is_sload, pos_c,
                                rd_bit | _gather_flat(st.s_read, pos_c))
        scount2 = torch.where(do_write & ~s_found, st.scount + 1, st.scount)
    s_mode2 = torch.where(ok & mode_on_now, 1, st.s_mode).to(torch.int32)

    # ---- calldata execution --------------------------------------------------------------
    cdl_r = zero_w
    if bool((ok & is_cdl & ~cd_symbolic).any()):
        cd_idx = cd_off[:, None] + ar32[None, :]
        cd_valid = (cd_idx < cd_size[:, None]) & (cd_idx < cd_bytes)
        cd_read = _take(st.calldata, cd_idx.clamp(0, cd_bytes - 1))
        cdl_r = bytes_be_to_word(torch.where(cd_valid, cd_read, 0))

    # ---- env / misc results ---------------------------------------------------------------
    env_u = u32(st.env)
    env_idx = tab["env"][op].clamp(0, N_ENV - 1)
    env_r = _onehot_gather(env_u, env_idx)
    env_sid_r = _gather_flat(st.env_sid, env_idx)
    pc_r = bv256.from_u32(pc if seg_base is None else (pc - seg_base) & M32)
    gl_slot = ENV_SLOTS["GASLIMIT"]
    gas_r = env_u[:, gl_slot, :]
    cds_r = bv256.from_u32(cd_size)
    codesize_r = bv256.from_u32(
        torch.full((n,), code.size, device=dev) if seg_base is None
        else seg_size)
    push_r = u32(code.push_value[pc_c])
    dup_r = _peek(stack_u, sp, dup_n)
    dup_sid = _peek_sid(st.ssid, sp, dup_n)

    cases = (
        zero_w, add_r, mul_r, sub_r, div_r, sdiv_r, mod_r, smod_r,
        addmod_r, mulmod_r, exp_r, sext_r, lt_r, gt_r, slt_r, sgt_r,
        eq_r, iszero_r, and_r, or_r, xor_r, not_r, byte_r, shl_r,
        shr_r, sar_r, mload_r, sload_r, pc_r, msize_r, gas_r, cdl_r,
        cds_r, codesize_r, env_r, push_r, dup_r,
    )
    assert len(cases) == len(RESULT_CLASSES)
    rclass = tab["result_class"][op]
    result = torch.stack(cases, dim=1)[lanes, rclass]
    result = torch.where(defer[:, None], 0, result)

    result_sid = torch.where(defer, prov_id, 0)
    result_sid = torch.where(
        ~defer & (rclass == RESULT_CLASS_ID["ENV"]), env_sid_r, result_sid)
    result_sid = torch.where(~defer & (op == _OP["CALLDATASIZE"]),
                             st.cd_size_sid, result_sid)
    result_sid = torch.where(~defer & (op == _OP["GAS"]),
                             st.env_sid[:, gl_slot], result_sid)
    result_sid = torch.where(~defer & is_dup, dup_sid, result_sid)
    result_sid = torch.where(~defer & is_mload, mload_sym_sid, result_sid)
    result_sid = torch.where(~defer & is_sload & s_found, sload_hit_sid,
                             result_sid)

    # ---- stack updates -----------------------------------------------------------------------
    new_sp = sp - npop + npush
    do_push = ok & (npush == 1)
    push_idx = (new_sp - 1).clamp(0, depth_cap - 1)
    stack = _scatter_word(st.stack, do_push, push_idx, i32(result))
    ssid = _scatter_flat(st.ssid, do_push, push_idx, result_sid)
    do_swap = ok & is_swap
    top_idx = (sp - 1).clamp(0, depth_cap - 1)
    swap_idx = (sp - 1 - swap_n).clamp(0, depth_cap - 1)
    swap_val = _peek(st.stack, sp, swap_n + 1)
    swap_sid = _peek_sid(st.ssid, sp, swap_n + 1)
    stack = _scatter_word(stack, do_swap, top_idx, swap_val)
    stack = _scatter_word(stack, do_swap, swap_idx, i32(a))
    ssid = _scatter_flat(ssid, do_swap, top_idx, swap_sid)
    ssid = _scatter_flat(ssid, do_swap, swap_idx, sid_a)

    # ---- deferred-record append -------------------------------------------------------------
    dlog = (st.dlog_op, st.dlog_pc, st.dlog_step, st.dlog_fentry,
            st.dlog_sid, st.dlog_val, st.dlog_count)
    if bool(logrec.any()):
        rec_op = torch.where(sload_rw, REC_SLOAD_RW, op)
        rec_sid0 = torch.where(sha3_defer, s3_sid0, sid_a)
        rec_sid1 = torch.where(sha3_defer,
                               torch.where(sha3_two, s3_sid1, 0), sid_b)
        rec_sid2 = torch.where(sha3_defer, 0, sid_c)
        rec_val0 = torch.where(sha3_defer[:, None], s3_val0, a)
        rec_val1 = torch.where(
            sha3_defer[:, None],
            torch.where((sha3_two & (s3_sid1 == 0))[:, None], s3_val1, 0), b)
        sha3_meta = torch.stack(
            [sha3_len, s3_k0lo, s3_k0hi,
             torch.where(sha3_two, s3_k1lo, 0),
             torch.where(sha3_two, s3_k1hi, 0), zero_u, zero_u, zero_u],
            dim=-1)
        rec_val2 = torch.where(sha3_defer[:, None], sha3_meta, c)
        rl = lanes[logrec]
        pos = st.dlog_count.to(I64).clamp(0, d_recs - 1)[logrec]
        dop, dpc, dstep, dfen, dsid, dval = (x.clone() for x in dlog[:6])
        dop[rl, pos] = rec_op[logrec].to(torch.int32)
        dpc[rl, pos] = st.pc[logrec]
        dstep[rl, pos] = step_no
        dfen[rl, pos] = st.fentry[logrec]
        dsid[rl, pos] = torch.stack([rec_sid0, rec_sid1, rec_sid2],
                                    dim=-1)[logrec].to(torch.int32)
        dval[rl, pos] = i32(torch.stack([rec_val0, rec_val1, rec_val2],
                                        dim=1)[logrec])
        dcount = torch.where(logrec, st.dlog_count + 1, st.dlog_count)
        dlog = (dop, dpc, dstep, dfen, dsid, dval, dcount)

    # ---- control flow ---------------------------------------------------------------------------
    next_pc = code.next_pc[pc_c].to(I64)
    new_pc = torch.where(is_jump, dest_eff, next_pc)
    new_pc = torch.where(is_jumpi & ~sym_b & jumpi_taken_conc, dest_eff,
                         new_pc)
    new_pc = torch.where(fork_can, dest_eff, new_pc)
    new_depth = st.depth + (ok & is_jumpi).to(torch.int32)
    jumped = ok & (is_jump | (is_jumpi & ~sym_b & jumpi_taken_conc)
                   | fork_can)
    new_fentry = torch.where(
        jumped & code.is_func_entry[dest_eff.clamp(0, code.size)], dest,
        st.fentry.to(I64))

    out = st.replace(
        pc=torch.where(ok, new_pc, pc).to(torch.int32),
        sp=torch.where(ok, new_sp, sp).to(torch.int32),
        depth=new_depth,
        fentry=new_fentry.to(torch.int32),
        last_jump=torch.where(ok & is_jump, st.pc, st.last_jump),
        stack=stack, ssid=ssid, memory=memory, mkind=mkind2,
        msize=msize2.to(torch.int32), mlog_off=mlog_off2,
        mlog_len=mlog_len2, mlog_sid=mlog_sid2, mlog_count=mlog_count2,
        skeys=skeys2, skey_sid=skey_sid2, s_wstep=s_wstep2, s_mode=s_mode2,
        svals=svals2, sval_sid=sval_sid2, s_written=s_written2,
        s_read=s_read2, scount=scount2,
        min_gas=i32(torch.where(ok, min_gas_u + gmin, min_gas_u)),
        max_gas=i32(torch.where(ok, max_gas_u + gmax, max_gas_u)),
        status=torch.where(running & park, Status.NEEDS_HOST, st.status
                           ).to(torch.int32),
        steps=st.steps + ok.to(torch.int32),
        dlog_op=dlog[0], dlog_pc=dlog[1], dlog_step=dlog[2],
        dlog_fentry=dlog[3], dlog_sid=dlog[4], dlog_val=dlog[5],
        dlog_count=dlog[6],
        step_no=st.step_no + 1,
    )
    if shard is not None:
        cols = (glanes, next_pc, st.fentry, st.pc, sid_b, st.min_gas,
                st.max_gas, dest)
        stash = torch.stack([c[fork_can].to(torch.int32) for c in cols],
                            dim=1)
        return out, stash
    if not bool(fork_can.any()):
        return out
    return _do_forks(out, st, fork_can, forder, next_pc, dest, sid_b)


def _do_forks(s: SymLaneState, st: SymLaneState, fork_can, forder,
              next_pc, dest, sid_b) -> SymLaneState:
    """Fork phase: each forking parent (in lane order) takes a child
    slot from the top of the free stack; the child is a copy of the
    parent's post-step row that takes the fall-through instead. ``st``
    is the pre-step state."""
    dev = s.pc.device
    n = s.pc.shape[0]
    maxf = min(MAX_FORKS_PER_STEP, n)
    lanes = torch.arange(n, device=dev)
    fslot = torch.arange(maxf, device=dev)
    parent_rows = torch.full((maxf,), n, dtype=torch.int64, device=dev)
    parent_rows[forder[fork_can]] = lanes[fork_can]
    nf = int(fork_can.sum())
    valid = fslot < nf
    child_idx = (s.free_count.to(torch.int64) - 1 - fslot).clamp(0, n - 1)
    child_rows = torch.where(valid, s.free_slots[child_idx].to(torch.int64), n)
    parent_c = parent_rows.clamp(0, n - 1)
    vc, vp = child_rows[valid], parent_c[valid]

    new = {}
    for name in FIELDS:
        x = getattr(s, name)
        if name in NO_COPY or x.dim() == 0 or x.shape[0] != n:
            continue
        y = x.clone()
        y[vc] = x[vp]
        new[name] = y
    new["pc"][vc] = next_pc[vp].to(torch.int32)
    new["fentry"][vc] = st.fentry[vp]
    new["dlog_count"][vc] = 0
    fc = int(s.flog_count)
    frow = fc + fslot[valid]

    def flog(plane, vals):
        y = plane.clone()
        y[frow] = vals.to(plane.dtype)
        return y

    step = torch.full((nf,), int(st.step_no), dtype=torch.int32, device=dev)
    return s.replace(
        **new,
        flog_parent=flog(s.flog_parent, parent_rows[valid]),
        flog_child=flog(s.flog_child, vc),
        flog_step=flog(s.flog_step, step),
        flog_pc=flog(s.flog_pc, st.pc[vp]),
        flog_sid=flog(s.flog_sid, sid_b[vp]),
        flog_gmin=flog(s.flog_gmin, st.min_gas[vp]),
        flog_gmax=flog(s.flog_gmax, st.max_gas[vp]),
        flog_fentry=flog(s.flog_fentry, st.fentry[vp]),
        flog_dest=flog(s.flog_dest, dest[vp]),
        flog_count=s.flog_count + nf,
        free_count=s.free_count - nf,
    )


# ---------------------------------------------------------------------------
# the run: plain loop on the CPU, kernel K1 on the card
# ---------------------------------------------------------------------------

def sym_run_plain(code: CompiledCode, st: SymLaneState, max_steps: int,
                  exec_table=None, taint_table=None, visited=None):
    """Up to ``max_steps`` plain steps, stopping once no lane is
    RUNNING. ``visited`` (optional (L+1,) bool) gets the pc of every
    RUNNING lane marked before each step. Returns (state, visited)."""
    for _ in range(max_steps):
        running = st.status == Status.RUNNING
        if not bool(running.any()):
            break
        if visited is not None:
            mark = st.pc.long()[running]
            visited = visited.clone()
            visited[mark[mark < visited.shape[0]]] = True
        st = sym_step(code, st, exec_table, taint_table)
    return st, visited


def op_table(exec_table=None, taint_table=None) -> np.ndarray:
    """(256, 9) int32 per-opcode table K1 reads: npop, npush, gas_min,
    gas_max, deferrable, result_class, env slot, executable, taint."""
    ex = SYM_EXECUTABLE if exec_table is None else np.asarray(exec_table)
    ta = np.zeros(256, bool) if taint_table is None \
        else np.asarray(taint_table)
    return np.stack([
        NPOP_TABLE, NPUSH_TABLE, GAS_MIN_TABLE.astype(np.int64),
        GAS_MAX_TABLE.astype(np.int64), DEFERRABLE, RESULT_CLASS_TABLE,
        ENV_TABLE, ex, ta,
    ], axis=1).astype(np.int32)


#: steps one launch of K1 runs between two reads of the device's running
#: count: a step that finds no lane running ends the launch, so the run
#: still stops at exactly the step the JAX loop stops at
SYNC_EVERY = 8

_STEP_SIGS = {
    "sym_run": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p],
    "sym_run_shape": [ctypes.c_int, ctypes.c_void_p],
    "sym_init": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p],
}

#: K1's launch shape by (lanes, device): threads a block, blocks, lanes
#: a thread, bytes of a lane's decisions, lanes a block
#: (``csrc/symstep.cu`` ``sym_run_shape``)
_SHAPES = {}


def _k1():
    from .. import _build

    lib = _build.lib("symstep.cu", _STEP_SIGS)
    lib.mtt_sym_fields.restype = ctypes.c_char_p
    built = lib.mtt_sym_fields().decode().rstrip(",").split(",")
    if tuple(built) != FIELDS:
        raise RuntimeError("csrc/common.cuh SYM_FIELDS differs from "
                           "SymLaneState")
    return lib


def run_shape(n: int, dev: torch.device):
    """K1's launch shape over ``n`` lanes on ``dev``: (threads a block,
    blocks, lanes a thread, bytes of a lane's decisions, lanes a block).
    Raises where the card has no cooperative launch."""
    from .. import _build

    key = (n, dev.index)
    if key not in _SHAPES:
        lib = _k1()
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            rc = lib.sym_run_shape(n, out)
        _build.check(lib, rc, "sym_run_shape (K1 needs a cooperative "
                     "launch of blocks that are all resident)")
        _SHAPES[key] = tuple(out)
    return _SHAPES[key]


#: each plane's dtype in the port (uint32 planes hold int32 bit patterns)
_DTYPES = {f: torch.uint8 if f in U8_FIELDS else torch.int32 for f in FIELDS}
#: by tuple of plane names: (their getter, their dtypes, the C array type)
_PLANE_ARGS = {}


def plane_args(st: SymLaneState, names: tuple) -> ctypes.Array:
    """A C array (``void**``) of the named planes of a CUDA state, each
    checked once (a contiguous CUDA tensor of its type); the caller
    keeps ``st`` alive while the kernels run."""
    spec = _PLANE_ARGS.get(names)
    if spec is None:
        spec = _PLANE_ARGS[names] = (
            operator.attrgetter(*names), tuple(_DTYPES[n] for n in names),
            ctypes.c_void_p * len(names))
    get, dtypes, array = spec
    planes = get(st)
    for t, dtype in zip(planes, dtypes):
        if not (t.is_cuda and t.dtype is dtype and t.is_contiguous()):
            from .. import _build

            for name, x, want in zip(names, planes, dtypes):
                _build.need_cuda(x, want, name)
    return array(*[t.data_ptr() for t in planes])


#: by id of a state: (a weak reference to it, its planes, its void**
#: array, its dims array); an entry leaves with its state
_STATE_ARGS = {}
_ALL_PLANES = operator.attrgetter(*FIELDS)


def state_args(st: SymLaneState):
    """(void** array, int dims array) of a CUDA state for the kernels
    that take the whole state (``csrc/common.cuh`` ``Sym``); the caller
    keeps ``st`` alive while they run. The arrays are built, and the
    planes checked, once a state: later calls reuse them while every
    plane is the same tensor."""
    from .. import _build

    planes = _ALL_PLANES(st)
    key = id(st)
    hit = _STATE_ARGS.get(key)
    if hit is not None and hit[0]() is st \
            and all(map(operator.is_, planes, hit[1])):
        return hit[2], hit[3]
    n, d, _ = st.stack.shape
    dims = [n, d, st.memory.shape[1], st.mlog_off.shape[1],
            st.skeys.shape[1], st.calldata.shape[1], st.dlog_op.shape[1],
            st.flog_parent.shape[0], st.env.shape[1]]
    out = plane_args(st, FIELDS), _build.int_array(dims)
    _STATE_ARGS[key] = (weakref.ref(st, lambda _, k=key: _STATE_ARGS.pop(
        k, None)), planes) + out
    return out


def sym_run_kernel(code: CompiledCode, st: SymLaneState, max_steps: int,
                   exec_table=None, taint_table=None, visited=None,
                   sync_every: int = SYNC_EVERY, phases=None):
    """``sym_run`` on the card through kernel K1 (``csrc/symstep.cu``):
    one cooperative launch a window of ``sync_every`` steps, the running
    count read back after each. Updates the state's planes in place (the
    JAX run donates its state) and returns (state, visited). Counts each
    launch in ``LAUNCHES["sym_run"]`` and its steps in ``"sym_step"``, or
    on a packed arena (K1's packed branch, row 2p) in
    ``"sym_run_packed"`` too and in ``"sym_step_packed"``. ``phases``
    (a CUDA int64 tensor of 4, or None) gets the SM cycles of K1's
    phases added (decide, exec, forks) and the steps run."""
    from .. import _build

    dev = st.pc.device
    lib = _k1()
    planes, dims = state_args(st)
    n = st.pc.shape[0]
    optab = torch.from_numpy(op_table(exec_table, taint_table)).to(dev)
    packed = code.packed.contiguous()
    _build.need_cuda(packed, torch.int32, "code.packed")
    seg_args, counter = (None, 0, None, 0), "sym_step"
    if code.seg_tab is not None:
        seg_of, seg_tab = code.seg_of.contiguous(), code.seg_tab.contiguous()
        _build.need_cuda(seg_of, torch.int32, "code.seg_of")
        _build.need_cuda(seg_tab, torch.int32, "code.seg_tab")
        seg_args = (_build.ptr(seg_of), seg_of.shape[0], _build.ptr(seg_tab),
                    seg_tab.shape[0])
        counter = "sym_step_packed"
    vis = visited
    if vis is not None:
        _build.need_cuda(vis, torch.bool, "visited")
    if phases is not None:
        _build.need_cuda(phases, torch.int64, "phases")
    if n == 0:
        return st, vis
    _, blocks, per, dec_bytes, lanes = run_shape(n, dev)
    # the count ring (zeroed: the first launch counts into slot 0), the
    # block counts, the forking parents' stash, and the decisions where a
    # thread holds several lanes (layout in csrc/symstep.cu sym_run)
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)
    scratch = torch.empty(per * blocks + 4 * min(MAX_FORKS_PER_STEP, n),
                          dtype=torch.int32, device=dev)
    dec = torch.empty(per * blocks * lanes * dec_bytes, dtype=torch.uint8,
                      device=dev) if per > 1 else None
    stream = _build.stream(dev)
    done = 0
    while done < max_steps:
        k = min(sync_every, max_steps - done)
        rc = lib.sym_run(
            planes, dims, _build.ptr(packed), code.size, *seg_args,
            _build.ptr(optab), _build.ptr(ctl), _build.ptr(scratch),
            None if dec is None else _build.ptr(dec), lanes, blocks, k,
            MAX_FORKS_PER_STEP, None if vis is None else _build.ptr(vis),
            0 if vis is None else vis.shape[0], int(done == 0),
            None if phases is None else _build.ptr(phases), stream)
        _build.LAUNCHES["sym_run"] += 1
        if code.seg_tab is not None:
            _build.LAUNCHES["sym_run_packed"] += 1
        _build.LAUNCHES[counter] += k
        _build.check(lib, rc, "sym_run")
        done += k
        if int(ctl[0]) == 0:
            break
    return st, vis


def sym_run(code: CompiledCode, st: SymLaneState, max_steps: int,
            exec_table=None, taint_table=None, visited=None):
    """Run up to ``max_steps`` steps (one sync window), stopping once no
    lane is RUNNING: the plain loop for a CPU state, kernel K1 for a
    CUDA state. Returns (state, visited); visited is None when not
    requested."""
    if st.pc.device.type == "cpu":
        return sym_run_plain(code, st, max_steps, exec_table, taint_table,
                             visited)
    return sym_run_kernel(code, st, max_steps, exec_table, taint_table,
                          visited)


# ---------------------------------------------------------------------------
# the run over a mesh: K1 a shard (parallel/mesh.SymShards)
# ---------------------------------------------------------------------------

#: the lane planes a fork's child copies from its parent (all but the
#: batch's global planes, and pc, fentry and dlog_count, which the child
#: gets from its parent's fork stash and 0); ``csrc/symstep.cu``
#: ``fork_planes`` lists the same planes, its 4-byte ones first
FORK_PLANES = tuple(f for f in FIELDS if f not in NO_COPY
                    and f not in ("pc", "fentry", "dlog_count"))


class _PlainShard:
    """K1's phases on one CPU shard, in plain PyTorch (``sym_step`` with
    a ``ShardStep``); the shard is replaced in ``ss.shards``."""

    def __init__(self, ss, i, code, exec_table, taint_table, visited):
        self.ss, self.i, self.code = ss, i, code
        self.tabs = exec_table, taint_table
        self.base = i * ss.per
        self.vis = None if visited is None else torch.zeros_like(visited)
        self.req = None

    def decide(self):
        st = self.ss.shards[self.i]
        running = st.status == Status.RUNNING
        if self.vis is not None:
            mark = st.pc.long()[running]
            self.vis[mark[(mark >= 0) & (mark < self.vis.shape[0])]] = True
        self.req = sym_step(self.code, st, *self.tabs,
                            ShardStep(self.base, decide=True))
        return lambda: (int(self.req.sum()), int(running.sum()))

    def execute(self, off, navail, free_count, flog_count, step_no, nf):
        st, stash = sym_step(self.code, self.ss.shards[self.i], *self.tabs,
                             ShardStep(self.base, off, navail, free_count,
                                       flog_count, step_no))
        self.ss.shards[self.i] = st
        return stash.t().contiguous()


_MESH_SIGS = {
    "sym_mesh_sizes": [ctypes.c_void_p],
    "sym_mesh_table": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p],
    "sym_host_alloc": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "sym_sync": [ctypes.c_void_p],
    "sym_decide": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "sym_exec": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "sym_fork_row_bytes": [ctypes.c_void_p],
    "sym_fork_plan_bytes": [ctypes.c_int],
    "sym_fork_plan": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    "sym_fork_rows": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "sym_vis_or": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p],
    "peer_access": [ctypes.c_int],
}

#: threads a block of K1's meshed phases (a lane a thread), shards a
#: launch and bitmaps a ``sym_vis_or`` launch (``csrc/symstep.cu``
#: ``MESH_THREADS``, ``MAX_MESH_SHARDS``, ``MAX_VIS_SRCS``)
MESH_THREADS = 64
MAX_MESH_SHARDS = 64
MAX_VIS_SRCS = 64


def _k1_mesh():
    """K1's library with its meshed entries bound; its constants checked
    once against this module's: (library, bytes of a shard's table
    entry, scratch bytes a lane)."""
    global _MESH_LIB
    if _MESH_LIB is None:
        lib = _k1()
        for name, argtypes in _MESH_SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.sym_mesh_sizes.restype = None
        out = (ctypes.c_int * 5)()
        lib.sym_mesh_sizes(out)
        if tuple(out[2:]) != (MESH_THREADS, MAX_MESH_SHARDS, MAX_VIS_SRCS):
            raise RuntimeError("csrc/symstep.cu's mesh constants differ "
                               "from ops/symstep.py's")
        _MESH_LIB = (lib, out[0], out[1])
    return _MESH_LIB


_MESH_LIB = None

#: mapped pinned host buffers of ``sym_decide``'s counts by (thread,
#: group of a run, ints): (an int32 numpy view, its device address)
_MESH_HOST = {}


def _mesh_host(slot: int, n: int):
    """A pinned host buffer of ``n`` ints mapped into every card's
    address space, made once for (this thread, ``slot``, ``n``): a run's
    groups take slots 0, 1, ... so their counts never share one."""
    key = (threading.get_ident(), slot, n)
    if key not in _MESH_HOST:
        from .. import _build

        lib = _k1_mesh()[0]
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _build.check(lib, lib.sym_host_alloc(n, ctypes.byref(host),
                                             ctypes.byref(dev)),
                     "sym_host_alloc")
        view = np.ctypeslib.as_array(
            (ctypes.c_int32 * max(n, 1)).from_address(host.value))
        _MESH_HOST[key] = (view, dev.value)
    return _MESH_HOST[key]


class _PlainGroup:
    """K1's phases on the CPU shards ``idx`` of a mesh, each shard's in
    plain PyTorch (``_PlainShard``); the group holding shard 0 also
    writes the step's fork-log child slots and step numbers at home, as
    ``sym_exec`` does on the home device."""

    def __init__(self, ss, idx, slot, code, exec_table, taint_table,
                 visited):
        self.ss, self.idx = ss, list(idx)
        self.shards = [_PlainShard(ss, i, code, exec_table, taint_table,
                                   visited) for i in self.idx]
        self.home = 0 in self.idx

    def decide(self):
        reads = [sh.decide() for sh in self.shards]

        def read():
            c = [r() for r in reads]
            return [x[0] for x in c], [x[1] for x in c]

        return read

    def execute(self, off, navail, free_count, flog_count, step_no, nf):
        out = [sh.execute(o, navail, free_count, flog_count, step_no, 0)
               for sh, o in zip(self.shards, off)]
        if self.home and nf:
            home = self.ss.home
            top = (free_count - 1 - torch.arange(nf)).clamp(0, self.ss.n - 1)
            home.flog_child[flog_count:flog_count + nf] = home.free_slots[top]
            home.flog_step[flog_count:flog_count + nf] = step_no
        return out

    def bitmaps(self, visited):
        """The group's own visited bitmaps (not ``visited``)."""
        return [sh.vis for sh in self.shards]


class _CudaGroup:
    """K1's phases over the CUDA shards ``idx`` of one device
    (``csrc/symstep.cu``), each one launch over all of them:
    ``sym_decide`` (each lane's decisions into the group's scratch, each
    block's fork requests and running lanes into a mapped host buffer,
    the visited bitmap; ``decide`` returns the read, which waits for the
    launch once), then ``sym_exec`` (each lane's step at the global fork
    ranks, the forking parents into each shard's stash; on the home
    device also the step's fork-log child slots and step numbers). The
    shards' table (``sym_mesh_table``) is built and copied once a run.
    Each launch on the current stream of the device, counted in
    ``LAUNCHES``."""

    def __init__(self, ss, idx, slot, code, exec_table, taint_table,
                 visited):
        from .. import _build

        self.b = _build
        self.lib, entry, dec_bytes = _k1_mesh()
        self.ss, self.idx = ss, list(idx)
        self.dev = ss.shards[self.idx[0]].device
        per = self.per = ss.per
        q = len(self.idx)
        self.bps = max(1, -(-per // MESH_THREADS))
        self.blocks = q * self.bps
        _build.need_cuda(code.packed, torch.int32, "code.packed")
        if code.seg_tab is not None:
            raise ValueError("a packed arena does not run over a mesh")
        cap = min(MAX_FORKS_PER_STEP, ss.n)
        with torch.cuda.device(self.dev):
            self.optab = torch.from_numpy(
                op_table(exec_table, taint_table)).to(self.dev)
            self.stash = torch.empty((q, len(STASH), cap),
                                     dtype=torch.int32, device=self.dev)
            self.dec = torch.empty(q * per * dec_bytes, dtype=torch.uint8,
                                   device=self.dev)
            self.counts = torch.empty(2 * self.blocks, dtype=torch.int32,
                                      device=self.dev)
            # the batch's bitmap where it lives on this device, else the
            # group's own, ORed into it after the run
            self.vis = None if visited is None \
                else visited if visited.device == self.dev \
                else torch.zeros(visited.shape[0], dtype=torch.bool,
                                 device=self.dev)
            args = [state_args(ss.shards[i]) for i in self.idx]
            planes = (ctypes.c_void_p * (q * len(FIELDS)))()
            for j, (p, _) in enumerate(args):
                planes[j * len(FIELDS):(j + 1) * len(FIELDS)] = list(p)
            self.host_tab = torch.empty(q * entry, dtype=torch.uint8,
                                        pin_memory=True)
            _build.check(self.lib, self.lib.sym_mesh_table(
                planes, q, args[0][1], _build.ptr(code.packed), code.size,
                _build.ptr(self.optab),
                _build.int_array([i * per for i in self.idx]),
                _build.ptr(self.stash), cap, _build.ptr(self.host_tab)),
                "sym_mesh_table")
            self.tab = self.host_tab.to(self.dev, non_blocking=True)
        view, host = _mesh_host(slot, 2 * self.blocks)
        self.counts_host = view[:2 * self.blocks].reshape(2, q, self.bps)
        # each launch's arguments but the step's, made once
        ptr = _build.ptr
        self.decide_args = (
            ptr(self.tab), q, per, ptr(self.dec), ptr(self.counts), host,
            None if self.vis is None else ptr(self.vis),
            0 if self.vis is None else self.vis.shape[0])
        self.exec_args = (ptr(self.tab), q, per, cap, ptr(self.dec),
                          ptr(self.counts))
        home = ss.home
        self.home_args = tuple(ptr(t) for t in (
            home.flog_child, home.flog_step, home.free_slots)) \
            if 0 in self.idx else (None, None, None)
        self.off = (ctypes.c_int * q)()
        self.stashes = list(self.stash)

    def decide(self):
        """Launch ``sym_decide``; returns the read of its counts:
        (requests, running lanes) a shard."""
        stream = self.b.stream(self.dev)
        with _current(self.dev):
            self.launch_decide(stream)

        def read():
            # the stream's handle may be a device's default stream, which
            # names the current device's: wait with this one current
            with _current(self.dev):
                self.b.check(self.lib, self.lib.sym_sync(stream),
                             "sym_decide")
            c = self.counts_host.sum(axis=2).tolist()
            return c[0], c[1]

        return read

    def launch_decide(self, stream):
        rc = self.lib.sym_decide(*self.decide_args, stream)
        self.b.LAUNCHES["sym_decide"] += 1
        self.b.check(self.lib, rc, "sym_decide")

    def execute(self, off, navail, free_count, flog_count, step_no, nf):
        b = self.b
        self.off[:] = off
        with _current(self.dev):
            rc = self.lib.sym_exec(
                *self.exec_args, self.off, navail, free_count, flog_count,
                step_no, *self.home_args, nf, self.ss.n, b.stream(self.dev))
        b.LAUNCHES["sym_exec"] += 1
        b.check(self.lib, rc, "sym_exec")
        return self.stashes

    def bitmaps(self, visited):
        """The group's own visited bitmap, where it is not ``visited``."""
        return [] if self.vis is None or self.vis is visited else [self.vis]


def _current(dev: torch.device):
    """``dev`` made the current device for a launch on it, where it is
    not already."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


#: the route of each (batch device, source device) pair of ``vis_or``:
#: "local", "peer" (read in place, access enabled once) or "copy"
_VIS_ROUTES = {}


def vis_route(dst: torch.device, src: torch.device) -> str:
    """How ``vis_or`` reads a bitmap on ``src`` into one on ``dst``, by
    the cards' topology: in place where it is the same device or the
    pair has peer access (enabled here, once a pair), else through a
    copy to ``dst``."""
    key = (dst.index, src.index)
    if key not in _VIS_ROUTES:
        if dst == src:
            route = "local"
        elif torch.cuda.can_device_access_peer(dst, src):
            from .. import _build

            lib = _k1_mesh()[0]
            with torch.cuda.device(dst):
                _build.check(lib, lib.peer_access(src.index), "peer_access")
            route = "peer"
        else:
            route = "copy"
        _VIS_ROUTES[key] = route
    return _VIS_ROUTES[key]


def vis_or(visited, srcs):
    """``visited |= src`` for every bitmap of ``srcs`` (the shards' own
    visited bitmaps, each as long as ``visited``): on a card one
    ``sym_vis_or`` launch on ``visited``'s device reads every source in
    place (``vis_route``; a source whose pair has no peer access is
    copied first), whose writes must have completed; on the CPU the
    plain ``visited | src`` of each. Returns ``visited``."""
    srcs = list(srcs)
    if visited.device.type == "cpu":
        for src in srcs:
            visited = visited | src.to(visited.device)
        return visited
    from .. import _build as b

    lib = _k1_mesh()[0]
    dev = visited.device
    if len(srcs) > MAX_VIS_SRCS:
        raise ValueError(f"vis_or: {len(srcs)} bitmaps, at most "
                         f"{MAX_VIS_SRCS}")
    held = []
    with _current(dev):
        for src in [visited] + srcs:
            if not (src.is_cuda and src.dtype is torch.bool
                    and src.is_contiguous() and src.shape == visited.shape):
                raise ValueError(f"vis_or: {tuple(src.shape)} {src.dtype} "
                                 f"on {src.device}: a contiguous CUDA bool "
                                 f"bitmap of {tuple(visited.shape)} wanted")
        for src in srcs:
            held.append(src if vis_route(dev, src.device) != "copy"
                        else src.to(dev))
        rc = lib.sym_vis_or(b.ptr(visited), b.ptr_array(held), len(held),
                            visited.shape[0], b.stream(dev))
    b.LAUNCHES["sym_vis_or"] += 1
    b.check(lib, rc, "sym_vis_or")
    return visited


def shard_groups(code, ss, exec_table=None, taint_table=None,
                 visited=None):
    """K1's phases over the shards of ``ss``, a group a device (at most
    ``MAX_MESH_SHARDS`` shards a group), the devices in the order they
    first appear: ``_PlainGroup`` on the CPU, ``_CudaGroup`` on a card;
    ``code`` is {device: compiled code}."""
    from ..parallel.mesh import device_groups

    groups = []
    for dev, idx in device_groups(ss.mesh):
        for lo in range(0, len(idx), MAX_MESH_SHARDS):
            cls = _PlainGroup if dev.type == "cpu" else _CudaGroup
            groups.append(cls(ss, idx[lo:lo + MAX_MESH_SHARDS],
                              len(groups), code[dev], exec_table,
                              taint_table, visited))
    return groups


def decide_groups(groups, d: int):
    """Every group's decide launched, then each read: (fork requests,
    running lanes) of each of the ``d`` shards, lists of ints in mesh
    order."""
    reads = [g.decide() for g in groups]
    req, run = [0] * d, [0] * d
    for g, read in zip(groups, reads):
        for i, r, u in zip(g.idx, *read()):
            req[i], run[i] = r, u
    return req, run


def fork_budget(req, free_count: int, flog_count: int, F: int, n: int):
    """A step's fork budget from each shard's requests (mesh order), as
    the JAX cumsum over every lane: (navail, each shard's global rank of
    its first request, each shard's forks, the step's forks)."""
    navail = min(free_count, MAX_FORKS_PER_STEP, n, F - flog_count)
    off, forks, at = [], [], 0
    for r in req:
        off.append(at)
        forks.append(max(0, min(r, navail - at)))
        at += r
    return navail, off, forks, max(0, min(at, navail))


def execute_groups(groups, d: int, off, forks, navail: int,
                   free_count: int, flog_count: int, step_no: int,
                   nf: int):
    """Every group's execute: [(stash, global rank of its first fork,
    forks)] a shard, mesh order."""
    out = [None] * d
    for g in groups:
        stashes = g.execute([off[i] for i in g.idx], navail, free_count,
                            flog_count, step_no, nf)
        for i, stash in zip(g.idx, stashes):
            out[i] = (stash, off[i], forks[i])
    return out


#: the home batch's fork-log planes a fork's stash fills (the child's
#: slot and the step come from ``sym_exec``), and their stash columns
FLOG_PLANES = ("flog_parent", "flog_pc", "flog_fentry", "flog_sid",
               "flog_gmin", "flog_gmax", "flog_dest")
FLOG_COLS = (0, 3, 2, 4, 5, 6, 7)


def child_slots(free_slots, free_count: int, nf: int, n: int):
    """The step's child slots in fork order (global lanes): the top of
    the batch's free stack, ``free_slots[clip(free_count - 1 - rank, 0,
    n - 1)]`` (as the home ``sym_exec`` writes them into the fork
    log)."""
    if isinstance(free_slots, np.ndarray):
        return free_slots[np.clip(free_count - 1 - np.arange(nf), 0, n - 1)]
    return free_slots[(free_count - 1 - torch.arange(nf)).clamp(0, n - 1)]


class _PlainForks:
    """A forking step's fork rows on CPU shards in plain PyTorch, a
    source shard at a time: each fork's seven fork-log words from its
    shard's stash into the home batch at ``flog_count`` + its global
    rank, and its parent's post-step row (``FORK_PLANES``, then the
    stash's pc and fentry and an empty record log) into its child's
    slot (``child_slots``), gathered and scattered once a (source,
    destination) pair of shards."""

    def __init__(self, ss, groups):
        self.ss = ss

    def run(self, stashes, nf, free_count, flog_count):
        """``stashes``: ``execute_groups``' [(stash, global rank of the
        shard's first fork, forks)] a shard."""
        ss = self.ss
        home, m = ss.home, ss.per
        child = child_slots(home.free_slots, free_count, nf, ss.n).long()
        for q, (stash, o, k) in enumerate(stashes):
            if not k:
                continue
            at = slice(flog_count + o, flog_count + o + k)
            for plane, c in zip(FLOG_PLANES, FLOG_COLS):
                getattr(home, plane)[at] = stash[c, :k]
            src = ss.shards[q]
            par = stash[0, :k].long() - q * m
            mine = child[o:o + k]
            for dq in (mine // m).unique().tolist():
                sel = mine // m == dq
                dst, dl = ss.shards[dq], mine[sel] - dq * m
                new = {}
                for f in FORK_PLANES:
                    y = getattr(dst, f).clone()
                    y[dl] = getattr(src, f)[par[sel]]
                    new[f] = y
                for f, col in (("pc", stash[1, :k]), ("fentry", stash[2, :k]),
                               ("dlog_count", torch.zeros_like(stash[0, :k]))):
                    y = getattr(dst, f).clone()
                    y[dl] = col[sel]
                    new[f] = y
                ss.shards[dq] = dst.replace(**new)


class _CudaForks:
    """A forking step's fork rows over a mesh's CUDA shards
    (``csrc/symstep.cu`` ``sym_fork_rows``): one launch on each device
    that holds a child's shard, and on the home device, which also
    writes the fork-log words; no index passes through the host. A plan
    a device (every shard's planes and stash, the batch's free stack
    copied there once, the home fork-log planes, flags) is built and
    copied once a run. Each source device is read in place over peer
    access where ``route`` (``vis_route``: by topology) gives "local" or
    "peer"; where it gives "copy" the source's device stages its forks'
    rows (the same kernel, a launch) and each such destination gets them
    in one copy. A destination's launch waits on an event recorded on
    each other source device after its ``sym_exec``. Each launch on the
    current stream of its device, counted in ``LAUNCHES``."""

    def __init__(self, ss, groups, route=None):
        from .. import _build

        route = route or vis_route
        self.b = _build
        self.lib = _k1_mesh()[0]
        d = ss.mesh.size
        if d > MAX_MESH_SHARDS:
            raise ValueError(f"fork rows over {d} shards, at most "
                             f"{MAX_MESH_SHARDS}")
        self.d, self.m, self.n = d, ss.per, ss.n
        home = ss.home
        stash = [None] * d
        for g in groups:
            for i, x in zip(g.idx, g.stashes):
                stash[i] = x
        cap = stash[0].shape[1]
        self.shard_dev = [st.device for st in ss.shards]
        self.devs = list(dict.fromkeys(g.dev for g in groups))
        self.home_dev = home.device
        nfield = len(FIELDS)
        planes = (ctypes.c_void_p * (d * nfield))()
        for i, st in enumerate(ss.shards):
            planes[i * nfield:(i + 1) * nfield] = list(state_args(st)[0])
        dims = state_args(ss.shards[0])[1]
        self.row = self.lib.sym_fork_row_bytes(dims)
        self.routes = {(dst, src): route(dst, src)
                       for dst in self.devs for src in self.devs}
        copied = {x for pair, r in self.routes.items() if r == "copy"
                  for x in pair}
        self.stagers = [src for src in self.devs
                        if any(self.routes[(dst, src)] == "copy"
                               for dst in self.devs)]
        self.plans, self.keep = {}, []
        stash_ptrs = _build.ptr_array(stash)
        for dev in self.devs:
            with torch.cuda.device(dev):
                stage = torch.empty(cap * self.row, dtype=torch.uint8,
                                    device=dev) if dev in copied else None
                free = home.free_slots if home.device == dev \
                    else home.free_slots.to(dev)
                flog = _build.ptr_array([getattr(home, f) for f in
                                         FLOG_PLANES]) \
                    if home.device == dev else None
                host = torch.empty(self.lib.sym_fork_plan_bytes(d),
                                   dtype=torch.uint8, pin_memory=True)
                _build.check(self.lib, self.lib.sym_fork_plan(
                    planes, d, dims, stash_ptrs,
                    _build.int_array([x == dev for x in self.shard_dev]),
                    _build.int_array([self.routes[(dev, x)] == "copy"
                                      for x in self.shard_dev]),
                    cap, self.n, _build.ptr(free), flog,
                    None if stage is None else _build.ptr(stage),
                    _build.ptr(host)), "sym_fork_plan")
                plan = host.to(dev, non_blocking=True)
            self.plans[dev] = (_build.ptr(plan), stage)
            self.keep += [plan, free, host]
        self.events = {dev: torch.cuda.Event() for dev in self.devs} \
            if len(self.devs) > 1 else None
        self.free = home.free_slots.cpu().numpy() if self.events else None
        self.off, self.forks = (ctypes.c_int * d)(), (ctypes.c_int * d)()

    def launch(self, dev, nf, free_count, flog_count, stage=0):
        with _current(dev):
            rc = self.lib.sym_fork_rows(
                self.plans[dev][0], self.d, self.off, self.forks, nf,
                free_count, flog_count, stage, self.b.stream(dev))
        self.b.LAUNCHES["sym_fork_rows"] += 1
        self.b.check(self.lib, rc, "sym_fork_rows")

    def run(self, stashes, nf, free_count, flog_count):
        """``stashes``: ``execute_groups``' [(stash, global rank of the
        shard's first fork, forks)] a shard (the stashes themselves are
        in the plans)."""
        for q, (_, o, k) in enumerate(stashes):
            self.off[q], self.forks[q] = o, k
        if self.events is None:  # one device
            dev = self.devs[0]
            if self.stagers:
                self.launch(dev, nf, free_count, flog_count, stage=1)
            self.launch(dev, nf, free_count, flog_count)
            return
        m = self.m
        srcs = list(dict.fromkeys(self.shard_dev[q] for q, (_, _, k)
                                  in enumerate(stashes) if k))
        child = child_slots(self.free, free_count, nf, self.n)
        dests = {self.shard_dev[q] for q in np.unique(child // m)}
        dests = [x for x in self.devs if x in dests or x == self.home_dev]
        for src in srcs:
            self.events[src].record(torch.cuda.current_stream(src))
        for src in srcs:
            to = [dst for dst in dests if self.routes[(dst, src)] == "copy"]
            if not to:
                continue
            self.launch(src, nf, free_count, flog_count, stage=1)
            runs = _rank_runs([(o, k) for q, (_, o, k) in enumerate(stashes)
                               if k and self.shard_dev[q] == src])
            for dst in to:
                if dst == src:
                    continue
                a, b = self.plans[dst][1], self.plans[src][1]
                for lo, hi in runs:
                    a[lo * self.row:hi * self.row].copy_(
                        b[lo * self.row:hi * self.row])
        for dst in dests:
            stream = torch.cuda.current_stream(dst)
            for src in srcs:
                if src != dst and self.routes[(dst, src)] == "peer":
                    stream.wait_event(self.events[src])
            self.launch(dst, nf, free_count, flog_count)


def _rank_runs(spans):
    """The (first, end) rank ranges of (first, count) spans, ascending,
    neighbours merged."""
    out = []
    for o, k in sorted(spans):
        if out and out[-1][1] == o:
            out[-1] = (out[-1][0], o + k)
        else:
            out.append((o, o + k))
    return out


def sym_run_mesh(code, ss, max_steps: int, exec_table=None,
                 taint_table=None, visited=None):
    """``sym_run`` over a batch placed on a mesh
    (``parallel/mesh.SymShards``), each shard's work on the device that
    holds it, a group of shards a device (``shard_groups``): per step
    every group decides (K1's ``sym_decide``, one launch over a card's
    shards; ``sym_step``'s first half a CPU shard), the shards' fork
    requests and running lanes come to the host (one wait a device),
    which stops at the first step where no lane of any shard runs and
    gives each shard the global rank of its first request and the
    step's fork budget (from the batch's free-slot and fork-log counts,
    as the JAX cumsum over every lane does); every group then executes
    (``sym_exec``), its forking parents into each shard's stash in fork
    order, the group on the home device also writing the step's fork-log
    child slots and step numbers; then the step's fork rows
    (``_CudaForks``: one ``sym_fork_rows`` launch a device that holds a
    child, or the home device, which also writes the other fork-log
    words; ``_PlainForks`` on CPU shards): each child's slot is the top
    of the batch's free-slot stack, and each parent's post-step row is
    copied into it. ``code`` is {device: compiled code}. Updates ``ss``
    (CUDA shards in place) and returns (ss, visited): the visited bitmap
    ORs every shard's (``vis_or``)."""
    home = ss.home
    n, d = ss.n, ss.mesh.size
    free_count = int(home.free_count)
    flog_count = int(home.flog_count)
    step_no = int(home.step_no)
    F = home.flog_parent.shape[0]
    if visited is not None and visited.device.type == "cpu":
        visited = visited.clone()
    groups = shard_groups(code, ss, exec_table, taint_table, visited)
    forks_of = _PlainForks if home.device.type == "cpu" else _CudaForks
    forker = None
    for _ in range(max_steps):
        req, run = decide_groups(groups, d)
        if not any(run):
            break
        navail, off, forks, nf = fork_budget(req, free_count, flog_count,
                                             F, n)
        stashes = execute_groups(groups, d, off, forks, navail, free_count,
                                 flog_count, step_no, nf)
        if nf:
            forker = forker or forks_of(ss, groups)
            forker.run(stashes, nf, free_count, flog_count)
        free_count -= nf
        flog_count += nf
        step_no += 1
    home.step_no.copy_(torch.tensor(step_no, dtype=torch.int32))
    home.flog_count.copy_(torch.tensor(flog_count, dtype=torch.int32))
    home.free_count.copy_(torch.tensor(free_count, dtype=torch.int32))
    if visited is not None:
        visited = vis_or(visited, [v for g in groups
                                   for v in g.bitmaps(visited)])
    return ss, visited
