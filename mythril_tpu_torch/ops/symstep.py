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
  ``csrc/symstep.cu``, and never the plain version.

The JAX stepper gates each expensive family behind a ``lax.cond`` over
"any lane needs it"; per lane the result is the same whether or not a
gate ran, which is what lets K1 compute each lane on its own.
"""

import ctypes
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


def sym_step(code: CompiledCode, st: SymLaneState, exec_table=None,
             taint_table=None) -> SymLaneState:
    """Advance every running lane by one instruction, in plain PyTorch
    (the JAX ``sym_step``, op for op). ``exec_table``/``taint_table`` are
    optional (256,) bool tables with the meaning they have there."""
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
    step_no = int(st.step_no)

    running = st.status == Status.RUNNING
    pc = st.pc.to(I64)
    sp = st.sp.to(I64)
    pc_c = pc.clamp(0, code.size)
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
    dest_u32, dest_hi = _u32_of(a)
    dest_small = ~dest_hi & (dest_u32 < code.size)
    dest = torch.where(dest_small, dest_u32, 0)
    dest_eff = dest
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
    forder = torch.cumsum(fork_req.to(I64), 0) - 1
    maxf = min(MAX_FORKS_PER_STEP, n)
    free_count = int(st.free_count)
    flog_count = int(st.flog_count)
    navail = min(free_count, maxf, st.flog_parent.shape[0] - flog_count)
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
    prov_id = -(lanes * d_recs + st.dlog_count.to(I64).clamp(0, d_recs - 1) + 1)
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
    pc_r = bv256.from_u32(pc)
    gl_slot = ENV_SLOTS["GASLIMIT"]
    gas_r = env_u[:, gl_slot, :]
    cds_r = bv256.from_u32(cd_size)
    codesize_r = bv256.from_u32(torch.full((n,), code.size, device=dev))
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


#: steps enqueued between two reads of the device's running count: the
#: kernels of a step after the last lane stopped exit at once, so the
#: run still stops at exactly the step the JAX loop stops at
SYNC_EVERY = 8

_STEP_SIGS = {
    "sym_run_steps": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "sym_count_running": [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p],
    "sym_init": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p],
}


def _k1():
    from .. import _build

    lib = _build.lib("symstep.cu", _STEP_SIGS)
    lib.mtt_sym_fields.restype = ctypes.c_char_p
    built = lib.mtt_sym_fields().decode().rstrip(",").split(",")
    if tuple(built) != FIELDS:
        raise RuntimeError("csrc/common.cuh SYM_FIELDS differs from "
                           "SymLaneState")
    return lib


def state_args(st: SymLaneState):
    """(void** array, int dims array) of a CUDA state for the kernels;
    the caller keeps ``st`` alive while they run."""
    from .. import _build

    for name in FIELDS:
        t = getattr(st, name)
        want = torch.uint8 if name in U8_FIELDS else torch.int32
        _build.need_cuda(t, want, name)
    n, d, _ = st.stack.shape
    dims = [n, d, st.memory.shape[1], st.mlog_off.shape[1],
            st.skeys.shape[1], st.calldata.shape[1], st.dlog_op.shape[1],
            st.flog_parent.shape[0], st.env.shape[1]]
    return (_build.ptr_array([getattr(st, f) for f in FIELDS]),
            _build.int_array(dims))


def sym_run_kernel(code: CompiledCode, st: SymLaneState, max_steps: int,
                   exec_table=None, taint_table=None, visited=None,
                   sync_every: int = SYNC_EVERY):
    """``sym_run`` on the card through kernel K1 (``csrc/symstep.cu``),
    reading the running count back every ``sync_every`` steps. Updates
    the state's planes in place (the JAX run donates its state) and
    returns (state, visited)."""
    from .. import _build

    dev = st.pc.device
    lib = _k1()
    planes, dims = state_args(st)
    n = st.pc.shape[0]
    optab = torch.from_numpy(op_table(exec_table, taint_table)).to(dev)
    packed = code.packed.contiguous()
    _build.need_cuda(packed, torch.int32, "code.packed")
    vis = visited
    if vis is not None:
        _build.need_cuda(vis, torch.bool, "visited")
    # per-step scratch (layout in csrc/symstep.cu sym_run_steps): fork
    # flags, block offsets, and the forking parents' stash
    nb = (n + 255) // 256
    ctl = torch.zeros(8, dtype=torch.int32, device=dev)
    scratch = torch.empty(n + nb + 1 + 4 * min(MAX_FORKS_PER_STEP, n),
                          dtype=torch.int32, device=dev)
    stream = _build.stream(dev)
    rc = lib.sym_count_running(planes, dims, _build.ptr(ctl), stream)
    _build.check(lib, rc, "sym_count_running")
    done = 0
    while done < max_steps:
        k = min(sync_every, max_steps - done)
        rc = lib.sym_run_steps(
            planes, dims, _build.ptr(packed), code.size, _build.ptr(optab),
            _build.ptr(ctl), _build.ptr(scratch), k, MAX_FORKS_PER_STEP,
            None if vis is None else _build.ptr(vis),
            0 if vis is None else vis.shape[0], stream)
        _build.LAUNCHES["sym_step"] += k
        _build.check(lib, rc, "sym_run_steps")
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
