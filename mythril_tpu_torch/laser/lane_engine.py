"""Lane engine, device half: the fused per-window dispatch and the window
loop of ``LaneEngine``.

The counterpart of the device half of ``mythril_tpu/laser/lane_engine.py``:
the constants, the packed seed buffers (``_seed_sections``,
``_pack_window``), the window dispatch ``window_exec`` (the JAX
``_window_exec``: remap and reset, kill, resume, seed; ``sym_run``;
record dedup and canonical remap; hold and retire selection; counters,
unique-record and fork tables) and its escalations ``_retire_rows``,
``_unique_table_big`` and ``_gather_full_flog``.

Each of them has a plain PyTorch version (the ``*_plain`` functions,
used for CPU tensors and as the comparison on the card) and, for CUDA
tensors, kernels in ``csrc/window.cu``: K2 ``window_prologue``, K3
``window_dedup``, K4 ``window_epilogue`` (whose gathers also serve the
three escalations).

``LaneEngine`` here adds no feature. It is the device loop of the JAX
engine's ``_explore_members``: seed fresh tx-entry lanes, dispatch
windows until no lane is RUNNING, retire parked lanes (in the window
dispatch, or through ``_retire_rows`` for the rest), and refill free
slots. It stops where the JAX engine hands retired rows to the host
drain and ``materialize``: the host bridge (SMT terms, the solver
screen, the interpreter and detectors) is not part of this package yet.
Its one device-facing duty, resolving canonical record ids to object
ids for the next window's remap, is done by ``ObjectTable``; no kills
and no SHA3 resumes are sent.
"""

import ctypes
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import symstep
from ..ops.bv256 import NLIMBS
from ..ops.stepper import CompiledCode, Status, compile_code
from ..ops.symstep import DEAD, SymLaneState
from ..support.devices import resolve
from ..support.opcodes import ADDRESS, OPCODES

_OPB = {name: data[ADDRESS] for name, data in OPCODES.items()}

#: fast-retire row budget and column floors (stack slots, memory bytes,
#: overlay records, storage slots) of the in-dispatch retire gather
RCAP = 16
RETIRE_FLOORS = (24, 512, 8, 8)
#: in-place-resume hold budget per window
HOLD_CAP = 64
#: device-seed column caps
SEED_STACK = 16
SEED_MEM = 256
SEED_CD = 160
#: sparse provisional-sid resolution pairs per window
PROV_BUCKET = 4096
RESUME_MEM = SEED_MEM
RESUME_MLOG = 8
_SHA3_BYTE = 0x20
#: unique-record / fork-row budgets of the window pull
URB = 512
FB = 512
_DEDUP_H = 4096  # dedup hash-table cells
_SSTORE_BYTE = _OPB["SSTORE"]
DEFAULT_WINDOW = 256
DEFAULT_STEP_BUDGET = 8192
#: rows per escalation-retire gather
RETIRE_CHUNK = 1024

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1
_M32 = 0xFFFFFFFF
_HASH_MUL = 0x9E3779B1


def _geo_bucket(k: int, cap: int, floor: int) -> int:
    """Power-of-two bucket {floor, 2*floor, ..., cap} at least k."""
    b = min(cap, floor)
    while b < min(k, cap):
        b *= 2
    return min(b, cap)


# ---------------------------------------------------------------------------
# packed host buffers
# ---------------------------------------------------------------------------

def _seed_sections(n, k, n_env, sd, pv):
    """Layout of the packed per-window i32 buffer: (name, shape, is_u32)."""
    return [
        ("idx", (k,), False),
        ("i32p", (k, 8 + n_env), False),
        ("u32p", (k, 1 + n_env * NLIMBS), True),
        ("fs", (n,), False),
        ("fcount", (), False),
        ("prov", (pv, 2), False),
        ("kill", (n,), False),
        ("stack_v", (k, sd * NLIMBS), True),
        ("stack_s", (k, sd), False),
        ("r_idx", (k,), False),
        ("r_i32", (k, 6), False),
        ("r_limbs", (k, NLIMBS), True),
    ]


def _section_offsets(sections):
    offs, off = {}, 0
    for name, shape, _ in sections:
        offs[name] = off
        off += int(np.prod(shape)) if shape else 1
    return offs, off


def _unpack_i32_sections(buf, sections):
    """Split a flat i32 buffer into named views (u32 sections stay as
    their int32 bit patterns, the port's plane dtype)."""
    out = {}
    offs, _ = _section_offsets(sections)
    for name, shape, _ in sections:
        size = int(np.prod(shape)) if shape else 1
        part = buf[offs[name]:offs[name] + size]
        out[name] = part.reshape(shape) if shape else part[0]
    return out


def _seed_widths(st: SymLaneState):
    return (min(SEED_STACK, st.stack.shape[1]),
            min(SEED_MEM, st.memory.shape[1]),
            min(SEED_CD, st.calldata.shape[1]))


def pack_window(n, n_env, lane_kwargs, seeds, free, kill, prov,
                calldata_cap, big=False, resumes=()):
    """The two flat host buffers (i32, u8) of one window dispatch, as
    the JAX engine's ``_pack_window`` packs them, from raw seed dicts
    (the form ``_seed_spec`` returns: group, sbase, calldata, cd_size,
    cd_sym, cd_size_sid, env, env_sid, gas_limit, pc, sp, msize, stack_v,
    stack_s, mem_v, mem_k). ``seeds`` is [(lane, seed dict)], ``prov``
    {(lane, slot): oid}. Returns (i32buf, u8buf, k, pv) as numpy."""
    n_depth = lane_kwargs.get("stack_depth", 64)
    mem_cap = lane_kwargs.get("memory_bytes", 4096)
    d_recs = lane_kwargs.get("dlog_records", 64)
    sd = min(SEED_STACK, n_depth)
    mc = min(SEED_MEM, mem_cap)
    ccw = min(SEED_CD, calldata_cap)
    k = n if big else min(16, n)
    if len(seeds) > k or len(resumes) > k:
        raise ValueError(f"{len(seeds)} seeds / {len(resumes)} resumes "
                         f"exceed the seed bucket {k}")
    idx = np.full(k, n, np.int32)
    i32p = np.zeros((k, 8 + n_env), np.int32)
    u32p = np.zeros((k, 1 + n_env * NLIMBS), np.uint32)
    u8p = np.zeros((k, ccw), np.uint8)
    stack_v = np.zeros((k, sd * NLIMBS), np.uint32)
    stack_s = np.zeros((k, sd), np.int32)
    mem_v = np.zeros((k, mc), np.uint8)
    mem_k = np.zeros((k, mc), np.uint8)
    for i, (lane, s) in enumerate(seeds):
        idx[i] = lane
        i32p[i, :8] = (s["sbase"], s["cd_size"], s["cd_sym"],
                       s["cd_size_sid"], s["pc"], s["sp"], s["msize"],
                       s["group"])
        i32p[i, 8:] = s["env_sid"]
        u32p[i, 0] = s["gas_limit"]
        u32p[i, 1:] = np.asarray(s["env"], np.uint32).reshape(-1)
        u8p[i] = np.asarray(s["calldata"], np.uint8)[:ccw]
        stack_v[i] = np.asarray(s["stack_v"], np.uint32)[:sd].reshape(-1)
        stack_s[i] = np.asarray(s["stack_s"], np.int32)[:sd]
        mem_v[i] = np.asarray(s["mem_v"], np.uint8)[:mc]
        mem_k[i] = np.asarray(s["mem_k"], np.uint8)[:mc]
    fs = np.zeros(n, np.int32)
    fs[:len(free)] = free
    pv = min(PROV_BUCKET, n * d_recs) if len(prov) <= PROV_BUCKET \
        else n * d_recs
    prov_pairs = np.full((pv, 2), n * d_recs, np.int32)
    for j, ((lane, slot), oid) in enumerate(prov.items()):
        prov_pairs[j] = (lane * d_recs + slot, oid)
    kl = np.full(n, n, np.int32)
    kl[:len(kill)] = kill
    r_idx = np.full(k, n, np.int32)
    r_i32 = np.zeros((k, 6), np.int32)
    r_limbs = np.zeros((k, NLIMBS), np.uint32)
    for i, (lane, pc, sp, msize, ming, maxg, sid, limbs) in enumerate(resumes):
        r_idx[i] = lane
        r_i32[i] = (pc, sp, msize, ming, maxg, sid)
        if limbs is not None:
            r_limbs[i] = limbs
    parts = [idx, i32p.reshape(-1), u32p.reshape(-1).view(np.int32), fs,
             np.array([len(free)], np.int32), prov_pairs.reshape(-1), kl,
             stack_v.reshape(-1).view(np.int32), stack_s.reshape(-1),
             r_idx, r_i32.reshape(-1), r_limbs.reshape(-1).view(np.int32)]
    i32buf = np.concatenate([np.ascontiguousarray(p, np.int32)
                             for p in parts])
    u8buf = np.concatenate([u8p.reshape(-1), mem_v.reshape(-1),
                            mem_k.reshape(-1)])
    return i32buf, u8buf, k, pv


# ---------------------------------------------------------------------------
# plain PyTorch versions of the window stages
# ---------------------------------------------------------------------------

def _lanes(st):
    return torch.arange(st.pc.shape[0], device=st.pc.device)


def _lookup(table, plane, d_recs):
    """Provisional sids (< 0) of ``plane`` -> table[(lane, slot)] (the
    JAX gather clamps the row); other sids unchanged."""
    n = table.shape[0]
    p = plane.long()
    negm = p < 0
    idx = torch.where(negm, -p - 1, 0)
    row = (idx // d_recs).clamp(max=n - 1)
    mapped = table[row, idx % d_recs]
    return torch.where(negm, mapped.to(plane.dtype), plane)


def _remap_reset_core(st: SymLaneState, prov_pairs) -> SymLaneState:
    d_recs = st.dlog_op.shape[1]
    n = st.pc.shape[0]
    dense = torch.full((n * d_recs,), _I32_MIN, dtype=torch.int32,
                       device=st.device)
    slot = prov_pairs[:, 0].long()
    ok = (slot >= 0) & (slot < n * d_recs)
    dense[slot[ok]] = prov_pairs[:, 1][ok]
    prov_arr = dense.reshape(n, d_recs)
    return st.replace(
        ssid=_lookup(prov_arr, st.ssid, d_recs),
        sval_sid=_lookup(prov_arr, st.sval_sid, d_recs),
        skey_sid=_lookup(prov_arr, st.skey_sid, d_recs),
        mlog_sid=_lookup(prov_arr, st.mlog_sid, d_recs),
        dlog_count=torch.zeros_like(st.dlog_count),
        flog_count=torch.zeros_like(st.flog_count),
    )


def _rows(idx, n):
    """Seed/resume row indices in range (padding holds n: dropped)."""
    keep = (idx >= 0) & (idx < n)
    return idx.long()[keep], keep


def _prologue_core(st: SymLaneState, idx, i32p, u32p, u8p, stack_v,
                   stack_s, mem_v, mem_k, fs, fcount) -> SymLaneState:
    n = st.pc.shape[0]
    n_env = st.env.shape[1]
    sd = stack_s.shape[1]
    mc = mem_v.shape[1]
    ccw = u8p.shape[1]
    r, keep = _rows(idx, n)
    i32p, u32p, u8p = i32p[keep], u32p[keep], u8p[keep]
    stack_v, stack_s, mem_v, mem_k = (stack_v[keep], stack_s[keep],
                                      mem_v[keep], mem_k[keep])

    def put(plane, vals):
        out = plane.clone()
        out[r] = vals.to(plane.dtype) if isinstance(vals, torch.Tensor) \
            else vals
        return out

    def put_prefix(plane, width, vals):
        out = plane.clone()
        out[r] = 0
        out[r, :width] = vals.to(plane.dtype)
        return out

    return st.replace(
        pc=put(st.pc, i32p[:, 4]), sp=put(st.sp, i32p[:, 5]),
        depth=put(st.depth, 0), group=put(st.group, i32p[:, 7]),
        ssid=put_prefix(st.ssid, sd, stack_s),
        stack=put_prefix(st.stack, sd, stack_v.reshape(-1, sd, NLIMBS)),
        memory=put_prefix(st.memory, mc, mem_v),
        mkind=put_prefix(st.mkind, mc, mem_k),
        msize=put(st.msize, i32p[:, 6]),
        mlog_count=put(st.mlog_count, 0), sval_sid=put(st.sval_sid, 0),
        s_written=put(st.s_written, 0), s_read=put(st.s_read, 0),
        skey_sid=put(st.skey_sid, 0), s_wstep=put(st.s_wstep, 0),
        s_mode=put(st.s_mode, 0), scount=put(st.scount, 0),
        skeys=put(st.skeys, 0), svals=put(st.svals, 0),
        min_gas=put(st.min_gas, 0), max_gas=put(st.max_gas, 0),
        steps=put(st.steps, 0), dlog_count=put(st.dlog_count, 0),
        fentry=put(st.fentry, -1), last_jump=put(st.last_jump, -1),
        status=put(st.status, Status.RUNNING),
        sbase=put(st.sbase, i32p[:, 0]),
        calldata=put_prefix(st.calldata, ccw, u8p),
        cd_size=put(st.cd_size, i32p[:, 1]),
        cd_sym=put(st.cd_sym, i32p[:, 2]),
        cd_size_sid=put(st.cd_size_sid, i32p[:, 3]),
        env=put(st.env, u32p[:, 1:].reshape(-1, n_env, NLIMBS)),
        env_sid=put(st.env_sid, i32p[:, 8:8 + n_env]),
        gas_limit=put(st.gas_limit, u32p[:, 0]),
        free_slots=fs.clone(), free_count=fcount.clone().reshape(()),
    )


def _hash_mix(h, f):
    """(h * 0x9E3779B1 + f) mod 2**32 on int64 values < 2**32."""
    lo = (h & 0xFFFF) * _HASH_MUL
    hi = ((h >> 16) * _HASH_MUL) & 0xFFFF
    return (lo + (hi << 16) + (f & _M32)) & _M32


def _dedup_canon(st: SymLaneState, d_recs: int):
    """Canonicalise this window's records (the JAX ``_dedup_canon``):
    rounds in global step order, a 4096-cell hash table with the lowest
    lane winning each cell. Returns (dlog_sid, canon_pid)."""
    n = st.pc.shape[0]
    dev = st.device
    lanes = _lanes(st)
    live_all = torch.arange(d_recs, device=dev)[None, :] \
        < st.dlog_count[:, None]
    canon = torch.zeros((n, d_recs), dtype=torch.int32, device=dev)
    dlog_sid = st.dlog_sid.clone()
    if not bool(live_all.any()):
        return dlog_sid, canon
    lo = int(st.dlog_step[live_all].min())
    hi = int(st.dlog_step[live_all].max())
    grp = st.group.long()
    vals_all = st.dlog_val.long() & _M32
    for s in range(lo, hi + 1):
        match = live_all & (st.dlog_step == s)
        has = match.any(dim=1)
        slot = match.to(torch.int32).argmax(dim=1)
        sids = _lookup(canon, dlog_sid[lanes, slot], d_recs)
        dlog_sid[lanes[has], slot[has]] = sids[has]
        op = st.dlog_op[lanes, slot].long()
        pc = st.dlog_pc[lanes, slot].long()
        fen = st.dlog_fentry[lanes, slot].long()
        vals = vals_all[lanes, slot].reshape(n, -1)
        sl = sids.long()
        h = torch.zeros(n, dtype=torch.int64, device=dev)
        for f in (grp, op, pc, fen, sl[:, 0], sl[:, 1], sl[:, 2]):
            h = _hash_mix(h, f)
        for c in range(vals.shape[1]):
            h = _hash_mix(h, vals[:, c])
        cand = has & (op != _SSTORE_BYTE) & (op != symstep.REC_SLOAD_RW)
        bucket = torch.where(cand, h % _DEDUP_H, _DEDUP_H)
        win = torch.full((_DEDUP_H,), _I32_MAX, dtype=torch.int64,
                         device=dev)
        win.scatter_reduce_(0, bucket[cand], lanes[cand], reduce="amin")
        w = win[bucket.clamp(0, _DEDUP_H - 1)].clamp(0, n - 1)
        eq = (cand & has[w] & (op == op[w]) & (pc == pc[w])
              & (fen == fen[w]) & (grp == grp[w])
              & (sl == sl[w]).all(dim=1) & (vals == vals[w]).all(dim=1))
        canon_lane = torch.where(eq, w, lanes)
        canon_slot = torch.where(eq, slot[w], slot).long()
        pid = -(canon_lane * d_recs + canon_slot + 1)
        canon[lanes[has], slot[has]] = pid[has].to(torch.int32)
    return dlog_sid, canon


def _canon_remap(st: SymLaneState, canon, d_recs: int) -> SymLaneState:
    return st.replace(
        ssid=_lookup(canon, st.ssid, d_recs),
        sval_sid=_lookup(canon, st.sval_sid, d_recs),
        skey_sid=_lookup(canon, st.skey_sid, d_recs),
        mlog_sid=_lookup(canon, st.mlog_sid, d_recs),
        flog_sid=_lookup(canon, st.flog_sid, d_recs),
    )


def _retire_widths(st, dstack, dmem, dmlog, dslot):
    return (min(dstack, st.stack.shape[1]), min(dmem, st.memory.shape[1]),
            min(dmlog, st.mlog_off.shape[1]), min(dslot, st.skeys.shape[1]))


def _retire_gather_core(st: SymLaneState, rc, dstack, dmem, dmlog, dslot):
    """Pack the rows of lanes rc into (i32, u32, u8), column-clipped."""
    ws, wm, wl, wk = _retire_widths(st, dstack, dmem, dmlog, dslot)
    k = rc.shape[0]
    rc = rc.long()
    i32 = torch.cat([
        torch.stack([st.pc[rc], st.sp[rc], st.depth[rc], st.fentry[rc],
                     st.last_jump[rc], st.msize[rc], st.mlog_count[rc],
                     st.scount[rc], st.min_gas[rc], st.max_gas[rc]], 1),
        st.mlog_off[rc, :wl], st.mlog_len[rc, :wl], st.mlog_sid[rc, :wl],
        st.ssid[rc, :ws], st.sval_sid[rc, :wk], st.s_written[rc, :wk],
        st.s_read[rc, :wk], st.skey_sid[rc, :wk], st.s_wstep[rc, :wk],
    ], dim=1)
    u32 = torch.cat([st.stack[rc, :ws].reshape(k, -1),
                     st.skeys[rc, :wk].reshape(k, -1),
                     st.svals[rc, :wk].reshape(k, -1)], dim=1)
    u8 = torch.cat([st.memory[rc, :wm], st.mkind[rc, :wm]], dim=1)
    return i32, u32, u8


def _resume_gather_core(st: SymLaneState, rc):
    rc = rc.long()
    d = st.stack.shape[1]
    top = (st.sp[rc] - 1).clamp(0, d - 1).long()
    sub = (st.sp[rc] - 2).clamp(0, d - 1).long()
    wl = min(RESUME_MLOG, st.mlog_off.shape[1])
    wm = min(RESUME_MEM, st.memory.shape[1])
    i32 = torch.cat([
        torch.stack([st.msize[rc], st.min_gas[rc], st.max_gas[rc],
                     st.gas_limit[rc], st.mlog_count[rc], st.ssid[rc, top],
                     st.ssid[rc, sub]], 1),
        st.mlog_off[rc, :wl], st.mlog_len[rc, :wl], st.mlog_sid[rc, :wl],
    ], dim=1)
    u32 = torch.cat([st.stack[rc, top], st.stack[rc, sub]], dim=1)
    u8 = torch.cat([st.memory[rc, :wm], st.mkind[rc, :wm]], dim=1)
    return i32, u32, u8


def _counts_core(st: SymLaneState):
    misc = torch.stack([st.dlog_count, st.status, st.steps, st.sp,
                        st.scount, st.mlog_count, st.msize, st.pc], dim=1)
    scal = torch.stack([st.flog_count, st.free_count])
    return misc, scal


def _first_indices(flag, cap, pad):
    """The first ``cap`` indices where flag is set, ascending, padded."""
    out = torch.full((cap,), pad, dtype=torch.int32, device=flag.device)
    idx = torch.nonzero(flag).reshape(-1)[:cap]
    out[:idx.shape[0]] = idx.to(torch.int32)
    return out


def _unique_table(st: SymLaneState, canon, d_recs: int, urb: int):
    n = st.pc.shape[0]
    dev = st.device
    live = torch.arange(d_recs, device=dev)[None, :] \
        < st.dlog_count[:, None]
    self_pid = -(_lanes(st)[:, None] * d_recs
                 + torch.arange(d_recs, device=dev)[None, :] + 1)
    is_canon = (live & (canon == self_pid)).reshape(-1)
    ucount = is_canon.sum().to(torch.int32)
    rows = _first_indices(is_canon, urb, 0).long()
    l, sl = rows // d_recs, rows % d_recs
    tab = torch.cat([
        torch.stack([l, sl], 1).to(torch.int32),
        torch.stack([st.dlog_op[l, sl], st.dlog_pc[l, sl],
                     st.dlog_step[l, sl], st.dlog_fentry[l, sl]], 1),
        st.dlog_sid[l, sl], st.dlog_val[l, sl].reshape(urb, 3 * NLIMBS),
    ], dim=1)
    return tab, ucount


def _fork_table(st: SymLaneState, fb: int):
    return torch.stack([
        st.flog_parent[:fb], st.flog_child[:fb], st.flog_step[:fb],
        st.flog_pc[:fb], st.flog_sid[:fb], st.flog_gmin[:fb],
        st.flog_gmax[:fb], st.flog_fentry[:fb], st.flog_dest[:fb]], dim=1)


def _select(st: SymLaneState, cc: CompiledCode, budget, resume_on):
    """(hold flags truncated to HOLD_CAP, retire-eligible flags)."""
    n = st.pc.shape[0]
    dstack, dmem, dmlog, dslot = RETIRE_FLOORS
    parked = (st.status == Status.NEEDS_HOST) | (
        (st.status == Status.RUNNING) & (st.steps >= budget))
    fits = ((st.sp <= dstack) & (st.msize <= dmem)
            & (st.mlog_count <= dmlog) & (st.scount <= dslot))
    op_at_pc = cc.opcode[st.pc.long().clamp(0, cc.packed.shape[0] - 1)]
    hold = ((int(resume_on) != 0) & (st.status == Status.NEEDS_HOST)
            & (op_at_pc == _SHA3_BYTE) & (st.sp >= 2)
            & (st.msize <= RESUME_MEM) & (st.mlog_count <= RESUME_MLOG))
    horder = torch.cumsum(hold.to(torch.int64), 0) - 1
    hold = hold & (horder < min(HOLD_CAP, n))
    return hold, parked & fits & ~hold


def prologue_plain(st: SymLaneState, i32buf, u8buf, k: int, pv: int):
    """Window stage 1 in plain PyTorch (K2's counterpart): remap the
    previous window's provisional sids and reset the logs, kill, apply
    SHA3 resumes, seed the k rows, refresh the free-slot stack."""
    n = st.pc.shape[0]
    n_depth = st.stack.shape[1]
    sd, mc, ccw = _seed_widths(st)
    a = _unpack_i32_sections(
        i32buf, _seed_sections(n, k, st.env.shape[1], sd, pv))
    u8p = u8buf[:k * ccw].reshape(k, ccw)
    mem_v = u8buf[k * ccw:k * (ccw + mc)].reshape(k, mc)
    mem_k = u8buf[k * (ccw + mc):k * (ccw + 2 * mc)].reshape(k, mc)

    st = _remap_reset_core(st, a["prov"])
    kl, _ = _rows(a["kill"], n)
    status = st.status.clone()
    status[kl] = DEAD
    st = st.replace(status=status)
    r, keep = _rows(a["r_idx"], n)
    ri = a["r_i32"][keep]
    slot = (ri[:, 1] - 1).clamp(0, n_depth - 1).long()
    planes = {f: getattr(st, f).clone() for f in (
        "pc", "sp", "msize", "min_gas", "max_gas", "ssid", "stack",
        "status")}
    planes["pc"][r] = ri[:, 0]
    planes["sp"][r] = ri[:, 1]
    planes["msize"][r] = ri[:, 2]
    planes["min_gas"][r] = ri[:, 3]
    planes["max_gas"][r] = ri[:, 4]
    planes["ssid"][r, slot] = ri[:, 5]
    planes["stack"][r, slot] = a["r_limbs"][keep]
    planes["status"][r] = Status.RUNNING
    st = st.replace(**planes)
    return _prologue_core(st, a["idx"], a["i32p"], a["u32p"], u8p,
                          a["stack_v"], a["stack_s"], mem_v, mem_k,
                          a["fs"], a["fcount"])


def dedup_plain(st: SymLaneState):
    """Window stage 3 in plain PyTorch (K3's counterpart): canonicalise
    the records and rewrite the persistent sid planes. Returns (state,
    canon_pid)."""
    d_recs = st.dlog_op.shape[1]
    dlog_sid, canon = _dedup_canon(st, d_recs)
    return _canon_remap(st.replace(dlog_sid=dlog_sid), canon, d_recs), canon


def epilogue_plain(st: SymLaneState, cc: CompiledCode, canon, budget: int,
                   resume_on):
    """Window stage 4 in plain PyTorch (K4's counterpart): hold and
    retire selection, row gathers, counters, unique-record and fork
    tables. Returns (state, outputs)."""
    n = st.pc.shape[0]
    d_recs = st.dlog_op.shape[1]
    rcap, hcap = min(RCAP, n), min(HOLD_CAP, n)
    hold, elig = _select(st, cc, budget, resume_on)
    hidx = _first_indices(hold, hcap, n)
    hrows = _resume_gather_core(st, hidx.clamp(0, n - 1))
    ridx = _first_indices(elig, rcap, n)
    rows = _retire_gather_core(st, ridx.clamp(0, n - 1), *RETIRE_FLOORS)
    status = st.status.clone()
    status[_rows(ridx, n)[0]] = DEAD
    st = st.replace(status=status)
    misc, scal = _counts_core(st)
    utab, ucount = _unique_table(st, canon, d_recs,
                                       min(URB, n * d_recs))
    ftab = _fork_table(st, min(FB, n))
    scal = torch.cat([scal, ucount.reshape(1)])
    return st, (misc, scal, utab, ftab, ridx) + rows + (hidx,) + hrows


def window_exec_plain(st: SymLaneState, cc: CompiledCode, i32buf, u8buf,
                      exec_table, taint_table, window: int, k: int,
                      budget: int, pv: int, visited, resume_on):
    """The whole window dispatch in plain PyTorch (the JAX
    ``_window_exec``). Returns (state, visited, outputs) with outputs
    (misc, scal, utab, ftab, ridx, r_i32, r_u32, r_u8, hidx, h_i32,
    h_u32, h_u8); u32 columns hold bit patterns."""
    st = prologue_plain(st, i32buf, u8buf, k, pv)
    st, visited = symstep.sym_run_plain(cc, st, window, exec_table,
                                        taint_table, visited)
    st, canon = dedup_plain(st)
    st, outs = epilogue_plain(st, cc, canon, budget, resume_on)
    return st, visited, outs


def retire_rows_plain(st: SymLaneState, ridx, dstack, dmem, dmlog, dslot):
    """Escalation retire (the JAX ``_retire_rows``): gather the lanes'
    rows and mark them DEAD; padding entries hold n."""
    n = st.pc.shape[0]
    rows = _retire_gather_core(st, ridx.clamp(0, n - 1), dstack, dmem,
                               dmlog, dslot)
    status = st.status.clone()
    status[_rows(ridx, n)[0]] = DEAD
    return st.replace(status=status), rows


def unique_table_big_plain(st: SymLaneState, urb: int):
    d_recs = st.dlog_op.shape[1]
    _, canon = _dedup_canon(st, d_recs)
    return _unique_table(st, canon, d_recs, urb)


def gather_full_flog_plain(st: SymLaneState):
    return _fork_table(st, st.flog_parent.shape[0])


# ---------------------------------------------------------------------------
# the kernels: csrc/window.cu
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_WINDOW_SIGS = {
    "window_prologue": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "window_dedup": [_P, _P, _P, _P, _I, _P],
    "window_epilogue": [_P, _P, _P, _I, _I, _I] + [_P] * 14
    + [_I, _I, _P, _P],
    "retire_rows": [_P, _P, _P, _I, _P, _P, _P, _P, _P],
    "unique_table": [_P, _P, _P, _I, _P, _P, _P, _P],
    "fork_table": [_P, _P, _I, _P, _P],
}


def _kw():
    from .. import _build

    return _build, _build.lib("window.cu", _WINDOW_SIGS)


def prologue_kernel(st, i32buf, u8buf, k, pv):
    """K2 on the card; updates the state's planes in place."""
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    sd, mc, ccw = _seed_widths(st)
    offs, total = _section_offsets(
        _seed_sections(n, k, st.env.shape[1], sd, pv))
    if i32buf.numel() != total or u8buf.numel() != k * (ccw + 2 * mc):
        raise ValueError("seed buffers do not match the seed sections")
    _build.need_cuda(i32buf, torch.int32, "i32buf")
    _build.need_cuda(u8buf, torch.uint8, "u8buf")
    order = list(offs.values())  # section order
    dense = torch.empty(n * d_recs, dtype=torch.int32, device=st.device)
    rc = lib.window_prologue(planes, dims, _build.ptr(i32buf),
                             _build.ptr(u8buf), _build.int_array(order), k,
                             pv, sd, mc, ccw, _build.ptr(dense),
                             _build.stream(st.device))
    _build.LAUNCHES["window_prologue"] += 1
    _build.check(lib, rc, "window_prologue")


def dedup_kernel(st: SymLaneState, write_sids: bool = True):
    """K3: the record dedup, and (write_sids) the dlog_sid rewrite plus
    the canonical remap of the persistent planes. Returns canon_pid."""
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    canon = torch.empty((n, d_recs), dtype=torch.int32, device=st.device)
    scratch = torch.empty(2 * _DEDUP_H + 6 * n + 4, dtype=torch.int32,
                          device=st.device)
    rc = lib.window_dedup(planes, dims, _build.ptr(canon),
                          _build.ptr(scratch), int(write_sids),
                          _build.stream(st.device))
    _build.LAUNCHES["window_dedup"] += 1
    _build.check(lib, rc, "window_dedup")
    return canon


def _row_outputs(st, k, dstack, dmem, dmlog, dslot):
    ws, wm, wl, wk = _retire_widths(st, dstack, dmem, dmlog, dslot)
    dev = st.device
    return (torch.empty((k, 10 + 3 * wl + ws + 5 * wk), dtype=torch.int32,
                        device=dev),
            torch.empty((k, NLIMBS * (ws + 2 * wk)), dtype=torch.int32,
                        device=dev),
            torch.empty((k, 2 * wm), dtype=torch.uint8, device=dev))


def epilogue_kernel(st, cc, canon, budget, resume_on):
    """K4 on the card; marks retired lanes DEAD in place and returns
    the outputs."""
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    dev = st.device
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    rcap, hcap = min(RCAP, n), min(HOLD_CAP, n)
    urb, fb = min(URB, n * d_recs), min(FB, n)
    wl = min(RESUME_MLOG, st.mlog_off.shape[1])
    wm = min(RESUME_MEM, st.memory.shape[1])

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    misc, scal, utab, ftab = i32(n, 8), i32(3), i32(urb, 3 * NLIMBS + 9), \
        i32(fb, 9)
    ridx, hidx = i32(rcap), i32(hcap)
    rows = _row_outputs(st, rcap, *RETIRE_FLOORS)
    hrows = (i32(hcap, 7 + 3 * wl), i32(hcap, 2 * NLIMBS),
             torch.empty((hcap, 2 * wm), dtype=torch.uint8, device=dev))
    scratch = i32(3 * n + n * d_recs + urb + (n * d_recs + 255) // 256 + 16)
    packed = cc.packed.contiguous()
    _build.need_cuda(packed, torch.int32, "code.packed")
    _build.need_cuda(canon, torch.int32, "canon")
    rc = lib.window_epilogue(
        planes, dims, _build.ptr(packed), packed.shape[0], int(budget),
        int(resume_on), _build.ptr(canon), _build.ptr(misc),
        _build.ptr(scal), _build.ptr(utab), _build.ptr(ftab),
        _build.ptr(ridx), *[_build.ptr(x) for x in rows], _build.ptr(hidx),
        *[_build.ptr(x) for x in hrows], _build.int_array(RETIRE_FLOORS),
        urb, fb, _build.ptr(scratch), _build.stream(dev))
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "window_epilogue")
    return (misc, scal, utab, ftab, ridx) + rows + (hidx,) + hrows


def window_exec_kernel(st: SymLaneState, cc: CompiledCode, i32buf, u8buf,
                       exec_table, taint_table, window: int, k: int,
                       budget: int, pv: int, visited, resume_on):
    """``window_exec`` on the card: K2, K1, K3, K4. Updates the state's
    planes in place (the JAX dispatch donates its state)."""
    prologue_kernel(st, i32buf, u8buf, k, pv)
    st, visited = symstep.sym_run_kernel(cc, st, window, exec_table,
                                         taint_table, visited)
    canon = dedup_kernel(st, write_sids=True)
    outs = epilogue_kernel(st, cc, canon, budget, resume_on)
    return st, visited, outs


def window_exec(st: SymLaneState, cc: CompiledCode, i32buf, u8buf,
                exec_table, taint_table, window: int, k: int, budget: int,
                pv: int, visited, resume_on):
    """One window dispatch: the plain version for a CPU state, the
    kernels for a CUDA state."""
    fn = window_exec_plain if st.device.type == "cpu" \
        else window_exec_kernel
    return fn(st, cc, i32buf, u8buf, exec_table, taint_table, window, k,
              budget, pv, visited, resume_on)


def _retire_rows_kernel(st, ridx, dstack, dmem, dmlog, dslot):
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    ridx = ridx.contiguous()
    _build.need_cuda(ridx, torch.int32, "ridx")
    rows = _row_outputs(st, ridx.shape[0], dstack, dmem, dmlog, dslot)
    rc = lib.retire_rows(planes, dims, _build.ptr(ridx), ridx.shape[0],
                         _build.int_array((dstack, dmem, dmlog, dslot)),
                         *[_build.ptr(x) for x in rows],
                         _build.stream(st.device))
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "retire_rows")
    return st, rows


def _retire_rows(st, ridx, dstack, dmem, dmlog, dslot):
    fn = retire_rows_plain if st.device.type == "cpu" \
        else _retire_rows_kernel
    return fn(st, ridx, dstack, dmem, dmlog, dslot)


def _unique_table_big(st: SymLaneState, urb: int):
    if st.device.type == "cpu":
        return unique_table_big_plain(st, urb)
    canon = dedup_kernel(st, write_sids=False)
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    tab = torch.empty((urb, 3 * NLIMBS + 9), dtype=torch.int32,
                      device=st.device)
    count = torch.empty(1, dtype=torch.int32, device=st.device)
    scratch = torch.empty(n * d_recs + urb + (n * d_recs + 255) // 256 + 8,
                          dtype=torch.int32, device=st.device)
    rc = lib.unique_table(planes, dims, _build.ptr(canon), urb,
                          _build.ptr(tab), _build.ptr(count),
                          _build.ptr(scratch), _build.stream(st.device))
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "unique_table")
    return tab, count[0]


def _gather_full_flog(st: SymLaneState):
    if st.device.type == "cpu":
        return gather_full_flog_plain(st)
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    fb = st.flog_parent.shape[0]
    tab = torch.empty((fb, 9), dtype=torch.int32, device=st.device)
    rc = lib.fork_table(planes, dims, fb, _build.ptr(tab),
                        _build.stream(st.device))
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "fork_table")
    return tab


#: the plain versions, for running the engine's loop without kernels on
#: the card (chip_smoke.py's comparison)
PLAIN = {"window_exec": window_exec_plain,
         "retire_rows": retire_rows_plain,
         "unique_table_big": unique_table_big_plain,
         "gather_full_flog": gather_full_flog_plain}
DISPATCH = {"window_exec": window_exec, "retire_rows": _retire_rows,
            "unique_table_big": _unique_table_big,
            "gather_full_flog": _gather_full_flog}


# ---------------------------------------------------------------------------
# the engine shell
# ---------------------------------------------------------------------------

class ObjectTable:
    """Object ids of the drained records: each unique-table row gets the
    next oid (ids start at 1; 0 means concrete). Slice 2 stores the
    record's SMT term here; this slice stores the row itself."""

    def __init__(self):
        self._objs: List = [None]

    def add(self, obj) -> int:
        self._objs.append(obj)
        return len(self._objs) - 1

    def __getitem__(self, sid: int):
        if sid <= 0:
            raise IndexError(f"unresolved/invalid sid {sid}")
        return self._objs[sid]

    def __len__(self):
        return len(self._objs)


class LaneEngine:
    """Owns one lane batch and object table for one contract's
    exploration: the window loop of the JAX engine, up to the host
    drain (see the module docstring)."""

    def __init__(self, n_lanes: int = 256, window: Optional[int] = None,
                 step_budget: int = DEFAULT_STEP_BUDGET, device=None,
                 plain: bool = False, **lane_kwargs):
        """``plain`` runs the plain PyTorch versions even on the card
        (the reference the kernels are held against)."""
        self.n_lanes = n_lanes
        self.window = DEFAULT_WINDOW if window is None else window
        self.step_budget = step_budget
        self.device = resolve(device)
        self.lane_kwargs = lane_kwargs
        self.plain = plain
        self.ops = PLAIN if plain else DISPATCH
        self.exec_table = symstep.SYM_EXECUTABLE.copy()
        self.taint_table = np.zeros(256, bool)
        self.resume_on = 0
        self.objects = ObjectTable()
        self._prov: Dict[Tuple[int, int], int] = {}
        self.stats = {"seeded": 0, "windows": 0, "forks": 0, "records": 0,
                      "retired": 0, "fast_retired": 0, "device_steps": 0,
                      "records_escalated": 0, "forks_escalated": 0}

    def _acquire_state(self) -> SymLaneState:
        return symstep.init_sym_lanes(self.n_lanes, device=self.device,
                                      plain=self.plain, **self.lane_kwargs)

    def _retire_floors(self, counts, lanes_sel):
        lk = self.lane_kwargs
        sel = np.asarray(lanes_sel, np.int64)
        return (
            _geo_bucket(max(int(counts["sp"][sel].max()), 1),
                        lk.get("stack_depth", 64), 8),
            _geo_bucket(max(int(counts["msize"][sel].max()), 1),
                        lk.get("memory_bytes", 4096), 64),
            _geo_bucket(max(int(counts["mlog_count"][sel].max()), 1),
                        lk.get("mem_records", 64), 8),
            _geo_bucket(max(int(counts["scount"][sel].max()), 1),
                        lk.get("storage_slots", 64), 8),
        )

    def _retire_chunked(self, st, lanes_sel, counts):
        """Escalation retire in chunks of at most RETIRE_CHUNK rows,
        each padded to a power-of-two bucket. Returns (st, [(lanes,
        floors, host rows)])."""
        cap = min(RETIRE_CHUNK, self.n_lanes)
        chunks = []
        for i in range(0, len(lanes_sel), RETIRE_CHUNK):
            part = list(lanes_sel[i:i + RETIRE_CHUNK])
            floors = self._retire_floors(counts, part)
            kp = _geo_bucket(len(part), cap, min(64, cap))
            idx = np.full(kp, self.n_lanes, np.int32)
            idx[:len(part)] = part
            st, rows = self.ops["retire_rows"](
                st, torch.from_numpy(idx).to(self.device), *floors)
            chunks.append((part, floors, [x.cpu().numpy() for x in rows]))
        return st, chunks

    def explore(self, code_bytes: bytes, seeds, func_entries=()) -> dict:
        """Run seeds (raw seed dicts, see ``pack_window``) of one
        contract until no lane is RUNNING. Returns {"windows": [per
        window: outputs, records, forks, retired chunks], "paths": lanes
        retired, "forks": forks made, "records": unique records}."""
        n = self.n_lanes
        cc = compile_code(code_bytes, func_entries, device=self.device)
        visited = torch.zeros(cc.packed.shape[0], dtype=torch.bool,
                              device=self.device)
        st = self._acquire_state()
        d_recs = self.lane_kwargs.get("dlog_records", 64)
        calldata_cap = int(st.calldata.shape[1])
        queue = deque(seeds)
        free = list(range(n - 1, -1, -1))
        small = min(16, n)
        windows = []
        while True:
            seed_cap = n if len(queue) > small else small
            entries = []
            while queue and free and len(entries) < seed_cap:
                entries.append((free.pop(), queue.popleft()))
            i32b, u8b, k, pv = pack_window(
                n, symstep.N_ENV, self.lane_kwargs, entries, free, [],
                self._prov, calldata_cap, big=seed_cap > small)
            self.stats["seeded"] += len(entries)
            n_free_written = len(free)
            st, visited, out = self.ops["window_exec"](
                st, cc, torch.from_numpy(i32b).to(self.device),
                torch.from_numpy(u8b).to(self.device), self.exec_table,
                self.taint_table, self.window, k, self.step_budget, pv,
                visited, self.resume_on)
            outs = [x.cpu().numpy() for x in out]
            misc, scal, utab, ftab, ridx = outs[:5]
            self.stats["windows"] += 1
            counts = {"dlog_count": misc[:, 0], "status": misc[:, 1],
                      "steps": misc[:, 2], "sp": misc[:, 3],
                      "scount": misc[:, 4], "mlog_count": misc[:, 5],
                      "msize": misc[:, 6], "pc": misc[:, 7]}
            nf, free_count, ucount = (int(x) for x in scal)
            if ucount > utab.shape[0]:
                urb_big = utab.shape[0]
                cap = n * d_recs
                while urb_big < ucount and urb_big < cap:
                    urb_big *= 2
                urb_big = min(urb_big, cap)
                tab, uc2 = self.ops["unique_table_big"](st, urb_big)
                utab, ucount = tab.cpu().numpy(), int(uc2)
                self.stats["records_escalated"] += 1
            if nf > ftab.shape[0]:
                ftab = self.ops["gather_full_flog"](st).cpu().numpy()
                self.stats["forks_escalated"] += 1
            records, forks = utab[:ucount], ftab[:nf]
            status = counts["status"].copy()
            steps = counts["steps"]
            consumed = n_free_written - free_count
            if consumed:
                free = free[:n_free_written - consumed]
            fast = [int(x) for x in ridx if x < n]
            runaway = (status == Status.RUNNING) & (steps >= self.step_budget)
            rest = np.nonzero((status == Status.NEEDS_HOST) | runaway)[0]
            chunks = []
            if len(rest):
                st, chunks = self._retire_chunked(st, rest.tolist(), counts)
            # the host drain's device-facing duty: every canonical record
            # gets an object id, resolved into the planes at the next
            # window's remap
            self._prov = {}
            for row in records:
                self._prov[(int(row[0]), int(row[1]))] = \
                    self.objects.add(row.copy())
            for lane in fast:
                self.stats["device_steps"] += int(steps[lane])
                free.append(lane)
            for part, _, _ in chunks:
                for lane in part:
                    self.stats["device_steps"] += int(steps[lane])
                    free.append(lane)
                status[np.asarray(part, np.int64)] = DEAD
            self.stats["forks"] += nf
            self.stats["records"] += ucount
            self.stats["fast_retired"] += len(fast)
            self.stats["retired"] += len(fast) + len(rest)
            windows.append({"outs": outs, "records": records,
                            "forks": forks, "retired": chunks})
            if not int(np.sum(status == Status.RUNNING)) and not queue:
                break
        return {"windows": windows, "paths": self.stats["retired"],
                "forks": self.stats["forks"],
                "records": self.stats["records"],
                "visited": visited.cpu().numpy()[:cc.size]}


#: env slots a fresh symbolic transaction entry carries as symbols (the
#: rest are concrete): the sender and origin, the call value, and the
#: block fields the interpreter leaves symbolic
_SYMBOLIC_ENV = ("ORIGIN", "CALLER", "CALLVALUE", "COINBASE", "TIMESTAMP",
                 "NUMBER", "DIFFICULTY", "SELFBALANCE")


#: gas limit and account address of a fresh transaction entry
_TX_GAS_LIMIT = 8_000_000
_TX_ADDRESS = 0xDEADBEEF


def tx_entry_seed(objects: ObjectTable, group: int, calldata_cap: int):
    """A raw seed dict (see ``pack_window``) of a fresh transaction
    entry: pc 0, empty stack and memory, symbolic calldata of symbolic
    size, symbolic sender/value/block fields, zero-array storage. Each
    symbol gets an object id from ``objects``."""
    from ..ops.stepper import ENV_SLOTS
    from ..ops.bv256 import int_to_limbs

    env = np.zeros((symstep.N_ENV, NLIMBS), np.uint32)
    env_sid = np.zeros(symstep.N_ENV, np.int32)
    for name, slot in ENV_SLOTS.items():
        if name in _SYMBOLIC_ENV:
            env_sid[slot] = objects.add(("env", name))
    env[ENV_SLOTS["ADDRESS"]] = int_to_limbs(_TX_ADDRESS)
    env[ENV_SLOTS["GASLIMIT"]] = int_to_limbs(_TX_GAS_LIMIT)
    env[ENV_SLOTS["CHAINID"]] = int_to_limbs(1)
    return dict(
        group=group, sbase=0, calldata=np.zeros(calldata_cap, np.uint8),
        cd_size=0, cd_sym=1, cd_size_sid=objects.add(("calldatasize",)),
        env=env, env_sid=env_sid, gas_limit=_TX_GAS_LIMIT, pc=0, sp=0,
        msize=0,
        stack_v=np.zeros((SEED_STACK, NLIMBS), np.uint32),
        stack_s=np.zeros(SEED_STACK, np.int32),
        mem_v=np.zeros(SEED_MEM, np.uint8), mem_k=np.zeros(SEED_MEM, np.uint8),
    )
