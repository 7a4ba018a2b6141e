"""Lane engine: the symbolic lane stepper's window dispatch on the card,
and the host bridge that feeds it from ``GlobalState``s and hands its
parked lanes back to the interpreter.

The counterpart of ``mythril_tpu/laser/lane_engine.py``, in two halves.

The device half: the packed seed buffers (``_seed_sections``,
``pack_window``), the window dispatch ``window_exec`` (the JAX
``_window_exec``: remap and reset, kill, resume, seed; ``sym_run``;
record dedup and canonical remap; hold and retire selection; counters,
unique-record and fork tables), its escalations ``_retire_rows``,
``_unique_table_big`` and ``_gather_full_flog``, and the window-merge
fingerprint ``merge_fingerprint``. Each has a plain PyTorch version
(the ``*_plain`` functions, used for CPU tensors and as the comparison
on the card) and, for CUDA tensors, kernels: K2 ``window_prologue``,
K3 ``window_dedup``, K4 ``window_epilogue`` (whose gathers also serve
the three escalations) in ``csrc/window.cu``, K9 in ``csrc/merge.cu``.
``support/device_loop.py`` runs that half alone on raw seed dicts.

The host half, ported from the JAX engine's (parity contract below):
``LaneEngine`` seeds device lanes from host ``GlobalState``s at
transaction entry (and mid-path, the spill/refill path), runs windows,
drains the device's deferred-op, path-condition and fork logs into
facade terms, screens forks, merges twin lanes at window boundaries,
resumes SHA3-parked lanes in place, and materializes parked lanes as
``GlobalState``s positioned at the instruction the device could not
execute. The host engine (svm.py) remains the semantic authority:
CALL/CREATE/SHA3/terminal opcodes and every detector hook run host-side
on the materialized states.

Parity contract (why this cannot diverge from the interpreter):
- deferred ALU records resolve through laser/alu.py — the same
  functions the instruction handlers call;
- CALLDATALOAD resolves through the transaction's own calldata object
  (state/calldata.py get_word_at), SLOAD through the same
  select+simplify the Storage class performs (state/account.py);
- JUMPI conditions build exactly the condi/negated pair of the jumpi_
  handler (instructions.py), including trivial-falsity pruning;
- materialized memory reproduces the byte-granular int/Extract layout
  of state/memory.py write_word_at;
- gas is the device's [min,max] interval added onto the seed state's
  counters, matching StateTransition accumulation.

The object table maps device sids (>0) to facade BitVec/Bool wrappers.
Provisional (negative) sids minted on device encode (lane, record-slot)
and are rewritten to table ids at each drain.

Unlike the JAX engine, nothing here falls back to the host: a kernel or
device call that fails raises to the caller. Cross-tenant wave packing
(``explore_packed``) is ported, and so is the meshed engine
(``LaneEngine(mesh=...)``, chosen by ``pick_mesh`` under
``args.tpu_mesh`` as the JAX engine chooses it): the lane planes live a
shard a device (``parallel/mesh.SymShards``) and every window runs its
phases a shard (``window_exec_mesh``: K2 and K1's phases a shard, K3
and K4 over the small planes gathered at the mesh's first device, K3's
remap a shard, K4's rows a device; K9 a shard), with the same outputs
as the JAX engine's window under GSPMD; a packed wave does not shard. Not
ported: the XLA compile warm-up (``warm_variant``) and the
kernel-fault capacity autoprobe.
"""

import ctypes
import functools
import logging
import os
import threading
import time
from collections import deque
from collections.abc import Sequence
from contextlib import contextmanager
from copy import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import bv256, symstep
from ..ops.bv256 import NLIMBS
from ..ops.stepper import CompiledCode, Status, compile_code
from ..ops.symstep import DEAD, SymLaneState
from ..parallel.mesh import _on
from ..smt import (
    BitVec, Bool, Concat, Extract, If, Not, simplify, symbol_factory,
)
from ..smt import terms as T
from ..support.devices import resolve
from ..support.opcodes import ADDRESS, OPCODES
from ..support.telemetry import trace
from . import alu
from .state.calldata import ConcreteCalldata
from .state.global_state import GlobalState

log = logging.getLogger(__name__)

_OPN = {data[ADDRESS]: name for name, data in OPCODES.items()}

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
                calldata_cap, big=False, resumes=(), meshed=False):
    """The two flat host buffers (i32, u8) of one window dispatch, as
    the JAX engine's ``_pack_window`` packs them, from raw seed dicts
    (the form ``_seed_spec`` returns: group, sbase, calldata, cd_size,
    cd_sym, cd_size_sid, env, env_sid, gas_limit, pc, sp, msize, stack_v,
    stack_s, mem_v, mem_k). ``seeds`` is [(lane, seed dict)], ``prov``
    {(lane, slot): oid}. A ``meshed`` engine's full bucket stays below
    the plane width, as the JAX engine's does under a mesh. Returns
    (i32buf, u8buf, k, pv) as numpy."""
    n_depth = lane_kwargs.get("stack_depth", 64)
    mem_cap = lane_kwargs.get("memory_bytes", 4096)
    d_recs = lane_kwargs.get("dlog_records", 64)
    sd = min(SEED_STACK, n_depth)
    mc = min(SEED_MEM, mem_cap)
    ccw = min(SEED_CD, calldata_cap)
    k = n if big else min(16, n)
    if meshed and k >= n and n > 1:
        k = max(n // 2, 1)
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


def prov_table(st: SymLaneState, prov_pairs, n=None):
    """The dense (lane, record slot) -> oid table of the sparse
    resolution pairs (int32 min where none), as the JAX
    ``.at[slot].set(oid, mode="drop")`` builds it: a negative slot
    counts from the end, a slot out of range either way is dropped, and
    of the pairs naming one slot the last wins. ``n``: the lanes of the
    batch the slots index (the state's, or a meshed batch's for one of
    its shards)."""
    d_recs = st.dlog_op.shape[1]
    n = st.pc.shape[0] if n is None else n
    size = n * d_recs
    dense = torch.full((size,), _I32_MIN, dtype=torch.int32,
                       device=st.device)
    slot = prov_pairs[:, 0].long()
    slot = torch.where(slot < 0, slot + size, slot)
    ok = (slot >= 0) & (slot < size)
    last = torch.full((size,), -1, dtype=torch.int64, device=st.device)
    last.scatter_reduce_(0, slot[ok], torch.nonzero(ok).reshape(-1),
                         reduce="amax")
    has = last >= 0
    dense[has] = prov_pairs[:, 1][last[has]]
    return dense.reshape(n, d_recs)


def _remap_reset_core(st: SymLaneState, prov_pairs, n=None) -> SymLaneState:
    d_recs = st.dlog_op.shape[1]
    prov_arr = prov_table(st, prov_pairs, n)
    return st.replace(
        ssid=_lookup(prov_arr, st.ssid, d_recs),
        sval_sid=_lookup(prov_arr, st.sval_sid, d_recs),
        skey_sid=_lookup(prov_arr, st.skey_sid, d_recs),
        mlog_sid=_lookup(prov_arr, st.mlog_sid, d_recs),
        dlog_count=torch.zeros_like(st.dlog_count),
        flog_count=torch.zeros_like(st.flog_count),
    )


def _rows(idx, n):
    """The rows a JAX ``.at[idx].set(..., mode="drop")`` writes: a
    negative index counts from the end, one out of range either way
    (the padding, n) is dropped. Returns (rows, mask of the entries
    kept); where two entries name one element, the later is written
    last, as JAX's scatter leaves it."""
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    keep = (i >= 0) & (i < n)
    return i[keep], keep


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


def prologue_plain(st: SymLaneState, i32buf, u8buf, k: int, pv: int,
                   gn=None):
    """Window stage 1 in plain PyTorch (K2's counterpart): remap the
    previous window's provisional sids and reset the logs, kill, apply
    SHA3 resumes, seed the k rows, refresh the free-slot stack. ``gn``:
    the lanes the provisional slots index where ``st`` is a shard of a
    meshed batch."""
    n = st.pc.shape[0]
    n_depth = st.stack.shape[1]
    sd, mc, ccw = _seed_widths(st)
    a = _unpack_i32_sections(
        i32buf, _seed_sections(n, k, st.env.shape[1], sd, pv))
    u8p = u8buf[:k * ccw].reshape(k, ccw)
    mem_v = u8buf[k * ccw:k * (ccw + mc)].reshape(k, mc)
    mem_k = u8buf[k * (ccw + mc):k * (ccw + 2 * mc)].reshape(k, mc)

    st = _remap_reset_core(st, a["prov"], gn)
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
_U = ctypes.c_uint
_WINDOW_SIGS = {
    "window_prologue_shape": [_I, _I, _P],
    "window_prologue": [_P, _P, _P, _P, _P, _U, _P, _P],
    "window_dedup": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "window_dedup_shape": [_I, _P],
    "window_epilogue_shape": [_I, _P],
    "window_epilogue": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "retire_rows": [_P, _P, _P, _I, _P, _P, _P, _P, _P],
    "unique_table": [_P, _P, _P, _I, _P, _P, _P, _P, _P],
    "fork_table": [_P, _I, _P, _P],
    "window_mesh_remap": [_P, _P, _I, _P, _P, _I, _P],
    "window_sym_bytes": [],
    "window_mesh_table": [_P, _I, _P, _P],
    "window_mesh_rows": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P],
}


_WINDOW_LIB = []


def _kw():
    """(``_build``, the loaded ``csrc/window.cu`` library), the library
    bound at the first call."""
    if not _WINDOW_LIB:
        from .. import _build

        _WINDOW_LIB.extend((_build, _build.lib("window.cu", _WINDOW_SIGS)))
    return _WINDOW_LIB[0], _WINDOW_LIB[1]


#: K2's and K4's launch shapes ({kernel: {key: shape}}, see
#: ``window_shape``)
_WIN_SHAPES = {"prologue": {}, "epilogue": {}}
#: K2's and K4's argument blocks by call shape (``_k2_plan``,
#: ``_k4_plan``)
_WIN_PLANS = {}
#: scratch by (kernel, device, stream, layout): [tensor, K2's last epoch,
#: lock]; K2's is zeroed once, when it is allocated
_WIN_SCRATCH = {}
_WIN_LOCK = threading.Lock()
#: ``csrc/window.cu`` PROV_LOCAL: past it K2's provisional table is dense
_K2_PROV_LOCAL = 4096


def window_shape(kernel: str, n: int, dev: torch.device, nbytes=0):
    """K2's (``kernel`` "prologue", its sid planes and seed rows
    ``nbytes``) or K4's ("epilogue") launch shape over ``n`` lanes on
    ``dev``
    (``csrc/window.cu`` ``window_prologue_shape``,
    ``window_epilogue_shape``): (blocks, threads a block, mode: 0 one
    block, 1 a cooperative grid[, lanes a thread for K4]). Raises where
    the card cannot launch the one the batch needs."""
    shapes = _WIN_SHAPES[kernel]
    key = (n, nbytes, dev.index)
    if key not in shapes:
        _build, lib = _kw()
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            rc = lib.window_prologue_shape(n, nbytes, out) \
                if kernel == "prologue" else lib.window_epilogue_shape(n, out)
        _build.check(lib, rc, f"window_{kernel}_shape (a wide batch needs "
                     "a cooperative launch)")
        shapes[key] = tuple(out)[:3 if kernel == "prologue" else 4]
    return shapes[key]


def _scratch(kernel, dev, stream, layout, nbytes):
    """[tensor of at least nbytes, epoch, lock] of ``kernel`` on dev's
    ``stream`` (a raw handle) for this layout: K2's zeroed at its
    allocation, its epoch the number of K2 calls on it (each call's
    table entries carry it, so none has to clear them); None for no
    bytes."""
    if not nbytes:
        return None
    key = (kernel, dev.index, stream, layout)
    hit = _WIN_SCRATCH.get(key)
    if hit is not None and hit[0].numel() >= nbytes:
        return hit
    with _WIN_LOCK:
        hit = _WIN_SCRATCH.get(key)
        if hit is None or hit[0].numel() < nbytes:
            buf = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
            hit = _WIN_SCRATCH[key] = [buf, hit[1] if hit else 0,
                                       threading.Lock()]
        return hit


def _k2_bytes(st, k):
    """K2's sid planes and the rows k seeds write (what decides its
    launch shape)."""
    d, m, c, s_, e, mr = (st.stack.shape[1], st.memory.shape[1],
                          st.calldata.shape[1], st.skeys.shape[1],
                          st.env.shape[1], st.mlog_off.shape[1])
    return 4 * st.pc.shape[0] * (d + 2 * s_ + mr) \
        + k * (36 * d + 2 * m + c + 36 * e + 84 * s_)


def _k2_plan(st, k, pv, shape, gn=0):
    """K2's argument block for these planes, k seeds and pv pairs (over
    a batch of ``gn`` lanes, 0: the state's): (C int array, scratch
    bytes, i32 buffer length, u8 buffer length)."""
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    key = ("prologue", n, d_recs, st.stack.shape[1], st.memory.shape[1],
           st.calldata.shape[1], st.skeys.shape[1], st.env.shape[1],
           st.mlog_off.shape[1], k, pv, st.device.index, shape, gn)
    plan = _WIN_PLANS.get(key)
    if plan is None:
        from .. import _build

        sd, mc, ccw = _seed_widths(st)
        offs, total = _section_offsets(
            _seed_sections(n, k, st.env.shape[1], sd, pv))
        blocks, threads, mode = shape or window_shape(
            "prologue", n, st.device, _k2_bytes(st, k))
        dense = 8 * (gn or n) * d_recs if pv > _K2_PROV_LOCAL else 0
        scratch = dense + (20 * n if mode == 1 else 0)
        plan = _WIN_PLANS[key] = (
            _build.int_array([blocks, threads, mode, k, pv, sd, mc, ccw]
                             + list(offs.values()) + [gn]),
            scratch, total, k * (ccw + 2 * mc),
            (n, gn, d_recs, bool(dense)))
    return plan


def prologue_kernel(st, i32buf, u8buf, k, pv, shape=None, gn=0):
    """K2 on the card, one launch that does not wait on the card;
    updates the state's planes in place. ``shape`` (blocks, threads,
    mode) overrides ``window_shape``'s; ``gn``: the lanes the
    provisional slots index where ``st`` is a shard of a meshed
    batch."""
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    args, nscratch, total, nu8, layout = _k2_plan(st, k, pv, shape, gn)
    if i32buf.numel() != total or u8buf.numel() != nu8:
        raise ValueError("seed buffers do not match the seed sections")
    for buf, dtype, name in ((i32buf, torch.int32, "i32buf"),
                             (u8buf, torch.uint8, "u8buf")):
        if not (buf.is_cuda and buf.dtype is dtype and buf.is_contiguous()):
            _build.need_cuda(buf, dtype, name)
    dev = st.device
    stream = _build.stream(dev)
    scratch = _scratch("prologue", dev, stream.value, layout, nscratch)
    if scratch is None:
        rc = lib.window_prologue(planes, dims, i32buf.data_ptr(),
                                 u8buf.data_ptr(), args, 1, None, stream)
    else:
        with scratch[2]:  # epochs reach the stream in their order
            scratch[1] += 1
            rc = lib.window_prologue(planes, dims, i32buf.data_ptr(),
                                     u8buf.data_ptr(), args, scratch[1],
                                     scratch[0].data_ptr(), stream)
    _build.LAUNCHES["window_prologue"] += 1
    _build.check(lib, rc, "window_prologue")


#: the planes K3 reads and writes, in ``csrc/window.cu`` ``DedupPlanes``
#: order
_DEDUP_PLANES = ("dlog_count", "dlog_step", "dlog_op", "dlog_pc",
                 "dlog_fentry", "group", "dlog_sid", "dlog_val", "ssid",
                 "sval_sid", "skey_sid", "mlog_sid", "flog_sid")
#: K3's launch shape by (lanes, device): (blocks, threads a block, mode:
#: 0 one block, 1 a cooperative grid)
_DEDUP_SHAPES = {}


def dedup_shape(n: int, dev: torch.device):
    """K3's launch shape over ``n`` lanes on ``dev`` (``csrc/window.cu``
    ``window_dedup_shape``): (blocks, threads a block, mode), one block
    or a cooperative grid by the batch's width. Raises where the card
    cannot launch the one the batch needs."""
    key = (n, dev.index)
    if key not in _DEDUP_SHAPES:
        _build, lib = _kw()
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            rc = lib.window_dedup_shape(n, out)
        _build.check(lib, rc, "window_dedup_shape (a wide batch needs a "
                     "cooperative launch)")
        _DEDUP_SHAPES[key] = tuple(out)
    return _DEDUP_SHAPES[key]


def dedup_kernel(st: SymLaneState, write_sids: bool = True, shape=None,
                 phases=None):
    """K3: the record dedup, and (write_sids) the dlog_sid rewrite plus
    the canonical remap of the persistent planes. Returns canon_pid
    without waiting on the card. ``shape`` (blocks, threads, mode)
    overrides ``dedup_shape``'s; ``phases`` (a CUDA int64 tensor of 8, or
    None) gets the SM cycles of K3's phases added (``csrc/window.cu``
    ``DedupScratch::phase``) and the rounds run.
    Counts each CUDA launch: the rounds, and the remap with
    write_sids."""
    _build, lib = _kw()
    planes = symstep.plane_args(st, _DEDUP_PLANES)
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    dims = _build.int_array((n, d_recs, st.ssid.shape[1],
                             st.sval_sid.shape[1], st.mlog_sid.shape[1],
                             st.flog_sid.shape[0]))
    blocks, threads, mode = shape or dedup_shape(n, st.device)
    if phases is not None:
        _build.need_cuda(phases, torch.int64, "phases")
    canon = torch.empty((n, d_recs), dtype=torch.int32, device=st.device)
    scratch = torch.empty(2 * _DEDUP_H + 4 + 4 * n + n * d_recs,
                          dtype=torch.int32, device=st.device)
    rc = lib.window_dedup(planes, dims, _build.ptr(canon),
                          _build.ptr(scratch), int(write_sids), blocks,
                          threads, mode,
                          None if phases is None else _build.ptr(phases),
                          _build.stream(st.device))
    if n and d_recs:
        _build.LAUNCHES["window_dedup"] += 1 + int(write_sids)
    _build.check(lib, rc, "window_dedup")
    return canon


def _views(base, sections):
    """Views of one int32 device buffer: sections [(uint8?, shape,
    strides, offset in the section's elements)] (``_layout``'s)."""
    as_u8 = base.view(torch.uint8)
    return tuple((as_u8 if u8 else base).as_strided(shape, stride, off)
                 for u8, shape, stride, off in sections)


class Outputs(Sequence):
    """Arrays that are sections of one device buffer (K4's 12 outputs,
    a retire's 3 rows), as a sequence of tensors. The views are made
    when first read (each costs the host microseconds); ``_start_pull``
    copies the buffer whole and reads none."""

    __slots__ = ("base", "sections", "_made")

    def __init__(self, base, sections):
        self.base, self.sections, self._made = base, sections, None

    def __len__(self):
        return len(self.sections)

    def __getitem__(self, i):
        if self._made is None:
            self._made = _views(self.base, self.sections)
        return self._made[i]


def _layout(shapes):
    """Sections [(uint8?, shape, strides, offset in the section's
    elements)] of the (dtype, shape) arrays placed one after the other
    in one buffer, each 16-byte aligned and contiguous; and the bytes in
    all (a multiple of 16)."""
    off, out = 0, []
    for dtype, shape in shapes:
        u8 = dtype is torch.uint8
        unit = 1 if u8 else 4
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        out.append((u8, tuple(shape), stride, off // unit))
        off += -(-int(np.prod(shape)) * unit // 16) * 16
    return out, max(off, 16)


def _row_shapes(k, ws, wm, wl, wk):
    """(dtype, shape) of the three arrays of k retire rows of these
    widths (``_retire_gather_core``'s packing)."""
    return [(torch.int32, (k, 10 + 3 * wl + ws + 5 * wk)),
            (torch.int32, (k, NLIMBS * (ws + 2 * wk))),
            (torch.uint8, (k, 2 * wm))]


@functools.lru_cache(maxsize=256)
def _row_layout(k, ws, wm, wl, wk):
    """``_layout`` of ``_row_shapes``, kept by shape."""
    return _layout(_row_shapes(k, ws, wm, wl, wk))


def _k4_plan(st, shape):
    """K4's argument block for these planes: (C int array, output
    sections, output bytes, scratch bytes)."""
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    key = ("epilogue", n, d_recs, st.stack.shape[1], st.memory.shape[1],
           st.mlog_off.shape[1], st.skeys.shape[1], st.device.index, shape)
    plan = _WIN_PLANS.get(key)
    if plan is None:
        from .. import _build

        rcap, hcap = min(RCAP, n), min(HOLD_CAP, n)
        urb, fb = min(URB, n * d_recs), min(FB, n)
        wl = min(RESUME_MLOG, st.mlog_off.shape[1])
        wm = min(RESUME_MEM, st.memory.shape[1])
        sections, nbytes = _layout(
            [(torch.int32, (n, 8)), (torch.int32, (3,)),
             (torch.int32, (urb, 3 * NLIMBS + 9)), (torch.int32, (fb, 9)),
             (torch.int32, (rcap,))]
            + _row_shapes(rcap, *_retire_widths(st, *RETIRE_FLOORS))
            + [(torch.int32, (hcap,)), (torch.int32, (hcap, 7 + 3 * wl)),
               (torch.int32, (hcap, 2 * NLIMBS)),
               (torch.uint8, (hcap, 2 * wm))])
        shape = shape or window_shape("epilogue", n, st.device)
        plan = _WIN_PLANS[key] = (
            _build.int_array(list(shape) + [urb, fb, *RETIRE_FLOORS]
                             + [off * (1 if u8 else 4)
                                for u8, _, _, off in sections]),
            sections, nbytes, _k4_scratch(shape, urb))
    return plan


def _k4_scratch(shape, urb):
    """Bytes of K4's scratch (``csrc/window.cu`` ``epilogue_launch``):
    a grid's scan sums, and the unique rows' indices where one block's
    shared memory does not hold them."""
    blocks, _, mode, _ = shape
    return 4 * (4 * blocks + urb) if mode == 1 or urb > 11 * 1024 else 0


def epilogue_kernel(st, cc, canon, budget, resume_on, shape=None):
    """K4 on the card, one launch that does not wait on the card: marks
    retired lanes DEAD in place and returns the 12 outputs, views of one
    device allocation. ``shape`` (blocks, threads, mode, lanes a thread)
    overrides ``window_shape``'s."""
    _build, lib = _kw()
    planes, dims = symstep.state_args(st)
    dev = st.device
    lay, sections, nbytes, nscratch = _k4_plan(st, shape)
    packed = cc.packed
    for t, name in ((canon, "canon"), (packed, "code.packed")):
        if not (t.is_cuda and t.dtype is torch.int32 and t.is_contiguous()):
            _build.need_cuda(t, torch.int32, name)
    out = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
    stream = _build.stream(dev)
    scratch = _scratch("epilogue", dev, stream.value, None, nscratch)
    rc = lib.window_epilogue(
        planes, dims, packed.data_ptr(), packed.shape[0], int(budget),
        int(resume_on), canon.data_ptr(), out.data_ptr(), lay,
        scratch[0].data_ptr() if scratch else None, stream)
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "window_epilogue")
    return Outputs(out, sections)


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
    sections, nbytes = _row_layout(ridx.shape[0], *_retire_widths(
        st, dstack, dmem, dmlog, dslot))
    out = torch.empty(nbytes // 4, dtype=torch.int32, device=st.device)
    ptr = out.data_ptr()
    rc = lib.retire_rows(planes, dims, ridx.data_ptr(), ridx.shape[0],
                         _build.int_array((dstack, dmem, dmlog, dslot)),
                         *[ptr + off * (1 if u8 else 4)
                           for u8, _, _, off in sections],
                         _build.stream(st.device))
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "retire_rows")
    return st, Outputs(out, sections)


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
    n = st.pc.shape[0]
    shape = window_shape("epilogue", n, st.device)
    out = torch.empty(urb * (3 * NLIMBS + 9) + 1, dtype=torch.int32,
                      device=st.device)
    tab, count = out[:-1].view(urb, 3 * NLIMBS + 9), out[-1]
    stream = _build.stream(st.device)
    scratch = _scratch("epilogue", st.device, stream.value, None,
                       _k4_scratch(shape, urb))
    rc = lib.unique_table(planes, dims, canon.data_ptr(), urb,
                          tab.data_ptr(), count.data_ptr(),
                          _build.int_array(shape),
                          scratch[0].data_ptr() if scratch else None, stream)
    _build.LAUNCHES["window_epilogue"] += 1
    _build.check(lib, rc, "unique_table")
    return tab, count


#: the fork log's planes in the fork table's column order
_FLOG_PLANES = ("flog_parent", "flog_child", "flog_step", "flog_pc",
                "flog_sid", "flog_gmin", "flog_gmax", "flog_fentry",
                "flog_dest")


def _gather_full_flog(st: SymLaneState):
    dev = st.flog_parent.device
    if dev.type == "cpu":
        return gather_full_flog_plain(st)
    _build, lib = _kw()
    flog = symstep.plane_args(st, _FLOG_PLANES)
    fb = st.flog_parent.shape[0]
    tab = torch.empty((fb, 9), dtype=torch.int32, device=dev)
    rc = lib.fork_table(flog, fb, tab.data_ptr(), _build.stream(dev))
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
# the window over a mesh (the JAX engine's window under GSPMD)
# ---------------------------------------------------------------------------

def split_window(i32buf, n, d, k, n_env, sd, pv):
    """Each shard's i32 seed buffer of one window's packed i32 buffer
    (``pack_window``) over ``d`` shards of ``n / d`` lanes: the seed,
    resume and kill entries name the shard's own lanes (JAX's drop rule
    on the global index, then the shard's local index; every other
    entry the padding), in their order, so a lane's last entry still
    wins; the provisional pairs stay the batch's (K2 reads them over the
    whole batch, ``gn``); the free-slot stack is the home batch's (an
    empty section a shard). The u8 buffer is the same for every shard."""
    buf = np.asarray(i32buf)
    m = n // d
    sec = _seed_sections(n, k, n_env, sd, pv)
    a = _unpack_i32_sections(buf, sec)

    def glob(idx):
        g = idx.astype(np.int64)
        return np.where(g < 0, g + n, g)

    idx_g, ridx_g, kill_g = glob(a["idx"]), glob(a["r_idx"]), glob(a["kill"])
    out = []
    for i in range(d):
        lo = i * m

        def local(g):
            return np.where((g >= lo) & (g < lo + m), g - lo, m
                            ).astype(np.int32)

        kl = kill_g[(kill_g >= lo) & (kill_g < lo + m)] - lo
        kill = np.full(m, m, np.int32)
        kill[:len(kl)] = kl[np.sort(np.unique(kl, return_index=True)[1])] \
            if len(kl) else kl
        parts = dict(a, idx=local(idx_g), r_idx=local(ridx_g), kill=kill,
                     fs=np.zeros(m, np.int32), fcount=np.zeros((), np.int32))
        out.append(np.concatenate([
            np.asarray(parts[name], np.int32).reshape(-1)
            for name, _, _ in _seed_sections(m, k, n_env, sd, pv)]))
    return out, a


def _owners(idx, m: int, d: int):
    """(the shard whose row a gather of each global lane of ``idx``
    reads, its local lane), int64 tensors: JAX's clip, so a negative
    index reads lane 0 and the padding n lane n-1 (of the last shard)."""
    g = idx.long()
    o = torch.div(g, m, rounding_mode="floor").clamp(0, d - 1)
    return o, (g - o * m).clamp(0, m - 1)


def mesh_rows_plain(ss, ridx, hidx, floors=RETIRE_FLOORS):
    """K4's rows over a batch on CPU shards (``parallel/mesh.SymShards``)
    in plain PyTorch, one call: the retire rows of ``ridx`` (global
    lanes, the padding n) under ``floors`` and the resume rows of
    ``hidx``, row j gathered once, from the shard that holds lane
    ridx[j] (hidx[j]) at JAX's clip (``_owners``); the retired lanes
    marked DEAD by JAX's drop rule (``_rows``: a negative index wraps
    once, one still out of range is dropped). Returns (ss, MeshRows)."""
    n, m, d = ss.n, ss.per, ss.mesh.size

    def gather(idx, core):
        o, local = _owners(idx, m, d)
        out = [x.new_empty((idx.shape[0],) + tuple(x.shape[1:]))
               for x in core(ss.shards[0], local.new_zeros(1))]
        for i in o.unique().tolist():
            sel = o == i
            for x, y in zip(out, core(ss.shards[i], local[sel])):
                x[sel] = y
        return out

    rows = gather(ridx, lambda st, rc: _retire_gather_core(st, rc, *floors))
    rows += gather(hidx, _resume_gather_core)
    dead = _rows(ridx, n)[0]
    for i, st in enumerate(ss.shards):
        mine = dead[(dead >= i * m) & (dead < (i + 1) * m)] - i * m
        if mine.numel():
            status = st.status.clone()
            status[mine] = DEAD
            ss.shards[i] = st.replace(status=status)
    return ss, MeshRows([rows], [0] * d, ridx, hidx, m)


class _BatchPlan:
    """The meshed batch's kernel arguments, held by the batch
    (``SymShards.plan``) for its life: a table a device (``csrc/window.cu``
    ``window_mesh_table``: a ``Sym`` a shard of the mesh, null for one
    the device does not hold; built and copied once) with the shards
    that device holds, the shards' dims, the part (device) of each shard,
    and for ``window_mesh_rows`` by call shape the output's sections,
    bytes and the floors' C array. ``mesh_rows_kernel`` and
    ``mesh_remap_kernel`` launch over it."""

    def __init__(self, ss):
        from ..parallel.mesh import device_groups

        _build, lib = _kw()
        d = len(ss.shards)
        nf = len(symstep.FIELDS)
        args = [symstep.state_args(st) for st in ss.shards]
        self.dims, self.groups, self.part_of = args[0][1], [], [0] * d
        for dev, idx in device_groups(ss.mesh):
            planes = (ctypes.c_void_p * (d * nf))()
            for i in idx:
                planes[i * nf:(i + 1) * nf] = list(args[i][0])
                self.part_of[i] = len(self.groups)
            host = torch.empty(d * lib.window_sym_bytes(), dtype=torch.uint8,
                               pin_memory=True)
            _build.check(lib, lib.window_mesh_table(planes, d, self.dims,
                                                    host.data_ptr()),
                         "window_mesh_table")
            tab = host.to(dev, non_blocking=True)
            self.groups.append((dev, tab, ctypes.c_void_p(tab.data_ptr()),
                                host, _build.int_array(idx)))
        st0 = ss.shards[0]
        self.resume = (min(RESUME_MLOG, st0.mlog_off.shape[1]),
                       min(RESUME_MEM, st0.memory.shape[1]))
        self.st0, self.shapes = st0, {}
        bad = [f"{f} of shard {i}" for i, st in enumerate(ss.shards)
               for f in REMAP_PLANES if getattr(st, f).data_ptr() % 16]
        if bad:
            raise ValueError(f"window_mesh_remap: {bad} not 16-byte "
                             f"aligned")
        # the home device's event after K3, and each other card's after
        # its remap (``mesh_remap_kernel``)
        self.events = {dev: torch.cuda.Event() for dev, *_ in self.groups} \
            if len(self.groups) > 1 else None

    def shape(self, rk, hk, floors):
        """(byte offsets of the six arrays, sections, bytes, floors)"""
        key = (rk, hk, floors)
        if key not in self.shapes:
            from .. import _build

            sections, nbytes = _layout(
                _row_shapes(rk, *_retire_widths(self.st0, *floors))
                + [(torch.int32, (hk, 7 + 3 * self.resume[0])),
                   (torch.int32, (hk, 2 * NLIMBS)),
                   (torch.uint8, (hk, 2 * self.resume[1]))])
            self.shapes[key] = (
                [off * (1 if u8 else 4) for u8, _, _, off in sections],
                sections, nbytes, _build.int_array(floors))
        return self.shapes[key]


def batch_plan(ss) -> _BatchPlan:
    """The batch's plan (``SymShards.plan``), made at its first use."""
    if ss.plan is None:
        ss.plan = _BatchPlan(ss)
    return ss.plan


def mesh_rows_kernel(ss, ridx, hidx, floors=RETIRE_FLOORS):
    """``mesh_rows_plain`` on the card (``csrc/window.cu``
    ``window_mesh_rows``): one launch a device over the shards it holds,
    a warp a row, each row gathered by the device that holds its lane
    and each retired lane marked DEAD in place by the device that holds
    it; the six arrays sections of one allocation a device. ``ridx`` and
    ``hidx`` stay on the card (a device that is not theirs reads a copy
    made there); ``hidx`` may be empty (an escalation retire)."""
    _build, lib = _kw()
    plan = batch_plan(ss)
    rk, hk = ridx.shape[0], hidx.shape[0]
    offs, sections, nbytes, fl = plan.shape(rk, hk, tuple(floors))
    d, n = len(ss.shards), ss.n
    parts = []
    for dev, _, tab, _, _ in plan.groups:
        r = ridx if ridx.device == dev else ridx.to(dev)
        h = hidx if hidx.device == dev else hidx.to(dev)
        for t, name in ((r, "ridx"), (h, "hidx")):
            if not (t.is_cuda and t.dtype is torch.int32
                    and t.is_contiguous()):
                _build.need_cuda(t, torch.int32, name)
        out = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
        base = out.data_ptr()
        with symstep._current(dev):
            rc = lib.window_mesh_rows(
                tab, d, n, plan.dims, r.data_ptr(), rk, fl, h.data_ptr(), hk,
                (ctypes.c_void_p * 6)(*[base + o for o in offs]),
                _build.stream(dev))
        _build.LAUNCHES["window_rows"] += 1
        _build.check(lib, rc, "window_mesh_rows")
        parts.append(Outputs(out, sections))
    return ss, MeshRows(parts, plan.part_of, ridx, hidx, ss.per)


def mesh_rows(ss, ridx, hidx, floors=RETIRE_FLOORS):
    """K4's rows over a meshed batch: the plain version on CPU shards,
    the kernel on a card's. Returns (ss, MeshRows)."""
    fn = mesh_rows_plain if ss.home.device.type == "cpu" \
        else mesh_rows_kernel
    return fn(ss, ridx, hidx, floors)


#: a shard's persistent sid planes, which K3's remap rewrites
REMAP_PLANES = ("ssid", "sval_sid", "skey_sid", "mlog_sid")


def remap_shard_plain(st: SymLaneState, canon) -> SymLaneState:
    """K3's remap on a shard in plain PyTorch: its four persistent sid
    planes through the whole batch's canon."""
    d_recs = st.dlog_op.shape[1]
    return st.replace(**{f: _lookup(canon, getattr(st, f), d_recs)
                         for f in REMAP_PLANES})


def mesh_remap_plain(ss, canon):
    """K3's remap over a meshed batch in plain PyTorch: each shard's four
    persistent sid planes through the whole batch's canon
    (``remap_shard_plain``). Returns ss."""
    for i, st in enumerate(ss.shards):
        ss.shards[i] = remap_shard_plain(st, canon)
    return ss


def mesh_remap_kernel(ss, canon):
    """``mesh_remap_plain`` on the card (``csrc/window.cu``
    ``window_mesh_remap``), in place: one launch a device over the
    shards it holds, through the batch's plan. ``canon`` is K3's, on the
    home device: across cards each other card's stream waits on an
    event recorded on the home device's after K3, and reads it in place
    over peer access (``symstep.vis_route``) or from one copy a card;
    the home device's stream then waits on each other card's remap (the
    canon stays live until they have read it). Returns ss."""
    _build, lib = _kw()
    plan = batch_plan(ss)
    home = ss.home.device
    if not (canon.device == home and canon.dim() == 2
            and canon.shape == (ss.n, plan.dims[6])):
        raise ValueError(f"mesh_remap: canon {tuple(canon.shape)} on "
                         f"{canon.device}, ({ss.n}, {plan.dims[6]}) on "
                         f"{home} wanted")
    _build.need_cuda(canon, torch.int32, "canon")
    ev = plan.events
    if ev is not None:
        ev[home].record(torch.cuda.current_stream(home))
    for dev, _, tab, _, held in plan.groups:
        src = canon
        if dev != home:
            if symstep.vis_route(dev, home) == "copy":
                src = canon.to(dev)
            else:
                torch.cuda.current_stream(dev).wait_event(ev[home])
        with symstep._current(dev):
            rc = lib.window_mesh_remap(tab, held, len(held), plan.dims,
                                       src.data_ptr(), ss.n,
                                       _build.stream(dev))
        _build.LAUNCHES["window_remap"] += 1
        _build.check(lib, rc, "window_mesh_remap")
        if dev != home:
            ev[dev].record(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(home).wait_event(ev[dev])
    return ss


def mesh_remap(ss, canon):
    """K3's remap over a meshed batch: the plain version on CPU shards,
    the kernel on a card's. Returns ss."""
    fn = mesh_remap_plain if ss.home.device.type == "cpu" \
        else mesh_remap_kernel
    return fn(ss, canon)


class MeshRows(Sequence):
    """A meshed rows call's arrays (``mesh_rows``): the retire rows of
    ``ridx``, then the resume rows of ``hidx`` (``width`` 6; an
    escalation retire's ``width`` 3: the retire rows alone). ``parts``
    holds each device's six arrays, ``part_of`` the part of each shard;
    row j comes from the part whose shard holds lane ridx[j] (hidx[j])
    at JAX's clip. With one part (one card, or CPU shards) its arrays
    are the rows; with several the host merges them by device, the
    indices pulled beside them. ``start_pull`` starts every copy to the
    host; indexing pulls at once (the CPU path)."""

    def __init__(self, parts, part_of, ridx, hidx, m, width=6):
        self.parts, self.part_of = parts, part_of
        self.ridx, self.hidx, self.m, self.width = ridx, hidx, m, width

    def __len__(self):
        return self.width

    def start_pull(self):
        pulls = [_start_pull(p) for p in self.parts]
        if len(pulls) == 1:
            return lambda: list(pulls[0]())[:self.width]
        idx = _start_pull([self.ridx, self.hidx])
        part_of = np.asarray(self.part_of)

        def merged():
            got = [list(p()) for p in pulls]
            out = []
            for c, sel in enumerate(idx()):
                if c and self.width == 3:
                    break
                o = np.clip(np.asarray(sel, np.int64) // self.m, 0,
                            len(part_of) - 1)
                where = part_of[o]
                for k in range(3 * c, 3 * c + 3):
                    arr = np.array(got[0][k])
                    for p in range(1, len(got)):
                        arr[where == p] = got[p][k][where == p]
                    out.append(arr)
            return out

        return merged

    def __getitem__(self, i):
        return torch.from_numpy(np.ascontiguousarray(
            self.start_pull()()[i]))


class MeshOutputs(Sequence):
    """A meshed window's 12 outputs: K4's at home (``home``: misc,
    scal, utab, ftab, ridx, ..., hidx, ...) with its retire and resume
    rows those of the meshed rows call (``rows``, a ``MeshRows``).
    ``start_pull`` starts every copy to the host; indexing pulls at once
    (the CPU path)."""

    def __init__(self, home, rows):
        self.home, self.rows = home, rows

    def __len__(self):
        return 12

    def start_pull(self):
        home = _start_pull(self.home)
        rows = _start_pull(self.rows)

        def assemble():
            out = list(home())
            got = rows()
            out[5:8], out[9:12] = got[:3], got[3:]
            return out

        return assemble

    def __getitem__(self, i):
        return torch.from_numpy(np.ascontiguousarray(
            self.start_pull()()[i]))


def window_exec_mesh(ss, codes, i32buf, u8buf, exec_table, taint_table,
                     window: int, k: int, budget: int, pv: int, visited,
                     resume_on):
    """One window dispatch over a batch placed on a mesh
    (``parallel/mesh.SymShards``), the JAX ``_window_exec`` under GSPMD:
    K2 a shard (the host splits the seed buffers, ``split_window``; the
    free-slot stack and counts go to the home batch), ``sym_run_mesh``
    (K1 a shard), K3 once at home over the record planes gathered there
    (``mesh.gather_home``: its canon orders records by global step over
    every lane) with the rewritten record sids copied back and every
    shard's sid planes remapped through that canon (``mesh_remap``: a
    launch a device), K4 at home over the gathered selection and counter
    planes (the selections in global lane order, the counters,
    unique-record and fork tables) and its retire and resume rows in one
    meshed rows call (``mesh_rows``: a launch a device, which also marks
    the retired lanes DEAD). Each phase takes the plain version on a CPU
    shard and the kernel on a CUDA one, on the shard's device.
    ``codes``: {device: compiled code}; the buffers are host arrays.
    Returns (ss, visited, MeshOutputs)."""
    from ..parallel.mesh import gather_home, scatter_home

    n, m, d = ss.n, ss.per, ss.mesh.size
    st0 = ss.shards[0]
    sd = min(SEED_STACK, st0.stack.shape[1])
    parts, sec = split_window(i32buf, n, d, k, st0.env.shape[1], sd, pv)
    u8 = torch.from_numpy(np.ascontiguousarray(np.asarray(u8buf)))
    home = ss.home
    home.free_slots.copy_(torch.from_numpy(np.asarray(sec["fs"], np.int32)))
    home.free_count.copy_(torch.tensor(int(sec["fcount"]),
                                       dtype=torch.int32))
    home.flog_count.copy_(torch.tensor(0, dtype=torch.int32))
    for i, st in enumerate(ss.shards):
        buf = torch.from_numpy(parts[i])
        if st.device.type == "cpu":
            ss.shards[i] = prologue_plain(st, buf, u8, k, pv, gn=n)
        else:
            with _on(st.device):
                prologue_kernel(st, buf.to(st.device), u8.to(st.device), k,
                                pv, gn=n)
    ss, visited = symstep.sym_run_mesh(codes, ss, window, exec_table,
                                       taint_table, visited)
    gather_home(ss)
    if ss.home.device.type == "cpu":
        ss.home, canon = dedup_plain(ss.home)
    else:
        with _on(ss.home.device):
            canon = dedup_kernel(ss.home, write_sids=True)
    scatter_home(ss, ("dlog_sid",))
    mesh_remap(ss, canon)
    cc = codes[ss.home.device]
    if ss.home.device.type == "cpu":
        ss.home, outs = epilogue_plain(ss.home, cc, canon, budget,
                                       resume_on)
    else:
        with _on(ss.home.device):
            outs = epilogue_kernel(ss.home, cc, canon, budget, resume_on)
    ss, rows = mesh_rows(ss, outs[4], outs[8])
    return ss, visited, MeshOutputs(outs, rows)


def retire_rows_mesh(ss, ridx, dstack, dmem, dmlog, dslot):
    """``_retire_rows`` over a mesh: one meshed rows call (``mesh_rows``)
    with no resume rows gathers the named lanes' rows and marks them
    DEAD; returns (ss, MeshRows of the three retire arrays)."""
    ss, rows = mesh_rows(ss, ridx, ridx[:0], (dstack, dmem, dmlog, dslot))
    rows.width = 3
    return ss, rows


# ---------------------------------------------------------------------------
# the window-merge fingerprint: csrc/merge.cu (K9)
# ---------------------------------------------------------------------------

def _mul32(a, b):
    """(a * b) mod 2**32 for int64 values in [0, 2**32) (the product
    would overflow int64): a's two 16-bit halves times b."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _sm32(x):
    """splitmix32 finisher on int64 values in [0, 2**32): the per-column
    weights of the fingerprint folds."""
    x = (x + 0x9E3779B9) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def merge_fingerprint_plain(st: SymLaneState, prov_pairs, gn=None):
    """Per-lane frontier fingerprint of the window-boundary merge pass
    in plain PyTorch (the JAX ``_merge_fingerprint``, fold for fold):
    two 32-bit multilinear hashes over pc, depth, fork group, fentry,
    the gas limit, the live stack (canonical sids and concrete limbs),
    memory kinds, concrete bytes and overlay records, the storage slot
    table with its write order as ranks, and the calldata shape; then
    the raw gas interval. Provisional sids resolve through
    ``prov_pairs`` as the next dispatch will resolve them (over a batch
    of ``gn`` lanes where ``st`` is a shard of a meshed one). Returns
    (N, 4) int32 holding the uint32 columns (h1, h2, min_gas,
    max_gas)."""
    n = st.pc.shape[0]
    dev = st.device
    d_recs = st.dlog_op.shape[1]
    prov_arr = prov_table(st, prov_pairs, gn)

    def remap(plane):
        return _lookup(prov_arr, plane, d_recs)

    h1 = torch.full((n,), 2166136261, dtype=torch.int64, device=dev)
    h2 = torch.full((n,), 0x9E3779B9, dtype=torch.int64, device=dev)
    seed = [0]

    def fold(h1, h2, arr, mask=None):
        seed[0] += 1
        arr = arr.reshape(n, -1).long() & _M32
        if mask is not None:
            arr = torch.where(mask.reshape(n, -1), arr, 0)
        k = arr.shape[1]
        idx = (torch.arange(k, dtype=torch.int64, device=dev)
               + ((seed[0] * 0x632BE59B) & _M32)) & _M32
        w1 = _sm32(idx)[None, :]
        w2 = _sm32(idx ^ 0x7F4A7C15)[None, :]
        s1 = _mul32(arr, w1).sum(dim=1) & _M32
        s2 = _mul32(arr ^ w2, w1).sum(dim=1) & _M32
        h1 = _mul32(h1 ^ s1, 16777619)
        h2 = _mul32((h2 + s2) & _M32, 2654435761)
        return h1, h2 ^ (h2 >> 15)

    for scalar in (st.pc, st.sp, st.depth, st.group, st.fentry,
                   st.msize, st.mlog_count, st.scount, st.s_mode,
                   st.sbase, st.cd_size, st.cd_sym, st.cd_size_sid,
                   st.gas_limit):
        h1, h2 = fold(h1, h2, scalar)

    depth_cap = st.stack.shape[1]
    slot_live = torch.arange(depth_cap, device=dev)[None, :] \
        < st.sp[:, None]
    ssid_r = remap(st.ssid)
    h1, h2 = fold(h1, h2, ssid_r, slot_live)
    conc = slot_live & (ssid_r == 0)
    h1, h2 = fold(h1, h2, st.stack, conc.repeat_interleave(NLIMBS, 1))

    h1, h2 = fold(h1, h2, st.mkind)
    conc_mem = (st.mkind != 0) & (st.mkind != symstep.KIND_SYM_WORD)
    h1, h2 = fold(h1, h2, st.memory, conc_mem)
    mr = st.mlog_off.shape[1]
    mlog_live = torch.arange(mr, device=dev)[None, :] \
        < st.mlog_count[:, None]
    h1, h2 = fold(h1, h2, st.mlog_off, mlog_live)
    h1, h2 = fold(h1, h2, st.mlog_len, mlog_live)
    h1, h2 = fold(h1, h2, remap(st.mlog_sid), mlog_live)

    s_slots = st.skeys.shape[1]
    srow = torch.arange(s_slots, device=dev)[None, :] < st.scount[:, None]
    skey_r = remap(st.skey_sid)
    sval_r = remap(st.sval_sid)
    h1, h2 = fold(h1, h2, skey_r, srow)
    h1, h2 = fold(h1, h2, sval_r, srow)
    h1, h2 = fold(h1, h2, st.s_written, srow)
    h1, h2 = fold(h1, h2, st.s_read, srow)
    h1, h2 = fold(h1, h2, st.skeys,
                  (srow & (skey_r == 0)).repeat_interleave(NLIMBS, 1))
    h1, h2 = fold(h1, h2, st.svals,
                  (srow & (sval_r == 0)).repeat_interleave(NLIMBS, 1))
    written = srow & (st.s_written != 0)
    ws = torch.where(written, st.s_wstep, _I32_MAX)
    slots = torch.arange(s_slots, device=dev)
    earlier = (ws[:, :, None] > ws[:, None, :]) | (
        (ws[:, :, None] == ws[:, None, :])
        & (slots[None, :, None] > slots[None, None, :]))
    rank = (earlier & written[:, None, :]).sum(dim=2)
    h1, h2 = fold(h1, h2, torch.where(written, rank, -1))

    out = torch.stack([h1, h2, st.min_gas.long() & _M32,
                       st.max_gas.long() & _M32], dim=1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


#: K9 (``csrc/merge.cu``): threads a block, pairs its shared hash holds
#: (past them the dense table and three launches), the shared bytes of
#: an SM that its resident blocks share
K9_THREADS = 256
K9_PROV_LOCAL = 4096
K9_SM_SMEM = 233472


def _prov_cap(pv: int) -> int:
    """K9's (and K2's) hash entries for pv pairs: a power of two, at
    most half full."""
    c = 32
    while c < 2 * pv:
        c *= 2
    return c


def _k9_smem(cap, team, depth, slots) -> int:
    """``csrc/merge.cu`` ``fp_smem``: the pair hash, each team's stage,
    the warps' sums and each team's fold sums."""
    stage = (depth + 4 * slots + 3) // 4 * 4
    warps = K9_THREADS // 32
    teams = warps // team
    return 8 * cap + 4 * (teams * stage + warps * 28 + teams * 2 * 28)


def merge_fp_plan(n: int, pv: int, depth: int, slots: int,
                  sms: int = 132) -> dict:
    """K9's launch for n lanes and pv resolution pairs: ``team`` warps a
    lane (8, the block, up to two lanes an SM; else 1, eight lanes a
    block at a time), ``blocks`` (at most as many as fit the card at
    once, each walking over lanes), the hash's entries (``cap``; 0 past
    ``K9_PROV_LOCAL`` pairs: the dense table), the shared bytes of a
    block (``smem``) and the CUDA launches a call makes (1 with the
    hash, 3 with the dense table)."""
    cap = _prov_cap(pv) if pv <= K9_PROV_LOCAL else 0
    warps = K9_THREADS // 32
    team = warps if n <= 2 * sms else 1
    teams = warps // team
    smem = _k9_smem(cap, team, depth, slots)
    per_sm = max(1, min(8, K9_SM_SMEM // (smem + 1024)))
    blocks = max(1, min(-(-n // teams), per_sm * sms))
    return dict(team=team, blocks=blocks, cap=cap, smem=smem,
                launches=1 if cap else 3)


_K9_SIGS = {"merge_fingerprint": [_P, _P, _P, _I, _P, _P, _P, _P],
            "merge_fp_smem": [_I, _I, _I, _I]}
#: K9's plan and launch arguments by (device, lanes, pairs, planes,
#: 16-byte rows), checked against the library once
_K9_LAUNCH = {}


def _k9_launch(lib, st: SymLaneState, pv: int, gn: int = 0):
    """K9's plan for this state and pair count, and its C argument
    array: made and checked (the library's own shared-memory size, the
    card's limit) once for each shape."""
    from .. import _build

    vec = int(st.memory.shape[1] % 16 == 0
              and st.memory.data_ptr() % 16 == 0
              and st.mkind.data_ptr() % 16 == 0)
    n, depth, slots = st.pc.shape[0], st.stack.shape[1], st.skeys.shape[1]
    key = (st.device, n, pv, depth, slots, vec, gn)
    hit = _K9_LAUNCH.get(key)
    if hit is None:
        smem_limit, sms = _build.device_limits(st.device)
        plan = merge_fp_plan(n, pv, depth, slots, sms)
        if lib.merge_fp_smem(plan["cap"], plan["team"], depth, slots) \
                != plan["smem"]:
            raise RuntimeError("csrc/merge.cu sizes its shared memory "
                               "otherwise than merge_fp_plan")
        if plan["smem"] > smem_limit:
            raise ValueError(f"K9: {plan['smem']} shared bytes a block for "
                             f"{depth} stack and {slots} storage slots")
        hit = _K9_LAUNCH[key] = (plan, _build.int_array(
            [plan["blocks"], plan["team"], plan["cap"], vec, gn]))
    return hit


def merge_fingerprint_kernel(st: SymLaneState, prov_pairs, gn=None):
    """K9 on the card (``csrc/merge.cu``): ``merge_fingerprint_plain``
    of a CUDA state, in one launch where the pairs fit its shared hash
    (``merge_fp_plan``). Launches on the current stream of the state's
    device; ``LAUNCHES["merge_fingerprint"]`` counts CUDA launches."""
    from .. import _build

    lib = _build.lib("merge.cu", _K9_SIGS)
    planes, dims = symstep.state_args(st)
    n, d_recs = st.pc.shape[0], st.dlog_op.shape[1]
    pairs = prov_pairs.contiguous()
    _build.need_cuda(pairs, torch.int32, "prov_pairs")
    if pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"prov_pairs: shape {tuple(pairs.shape)}")
    pv = pairs.shape[0]
    out = torch.empty((n, 4), dtype=torch.int32, device=st.device)
    if n == 0:
        return out
    plan, args = _k9_launch(lib, st, pv, gn or 0)
    dense = None if plan["cap"] else torch.empty(
        (gn or n) * d_recs, dtype=torch.int32, device=st.device)
    rc = lib.merge_fingerprint(planes, dims, _build.ptr(pairs), pv, args,
                               None if dense is None else _build.ptr(dense),
                               _build.ptr(out), _build.stream(st.device))
    _build.LAUNCHES["merge_fingerprint"] += plan["launches"]
    _build.check(lib, rc, "merge_fingerprint")
    return out


def merge_fingerprint(st: SymLaneState, prov_pairs, gn=None):
    """The window-merge fingerprint: the plain version for a CPU state,
    K9 for a CUDA state (``gn``: see ``merge_fingerprint_plain``)."""
    if st.device.type == "cpu":
        return merge_fingerprint_plain(st, prov_pairs, gn)
    return merge_fingerprint_kernel(st, prov_pairs, gn)


def _prov_pairs(prov: dict, n: int, d_recs: int, device) -> torch.Tensor:
    """The (pv, 2) int32 resolution pairs of a window boundary, [lane *
    d_recs + slot, oid] in the order of ``prov`` ({(lane, slot): oid}),
    then padding (slot n * d_recs, dropped): pv is ``PROV_BUCKET`` (or
    n * d_recs when smaller) up to that many pairs, n * d_recs past it.
    Packed by numpy from the dict's views (no Python loop over the
    pairs) into pinned memory on a card, and copied there in one
    asynchronous copy."""
    import itertools

    k = len(prov)
    pv = min(PROV_BUCKET, n * d_recs) if k <= PROV_BUCKET else n * d_recs
    cuda = torch.device(device).type == "cuda"
    host = torch.empty((pv, 2), dtype=torch.int32, pin_memory=cuda)
    arr = host.numpy()
    arr[:] = n * d_recs
    if k:
        keys = np.fromiter(itertools.chain.from_iterable(prov.keys()),
                           dtype=np.int64, count=2 * k).reshape(k, 2)
        arr[:k, 0] = keys[:, 0] * d_recs + keys[:, 1]
        arr[:k, 1] = np.fromiter(prov.values(), dtype=np.int64, count=k)
    return host.to(device, non_blocking=cuda)


class ObjectTable:
    """sid (>0) -> object (a facade BitVec or Bool for the engine; any
    record for ``support/device_loop.py``). Ids start at 1; 0 means
    concrete."""

    def __init__(self):
        self._objs: List = [None]

    def add(self, obj) -> int:
        self._objs.append(obj)
        return len(self._objs) - 1

    def __getitem__(self, sid: int):
        if sid <= 0:
            # a negative sid here means a provisional id leaked through
            # a drain unresolved: fail loudly instead of returning an
            # unrelated object
            raise IndexError(f"unresolved/invalid sid {sid}")
        return self._objs[sid]

    def __len__(self):
        return len(self._objs)


# ---------------------------------------------------------------------------
# the host bridge
# ---------------------------------------------------------------------------

class LaneCtx:
    """Host context of one device lane: the pristine entry state it was
    seeded from, the (step-stamped) path conditions accumulated through
    drains, and per-adapter sink-taint promotions."""

    __slots__ = ("template", "conds", "addr2idx", "storage_seed_raw",
                 "calldata", "gas0_min", "gas0_max", "promos",
                 "swrites", "owner", "code_base", "func_names")

    def __init__(self, template, addr2idx, storage_seed_raw, calldata,
                 gas0_min, gas0_max, owner=None, code_base=0,
                 func_names=None):
        self.template = template
        #: cross-tenant wave packing (docs/daemon.md §wave packing):
        #: the owning request's tag (None outside packed explores —
        #: READ only through retire_ring.owner_of, lint rule 10), the
        #: member segment's arena base offset, and the member's own
        #: function-name map (None = use the engine's per-explore map)
        self.owner = owner
        self.code_base = code_base
        self.func_names = func_names
        # [(global step, Bool)] — the step stamp lets drain-time sites
        # reconstruct the constraint prefix at any earlier record
        self.conds: List[tuple] = []
        self.addr2idx = addr2idx
        self.storage_seed_raw = storage_seed_raw
        self.calldata = calldata
        self.gas0_min = gas0_min
        self.gas0_max = gas0_max
        # adapter-id -> [(step, annotation)] (lane_adapters promotions)
        self.promos: Dict[int, List[tuple]] = {}
        # per-path storage-write mirror [(key BitVec, value BitVec)] in
        # program order, built from the lane's SSTORE records —
        # REC_SLOAD_RW resolution folds it over the seed storage
        self.swrites: List[tuple] = []

    def clone(self) -> "LaneCtx":
        c = LaneCtx(self.template, self.addr2idx, self.storage_seed_raw,
                    self.calldata, self.gas0_min, self.gas0_max,
                    owner=self.owner, code_base=self.code_base,
                    func_names=self.func_names)
        c.conds = list(self.conds)
        c.promos = {k: list(v) for k, v in self.promos.items()}
        c.swrites = list(self.swrites)
        return c


class _DrainSite:
    """A reconstructed pre-hook site: enough of the GlobalState at a
    device-executed instruction (pc, constraint prefix, gas interval,
    active function, relevant stack tail) for an unmodified detection
    module to run against. Built lazily — most sites are never
    materialized."""

    __slots__ = ("engine", "ctx", "step", "byte_pc", "fentry", "gmin",
                 "gmax", "stack_tail", "_prefix")

    def __init__(self, engine, ctx, step, byte_pc, fentry, gmin=None,
                 gmax=None, stack_tail=(), prefix=None):
        self.engine = engine
        self.ctx = ctx
        self.step = step
        self.byte_pc = byte_pc
        self.fentry = fentry
        self.gmin = gmin
        self.gmax = gmax
        self.stack_tail = stack_tail
        self._prefix = prefix  # explicit snapshot, or None -> by step

    def _conds(self):
        if self._prefix is not None:
            return self._prefix
        return [c for (s, c) in self.ctx.conds if s < self.step]

    def build_state(self) -> GlobalState:
        # copy(), not deepcopy(): the same sharing level the
        # interpreter's own per-instruction StateTransition copy uses —
        # accounts/storage fork independently, terms/code are shared
        gs = copy(self.ctx.template)
        for c in self._conds():
            gs.world_state.constraints.append(c)
        ms = gs.mstate
        a2i = self.ctx.addr2idx
        # device pcs are arena coordinates under a packed wave; the
        # ctx carries its member segment's base (0 unpacked)
        byte_pc = self.byte_pc - self.ctx.code_base
        ms.pc = int(a2i[min(max(byte_pc, 0), a2i.shape[0] - 1)])
        if self.gmin is not None:
            ms.min_gas_used = self.ctx.gas0_min + int(self.gmin)
            ms.max_gas_used = self.ctx.gas0_max + int(self.gmax)
        fentry = self.fentry
        fnames = self.ctx.func_names if self.ctx.func_names \
            is not None else self.engine._func_names
        if fentry >= 0 and fentry in fnames:
            gs.environment.active_function_name = fnames[fentry]
        for v in self.stack_tail:
            ms.stack.append(v)
        return gs

    def lazy_ostate(self):
        return _LazyOState(self)

    def fire_module_pre_hook(self, module):
        """Run the module's hook entry point against this site — the
        function name makes module_helpers.is_prehook() report True,
        exactly as under svm._execute_pre_hook."""
        module.execute(self.build_state())


class _LazyOState:
    """Materialize-on-first-touch proxy for annotation-captured states
    (the integer module stores one per arithmetic op; almost none are
    ever promoted to a sink, so the deepcopy is deferred)."""

    __slots__ = ("_site", "_gs")

    def __init__(self, site):
        self._site = site
        self._gs = None

    def __getattr__(self, name):
        if self._gs is None:
            self._gs = self._site.build_state()
        return getattr(self._gs, name)

    def __reduce__(self):
        # pickled (a round-boundary checkpoint, a migration batch) as
        # the state it stands for: the site holds the lane engine, whose
        # locks do not pickle
        if self._gs is None:
            self._gs = self._site.build_state()
        return _same, (self._gs,)


def _same(x):
    """Unpickles a ``_LazyOState`` as its materialized state."""
    return x


#: phase wall-clock accumulator (seconds), enabled by MYTHRIL_TPU_PROF=1.
#: In profiling mode the card is synchronized inside a phase that
#: launches, so asynchronous launch cost lands on the phase that caused
#: it.
PROF: Dict[str, float] = {}
PROF_ON = os.environ.get("MYTHRIL_TPU_PROF") == "1"


@contextmanager
def _prof(name: str, sync=None):
    if not PROF_ON:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            x = sync() if callable(sync) else sync
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
        PROF[name] = PROF.get(name, 0.0) + time.perf_counter() - t0
        PROF["n_" + name] = PROF.get("n_" + name, 0.0) + 1


#: stats of the most recent completed explore() in this process — lets
#: callers/tests assert the device path genuinely ran (a fallback to the
#: host interpreter would make lane-vs-host comparisons vacuous).
#: RUN_STATS_TOTAL accumulates across engines (spill/refill re-sweeps
#: create several per analysis).
LAST_RUN_STATS: Optional[dict] = None
RUN_STATS_TOTAL: Dict[str, int] = {}


@functools.lru_cache(maxsize=65536)
def _bv_raw(v: int):
    return symbol_factory.BitVecVal(v, 256).raw


@functools.lru_cache(maxsize=256)
def _mem_word(obj) -> BitVec:
    """A sid-carried word as ``Memory.write_word_at`` stores it
    (state/memory.py): a Bool as 0/1, a narrower value zero-padded on
    the left, a wider one cut to its low 256 bits. A CALLDATALOAD at a
    symbolic offset gives a zero-width word (state/calldata.py), which
    MSTORE pads to 256 zero bits."""
    if isinstance(obj, Bool):
        return If(obj, _bv_val(1), _bv_val(0))
    if obj.size() < 256:
        return Concat(symbol_factory.BitVecVal(0, 256 - obj.size()), obj)
    if obj.size() > 256:
        return Extract(255, 0, obj)
    return obj


def _bv8_raw(v: int):
    return symbol_factory.BitVecVal(v, 8).raw


def _bv_val(v: int) -> BitVec:
    """256-bit constant facade over a memoized term: materialization
    interns the same slot keys / small constants tens of times per
    path across a terminal storm, and the intern round trip dominated
    the stack/storage rebuild. The facade itself stays per-call —
    Expression.annotate mutates in place, so instances must not be
    shared across paths."""
    return BitVec(_bv_raw(v))



# ---------------------------------------------------------------------------
# streaming retire/materialize pipeline gates (docs/drain_pipeline.md,
# "streaming retire"). MTPU_STREAM is the master gate (default on;
# =0 restores the monolithic-retire behavior bit-for-bit);
# MTPU_RETIRE_CHUNK bounds rows per retire gather (pow2-rounded, so
# buffer shapes repeat; 0 disables chunking specifically);
# MTPU_MAT_WORKERS sizes the materialization ring's worker pool (K=1
# stays the default — single-CPU container constraint, ROADMAP).
# ---------------------------------------------------------------------------

#: tri-state test/bench overrides (None = read the env)
FORCE_STREAM: Optional[bool] = None
FORCE_RETIRE_CHUNK: Optional[int] = None

#: default rows-per-gather bound: at full plane caps a retire row is
#: ~7 KB, so 1024 bounds any single gather's device output buffer to a
#: few MB regardless of live width — live width stops being a
#: single-allocation limit
DEFAULT_RETIRE_CHUNK = 1024


def stream_enabled() -> bool:
    """The MTPU_STREAM master gate (default on). Off: monolithic
    retire gathers, no spill merge, K=1 inline materialization —
    today's behavior bit-for-bit."""
    if FORCE_STREAM is not None:
        return bool(FORCE_STREAM)
    return os.environ.get("MTPU_STREAM", "1") != "0"


def retire_chunk() -> int:
    """Rows-per-gather bound for the chunked retire path (pow2-rounded
    down, min 16 so the floors bucketing stays sane); 0 = monolithic
    (MTPU_RETIRE_CHUNK=0, or the master gate off)."""
    if not stream_enabled():
        return 0
    if FORCE_RETIRE_CHUNK is not None:
        ch = int(FORCE_RETIRE_CHUNK)
    else:
        try:
            ch = int(os.environ.get("MTPU_RETIRE_CHUNK",
                                    str(DEFAULT_RETIRE_CHUNK)))
        except ValueError:
            ch = DEFAULT_RETIRE_CHUNK
    if ch <= 0:
        return 0
    ch = max(ch, 4)  # tiny chunks exist for tests/smoke rigs only
    return 1 << (ch.bit_length() - 1)  # pow2 floor: shapes repeat


def mat_workers() -> int:
    """Materialization ring worker count (MTPU_MAT_WORKERS, default 1
    — the single-CPU pool default; the ring structure is what scales)."""
    if not stream_enabled():
        return 1
    try:
        return max(1, int(os.environ.get("MTPU_MAT_WORKERS", "1")))
    except ValueError:
        return 1


# ---------------------------------------------------------------------------
# capacity autoprobe (docs/drain_pipeline.md): on the first kernel-fault
# fallback the engine binary-searches the max stable live width ONCE and
# clamps pick_width (persisted into stats.json via parallel/cost_model
# so subsequent runs — and the future daemon — never re-fault).
# ---------------------------------------------------------------------------

#: in-process live-width clamps keyed by the pow2 shape of the request.
#: The JAX package fills it from its kernel-fault autoprobe, which has
#: no counterpart here (a failed launch raises); clamps a prior run
#: persisted through parallel/cost_model still bind.
CAPACITY_CLAMPS: Dict[int, int] = {}
_CLAMP_WARNED = False


def capacity_clamp(width: Optional[int] = None) -> Optional[int]:
    """The live-width clamp binding a request of `width`: this
    process's probe result for that pow2 shape, else the one a prior
    run persisted into stats.json (cost_model, per-shape map — a
    legacy scalar loads as the shape-blind entry and binds every
    width). ``width=None`` returns the tightest clamp known from any
    shape (admission-control callers without a concrete request)."""
    try:
        from ..parallel import cost_model

        if width is None:
            cands = list(CAPACITY_CLAMPS.values()) \
                + list(cost_model.WIDTH_CLAMPS.values())
            return min(cands) if cands else None
        shape = cost_model.clamp_shape(width)
        persisted = cost_model.width_clamp_for(width)
        local = CAPACITY_CLAMPS.get(shape)
        cands = [c for c in (local, persisted) if c is not None]
        return min(cands) if cands else None
    except Exception:  # pragma: no cover - cost model optional
        if width is None:
            return min(CAPACITY_CLAMPS.values()) \
                if CAPACITY_CLAMPS else None
        return CAPACITY_CLAMPS.get(
            1 << (max(int(width), 1) - 1).bit_length())




def _u32(x) -> np.ndarray:
    """A host copy of a u32 column block as uint32 (the port's tensors
    hold the bit patterns as int32)."""
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x


def _one_buffer(out):
    """(a uint8 tensor over ``Outputs``' buffer, [(byte offset, bytes,
    numpy dtype, shape)] of its arrays)."""
    return out.base.view(torch.uint8), [
        (off * (1 if u8 else 4), int(np.prod(shape)) * (1 if u8 else 4),
         np.uint8 if u8 else np.int32, shape)
        for u8, shape, _, off in out.sections]


def _host_views(raw, parts):
    """The arrays of ``_one_buffer``'s parts in a host copy of the
    buffer (``raw``: its bytes as a numpy uint8 array)."""
    return [raw[off:off + size].view(dtype).reshape(shape)
            for off, size, dtype, shape in parts]


def _start_pull(tensors):
    """Start the copies of device output tensors to the host now, on
    the current stream, into pinned memory, and return ``pull()``,
    which waits for those copies only (an event recorded after them)
    and gives the host arrays. ``Outputs`` (views of one buffer) come
    back in one copy into one pinned buffer, each array a view of it;
    other tensors in a copy each. A pull on another thread (the
    retire ring's workers) never waits for, or races with, launches
    made after this call. CPU tensors come back as they are. A meshed
    window's outputs (``MeshOutputs``, ``MeshRows``) pull each shard's
    part and assemble them."""
    if isinstance(tensors, (MeshOutputs, MeshRows)):
        return tensors.start_pull()
    if isinstance(tensors, Outputs):
        dev = tensors.base.device
        raw, parts = _one_buffer(tensors)
        host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(raw, non_blocking=True)

        def arrays():
            return _host_views(host.numpy(), parts)
    else:
        tensors = list(tensors)
        if not tensors or tensors[0].device.type == "cpu":
            outs = [t.numpy() for t in tensors]
            return lambda: outs
        dev = tensors[0].device
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)

        def arrays():
            return [h.numpy() for h in hosts]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def pull():
        done.synchronize()
        return arrays()

    return pull


def _unpack_resume(packed) -> dict:
    """Host-side inverse of _resume_gather_core's packing."""
    i32, u32, u8 = [np.asarray(x) for x in packed]
    u32 = _u32(u32)
    out = {}
    for col, name in enumerate(("msize", "min_gas", "max_gas",
                                "gas_limit", "mlog_count",
                                "sid_top", "sid_sub")):
        out[name] = i32[:, col]
    off = 7
    for name in ("mlog_off", "mlog_len", "mlog_sid"):
        out[name] = i32[:, off:off + RESUME_MLOG]
        off += RESUME_MLOG
    out["top"] = u32[:, :bv256.NLIMBS]
    out["sub"] = u32[:, bv256.NLIMBS:]
    out["memory"] = u8[:, :RESUME_MEM]
    out["mkind"] = u8[:, RESUME_MEM:]
    return out


def _unpack_rows(packed, dstack, dmem, dmlog, dslot) -> dict:
    """Host-side inverse of _retire_rows' packing."""
    i32, u32, u8 = [np.asarray(x) for x in packed]
    u32 = _u32(u32)
    k = i32.shape[0]
    out = {}
    off = 0
    for name in ("pc", "sp", "depth", "fentry", "last_jump", "msize",
                 "mlog_count", "scount", "min_gas", "max_gas"):
        out[name] = i32[:, off]
        off += 1
    for name, w in (("mlog_off", dmlog), ("mlog_len", dmlog),
                    ("mlog_sid", dmlog), ("ssid", dstack),
                    ("sval_sid", dslot), ("s_written", dslot),
                    ("s_read", dslot), ("skey_sid", dslot),
                    ("s_wstep", dslot)):
        out[name] = i32[:, off:off + w]
        off += w
    off = 0
    for name, w, shp in (
        ("stack", dstack * bv256.NLIMBS, (dstack, bv256.NLIMBS)),
        ("skeys", dslot * bv256.NLIMBS, (dslot, bv256.NLIMBS)),
        ("svals", dslot * bv256.NLIMBS, (dslot, bv256.NLIMBS)),
    ):
        out[name] = u32[:, off:off + w].reshape((k,) + shp)
        off += w
    out["memory"] = u8[:, :dmem]
    out["mkind"] = u8[:, dmem:]
    return out



def _limbs_int(limbs) -> int:
    return bv256.limbs_to_int(np.asarray(limbs))


def lane_seedable(gs, stack_depth: int = SEED_STACK,
                  memory_bytes: int = SEED_MEM,
                  exec_table=None) -> bool:
    """True when the lane engine can seed this state: tx-entry states
    and mid-path states with device-representable stack/memory (the
    host spill/refill path — over-capacity forks park to the host and
    their descendants re-enter the device here). Mid-path limits:
    every stack item is an int/term, memory bytes are concrete, the
    state advanced past the instruction it parked at, and the
    stack/memory content fits the SEED_* columns of the packed seed
    buffer (deeper states stay on the host)."""
    from .transaction import MessageCallTransaction

    ms = gs.mstate
    storage = gs.environment.active_account.storage
    ilist = gs.environment.code.instruction_list
    if (
        gs.environment.static
        or ms.subroutine_stack
        or not isinstance(gs.current_transaction, MessageCallTransaction)
        or (storage.dynld and storage.dynld.active)
        or getattr(gs, "_lane_parked_pc", None) == ms.pc
        or ms.pc >= len(ilist)
        or len(ms.stack) > stack_depth
        or int(ms.memory_size) > memory_bytes
    ):
        return False
    table = symstep.SYM_EXECUTABLE if exec_table is None else exec_table
    op_byte = _OPB.get(ilist[ms.pc]["opcode"])
    if op_byte is None or not table[op_byte]:
        return False  # would park on the first device step anyway
    for key, val in ms.memory._memory.items():
        if not isinstance(key, int):
            return False
        if isinstance(val, int):
            continue
        if not (isinstance(val, BitVec) and val.value is not None):
            return False
    return True


def code_to_bytes(code_obj) -> Optional[bytes]:
    """Concrete bytecode of a Disassembly, or None when it holds
    symbolic bytes (runtime code returned by a creation tx can,
    disassembler/disassembly.py assign_bytecode)."""
    bc = getattr(code_obj, "bytecode", None)
    if isinstance(bc, str):
        try:
            return bytes.fromhex(bc.replace("0x", ""))
        except ValueError:
            return None
    if isinstance(bc, (bytes, bytearray)):
        return bytes(bc)
    if isinstance(bc, tuple):
        from ..support.support_utils import fold_concrete_bytes

        norm = fold_concrete_bytes(bc)
        if all(isinstance(b, int) for b in norm):
            return bytes(norm)
    return None


def _storage_read_term(seed_raw: "T.Term", key: BitVec) -> BitVec:
    """The exact term Storage.__getitem__ builds for an in-memory read
    (state/account.py:37-67 minus the dynamic-loader path): a select over
    the storage array, simplified. Read-over-write folding makes the
    select against the seed array identical to the interpreter's select
    against the current array for any key that misses the write log."""
    idx = key.raw
    return simplify(BitVec(T.mk_select(seed_raw, idx), key.annotations))


# ---------------------------------------------------------------------------
# deferred-record resolution
# ---------------------------------------------------------------------------

#: CompiledCode per (bytecode, function entries) — the code planes stay
#: resident on device across transactions, sweeps, and contracts (each
#: compile_code call costs host decode + five H2D transfers).
_CC_CACHE: Dict[tuple, object] = {}

#: daemon request epoch (docs/daemon.md): the resident daemon bumps
#: this once per request, and a code-plane cache hit whose compile
#: landed in an EARLIER epoch counts as compile_reuse_hits — the
#: cross-request amortization the daemon exists for. One-shot
#: processes never bump it, so every hit stays same-epoch. (The JAX
#: package also books warmed window variants here; the kernels have no
#: per-shape compile, so the port has no such variants to count.)
REQUEST_EPOCH = [0]
_CC_EPOCH: Dict[tuple, int] = {}


def _note_cross_request_hit(epochs: Dict[tuple, int], key) -> None:
    """Book a cache hit against the epoch its compile was paid in."""
    if epochs.get(key, REQUEST_EPOCH[0]) != REQUEST_EPOCH[0]:
        from ..smt.solver.solver_statistics import SolverStatistics

        SolverStatistics().bump(compile_reuse_hits=1)

#: all-DEAD SymLaneState pool keyed by shape config: a finished engine
#: parks its device buffers here and the next engine (same shapes —
#: possibly a different contract) adopts them instead of paying the
#: init dispatch. A pooled state is interchangeable because every live
#: field of a lane is fully rewritten when the row is seeded.
_STATE_POOL: Dict[tuple, List[SymLaneState]] = {}


def _compiled_code(code_bytes: bytes, fentries, device) -> CompiledCode:
    from ..analysis import static_pass
    from ..analysis.static_pass import loop_summary

    static_on = static_pass.enabled()
    info = static_pass.info_for(code_bytes) if static_on else None
    det_mask = info.reach_mask if info is not None else None
    # verified loop-summary park plane (docs/static_pass.md,
    # MTPU_LOOPSUM): lanes arriving at a summarizable head park so the
    # host applies the closed form instead of the device unrolling the
    # loop. The cache key carries the marked head set — bench/tests
    # flip the gate mid-process and must not adopt a stale plane.
    loopsum_heads = ()
    try:
        if info is not None and loop_summary.enabled():
            loopsum_heads = tuple(
                sorted(loop_summary.summarizable_heads(info)))
    except Exception as e:
        log.debug("loop-summary heads unavailable: %s", e)
    key = (code_bytes, tuple(sorted(fentries)), static_on,
           loopsum_heads, str(device))
    cc = _CC_CACHE.get(key)
    if cc is None:
        loopsum_plane = (loop_summary.device_park_pcs(info)
                         if loopsum_heads else None)
        with _prof("compile_code"), trace.span(
                "lane.compile_code", code_len=len(code_bytes)):
            cc = compile_code(code_bytes, func_entries=key[1],
                              det_mask=det_mask,
                              loopsum_pcs=loopsum_plane, device=device)
        if len(_CC_CACHE) >= 64:  # bound device-resident code tensors
            evicted = next(iter(_CC_CACHE))
            _CC_CACHE.pop(evicted)
            _CC_EPOCH.pop(evicted, None)
        _CC_CACHE[key] = cc
        _CC_EPOCH[key] = REQUEST_EPOCH[0]
    else:
        _note_cross_request_hit(_CC_EPOCH, key)
    return cc


# -- cross-tenant wave packing (docs/daemon.md §wave packing) ---------------


class _PackMember:
    """One member of a packed explore: the owner tag (request id), its
    code bytes, arena base, and function-name map. The verified
    loop-summary park planes pack per member (the owning svm applies
    the closed forms — solo behavior); the det-mask plane ships empty
    and the host static retire / jump patching stand down under
    packing (documented in PARITY.md) — issue identity is gated by
    those layers' own on/off equivalence."""

    __slots__ = ("owner", "code", "base", "func_names")

    def __init__(self, owner, code, base, func_names):
        self.owner = owner
        self.code = code
        self.base = base
        self.func_names = func_names


#: packed CompiledCode per member-key tuple (code bytes, sorted
#: function entries and loop-summary heads per member) and device.
#: Bounded like _CC_CACHE.
_PACK_CC_CACHE: Dict[tuple, tuple] = {}
_PACK_CC_EPOCH: Dict[tuple, int] = {}


def _compiled_packed(member_keys: tuple, device):
    """(CompiledCode, bases) on ``device`` for a tuple of (code_bytes,
    fentries, loopsum_heads) member keys — the head set is part of the
    cache key for the same reason _compiled_code's is (gate flips
    mid-process must not adopt a stale park plane)."""
    key = (tuple(member_keys), str(device))
    hit = _PACK_CC_CACHE.get(key)
    if hit is None:
        from ..analysis import static_pass
        from ..analysis.static_pass import loop_summary
        from ..ops.stepper import compile_packed_code

        spec = []
        for code, fentries, heads in key[0]:
            plane = None
            if heads:
                try:
                    plane = loop_summary.device_park_pcs(
                        static_pass.info_for(code))
                except Exception:
                    plane = None
            spec.append((code, fentries, plane))
        with _prof("compile_code"), trace.span(
                "lane.compile_code",
                code_len=sum(len(c) for c, _f, _h in key[0]),
                members=len(key[0])):
            cc, bases = compile_packed_code(spec, device=device)
        if len(_PACK_CC_CACHE) >= 32:
            evicted = next(iter(_PACK_CC_CACHE))
            _PACK_CC_CACHE.pop(evicted)
            _PACK_CC_EPOCH.pop(evicted, None)
        hit = _PACK_CC_CACHE[key] = (cc, bases)
        _PACK_CC_EPOCH[key] = REQUEST_EPOCH[0]
    else:
        _note_cross_request_hit(_PACK_CC_EPOCH, key)
    return hit




# ops whose alu resolver takes pop-coerced bitvec args, keyed by arity
_ALU2 = {
    "ADD": alu.add, "SUB": alu.sub, "MUL": alu.mul, "DIV": alu.div,
    "SDIV": alu.sdiv, "MOD": alu.mod, "SMOD": alu.smod,
    "SIGNEXTEND": alu.signextend, "LT": alu.lt, "GT": alu.gt,
    "SLT": alu.slt, "SGT": alu.sgt, "AND": alu.and_, "OR": alu.or_,
    "XOR": alu.xor, "BYTE": alu.byte_op, "SHL": alu.shl,
    "SHR": alu.shr, "SAR": alu.sar,
}
_ALU3 = {"ADDMOD": alu.addmod, "MULMOD": alu.mulmod}

# pop arity per deferrable op (memo keys must ignore the unused operand
# slots — they hold whatever sat below the live operands on the stack)
_ARITY = {name: 2 for name in _ALU2}
_ARITY.update({name: 3 for name in _ALU3})
_ARITY.update({"EQ": 2, "EXP": 2, "ISZERO": 1, "NOT": 1,
               "SLOAD": 1, "CALLDATALOAD": 1, "SHA3": 3,
               "BALANCE": 1})


#: steps per window dispatch. The step loop exits as soon as no lane is
#: RUNNING, so a large window costs nothing when paths park early, and
#: every extra dispatch pays a host round trip (the outputs' pull, the
#: drain, the next pack). Deep device paths (SHA3 defer + symbolic-storage
#: mode keep token transfers on-device end-to-end) want whole
#: transactions inside ONE window. Bounded by the deferred-log
#: capacity only in the worst case (dlog_full parks, degraded not
#: wrong).
DEFAULT_WINDOW = 256
DEFAULT_STEP_BUDGET = 8192

#: in-explore safety caps for the engine's id-keyed memos (they also
#: clear wholesale at every explore — persistent corpus engines
#: otherwise grow them without bound; see _reset_explore_memos)
_CDL_CACHE_CAP = 1 << 16
_RECORD_MEMO_CAP = 1 << 20


def device_break_even(code: Optional[bytes] = None) -> int:
    """Smallest wave worth dispatching to the device for `code`
    (svm._lane_engine_sweep's engagement gate): 1, as the JAX package
    answers for a local accelerator (the port has no tunneled
    backend)."""
    return 1


#: per-code fork-scale observations: code -> peak width demand (lanes
#: concurrently occupied + entries waiting for a slot) in any one
#: explore. Feeds pick_width so a contract that demonstrably forks
#: wide gets a wide engine on the next sweep, while small analyses
#: stay on narrow (cheap) planes.
PATH_HISTORY: Dict[bytes, int] = {}

#: benchmark/test hook: pin the autotuned width (the merge rig runs at
#: a width of its choosing). None = autotune normally.
FORCE_WIDTH: Optional[int] = None


def pick_mesh(width: int):
    """Device mesh for a sweep under the args.tpu_mesh policy, or None
    for single-device execution, as the JAX engine picks it: auto (-1)
    shards over every card when more than one exists, N over at most N;
    the width must divide evenly and leave at least 8 lanes a shard
    (narrower shards pay the exchange for no batching win). The cards
    are those of the analysis's device (``args.device``): a run on the
    CPU or on a card named by its index is a one-device run, as is a
    one-card host, and resolves to None under every setting."""
    from ..support.devices import device_count
    from ..support.support_args import args

    setting = getattr(args, "tpu_mesh", -1)
    if setting == 0:
        return None
    device = getattr(args, "device", None)
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return None
    nd = device_count()
    if setting > 0:
        nd = min(setting, nd)
    while nd > 1 and (width % nd or width // nd < 8):
        nd -= 1
    if nd <= 1:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(nd)


def pick_width(cap: int, n_entries: int,
               code: Optional[bytes] = None,
               headroom: int = 8) -> int:
    """Engine width for a sweep: the smallest power-of-two bucket with
    generous fork headroom over the entry batch (and over the code's
    observed fork scale), bounded by the configured lane cap. The cap
    is CAPACITY, not a mandate — a 4096-wide plane set for a 30-path
    contract pays init, transfers and per-window compute for lanes
    that never run. Correctness never depends on the width: fork
    pressure stalls parents until slots free, and the host
    spill/refill path absorbs overflow
    (tests/test_lane_spill_refill.py). Worklists that genuinely grow
    pick a wider engine on the next sweep. A capacity-autoprobe clamp
    (CAPACITY_CLAMPS / stats.json via cost_model) caps the width below
    any live-plane size that kernel-faulted this worker class AT THE
    REQUESTED SHAPE — clamps are per pow2 shape, so a 256k fault's
    clamp never narrows a 32k sweep — and the engine degrades through
    the spill/refill path instead of faulting (logged at WARNING once
    when the clamp actually binds)."""
    global _CLAMP_WARNED
    if FORCE_WIDTH is not None:
        return max(min(cap, FORCE_WIDTH), 1)
    clamp = capacity_clamp(cap)
    if clamp is not None and clamp < cap:
        if not _CLAMP_WARNED:
            _CLAMP_WARNED = True
            log.warning(
                "lane width capped at %d by the capacity autoprobe "
                "(configured cap %d kernel-faulted a worker at that "
                "shape; overflow degrades via spill/refill)",
                clamp, cap)
        cap = max(clamp, 1)
    if cap <= 64:
        return max(cap, 1)
    demand = max(n_entries * headroom,
                 PATH_HISTORY.get(code, 0) if code else 0)
    want = 64
    while want < cap and want < demand:
        want *= 2
    return min(want, cap)


class LaneEngine:
    """Owns one lane batch + object table for a single contract's
    exploration."""

    def __init__(self, n_lanes: int = 256, window: Optional[int] = None,
                 step_budget: int = DEFAULT_STEP_BUDGET,
                 blocked_ops=None, adapters=None, mesh=None,
                 slim_stop: bool = False, device=None, **lane_kwargs):
        self.n_lanes = n_lanes
        # resolve at call time: bench.py --smoke (and tests) retune the
        # module-level DEFAULT_WINDOW before svm builds the engine
        self.window = DEFAULT_WINDOW if window is None else window
        self.step_budget = step_budget
        self.lane_kwargs = lane_kwargs
        #: svm guarantees no essential hook watches STOP: lanes parked
        #: at a top-level STOP materialize without the stack/memory
        #: rebuild the STOP transaction-end path never reads
        self.slim_stop = slim_stop
        # a mesh (parallel/mesh.Mesh) places the lane planes over its
        # devices (parallel/mesh.SymShards) and runs every window's
        # phases a shard, as the JAX engine runs its window SPMD over a
        # `lanes` mesh (window_exec_mesh); the host bridge is the same
        self.mesh = mesh
        if mesh is not None and n_lanes % mesh.devices.size:
            raise ValueError(
                f"{n_lanes} lanes not divisible by "
                f"{mesh.devices.size} mesh devices")
        #: the torch device of the lane planes (a mesh's: its first,
        #: where the batch's global planes live): the caller's, else
        #: args.device, else the card (support/devices.resolve)
        self.device = resolve(device) if mesh is None \
            else mesh.devices[0]
        #: device-resident / host coverage bitmaps per code (see explore)
        self._visited_dev: Dict[bytes, object] = {}
        self.visited_by_code: Dict[bytes, np.ndarray] = {}
        # opcodes with registered detector hooks must park so the hooks
        # fire host-side; remove them from the device-executable set.
        # Modules with a lane adapter (analysis/module/lane_adapters.py)
        # are instead served at drain time and their hooks stay lifted.
        table = symstep.SYM_EXECUTABLE.copy()
        for name in blocked_ops or ():
            if name in _OPB:
                table[_OPB[name]] = False
        #: the hook-blocked opcode set, kept for the wave-pack
        #: coordinator to replicate this config on a packed engine
        self.blocked_ops = frozenset(blocked_ops or ())
        self.exec_table = table
        self.adapters = list(adapters or ())
        taint = np.zeros(256, bool)
        for ad in self.adapters:
            for name in ad.taint_ops:
                if name in _OPB:
                    taint[_OPB[name]] = True
        self.taint_table = taint
        # arithmetic records get their pc in the memo key when an
        # adapter annotates them (the annotation site is per-pc)
        self._annot_ops = {
            op for ad in self.adapters
            for op in ("ADD", "SUB", "MUL", "EXP")
            if op in ad.taint_ops
        }
        self.objects = ObjectTable()
        # (lane, record-slot) -> object id for the most recent window's
        # deferred records; the device-side remap of these lands at the
        # NEXT window's fused dispatch, so retired-row resolution (_obj)
        # reads this map directly in the meantime
        self._prov: Dict[Tuple[int, int], int] = {}
        self._group_seq = 0
        self._func_names: Dict[int, str] = {}
        # repeated CALLDATALOADs at the same offset across lanes resolve
        # to the same word term; building it once matters (32 If+select
        # terms per word). All three memos below key on id()s and
        # per-window (step, pc) tuples, which alias across codes once
        # the owning objects die — they reset at every explore() (see
        # _reset_explore_memos) and values pin the id-keyed owners so
        # an id cannot be recycled while its entry is live.
        self._cdl_cache: Dict[Tuple[int, int], tuple] = {}
        self._record_memo: Dict[tuple, int] = {}
        self._fired_sites: set = set()
        self._memo_pins: list = []
        #: static pre-analysis of the current explore's code (None =
        #: gate off / unavailable) + per-template pending-PI memo
        self._static_info = None
        self._static_clean: Dict[int, bool] = {}
        self.stats = {
            "seeded": 0, "reseeded": 0, "forks": 0, "records": 0,
            "parked": 0, "dead": 0, "device_steps": 0, "windows": 0,
            "resumed": 0, "overlap_mat": 0, "overlap_mat_ms": 0,
            # window-pipeline overlap (docs/drain_pipeline.md):
            # host-visible device idle (pull-complete -> next dispatch),
            # host work overlapped with device execution, host blocked
            # on the fused window pull, and the batched fork screen
            "overlap_idle_ms": 0, "overlap_busy_ms": 0,
            "device_wait_ms": 0, "overlap_solve_ms": 0,
            "fork_screened": 0, "fork_killed": 0,
            # window-boundary merge/subsume pass (docs/lane_merge.md)
            "lanes_merged": 0, "lanes_subsumed": 0, "merge_rounds": 0,
            # static pre-analysis consumers (docs/static_pass.md)
            "static_retired": 0, "static_jump_patches": 0,
            # streaming retire pipeline (docs/drain_pipeline.md):
            # bounded gathers issued, D2H pull wall hidden behind the
            # next window's execution, spill candidates merged before
            # materialization, and the deferral ring's peak occupancy
            "retire_chunks": 0, "retire_overlap_ms": 0,
            "spill_merged": 0, "ring_high_water": 0,
        }
        # static-pass run context, set by svm per sweep (the engine is
        # cached across sweeps and transactions): the active-detector
        # anchor mask (None = screen off), whether the current round is
        # the run's last (open states unused afterwards), and whether
        # patching a statically-resolved symbolic JUMP dest is safe
        # (off while an arbitrary-jump-class detector is active — its
        # issue PREDICATE is the dest's symbolicness)
        self.static_active_mask = None
        self.static_final_tx = False
        self.static_jump_patch_ok = False
        #: active-module names for the taint-refined reach plane
        #: (docs/static_pass.md; None = refinement off, raw mask)
        self.static_module_names = None
        # in-place SHA3 resume: off whenever a detector hooks SHA3
        # (the hook must fire host-side; no adapter lifts SHA3 today)
        self.resume_on = "SHA3" not in set(blocked_ops or ())
        self._resume_flag = 1 if self.resume_on else 0
        self.last_run_stats: Optional[dict] = None
        #: mid-flight wave export client (docs/checkpoint.md; set by
        #: svm from the migration bus): polled at every window
        #: boundary — `want(live)` lanes retire through the escalation
        #: gather, materialize, and hand to `deliver(states)` as an
        #: in-flight migration batch. None = seam off (the default).
        self.export_client = None
        #: live lane ctxs of an explore in progress (SIGTERM dump
        #: path: support/checkpoint.snapshot_live_states)
        self._explore_ctxs = None
        #: packed-wave issue attribution (docs/daemon.md §wave
        #: packing): owner tag -> context manager activating that
        #: request's RunContext, so drain-time site firing lands
        #: issues in the OWNING member's detector lists. None (the
        #: default, incl. every plain explore) fires sites under the
        #: caller's context — bit-for-bit today's behavior.
        self.owner_context = None
        #: per-boundary merge_fingerprint cache (None = not computed
        #: this boundary) shared by the window
        #: merge and the merge-before-spill pass — ONE dispatch serves
        #: both (docs/drain_pipeline.md)
        self._fp_boundary = None
        #: deferred retire/materialize ring of the explore in progress
        #: (laser/retire_ring.py); None between explores
        self._ring = None
        #: materialize() bumps stats off-thread under MTPU_MAT_WORKERS>1
        self._stats_lock = threading.Lock()

    def _full_bucket(self) -> int:
        """Full-width seed bucket for backlog drains, kept strictly
        below the plane width under a mesh, as the JAX engine keeps it
        (its k == n seed scatter trips the SPMD partitioner)."""
        return self.n_lanes if self.mesh is None \
            else max(self.n_lanes // 2, 1)

    # -- seeding ------------------------------------------------------------
    # (eligibility is decided by the caller: svm._lane_engine_sweep)

    def _env_words(self, gs: GlobalState):
        """(slot -> (concrete value | None, sid)) for the env plane,
        mirroring the corresponding instruction handlers."""
        env = gs.environment
        ms = gs.mstate

        def entry(val):
            # (concrete value, None) | (None, symbolic wrapper) — the
            # object slot must be None for concrete values: downstream
            # consumers test `obj is not None`
            if isinstance(val, int):
                return val, None
            if isinstance(val, BitVec) and val.value is not None:
                return val.value, None
            return None, val  # symbolic: sid assigned after adapters

        out = {}
        out["ADDRESS"] = entry(env.address)
        out["ORIGIN"] = entry(env.origin)
        out["CALLER"] = entry(env.sender)
        out["CALLVALUE"] = entry(env.callvalue)
        out["GASPRICE"] = entry(env.gasprice)
        out["COINBASE"] = entry(gs.new_bitvec("coinbase", 256))
        out["TIMESTAMP"] = entry(
            symbol_factory.BitVecSym("timestamp", 256))
        out["NUMBER"] = entry(env.block_number)
        out["DIFFICULTY"] = entry(gs.new_bitvec("block_difficulty", 256))
        out["GASLIMIT"] = entry(ms.gas_limit)
        out["CHAINID"] = entry(env.chainid)
        out["SELFBALANCE"] = entry(env.active_account.balance())
        out["BASEFEE"] = entry(env.basefee)
        return out

    def _seed_spec(self, gs: GlobalState, calldata_cap: int,
                   member=None):
        """(LaneCtx, host-side per-lane values) for one entry state.
        ``member`` is the packed-wave member record (owner tag, arena
        base, function-name map) or None for a plain explore."""
        env = gs.environment
        acct = env.active_account
        ms = gs.mstate

        # instruction index <-> byte address maps
        ilist = env.code.instruction_list
        code_len = len(code_to_bytes(env.code) or b"")
        addr2idx = np.full(max(code_len + 2, 2), len(ilist),
                           dtype=np.int32)
        for i, ins in enumerate(ilist):
            if ins["address"] < addr2idx.shape[0]:
                addr2idx[ins["address"]] = i

        storage_raw = acct.storage._standard_storage.raw
        virgin_zero = (
            storage_raw.op == T.CONST_ARRAY
            and T.is_const(storage_raw.args[0])
            and storage_raw.args[0].val == 0
        )

        calldata = env.calldata
        concrete_cd = (
            isinstance(calldata, ConcreteCalldata)
            and all(isinstance(x, int)
                    for x in calldata._concrete_calldata)
            and len(calldata._concrete_calldata)
            <= min(calldata_cap, SEED_CD)
        )

        gas0_min, gas0_max = ms.min_gas_used, ms.max_gas_used
        self._group_seq += 1
        dev_limit = max(int(ms.gas_limit) - int(gas0_min), 0) \
            if isinstance(ms.gas_limit, int) else 0xFFFFFFF

        if member is None:
            ctx = LaneCtx(gs, addr2idx, storage_raw, calldata,
                          gas0_min, gas0_max)
        else:
            ctx = LaneCtx(gs, addr2idx, storage_raw, calldata,
                          gas0_min, gas0_max, owner=member.owner,
                          code_base=member.base,
                          func_names=member.func_names)

        envw = self._env_words(gs)
        if self.adapters:
            # taint seeding: annotating the env source terms once per
            # seed is host-equivalent — the interpreter's post-hooks
            # annotate the same shared wrapper the handlers push.
            # Adapters may also REPLACE an entry (e.g. ORIGIN gets its
            # own wrapper so the shared sender object isn't tainted)
            env_objects = {
                name: obj for name, (val, obj) in envw.items()
                if obj is not None
            }
            for ad in self.adapters:
                ad.seed_env(env_objects, gs)
            envw = {
                name: (val, env_objects.get(name, obj))
                for name, (val, obj) in envw.items()
            }
        env_vals = np.zeros((symstep.N_ENV, bv256.NLIMBS), np.uint32)
        env_sids = np.zeros(symstep.N_ENV, np.int32)
        for name, slot in symstep.ENV_SLOTS.items():
            val, obj = envw[name]
            if obj is not None:
                env_sids[slot] = self.objects.add(obj)
            else:
                env_vals[slot] = bv256.int_to_limbs(val or 0)

        cd_buf = np.zeros(calldata_cap, np.uint8)
        cd_size = 0
        cd_sym = 0
        cd_size_sid = 0
        if concrete_cd:
            data = calldata._concrete_calldata
            cd_buf[: len(data)] = np.asarray(data, np.uint8)
            cd_size = len(data)
        else:
            cd_sym = 1
            size = calldata.calldatasize
            if isinstance(size, BitVec) and size.value is not None:
                cd_size = min(int(size.value), 1 << 29)
            else:
                cd_size_sid = self.objects.add(size)

        # mid-path seeds (host spill/refill): device pc is a byte
        # address; stack objects become sids; memory must be concrete
        # bytes (ints or concrete 8-bit terms — eligibility checked by
        # svm.lane_seedable)
        n_depth = self.lane_kwargs.get("stack_depth", 64)
        mem_cap = self.lane_kwargs.get("memory_bytes", 4096)
        if len(ms.stack) > min(SEED_STACK, n_depth) or int(
            ms.memory_size
        ) > min(SEED_MEM, mem_cap):
            # callers gate on lane_seedable; packing would silently
            # truncate a deeper state into wrong execution
            raise ValueError("seed exceeds SEED_STACK/SEED_MEM columns")
        byte_pc = 0
        if ms.pc:
            byte_pc = ilist[ms.pc]["address"]
        if member is not None:
            byte_pc += member.base  # seed in arena coordinates
        stack_v = np.zeros((n_depth, bv256.NLIMBS), np.uint32)
        stack_s = np.zeros(n_depth, np.int32)
        for i, item in enumerate(ms.stack):
            if isinstance(item, int):
                stack_v[i] = bv256.int_to_limbs(item)
            elif isinstance(item, BitVec) and item.value is not None:
                stack_v[i] = bv256.int_to_limbs(item.value)
            else:
                if isinstance(item, Bool):
                    item = If(item, _bv_val(1), _bv_val(0))
                stack_s[i] = self.objects.add(item)
        mem_v = np.zeros(mem_cap, np.uint8)
        mem_k = np.zeros(mem_cap, np.uint8)
        for key, val in ms.memory._memory.items():
            if isinstance(val, int):
                mem_v[key] = val & 0xFF
                mem_k[key] = symstep.KIND_BYTE_INT
            else:  # concrete 8-bit term (eligibility guarantees)
                mem_v[key] = val.value & 0xFF
                mem_k[key] = symstep.KIND_CONC_WORD

        return ctx, dict(
            group=self._group_seq,
            sbase=0 if virgin_zero else 1,
            calldata=cd_buf, cd_size=cd_size, cd_sym=cd_sym,
            cd_size_sid=cd_size_sid, env=env_vals, env_sid=env_sids,
            gas_limit=dev_limit,
            pc=byte_pc, sp=len(ms.stack), msize=int(ms.memory_size),
            stack_v=stack_v, stack_s=stack_s, mem_v=mem_v, mem_k=mem_k,
        )

    def _pack_window(self, entries, ctxs: List[Optional[LaneCtx]],
                     free, kill, calldata_cap: int, big: bool = False,
                     resumes=()):
        """Pack EVERYTHING the next window dispatch needs from the host
        into two flat buffers (one i32, one u8): seed rows, free-slot
        stack, the previous drain's provisional-sid resolutions, and
        the kill list — each host->device copy pays its own latency,
        so the count is what matters.
        Returns (i32buf, u8buf, k, pv) with the layout of
        _seed_sections, the buffers on the engine's device."""
        lanes, specs = [], []
        with _prof("seed_pack"):
            for lane, gs, member in entries:
                ctx, spec = self._seed_spec(gs, calldata_cap, member)
                ctxs[lane] = ctx
                lanes.append(lane)
                specs.append(spec)
        # two seed buckets: the small one covers the common trickle,
        # the full-width one drains seed floods in one window
        i32buf, u8buf, k, pv = pack_window(
            self.n_lanes, symstep.N_ENV, self.lane_kwargs,
            list(zip(lanes, specs)), free, kill, self._prov,
            calldata_cap, big=big, resumes=resumes,
            meshed=self.mesh is not None)
        self.stats["seeded"] += len(entries)
        # mid-path re-entries (the spill/refill path) vs fresh tx seeds
        self.stats["reseeded"] += sum(1 for s in specs if s["pc"])
        if self.mesh is not None:  # window_exec_mesh splits them
            return i32buf, u8buf, k, pv
        return (torch.from_numpy(i32buf).to(self.device),
                torch.from_numpy(u8buf).to(self.device), k, pv)

    # -- drain ---------------------------------------------------------------

    def _resolve_arg(self, sid: int, val_limbs, prov: Dict[Tuple[int, int],
                                                           int], d_recs):
        if sid == 0:
            return _bv_val(_limbs_int(val_limbs))
        if sid > 0:
            return self.objects[sid]
        idx = -sid - 1
        key = (idx // d_recs, idx % d_recs)
        return self.objects[prov[key]]

    @contextmanager
    def _owner_run(self, ctx: LaneCtx):
        """Host work for one lane of a packed wave runs under the lane
        owner's RunContext (``owner_context``): the keccak manager and
        the detector lists are per-analysis singletons, and the wave is
        dispatched under whichever member arrived last. A solo wave
        runs under the caller's own context."""
        if self.owner_context is None:
            yield
            return
        from .retire_ring import owner_of

        with self.owner_context(owner_of(ctx)):
            yield

    def _resolve_record(self, ctx: LaneCtx, opname: str, args):
        """args: raw resolved operand objects in pop order."""
        if opname in _ALU2:
            return _ALU2[opname](alu.to_bitvec(args[0]),
                                 alu.to_bitvec(args[1]))
        if opname in _ALU3:
            return _ALU3[opname](alu.to_bitvec(args[0]),
                                 alu.to_bitvec(args[1]),
                                 alu.to_bitvec(args[2]))
        if opname == "EQ":
            return alu.eq(args[0], args[1])
        if opname == "ISZERO":
            return alu.iszero(args[0])
        if opname == "NOT":
            return alu.not_(alu.to_bitvec(args[0]))
        if opname == "EXP":
            result, constraint = alu.exp(alu.to_bitvec(args[0]),
                                         alu.to_bitvec(args[1]))
            assert constraint is None, \
                "device deferred an impure EXP (stepper bug)"
            return result
        if opname == "CALLDATALOAD":
            off = alu.to_bitvec(args[0])
            key = (id(ctx.calldata), off.raw.tid)
            hit = self._cdl_cache.get(key)
            if hit is not None:
                return hit[1]
            cached = ctx.calldata.get_word_at(off)
            if len(self._cdl_cache) > _CDL_CACHE_CAP:
                self._cdl_cache.clear()
            # the value pins the calldata object: its id (the key) can
            # never be recycled onto a different calldata while the
            # entry is live
            self._cdl_cache[key] = (ctx.calldata, cached)
            return cached
        if opname == "SLOAD":
            return _storage_read_term(ctx.storage_seed_raw,
                                      alu.to_bitvec(args[0]))
        if opname == "BALANCE":
            # symbolic address: the interpreter reads the global
            # balances array directly (instructions.py balance_)
            return ctx.template.world_state.balances[
                alu.to_bitvec(args[0])]
        if opname == "SHA3":
            # device-read input words + packed meta (length + per-byte
            # memory kinds). Rebuild the hash input byte-for-byte the
            # way the interpreter's sha3_ handler reads Memory (ints
            # for untouched/MSTORE8 bytes, 8-bit const terms for
            # concrete-word bytes, Extract slices for symbolic words):
            # the keccak input term tids then match the host exactly.
            from .function_managers import keccak_function_manager

            meta = alu.to_bitvec(args[2]).value
            length = meta & 0xFFFFFFFF
            all_sym_kinds = (1 << 64) - 1  # every 2-bit field == 3
            byte_list: list = []
            for w in range(length // 32):
                kinds = (meta >> (32 + w * 64)) & all_sym_kinds
                if kinds == all_sym_kinds:  # sid-carried word term
                    word = _mem_word(args[w])
                    byte_list.extend(
                        simplify(Extract(255 - 8 * j, 248 - 8 * j,
                                         word))
                        for j in range(32))
                    continue
                word_int = alu.to_bitvec(args[w]).value or 0
                raw = word_int.to_bytes(32, "big")
                for j in range(32):
                    kind = (kinds >> (2 * j)) & 3
                    if kind == symstep.KIND_CONC_WORD:
                        byte_list.append(
                            symbol_factory.BitVecVal(raw[j], 8))
                    else:
                        byte_list.append(raw[j])
            if all(isinstance(bb, int) for bb in byte_list):
                data = symbol_factory.BitVecVal(
                    int.from_bytes(bytes(byte_list), "big"),
                    length * 8)
            else:
                parts = [
                    bb if isinstance(bb, BitVec)
                    else symbol_factory.BitVecVal(bb, 8)
                    for bb in byte_list
                ]
                data = simplify(Concat(parts))
            # the hash and its axioms belong to the lane owner's
            # analysis, not to the member that dispatched the wave
            with self._owner_run(ctx):
                return keccak_function_manager.create_keccak(data)
        raise AssertionError(f"unresolvable deferred op {opname}")

    def _jumpi_site_work(self, ctx, lane, cond, step, byte_pc,
                         fentry, gmin, gmax, dest=0):
        """Drain-time detector work for one path-condition record:
        per-lane sink promotions, plus site-firing modules deduped
        across the sibling lanes sharing the record (the interpreter
        fires its pre-hook once per JUMPI execution; issue identity is
        per (site, condition, path prefix)). The site's stack tail is
        the real pre-hook stack [-2]=condition, [-1]=jump destination
        (always concrete on device — forks require dest_ok)."""
        prefix = [c for (_, c) in ctx.conds]
        site = _DrainSite(self, ctx, step, byte_pc, fentry, gmin, gmax,
                          stack_tail=(cond, _bv_val(dest)),
                          prefix=prefix)
        for ad in self.adapters:
            anns = ad.on_jumpi(cond, site)
            if anns:
                ctx.promos.setdefault(id(ad), []).extend(
                    (step, a) for a in anns)
        key = (step, byte_pc, cond.raw.tid,
               tuple(c.raw.tid for c in prefix))
        if key in self._fired_sites:
            return
        self._fired_sites.add(key)
        if self.owner_context is not None:
            # packed wave: site-firing modules append to the global
            # detector singletons, so fire under the lane OWNER's
            # RunContext (per-request issue attribution)
            from .retire_ring import owner_of

            with self.owner_context(owner_of(ctx)):
                for ad in self.adapters:
                    ad.on_jumpi_site(cond, site)
            return
        for ad in self.adapters:
            ad.on_jumpi_site(cond, site)

    def _drain_host(self, recs, forks,
                    ctxs: List[Optional[LaneCtx]]
                    ) -> Tuple[Dict[Tuple[int, int], int], List[int]]:
        """Resolve one window's canonical records and fork table into
        facade terms; returns (provisional-sid resolutions, dead
        lanes). Pure host work — the provisional remap + log reset
        ride the NEXT window's fused dispatch.

        recs: [(step, lane, slot, op, pc, fentry, sids(3), vals(3,8))]
        — one entry per DISTINCT term (device-deduped; `lane` is the
        canonical instance's lane). forks: [(step, parent, child, pc,
        sid, gmin, gmax, fentry)]. Events interleave in global step
        order, so a fork clones its parent's context exactly as
        accumulated at that step — condition prefixes, sink
        promotions, and annotations inherit by construction (the
        interpreter's deepcopy-at-JUMPI semantics)."""
        from .retire_ring import owner_of

        d_recs = self.lane_kwargs.get("dlog_records", 64)
        _t_drain_py = time.perf_counter() if PROF_ON else 0.0
        prov: Dict[Tuple[int, int], int] = {}
        dead: List[int] = []
        dead_set: set = set()
        events = [(r[0], 0, r) for r in recs] \
            + [(f[0], 1, f) for f in forks]
        events.sort(key=lambda e: (e[0], e[1]))
        for _, kind, ev in events:
            if kind == 0:
                step, lane, slot, op, pc, fentry, sids, vals = ev
                opname = "SLOAD_RW" if op == symstep.REC_SLOAD_RW \
                    else _OPN[op]
                ctx = ctxs[lane]
                if opname == "SSTORE":
                    # write-mirror + taint-sink record (never deduped,
                    # per-lane): the mirror feeds SLOAD_RW resolution
                    value = self._resolve_arg(sids[1], vals[1], prov,
                                              d_recs)
                    key = self._resolve_arg(sids[0], vals[0], prov,
                                            d_recs)
                    ctx.swrites.append((alu.to_bitvec(key),
                                        alu.to_bitvec(value)))
                    if lane in dead_set:
                        continue
                    site = _DrainSite(self, ctx, step, pc, fentry)
                    for ad in self.adapters:
                        for ann in ad.on_sstore(alu.to_bitvec(value),
                                                site,
                                                alu.to_bitvec(key)):
                            ctx.promos.setdefault(id(ad), []).append(
                                (step, ann))
                    continue
                if opname == "SLOAD_RW":
                    # mode SLOAD: read-over-write over the per-path
                    # mirror, folded onto the seed storage (the lane's
                    # write history at this step is exactly
                    # ctx.swrites — records replay in step order).
                    # Never memoized: identical (key, pc) records on
                    # different paths see different mirrors.
                    key = alu.to_bitvec(self._resolve_arg(
                        sids[0], vals[0], prov, d_recs))
                    term = _storage_read_term(ctx.storage_seed_raw,
                                              key)
                    for wk, wv in ctx.swrites:
                        term = If(wk == key, wv, term)
                    term = simplify(term)
                    if isinstance(term, Bool):
                        term = If(term, _bv_val(1), _bv_val(0))
                    prov[(lane, slot)] = self.objects.add(term)
                    continue
                # cross-WINDOW dedup via the memo (the device already
                # deduped within the window)
                key_parts = [opname]
                for j in range(_ARITY[opname]):
                    sid = sids[j]
                    if sid == 0:
                        key_parts.append(("c", _limbs_int(vals[j])))
                    elif sid > 0:
                        key_parts.append(("o", sid))
                    else:
                        idx = -sid - 1
                        key_parts.append(
                            ("o", prov[(idx // d_recs,
                                        idx % d_recs)]))
                # SLOAD/CALLDATALOAD resolve against per-seed context;
                # pin the template so its id (part of the key) cannot
                # be recycled while the memo entry is live
                if opname in ("SLOAD", "CALLDATALOAD", "BALANCE"):
                    key_parts.append(("ctx", id(ctx.template)))
                    self._memo_pins.append(ctx.template)
                # annotated arithmetic is per-site AND per-seed: two
                # executions at different pcs (or from different entry
                # states) must annotate separately — the interpreter
                # captures a distinct ostate per execution
                if opname in self._annot_ops:
                    key_parts.append(("pc", pc, "ctx",
                                      id(ctx.template)))
                    self._memo_pins.append(ctx.template)
                # a packed wave's tenants never share a resolved term:
                # a SHA3 lives in its owner's keccak manager
                key_parts.append(("owner", owner_of(ctx)))
                key = tuple(key_parts)
                oid = self._record_memo.get(key)
                if oid is None:
                    args = [
                        self._resolve_arg(sids[j], vals[j], prov,
                                          d_recs)
                        for j in range(3)
                    ]
                    if opname in self._annot_ops:
                        site = _DrainSite(self, ctx, step, pc, fentry)
                        cargs = [alu.to_bitvec(x)
                                 if not isinstance(x, int)
                                 else _bv_val(x) for x in args[:2]]
                        for ad in self.adapters:
                            ad.pre_resolve(opname, cargs, site)
                        args[:2] = cargs
                    obj = self._resolve_record(ctx, opname, args)
                    # sids model stack slots: apply MachineStack
                    # .append's coercion (state/machine_state.py)
                    if isinstance(obj, Bool):
                        obj = If(obj, _bv_val(1), _bv_val(0))
                    elif isinstance(obj, int):
                        obj = _bv_val(obj)
                    oid = self.objects.add(obj)
                    if len(self._record_memo) > _RECORD_MEMO_CAP:
                        self._record_memo.clear()
                    self._record_memo[key] = oid
                prov[(lane, slot)] = oid
            else:
                (step, parent, child, pc, sid, gmin, gmax, fentry,
                 dest) = ev
                ctx = ctxs[parent]
                if parent in dead_set:
                    # descendants of a trivially-false path die with it
                    ctxs[child] = ctx.clone()
                    dead_set.add(child)
                    dead.append(child)
                    continue
                if sid > 0:
                    cond = self.objects[sid]
                else:
                    idx = -sid - 1
                    cond = self.objects[prov[(idx // d_recs,
                                              idx % d_recs)]]
                if self.adapters:
                    self._jumpi_site_work(ctx, parent, cond, step, pc,
                                          fentry, gmin, gmax, dest)
                ctxs[child] = cctx = ctx.clone()
                if isinstance(cond, Bool):
                    chosen_p = simplify(cond)
                    chosen_c = simplify(Not(cond))
                else:
                    chosen_p = cond != 0
                    chosen_c = cond == 0
                if chosen_p.is_false:
                    dead_set.add(parent)
                    dead.append(parent)
                else:
                    ctx.conds.append((step, chosen_p))
                if chosen_c.is_false:
                    dead_set.add(child)
                    dead.append(child)
                else:
                    cctx.conds.append((step, chosen_c))
        self.stats["records"] += len(recs)
        self.stats["forks"] += len(forks)
        self.stats["dead"] += len(dead)

        if PROF_ON:
            PROF["drain_py"] = PROF.get("drain_py", 0.0) \
                + time.perf_counter() - _t_drain_py
        return prov, dead

    # -- materialization -----------------------------------------------------

    def _obj(self, sid: int, prov: Optional[dict] = None):
        """Object for a retired-row sid: positive sids index the table;
        negative sids are this window's provisional records, resolved
        through the drain's (lane, slot) map (the device-side remap only
        lands at the NEXT window's dispatch — retired rows are pulled
        before that). `prov` is an explicit snapshot of that map for
        ring-deferred materialization: the next drain REPLACES
        self._prov, and a chunk materializing after that boundary (a
        worker-pool build, or a deep ring) must resolve against the
        map of the window it retired in."""
        if sid > 0:
            return self.objects[sid]
        d_recs = self.lane_kwargs.get("dlog_records", 64)
        idx = -sid - 1
        table = self._prov if prov is None else prov
        return self.objects[table[(idx // d_recs, idx % d_recs)]]

    def _try_resume(self, rows: dict, i: int, byte_pc: int, sp: int
                    ) -> Optional[tuple]:
        """Replay sha3_ semantics (laser/instructions.py:395-448) for a
        held lane from its slim row; returns the device patch
        (pc, sp, msize, min_gas, max_gas, sid, limbs) or None to
        decline (symbolic length, out-of-gas, oversized hash — the
        escalation path then hands the lane to the interpreter, which
        owns the constraint-adding and exception semantics)."""
        from ..support.eth_constants import (
            GAS_MEMORY, GAS_MEMORY_QUADRATIC_DENOMINATOR, ceil32,
        )
        from .function_managers import keccak_function_manager
        from .instruction_data import calculate_sha3_gas
        from .transaction import tx_id_manager

        if int(rows["sid_sub"][i]):
            return None  # symbolic length: interpreter concretizes
        length = _limbs_int(rows["sub"][i])
        if length > 4096:
            return None  # oversized: not worth modeling off-row
        min_gas = int(rows["min_gas"][i])
        max_gas = int(rows["max_gas"][i])
        sha3_min, sha3_max = calculate_sha3_gas(length)
        min_gas += sha3_min
        max_gas += sha3_max

        msize = int(rows["msize"][i])
        new_msize = msize
        sid_top = int(rows["sid_top"][i])
        index = None
        if sid_top == 0:
            index = _limbs_int(rows["top"][i])
            if index + length > 1 << 20:
                return None
            if length > 0 and msize <= index + length:
                # mem_extend: word-aligned growth + quadratic fee
                # (state/machine_state.py:96-142)
                new_msize = ceil32(index + length)
                for size, sign in ((new_msize, 1), (msize, -1)):
                    words = size // 32
                    fee = words * GAS_MEMORY + words ** 2 \
                        // GAS_MEMORY_QUADRATIC_DENOMINATOR
                    min_gas += sign * fee
                    max_gas += sign * fee
                if new_msize > self.lane_kwargs.get(
                        "memory_bytes", 4096):
                    return None  # outgrows the device planes
        if min_gas >= int(rows["gas_limit"][i]):
            return None  # OOG: the interpreter owns the exception

        if length == 0:
            result = keccak_function_manager.get_empty_keccak_hash()
        elif index is None:
            # symbolic offset: hash a fresh per-site symbolic input
            # (instructions.py:421-432)
            result = keccak_function_manager.create_keccak(
                symbol_factory.BitVecSym(
                    f"sha3_input_{tx_id_manager.get_next_tx_id()}",
                    length * 8,
                ))
        else:
            mem = rows["memory"][i]
            kind = rows["mkind"][i]
            sym_cover: Dict[int, Tuple[object, int]] = {}
            for r in range(int(rows["mlog_count"][i])):
                off = int(rows["mlog_off"][i, r])
                for j in range(int(rows["mlog_len"][i, r])):
                    sym_cover[off + j] = (
                        self._obj(int(rows["mlog_sid"][i, r])), j)
            byte_list = []
            for j in range(index, index + length):
                k = int(kind[j]) if j < RESUME_MEM else 0
                if k == symstep.KIND_SYM_WORD:
                    obj, jj = sym_cover[j]
                    byte_list.append(simplify(
                        Extract(255 - 8 * jj, 248 - 8 * jj,
                                _mem_word(obj))))
                elif k == symstep.KIND_CONC_WORD:
                    byte_list.append(
                        symbol_factory.BitVecVal(int(mem[j]), 8))
                else:  # written int byte, or the default-zero region
                    byte_list.append(int(mem[j]) if j < RESUME_MEM
                                     else 0)
            if all(isinstance(b, int) for b in byte_list):
                data = symbol_factory.BitVecVal(
                    int.from_bytes(bytes(byte_list), "big"),
                    length * 8)
            else:
                parts = [
                    b if isinstance(b, BitVec)
                    else symbol_factory.BitVecVal(b, 8)
                    for b in byte_list
                ]
                data = simplify(Concat(parts))
            result = keccak_function_manager.create_keccak(data)

        if result.value is not None and not result.annotations:
            sid, limbs = 0, bv256.int_to_limbs(result.value)
        else:
            sid, limbs = self.objects.add(result), None
        return (byte_pc + 1, sp - 1, new_msize, min_gas, max_gas,
                sid, limbs)

    def materialize(self, st_host: dict, lane: int,
                    ctx: LaneCtx,
                    prov: Optional[dict] = None) -> GlobalState:
        """Rebuild a host GlobalState for a parked lane. `st_host` holds
        the lane's rows on the host (``_unpack_rows``); `prov` is an
        optional snapshot
        of the provisional-sid map for ring-deferred builds (see
        _obj)."""
        # copy(), not deepcopy() — interpreter-fork sharing semantics;
        # per-lane Account/Storage instances keep mutations independent
        gs = copy(ctx.template)
        ms = gs.mstate

        for _, cond in ctx.conds:
            gs.world_state.constraints.append(cond)

        # device pcs are arena coordinates under a packed wave (the
        # ctx carries its member segment's base, 0 unpacked); fentry
        # values are member-local by construction (symstep records the
        # pushed destination, not the arena pc)
        byte_pc = int(st_host["pc"][lane]) - ctx.code_base
        ms.pc = int(ctx.addr2idx[min(max(byte_pc, 0),
                                     ctx.addr2idx.shape[0] - 1)])
        ms.depth += int(st_host["depth"][lane])
        # active function from the last function-entry jump the device
        # took (svm._new_node_state parity for host-executed jumps)
        fentry = int(st_host["fentry"][lane])
        fnames = ctx.func_names if ctx.func_names is not None \
            else self._func_names
        if fentry >= 0 and fentry in fnames:
            gs.environment.active_function_name = fnames[fentry]
        ms.min_gas_used = ctx.gas0_min + int(st_host["min_gas"][lane])
        ms.max_gas_used = ctx.gas0_max + int(st_host["max_gas"][lane])

        # top-level STOP park with slim_stop: the transaction-end path
        # (svm._fast_terminal, or the normal STOP path when it
        # declines) reads neither the stack nor memory bytes — skip
        # both rebuilds. Storage, constraints, gas, promotions, and
        # annotations below still rebuild in full.
        slim = (
            self.slim_stop
            and ms.pc < len(gs.environment.code.instruction_list)
            and gs.environment.code.instruction_list[ms.pc]["opcode"]
            == "STOP"
            and gs.transaction_stack
            and gs.transaction_stack[-1][1] is None
        )

        # stack: the device planes hold the COMPLETE current stack
        # (mid-path re-seeds arrive with the template's entries already
        # on device) — rebuild from scratch, never append to the
        # template's copy
        del ms.stack[:]
        sp = 0 if slim else int(st_host["sp"][lane])
        for s in range(sp):
            sid = int(st_host["ssid"][lane, s])
            if sid:
                ms.stack.append(self._obj(sid, prov))
            else:
                ms.stack.append(
                    _bv_val(_limbs_int(st_host["stack"][lane, s])))

        # memory: reproduce the byte-level representation the Memory
        # class would hold after the same writes — MSTORE8 bytes as
        # ints, concrete-word bytes as 8-bit const terms, symbolic-word
        # bytes as Extract slices (state/memory.py:61-88). Like the
        # stack, the device planes are the complete state: reset the
        # template's copy before rebuilding
        ms.memory._memory.clear()
        ms.memory._msize = 0
        msize = int(st_host["msize"][lane])
        if slim:
            ms.memory._msize = msize  # size for fidelity, no content
            msize = 0
        if msize:
            ms.memory.extend(msize)
            mem = st_host["memory"][lane]
            kind = st_host["mkind"][lane]
            sym_cover: Dict[int, Tuple[object, int]] = {}
            for r in range(int(st_host["mlog_count"][lane])):
                off = int(st_host["mlog_off"][lane, r])
                ln = int(st_host["mlog_len"][lane, r])
                obj = self._obj(int(st_host["mlog_sid"][lane, r]),
                                prov)
                for j in range(ln):
                    sym_cover[off + j] = (obj, j)
            for i in np.nonzero(kind)[0]:
                i = int(i)
                k = int(kind[i])
                if k == symstep.KIND_BYTE_INT:
                    ms.memory[i] = int(mem[i])
                elif k == symstep.KIND_CONC_WORD:
                    ms.memory[i] = BitVec(_bv8_raw(int(mem[i])))
                else:  # KIND_SYM_WORD
                    obj, j = sym_cover[i]
                    ms.memory[i] = simplify(
                        Extract(255 - 8 * j, 248 - 8 * j, _mem_word(obj)))

        # storage: replay reads/writes in keys_get/keys_set parity order
        # — the interpreter records *every* read, so a slot read before
        # its first write (s_read bit 1) replays a read ahead of the
        # store, and one read after a write (bit 2) replays one behind
        acct = gs.environment.active_account
        any_written = False
        scount = int(st_host["scount"][lane])
        entries = []
        for r in range(scount):
            sidk = int(st_host["skey_sid"][lane, r])
            key = alu.to_bitvec(self._obj(sidk, prov)) if sidk else \
                _bv_val(_limbs_int(st_host["skeys"][lane, r]))
            entries.append((
                key,
                int(st_host["s_written"][lane, r]),
                int(st_host["s_read"][lane, r]),
                int(st_host["sval_sid"][lane, r]),
                r,
                int(st_host["s_wstep"][lane, r]),
                sidk,
            ))

        def _sval(r, sid):
            if sid:
                return self._obj(sid, prov)
            return _bv_val(_limbs_int(st_host["svals"][lane, r]))

        if not any(e[6] for e in entries):
            # concrete keys only: slot order == the historical replay
            for key, written, sread, sid, r, _w, _k in entries:
                if sread & 1:
                    _ = acct.storage[key]
                if written:
                    any_written = True
                    acct.storage[key] = _sval(r, sid)
                if sread & 2:
                    _ = acct.storage[key]
        else:
            # symbolic keys may alias: the host Storage builds the
            # read-over-write term, so writes must replay in device
            # step order (s_wstep) for later writes to shadow earlier
            # maybe-equal ones
            for key, written, sread, sid, r, _w, _k in entries:
                if sread & 1:
                    _ = acct.storage[key]
            for key, written, sread, sid, r, _w, _k in sorted(
                    (e for e in entries if e[1]), key=lambda e: e[5]):
                any_written = True
                acct.storage[key] = _sval(r, sid)
            for key, written, sread, sid, r, _w, _k in entries:
                if sread & 2:
                    _ = acct.storage[key]
        if any_written:
            # device-executed SSTOREs must leave the same mark the
            # mutation-pruner's SSTORE hook would have left, or clean-
            # path pruning drops the mutated end state
            from .plugin.plugins.plugin_annotations import (
                MutationAnnotation,
            )
            if not list(gs.get_annotations(MutationAnnotation)):
                gs.annotate(MutationAnnotation())

        # adapter state transfer (sink promotions, last-jump tracking)
        if self.adapters:
            last_jump = int(st_host["last_jump"][lane]) \
                if "last_jump" in st_host else -1
            if last_jump >= 0:
                last_jump -= ctx.code_base  # arena -> member-local
            for ad in self.adapters:
                plist = ctx.promos.get(id(ad), ())
                ad.attach(gs, [a for (_, a) in plist], last_jump)

        # spill/refill marker: the state parked AT this instruction
        # because the device could not execute it — it must take at
        # least one host step before becoming re-seedable (the marker
        # does not survive GlobalState.__copy__, so the post-step
        # states are eligible again)
        gs._lane_parked_pc = ms.pc

        # guarded: ring workers (MTPU_MAT_WORKERS>1) materialize off
        # the engine thread, and `+= 1` is not GIL-atomic
        with self._stats_lock:
            self.stats["parked"] += 1
        return gs

    # -- per-explore memo hygiene --------------------------------------------

    def _reset_explore_memos(self) -> None:
        """Clear the id-/site-keyed memos at every explore. Persistent
        engines (corpus runs) otherwise grow them without bound, and
        their keys — object ids, (step, pc) tuples — alias across
        codes once the owning objects die. Within one explore the
        memo values/pins keep the id-keyed owners alive, so id reuse
        cannot corrupt a live entry."""
        self._cdl_cache.clear()
        self._record_memo.clear()
        self._fired_sites.clear()
        self._memo_pins.clear()
        self._static_clean.clear()

    # -- overlapped fork-feasibility screening -------------------------------

    def _screen_forks(self, queries, registry):
        """Batched feasibility discharge for still-running forked
        lanes' condition prefixes (smt/solver/batch.py): runs in the
        OVERLAPPED phase — the device is already executing the next
        window — so the solver work that used to serialize behind the
        drain now hides behind device execution. Returns the lanes
        whose prefix is provably UNSAT; they join the next dispatch's
        kill list. Sound: only proved-infeasible paths die (the same
        guarantee as the host's prune_feasible_states, and engaged
        under the same args.pruning_factor gate — the default-off host
        policy keeps lane/host path counts identical by default).
        Screening a lane's conds WITHOUT the keccak axioms is sound
        for killing: an UNSAT subset implies an UNSAT superset. The
        discharge also consults the RUN-WIDE verdict cache
        (smt/solver/verdicts.py): a prefix refuted in any earlier
        window or call site kills its descendants here without a
        solve, and prefixes this screen refutes kill the open-state
        screen's supersets later. With MTPU_PROPAGATE on the
        discharge additionally runs the bidirectional propagation
        prescreen FIRST (ops/propagate.py): product-domain kills
        before any solver work, and harvested facts hint the solves
        that survive (docs/propagation.md)."""
        from ..smt import Model
        from ..smt.solver import batch as solver_batch
        from ..support.model import model_cache

        term_sets = [[c.raw for c in conds] for _, conds in queries]

        def quick_sat(conj):
            return model_cache.check_quick_sat(conj)

        def on_sat_model(md):
            # feed the shared ModelCache: sibling lanes (and later
            # open-state screens) quick-sat against this model
            model_cache.put(Model([md]), 1)

        t0 = time.perf_counter()
        # a failure of the discharge (its device prescreen included)
        # raises to the caller
        with trace.span("lane.fork_screen", n=len(queries)):
            verdicts = solver_batch.discharge(
                term_sets, timeout_s=2.0, conflict_budget=16384,
                quick_sat=quick_sat, on_sat_model=on_sat_model,
                registry=registry)
        self.stats["overlap_solve_ms"] += int(
            (time.perf_counter() - t0) * 1000)
        self.stats["fork_screened"] += len(queries)
        return [lane for (lane, _), v in zip(queries, verdicts)
                if v == solver_batch.UNSAT]

    def _submit_fork_screen(self, queries, registry):
        """Start the fork-feasibility screen for this window's touched
        lanes. With the solver pool parallel (smt/solver/pool.py) the
        batch goes through `discharge_async` right away at the drain —
        the pool's workers solve it while this thread packs and
        dispatches the next window and blocks in the device pull — and
        the returned token is collected one boundary later
        (_collect_fork_screen), booking the hidden wall as
        async_overlap_ms. With the pool serial the token defers the
        whole screen to collection time, which lands in the overlapped
        phase exactly where the synchronous screen ran before — the
        K=1 path behaves as the synchronous screen."""
        from ..smt.solver import pool as pool_mod

        if not pool_mod.get_pool().parallel:
            return (queries, registry, None)
        from ..smt import Model
        from ..smt.solver import batch as solver_batch
        from ..support.model import model_cache

        term_sets = [[c.raw for c in conds] for _, conds in queries]

        def quick_sat(conj):
            return model_cache.check_quick_sat(conj)

        def on_sat_model(md):
            model_cache.put(Model([md]), 1)

        fut = solver_batch.discharge_async(
            term_sets, timeout_s=2.0, conflict_budget=16384,
            quick_sat=quick_sat, on_sat_model=on_sat_model,
            registry=registry)
        return (queries, registry, fut)

    def _collect_fork_screen(self, token):
        """Verdicts for a screen started at the previous boundary;
        returns the proved-UNSAT lanes for the next dispatch's kill
        list (same protocol as the synchronous screen)."""
        queries, registry, fut = token
        if fut is None:
            return self._screen_forks(queries, registry)
        from ..smt.solver import batch as solver_batch

        verdicts = fut.result()  # a failed screen raises here
        self.stats["overlap_solve_ms"] += int(fut.duration_ms)
        self.stats["fork_screened"] += len(queries)
        return [lane for (lane, _), v in zip(queries, verdicts)
                if v == solver_batch.UNSAT]

    # -- window-boundary lane merge / subsumption ----------------------------

    def _template_static_clean(self, ctx: LaneCtx) -> bool:
        """No pending PotentialIssues ride the lane's seed state (a
        statically-dead lane carrying one must still reach a terminator
        to discharge it). Memoized per template per explore."""
        key = id(ctx.template)
        cached = self._static_clean.get(key)
        if cached is None:
            try:
                from ..analysis.potential_issues import (
                    PotentialIssuesAnnotation,
                )

                cached = not any(
                    isinstance(a, PotentialIssuesAnnotation)
                    and a.potential_issues
                    for a in ctx.template.annotations)
            except Exception:
                cached = False
            self._static_clean[key] = cached
            self._memo_pins.append(ctx.template)
        return cached

    def _static_retire(self, status, ctxs, dead_set, kill,
                       counts_h, resumes) -> None:
        """Window-boundary static retire (docs/static_pass.md): a lane
        whose per-PC reachable-detector mask has no bit in common with
        the run's active-detector mask can never mint another issue; if
        additionally no open-state terminator is reachable — or no
        later round consumes open states and nothing is pending on the
        lane — it retires on the next dispatch's kill list with ZERO
        solver or materialization work (`statically_retired`). Runs
        BEFORE the merge pass so retired lanes never cost a fingerprint
        dispatch. Gated by MTPU_STATIC via the info lookup and by svm
        actually setting an active mask."""
        info = self._static_info
        active = self.static_active_mask
        if info is None or active is None:
            return
        from ..analysis.static_pass import TERMINATOR_BIT

        # taint-refined plane for the active-module set: anchor
        # sites whose trigger operands are provably
        # attacker-independent stop holding lanes alive; None falls
        # back to the raw reach mask (MTPU_TAINT=0, unconverged taint
        # fixpoint, or a module with unknown trigger semantics)
        plane = None
        if self.static_module_names is not None:
            try:
                from ..analysis import static_pass

                plane = static_pass.refined_plane(
                    info, self.static_module_names)
            except Exception:
                plane = None

        active = int(active)
        final_tx = bool(self.static_final_tx)
        excluded = dead_set | set(kill) | {r[0] for r in resumes}
        pcs = counts_h["pc"]
        retired = 0
        for lane in range(self.n_lanes):
            ctx = ctxs[lane]
            if (ctx is None or lane in excluded
                    or status[lane] != Status.RUNNING):
                continue
            if ctx.promos:
                continue  # pending drain promotions: must materialize
            mask = info.mask_at(int(pcs[lane]), plane)
            if mask & active:
                continue
            if mask & int(TERMINATOR_BIT):
                if not final_tx or not self._template_static_clean(ctx):
                    continue
            kill.append(lane)
            retired += 1
        if retired:
            self.stats["static_retired"] += retired
            from ..smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(static_retired_lanes=retired)
            trace.event("static.retire", retired=retired)
            log.info("static pass retired %d lanes at the window "
                     "boundary", retired)

    def _patch_jump_parks(self, results: List[GlobalState]
                          ) -> List[GlobalState]:
        """Consult the static jump table before a symbolic-dest JUMP
        park falls back to the host interpreter (which ends the path —
        instructions.jump_ raises on a symbolic dest). A site whose
        value-set resolved to EXACTLY one target continues there, with
        the dest == target equality appended as a path condition
        (implied true by the resolution's soundness, so the issue set
        cannot grow; and were the resolution ever wrong, the constraint
        makes the wrong continuation infeasible rather than unsound).
        Disabled while an arbitrary-jump-class detector is active."""
        info = self._static_info
        if info is None or not self.static_jump_patch_ok \
                or not info.jump_table:
            return results
        patched = 0
        for gs in results:
            try:
                ilist = gs.environment.code.instruction_list
                pc = gs.mstate.pc
                if pc >= len(ilist) or ilist[pc]["opcode"] != "JUMP":
                    continue
                stack = gs.mstate.stack
                if not stack:
                    continue
                dest = stack[-1]
                if getattr(dest, "symbolic", False) is not True:
                    continue
                targets = info.jump_table.get(ilist[pc]["address"])
                if not targets or len(targets) != 1:
                    continue
                target = symbol_factory.BitVecVal(targets[0], 256)
                gs.world_state.constraints.append(dest == target)
                stack[-1] = target
                patched += 1
            except Exception:
                continue
        if patched:
            self.stats["static_jump_patches"] += patched
            log.info("static jump table resolved %d symbolic JUMP "
                     "parks in place", patched)
        return results

    def _window_merge(self, st, status, ctxs, dead_set, kill,
                      counts_h, resumes) -> None:
        """Collapse exact-frontier twin lanes at the window boundary
        (docs/lane_merge.md). Runs AFTER the drain (canonical sids and
        this window's conds are final) and BEFORE the next dispatch's
        kill list closes, so a retired lane never executes another
        step. Cheap host pre-grouping (pc/sp/counters/template/write
        mirror) decides whether the device fingerprint dispatch is
        worth issuing at all; groups that survive the full fingerprint
        hand their condition lists to merge.plan_group — duplicates and
        implied siblings retire subsumed, the incomparable rest merges
        into one lane under an OR'd suffix with disjunct provenance.
        Gated by MTPU_MERGE (default on). A fingerprint kernel that
        fails raises (``_boundary_fp``)."""
        from . import merge as merge_mod

        if not merge_mod.enabled():
            return
        excluded = dead_set | set(kill) | {r[0] for r in resumes}
        pcs, sps = counts_h["pc"], counts_h["sp"]
        pre: Dict[tuple, List[int]] = {}
        for lane in range(self.n_lanes):
            ctx = ctxs[lane]
            if (ctx is None or lane in excluded
                    or status[lane] != Status.RUNNING):
                continue
            if ctx.promos:
                continue  # adapter sink promotions are per-path
            key = (
                id(ctx.template), int(pcs[lane]), int(sps[lane]),
                int(counts_h["msize"][lane]),
                int(counts_h["scount"][lane]),
                int(counts_h["mlog_count"][lane]),
                tuple((k.raw.tid, v.raw.tid) for k, v in ctx.swrites),
            )
            pre.setdefault(key, []).append(lane)
        if not any(len(v) > 1 for v in pre.values()):
            return
        fp = self._boundary_fp(st, groups=len(pre))
        merged, subsumed, widened, dropped = \
            self._collapse_twins(pre, fp, ctxs)
        kill.extend(dropped)
        if merged or subsumed:
            self.stats["lanes_merged"] += merged
            self.stats["lanes_subsumed"] += subsumed
            self.stats["merge_rounds"] += 1
            self.stats["gas_widened"] = (
                self.stats.get("gas_widened", 0) + widened)
            from ..smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(
                lanes_merged=merged, lanes_subsumed=subsumed,
                merge_rounds=1, gas_widened_lanes=widened)
            merge_mod.note_retired(merged + subsumed)
            trace.event("merge.window", merged=merged,
                        subsumed=subsumed)
            log.info("lane merge: %d merged, %d subsumed at window "
                     "boundary", merged, subsumed)

    def _boundary_fp(self, st, groups: int = 0):
        """Per-lane frontier fingerprint for THIS window boundary
        (``merge_fingerprint`` over the full plane: K9 on the card),
        computed at most once and shared by the live-lane window merge
        AND the merge-before-spill pass — the two passes cost ONE
        launch between them. The cache resets at every window (explore
        loop). Returns (N, 4) uint32. A kernel that fails raises: the
        JAX engine skips the merge instead, which here would hide the
        kernel."""
        if self._fp_boundary is None:
            d_recs = self.lane_kwargs.get("dlog_records", 64)
            with _prof("merge_fp"), \
                    trace.span("merge.fingerprint", groups=groups):
                if self.mesh is None:
                    pairs = _prov_pairs(self._prov, self.n_lanes, d_recs,
                                        self.device)
                    fp = _start_pull([merge_fingerprint(st, pairs)])()[0]
                else:  # K9 a shard, over the batch's pairs
                    pulls = []
                    for shard in st.shards:
                        with _on(shard.device):
                            pairs = _prov_pairs(self._prov, self.n_lanes,
                                                d_recs, shard.device)
                            pulls.append(_start_pull([merge_fingerprint(
                                shard, pairs, self.n_lanes)]))
                    fp = np.concatenate([p()[0] for p in pulls])
                self._fp_boundary = fp.view(np.uint32)
        return self._fp_boundary

    def _collapse_twins(self, pre, fp, ctxs):
        """Shared twin-collapse body of the window merge and the
        merge-before-spill pass: within each host pre-group, lanes
        whose device fingerprints match hand their condition lists to
        merge.plan_group; the survivor's ctx takes the OR'd suffix
        (and, under MTPU_MERGE_GASWIDEN, gas offsets widened to the
        group hull — gas-widening merge, docs/lane_merge.md: with
        widening OFF the gas interval joins the exact twin key, the
        historical behavior). Returns (merged, subsumed, widened,
        dropped lane list)."""
        from . import merge as merge_mod

        gas_widen = merge_mod.gas_widen_enabled()
        merged = subsumed = widened = 0
        dropped_lanes: List[int] = []
        from .retire_ring import owner_of as _owner_of

        for _key, lanes in pre.items():
            if len(lanes) < 2:
                continue
            # cross-tenant lanes must never OR-merge (docs/daemon.md
            # §wave packing): the pre-group keys on id(template) and
            # arena pc, both per-member by construction, so a mixed
            # group is a routing bug — assert rather than merge wrong
            assert len({_owner_of(ctxs[lane])
                        for lane in lanes}) == 1, \
                "cross-tenant lanes reached one merge group"
            twins: Dict[tuple, List[int]] = {}
            for lane in lanes:
                tkey = (int(fp[lane, 0]), int(fp[lane, 1]))
                if not gas_widen:
                    tkey += (int(fp[lane, 2]), int(fp[lane, 3]))
                twins.setdefault(tkey, []).append(lane)
            for group in twins.values():
                if len(group) < 2:
                    continue
                cond_lists = [[c for (_s, c) in ctxs[g].conds]
                              for g in group]
                plan = merge_mod.plan_group(cond_lists)
                if plan is None:
                    continue
                survivor = group[plan.keep]
                if plan.new_conds is not None:
                    sc = ctxs[survivor].conds
                    stamp = max((cl[-1][0] for cl in
                                 (ctxs[g].conds for g in group) if cl),
                                default=0)
                    ctxs[survivor].conds = (
                        sc[:plan.prefix_len]
                        + [(stamp, c)
                           for c in plan.new_conds[plan.prefix_len:]])
                if gas_widen:
                    # the survivor now represents every dropped arm:
                    # widen its host gas offsets so the effective
                    # interval (materialize/_DrainSite add gas0_* to
                    # the device values) covers the group's hull
                    members = [survivor] + [group[mi]
                                            for mi in plan.dropped]
                    dmin = min(int(fp[m, 2]) for m in members) \
                        - int(fp[survivor, 2])
                    dmax = max(int(fp[m, 3]) for m in members) \
                        - int(fp[survivor, 3])
                    if dmin or dmax:
                        ctxs[survivor].gas0_min += dmin
                        ctxs[survivor].gas0_max += dmax
                        widened += len(plan.dropped)
                for mi, reason in plan.dropped.items():
                    dropped_lanes.append(group[mi])
                    if reason == "merged":
                        merged += 1
                    else:
                        subsumed += 1
        return merged, subsumed, widened, dropped_lanes

    def _spill_merge(self, st, lanes, ctxs, dead_set, counts_h) -> set:
        """Merge-before-spill (docs/drain_pipeline.md): the window's
        retired SPILL CANDIDATES — parked lanes about to materialize
        into the host worklist — run the same fingerprint twin-collapse
        the live-lane merge runs, BEFORE any GlobalState is built. A
        rejoin twin that would have merged at the next dispatch instead
        re-executed host-side in the spill/refill regime (one
        interpreter step + re-seed + full device re-execution per twin,
        every spill generation); collapsing it here is why the overflow
        regime stops paying rejoin storms twice. The dropped lanes are
        already DEAD on device (the retire gather marked them); they
        are simply never materialized, and the survivor materializes
        with the OR'd constraint suffix (witness re-concretization
        preserved — the same soundness argument as docs/lane_merge.md).
        Returns the dropped-lane set. Gated by MTPU_MERGE +
        MTPU_STREAM (merge.spill_merge_enabled)."""
        from . import merge as merge_mod

        if not merge_mod.spill_merge_enabled():
            return set()
        pcs, sps = counts_h["pc"], counts_h["sp"]
        pre: Dict[tuple, List[int]] = {}
        for lane in lanes:
            ctx = ctxs[lane]
            if ctx is None or lane in dead_set or ctx.promos:
                continue
            key = (
                id(ctx.template), int(pcs[lane]), int(sps[lane]),
                int(counts_h["msize"][lane]),
                int(counts_h["scount"][lane]),
                int(counts_h["mlog_count"][lane]),
                tuple((k.raw.tid, v.raw.tid) for k, v in ctx.swrites),
            )
            pre.setdefault(key, []).append(lane)
        if not any(len(v) > 1 for v in pre.values()):
            return set()
        fp = self._boundary_fp(st, groups=len(pre))
        merged, subsumed, widened, dropped = \
            self._collapse_twins(pre, fp, ctxs)
        if not dropped:
            return set()
        n = merged + subsumed
        self.stats["spill_merged"] += n
        self.stats["gas_widened"] = (
            self.stats.get("gas_widened", 0) + widened)
        from ..smt.solver.solver_statistics import SolverStatistics

        SolverStatistics().bump(spill_merged_lanes=n,
                                gas_widened_lanes=widened)
        merge_mod.note_retired(n)
        trace.event("retire.spill_merge", merged=merged,
                    subsumed=subsumed)
        log.info("merge-before-spill: %d of %d spill candidates "
                 "collapsed at the window boundary", n, len(lanes))
        return set(dropped)

    # -- chunked escalation retire (docs/drain_pipeline.md) ------------------

    def _retire_chunked(self, st, lanes_sel, retire_floors):
        """The ONE sanctioned escalation-retire gather seam
        (tools/lint_static.py rule "unbounded-retire-gather"): retiring
        k lanes issues ceil(k/chunk) gathers of at most
        MTPU_RETIRE_CHUNK rows each into bounded device buffers — live
        width is no longer a single-allocation limit (the 64k-LIVE
        kernel-fault shape, BENCH_r08). Chunk buckets are pow2 capped
        at the chunk bound. Each chunk's copy to the host starts at
        dispatch into buffers no later launch writes (``_start_pull``);
        a deferred pull (the retire ring) waits for that copy only, so
        it overlaps the next window's device execution. With chunking
        off (MTPU_RETIRE_CHUNK=0 or MTPU_STREAM=0) this is the old
        monolithic gather. Returns (st, [(lanes, pull, floors,
        dispatch time)]), ``pull()`` giving the chunk's host rows."""
        ch = retire_chunk()
        if ch <= 0 or len(lanes_sel) <= ch:
            parts = [list(lanes_sel)]
        else:
            parts = [list(lanes_sel[i:i + ch])
                     for i in range(0, len(lanes_sel), ch)]
        cap = min(ch, self.n_lanes) if ch > 0 else self.n_lanes
        chunks = []
        for part in parts:
            floors = retire_floors(part)
            kp = _geo_bucket(len(part), cap, min(64, cap))
            idx = np.full(kp, self.n_lanes, np.int32)
            idx[: len(part)] = part
            with _prof("retire_dispatch"):
                retire = _retire_rows if self.mesh is None \
                    else retire_rows_mesh
                st, rows = retire(
                    st, torch.from_numpy(idx).to(self.device), *floors)
                pull = _start_pull(rows)
            chunks.append((part, pull, floors, time.perf_counter()))
        if ch > 0:
            self.stats["retire_chunks"] += len(parts)
            from ..smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(retire_chunks=len(parts))
            if len(parts) > 1:
                trace.event("retire.chunked", lanes=len(lanes_sel),
                            chunks=len(parts))
        return st, chunks

    def live_seed_states(self) -> List[GlobalState]:
        """Host-only snapshot of every live lane as (seed template +
        accumulated path conditions) — the lane's state at the window
        boundary where it was seeded, restricted to its recorded
        branch. Safe from a signal handler (no device access), so the
        SIGTERM/fatal live dump can capture lanes mid-window
        (support/checkpoint.snapshot_live_states); the device progress
        since the seed re-executes on resume, and issue dedup absorbs
        any re-detection. Empty when no explore is running.

        Retired-but-unmaterialized lanes parked in the retire ring
        (chunks whose pull is still deferred behind the next window)
        are covered too: their ctxs ride the pending jobs'
        introspection hook, so a SIGTERM mid-boundary loses no
        in-flight subtree to the deferral."""
        ctxs = self._explore_ctxs
        if not ctxs:
            return []
        ctxs = list(ctxs)
        ring = self._ring
        if ring is not None:
            try:
                ctxs.extend(ring.pending_ctx_sources())
            except Exception:
                pass  # best-effort, signal-safe
        out = []
        for ctx in list(ctxs):
            if ctx is None:
                continue
            try:
                gs = copy(ctx.template)
                for _step, cond in list(ctx.conds):
                    gs.world_state.constraints.append(cond)
                out.append(gs)
            except Exception:
                continue  # best-effort: the lane re-runs from the
                #           round checkpoint instead
        return out

    def _window_export(self, st, status, ctxs, dead_set, kill,
                       resumes, steps, free, results,
                       retire_floors):
        """Mid-flight wave export at the window boundary
        (docs/checkpoint.md): when the export client asks for n lanes,
        the TAIL of the live set retires through the escalation gather
        and materializes into ordinary mid-path GlobalStates — the
        complete per-lane plane (pc, depth, call frame, stack, memory,
        storage slots, gas interval, constraints, pending promotions)
        — which `deliver` ships as an in-flight migration batch. The
        exported lanes are DEAD on device the moment the gather runs
        (same protocol as the escalation retire), so a shipped lane
        never executes another step: kill-then-import. A declined
        delivery parks the states locally instead — work can move,
        but never be lost. Runs AFTER the merge pass so a lane about
        to collapse is never shipped."""
        client = self.export_client
        excluded = dead_set | set(kill) | {r[0] for r in resumes}
        live = [lane for lane in range(self.n_lanes)
                if (ctxs[lane] is not None and lane not in excluded
                    and status[lane] == Status.RUNNING)]
        if len(live) < 2:
            return st
        try:
            want = int(client.want(len(live)))
        except Exception:
            want = 0
        want = min(want, len(live) - 1)
        if want < 1:
            return st
        sel = live[len(live) - want:]
        try:
            # the export retires through the SAME chunked gather seam
            # as the escalation retire (docs/drain_pipeline.md): a
            # migration client asking for half a 64k wave must not
            # recreate the single-allocation shape chunking removed
            with _prof("ckpt_export"), \
                    trace.span("ckpt.export", lanes=len(sel)):
                st, chunks = self._retire_chunked(st, sel,
                                                  retire_floors)
                exported = []
                for part, pull, floors, _t in chunks:
                    rows_host = _unpack_rows(pull(), *floors)
                    exported.extend(
                        self.materialize(rows_host, row, ctxs[lane])
                        for row, lane in enumerate(part))
        except Exception as e:  # a seam, never an error path
            log.warning("mid-flight lane export failed (%s); lanes "
                        "stay local", e)
            return st
        # the gather marked the rows DEAD on device: recycle the slots
        # now, exactly like the escalation retire
        for lane in sel:
            self.stats["device_steps"] += int(steps[lane])
            ctxs[lane] = None
            free.append(lane)
        status[np.asarray(sel, np.int32)] = DEAD
        delivered = False
        try:
            delivered = bool(client.deliver(exported))
        except Exception as e:
            log.debug("export delivery failed: %s", e)
        if delivered:
            self.stats["exported"] = (
                self.stats.get("exported", 0) + len(sel))
            log.info("mid-flight export: %d live lanes shipped at the "
                     "window boundary", len(sel))
        else:
            # undeliverable (no thief claimed / save failed): the
            # states are ordinary parked mid-path states — they
            # continue locally through the spill/refill path
            results.extend(exported)
        return st

    # -- top-level loop ------------------------------------------------------

    def explore(self, code_bytes: bytes,
                entry_states: List[GlobalState]) -> List[GlobalState]:
        """Run entry states on device until every path parks or dies;
        returns the materialized parked states (each positioned at the
        first instruction the device could not execute)."""
        return self._explore_members(
            ((code_bytes, entry_states, None),))[None]

    def explore_packed(self, members) -> Dict[object, list]:
        """Cross-tenant packed explore (docs/daemon.md §wave packing):
        ``members`` is [(code_bytes, entry_states, owner)] with
        distinct owner tags; every member's lanes ride the SAME window
        dispatches over one segment-arena CompiledCode (K1's packed
        branch on the card), and retires route back per tenant
        (retire_ring.TenantRouter) in submit order. Returns {owner:
        parked states}. Member execution is independent by
        construction — per-seed group ids key the device record dedup,
        arena pcs are disjoint across segments, and the merge
        pre-groups key on per-member templates — so per-tenant results
        are identical to running each member's explore alone (gated by
        tests/test_torch_wave_pack.py)."""
        owners = [owner for _c, _s, owner in members]
        if len(set(owners)) != len(owners):
            raise ValueError("packed members need distinct owner tags")
        if self.mesh is not None:
            raise ValueError("packed waves do not shard")
        return self._explore_members(tuple(members))

    def _explore_members(self, members) -> Dict[object, list]:
        packed = len(members) > 1
        code_bytes = members[0][0]
        mems: List[Optional[_PackMember]] = []
        stats0 = dict(self.stats)  # engines persist across explores
        self._reset_explore_memos()
        codes = {}
        if not packed:
            entry_states = members[0][1]
            self._func_names = dict(
                getattr(entry_states[0].environment.code,
                        "address_to_function_name", {}) or {}
            ) if entry_states else {}
            # static pre-analysis (docs/static_pass.md): memoized per
            # code hash; feeds the window-boundary retire, the
            # jump-table consult on symbolic JUMP parks, and the
            # det-mask plane the compile below ships with the code
            # tensors
            try:
                from ..analysis import static_pass

                self._static_info = static_pass.info_for(code_bytes)
            except Exception as e:  # a host analysis, not the device
                log.debug("static pass unavailable: %s", e)
                self._static_info = None
            cc = _compiled_code(code_bytes, self._func_names.keys(),
                                self.device)
            mems.append(None)
            # the code tensors once a device of the mesh (the JAX
            # engine's replicated copy, _cc_rep)
            codes = {dev: _compiled_code(code_bytes,
                                         self._func_names.keys(), dev)
                     for dev in (self.mesh.devices if self.mesh else ())}
        else:
            # packed wave: per-member function maps ride the lane
            # ctxs. The verified loop-summary park planes pack per
            # member (lanes park at summarizable heads and the OWNING
            # svm applies the closed form after the sweep, exactly the
            # solo path). The remaining per-code host consumers
            # (static retire, jump patching) stand down — their gates'
            # own on/off identity covers the parity.
            self._func_names = {}
            self._static_info = None
            member_keys = []
            for code, states, owner in members:
                fnames = dict(
                    getattr(states[0].environment.code,
                            "address_to_function_name", {}) or {}
                ) if states else {}
                heads = ()
                try:
                    from ..analysis import static_pass
                    from ..analysis.static_pass import loop_summary

                    if static_pass.enabled() \
                            and loop_summary.enabled():
                        info = static_pass.info_for(code)
                        if info is not None:
                            heads = tuple(sorted(
                                loop_summary.summarizable_heads(
                                    info)))
                except Exception as e:
                    log.debug("packed loop-summary heads "
                              "unavailable: %s", e)
                member_keys.append(
                    (code, tuple(sorted(fnames.keys())), heads))
                mems.append(_PackMember(owner, code, 0, fnames))
            cc, bases = _compiled_packed(tuple(member_keys), self.device)
            for m, base in zip(mems, bases):
                m.base = base
            from ..smt.solver.solver_statistics import (
                SolverStatistics as _SSP,
            )

            _SSP().bump(waves_packed=1, pack_members=len(members))
        # per-byte-address coverage bitmap, device-resident across
        # windows AND explores of the same code (the interpreter's
        # execute_state coverage hook cannot see device steps; this is
        # its device twin — svm merges it into the coverage plugin); a
        # packed wave's bitmap covers the arena
        visited = self._visited_dev.pop(code_bytes, None) \
            if not packed else None
        if visited is None:
            visited = torch.zeros(cc.packed.shape[0], dtype=torch.bool,
                                  device=self.device)
        code_len = len(code_bytes) if not packed \
            else int(cc.packed.shape[0]) - 1
        st = self._acquire_state()
        ctxs: List[Optional[LaneCtx]] = [None] * self.n_lanes
        # expose the live ctx table for the SIGTERM live dump
        # (live_seed_states); cleared in the finally below
        self._explore_ctxs = ctxs
        queue = deque((midx, gs) for midx, (_c, states, _o)
                      in enumerate(members) for gs in states)
        n_entries = len(queue)
        free = list(range(self.n_lanes - 1, -1, -1))
        results: List[GlobalState] = []
        from .retire_ring import TenantRouter, owner_of

        if packed:
            router = TenantRouter([m.owner for m in mems])
            sink = router
            deliver = router.deliver
        else:
            router = None
            sink = results
            deliver = lambda _owner, gs: results.append(gs)  # noqa: E731
        calldata_cap = int((st if self.mesh is None else st.shards[0])
                           .calldata.shape[1])
        n = self.n_lanes

        kill: List[int] = []
        resumes: List[tuple] = []
        small = min(16, self.n_lanes)
        if self.mesh is not None and small >= self.n_lanes:
            # under a mesh the seed bucket stays below the plane width,
            # as the JAX engine's does
            small = max(self.n_lanes // 2, 1)
        peak_demand = len(queue)
        # streaming retire/materialize pipeline
        # (docs/drain_pipeline.md "streaming retire"): window k's
        # retired lanes leave the device as bounded CHUNKS
        # (_retire_chunked) whose D2H pulls and GlobalState rebuilds
        # run AFTER window k+1 is dispatched — the host's biggest
        # per-window costs (transfer + materialize) overlap device
        # execution. The deferral structure is a bounded ring
        # (laser/retire_ring.py) feeding a K-worker materialization
        # pool (K=1 default: inline at flush, bit-identical to the old
        # pending_mat list) with delivery order into `results` pinned
        # to submit order. Each job snapshots this window's
        # provisional-sid map — the next drain REPLACES self._prov.
        from .retire_ring import RetireRing

        ring = RetireRing(workers=mat_workers(), sink=sink)
        self._ring = ring
        from ..smt.solver.solver_statistics import SolverStatistics \
            as _SS

        def _submit_mat(rows_ref, floors, items, t_disp) -> None:
            """Queue one retired chunk: rows_ref is a host dict when
            already pulled (floors None) or the pull of a deferred
            gather (``_start_pull``); items = [(row index, ctx
            snapshot)]."""
            prov = self._prov

            def pull():
                if floors is None:
                    return rows_ref
                t0 = time.perf_counter()
                hidden_ms = (t0 - t_disp) * 1000.0
                with self._stats_lock:
                    # wall the D2H copy had to progress behind the
                    # next window's execution before anyone blocked
                    # on it — the measured hide of the deferred pull
                    self.stats["retire_overlap_ms"] += hidden_ms
                _SS().bump(retire_overlap_ms=hidden_ms)
                with _prof("retire_pull"), \
                        trace.span("retire.pull", rows=len(items)):
                    return _unpack_rows(rows_ref(), *floors)

            def build(rows_host):
                t0 = time.perf_counter()
                with trace.span("retire.materialize", n=len(items)):
                    if packed:
                        # retire chunks carry the owner tag: the ring
                        # sink (TenantRouter) routes each state into
                        # its request's worklist in submit order
                        out = [
                            (owner_of(ctx),
                             self.materialize(rows_host, row, ctx,
                                              prov=prov))
                            for row, ctx in items]
                    else:
                        out = [self.materialize(rows_host, row, ctx,
                                                prov=prov)
                               for row, ctx in items]
                with self._stats_lock:
                    self.stats["overlap_mat"] += len(items)
                    self.stats["overlap_mat_ms"] += int(
                        (time.perf_counter() - t0) * 1000)
                return out

            build.ring_items = items  # SIGTERM live-dump introspection
            # already-pulled chunks hand the ring their host rows so
            # it can park them codec-encoded (state_codec.encode_rows)
            # instead of holding raw planes until flush
            ring.submit(pull, build,
                        payload=rows_ref if floors is None else None)

        # overlapped fork-feasibility screening (batched discharge,
        # gated like the host's fork pruning): queries collected at
        # drain k discharge while window k+1 executes; UNSAT lanes
        # ride the kill list of dispatch k+2
        from ..smt.solver.solver_statistics import SolverStatistics
        from ..support.support_args import args as _args

        _solver_stats = SolverStatistics()
        screen_on = bool(getattr(_args, "pruning_factor", None))
        screen_registry = None
        if screen_on:
            from ..smt.solver.batch import SubsetRegistry

            screen_registry = SubsetRegistry()
        pending_screen: List[tuple] = []
        screen_future = None
        screen_dead: List[int] = []
        t_idle0 = None
        trace.begin("lane.explore", n_lanes=self.n_lanes,
                    entries=n_entries, code_len=code_len,
                    pack_members=len(members) if packed else 0)
        try:
            while True:
                # per-boundary fingerprint cache: the window merge and
                # the merge-before-spill pass share ONE dispatch
                self._fp_boundary = None
                # a seed backlog beyond the small bucket drains in ONE
                # window through the full-width seed bucket (the
                # kernels have no per-shape compile to wait for)
                seed_cap = small
                full_bucket = self._full_bucket()
                if (len(queue) > small or len(resumes) > small) \
                        and full_bucket > small:
                    seed_cap = full_bucket
                entries = []
                while queue and free and len(entries) < seed_cap:
                    midx, gs = queue.popleft()
                    if self.adapters and not all(
                        ad.seed_ok(gs) for ad in self.adapters
                    ):
                        # host handles this entry
                        deliver(mems[midx].owner if packed else None,
                                gs)
                        continue
                    entries.append((free.pop(), gs, mems[midx]))
                i32buf, u8buf, k, pv = self._pack_window(
                    entries, ctxs, free, kill, calldata_cap,
                    big=seed_cap > small, resumes=resumes)
                resumes = []
                n_free_written = len(free)
                _tw = time.perf_counter() if PROF_ON else 0.0
                if t_idle0 is not None:
                    # host-visible device idle: from the previous
                    # window's pull completing (device drained) to this
                    # dispatch being enqueued — the serial drain wall
                    # the pipeline exists to shrink
                    idle_ms = (time.perf_counter() - t_idle0) * 1000
                    self.stats["overlap_idle_ms"] += int(idle_ms)
                    _solver_stats.overlap_idle_ms += idle_ms
                    t_idle0 = None
                with _prof("window_exec",
                           sync=lambda: getattr(st, "home", st).pc), \
                        trace.span("lane.window_dispatch",
                                   seeds=k, window=self.window):
                    if self.mesh is None:
                        st, visited, out = window_exec(
                            st, cc, i32buf, u8buf, self.exec_table,
                            self.taint_table, self.window, k,
                            self.step_budget, pv, visited,
                            self._resume_flag)
                    else:
                        st, visited, out = window_exec_mesh(
                            st, codes, i32buf, u8buf, self.exec_table,
                            self.taint_table, self.window, k,
                            self.step_budget, pv, visited,
                            self._resume_flag)
                # start the fused outputs' copies to the host now: the
                # transfer overlaps the host work below instead of
                # serializing into the blocking pull
                out_pull = _start_pull(out)
                # the kill landed at the dispatch's reset phase: only now
                # may the slots be recycled (they enter the free stack the
                # device sees at the NEXT dispatch)
                for lane in kill:
                    ctxs[lane] = None
                    free.append(lane)
                kill = []
                # the dispatch above is asynchronous: while this window
                # executes, pull+rebuild the LAST window's retired
                # GlobalStates and discharge its fork-feasibility batch
                t_busy0 = time.perf_counter()
                ring.flush()
                if screen_future is not None:
                    # started at the previous drain: with the pool
                    # parallel the verdicts are usually already done
                    # (they solved behind the pull + this dispatch);
                    # serial tokens run the whole screen here, exactly
                    # where the synchronous screen used to
                    screen_dead = self._collect_fork_screen(
                        screen_future)
                    screen_future = None
                busy_ms = (time.perf_counter() - t_busy0) * 1000
                self.stats["overlap_busy_ms"] += int(busy_ms)
                _solver_stats.overlap_busy_ms += busy_ms
                if PROF_ON:
                    PROF.setdefault("windows", []).append(  # type: ignore
                        (round(time.perf_counter() - _tw, 3), k,
                         len(code_bytes), self.n_lanes))
                self.stats["windows"] += 1
                # device-dispatch accounting (docs/daemon.md §wave
                # packing): window count feeds the bench "strictly
                # fewer dispatches" gate; occupancy is the live-lane
                # share of the wave — packed waves carry several
                # tenants' lanes through the same dispatches
                _solver_stats.bump(lane_windows=1)
                live_now = n - len(free)
                if live_now > 0:
                    _solver_stats.bump_max(pack_occupancy_pct=round(
                        100.0 * live_now / n, 1))
                if packed:
                    owners_live = {owner_of(c) for c in ctxs
                                   if c is not None}
                    if len(owners_live) > 1:
                        _solver_stats.bump(
                            dispatches_saved=len(owners_live) - 1)
                t_wait0 = time.perf_counter()
                with _prof("window_pull"), \
                        trace.span("lane.window_pull"):
                    (misc, scal, utab, ftab, ridx, r_i32, r_u32,
                     r_u8, hidx, h_i32, h_u32, h_u8) = out_pull()
                wait_ms = (time.perf_counter() - t_wait0) * 1000
                self.stats["device_wait_ms"] += int(wait_ms)
                _solver_stats.device_wait_ms += wait_ms
                t_idle0 = time.perf_counter()
                counts_h = {
                    "dlog_count": misc[:, 0], "status": misc[:, 1],
                    "steps": misc[:, 2], "sp": misc[:, 3],
                    "scount": misc[:, 4], "mlog_count": misc[:, 5],
                    "msize": misc[:, 6], "pc": misc[:, 7],
                    "flog_count": int(scal[0]),
                    "free_count": int(scal[1]),
                    "ucount": int(scal[2]),
                }
                self.last_counts = counts_h
                nf = counts_h["flog_count"]
                ucount = counts_h["ucount"]
                if ucount > utab.shape[0]:
                    # more distinct records than the fused pull budget:
                    # re-pull at the smallest geometric bucket that
                    # fits the count we already have (a few compiles,
                    # cached per bucket; the table ships right-sized)
                    cap = self.n_lanes * self.lane_kwargs.get(
                        "dlog_records", 64)
                    urb_big = utab.shape[0]
                    while urb_big < ucount and urb_big < cap:
                        urb_big *= 2
                    urb_big = min(urb_big, cap)
                    with _prof("logs_escalate"):
                        tab, uc2 = _unique_table_big(
                            getattr(st, "home", st), urb_big)
                        utab = tab.cpu().numpy()
                    ucount = int(uc2)
                    if ucount > utab.shape[0]:
                        raise RuntimeError(
                            f"{ucount} distinct records in one window "
                            f"exceed the escalation budget")
                recs = []
                for i in range(ucount):
                    row = utab[i]
                    recs.append((
                        int(row[4]), int(row[0]), int(row[1]), int(row[2]),
                        int(row[3]), int(row[5]),
                        (int(row[6]), int(row[7]), int(row[8])),
                        np.ascontiguousarray(row[9:]).view(np.uint32)
                        .reshape(3, bv256.NLIMBS),
                    ))
                if nf > ftab.shape[0]:
                    with _prof("flog_escalate"):
                        ftab = _gather_full_flog(
                            getattr(st, "home", st)).cpu().numpy()
                forks = []
                for i in range(nf):
                    r = ftab[i]
                    forks.append((
                        int(r[2]), int(r[0]), int(r[1]), int(r[3]),
                        int(r[4]), int(np.uint32(r[5])),
                        int(np.uint32(r[6])), int(r[7]), int(r[8]),
                    ))
                status = counts_h["status"].copy()
                steps = counts_h["steps"]
                # forked children consumed slots from the top (tail) of the
                # free stack; reconcile before re-seeding
                consumed = n_free_written - counts_h["free_count"]
                if consumed:
                    free = free[: n_free_written - consumed]

                # fast-retired lanes: the window dispatch already
                # gathered their rows and marked them DEAD (ridx row i
                # is the i-th retired lane; padding entries hold n)
                fast = [int(x) for x in ridx if x < n]
                # escalation set: parked lanes past the fast budget or
                # over a column floor (status still NEEDS_HOST), plus
                # runaways
                runaway = (status == Status.RUNNING) \
                    & (steps >= self.step_budget)
                rest = np.nonzero(
                    (status == Status.NEEDS_HOST) | runaway)[0].tolist()
                # in-place resume candidates: the device held SHA3-
                # parked lanes in the envelope and shipped their slim
                # rows with this window's output. Resolving them needs
                # the drain's provisional-sid map, so the actual
                # _try_resume runs AFTER the drain below; here the
                # held set is only carved out of the escalation retire
                # (optimistically — a declined lane retires through
                # the supplementary dispatch afterwards).
                held = [int(x) for x in hidx if x < n]
                cap_r = small
                full_r = self._full_bucket()
                if len(held) > small and full_r > small:
                    cap_r = full_r
                held = held[:cap_r]
                if held:
                    held_set = set(held)
                    rest = [l for l in rest if l not in held_set]
                # DISPATCH the escalation retire before the host drain:
                # the device gathers and ships the rows (the largest
                # per-window transfer) while the host resolves this
                # window's records and forks — the two biggest
                # per-window costs overlap instead of serializing
                def _retire_floors(lanes_sel):
                    # content-adaptive floors: the smallest pow2
                    # columns that hold every selected row
                    lk = self.lane_kwargs
                    c = counts_h
                    sel = np.asarray(lanes_sel, np.int32)
                    return (
                        _geo_bucket(max(int(c["sp"][sel].max()), 1),
                                    lk.get("stack_depth", 64), 8),
                        _geo_bucket(max(int(c["msize"][sel].max()), 1),
                                    lk.get("memory_bytes", 4096), 64),
                        _geo_bucket(
                            max(int(c["mlog_count"][sel].max()), 1),
                            lk.get("mem_records", 64), 8),
                        _geo_bucket(max(int(c["scount"][sel].max()), 1),
                                    lk.get("storage_slots", 64), 8),
                    )

                def _materialize_rows(lanes_sel, rows_host):
                    with _prof("materialize"):
                        for row, lane in enumerate(lanes_sel):
                            self.stats["device_steps"] += \
                                int(steps[lane])
                            if lane not in dead_set:
                                deliver(owner_of(ctxs[lane]),
                                        self.materialize(
                                            rows_host, row,
                                            ctxs[lane]))
                            ctxs[lane] = None
                            free.append(lane)
                    status[np.asarray(lanes_sel, np.int32)] = DEAD

                rest_chunks = []
                if rest:
                    st, rest_chunks = self._retire_chunked(
                        st, rest, _retire_floors)

                self._prov, dead = self._drain_host(recs, forks, ctxs)
                dead_set = set(dead)

                # merge-before-spill (docs/drain_pipeline.md): the
                # retired spill candidates — fast + escalation sets,
                # now with their condition lists final — collapse
                # exact-frontier twins BEFORE any GlobalState is
                # built; dropped twins are never materialized, so the
                # spill/refill regime stops re-executing rejoins it
                # would have merged at the next dispatch
                spill_dropped: set = set()
                if fast or rest:
                    spill_dropped = self._spill_merge(
                        st, fast + rest, ctxs, dead_set, counts_h)

                # in-place resume (needs self._prov): patches ride the
                # next dispatch's seed buffer — zero extra round trips.
                # A trivially-false (dead) lane must NOT resume: the
                # next dispatch's kill would race its patch (kill sets
                # DEAD before patches set RUNNING) while the host has
                # already freed its slot — route dead lanes to the
                # supplementary retire instead.
                declined: List[int] = []
                if held:
                    pcs = counts_h["pc"]
                    rrows = _unpack_resume((h_i32, h_u32, h_u8))
                    with _prof("resume_host"):
                        for row_i, lane in enumerate(held):
                            patch = None
                            if lane not in dead_set:
                                with self._owner_run(ctxs[lane]):
                                    patch = self._try_resume(
                                        rrows, row_i,
                                        int(pcs[lane]),
                                        int(counts_h["sp"][lane]))
                            if patch is not None:
                                resumes.append((lane,) + patch)
                                status[lane] = Status.RUNNING
                                self.stats["resumed"] += 1
                            else:
                                declined.append(lane)

                if fast:
                    st_fast = _unpack_rows((r_i32, r_u32, r_u8),
                                           *RETIRE_FLOORS)
                    with _prof("materialize"):
                        items = []
                        for row, lane in enumerate(fast):
                            self.stats["device_steps"] += int(steps[lane])
                            if lane not in dead_set \
                                    and lane not in spill_dropped:
                                items.append((row, ctxs[lane]))
                            ctxs[lane] = None
                            free.append(lane)
                        if items:
                            _submit_mat(st_fast, None, items,
                                        time.perf_counter())
                for part, pull, floors_c, t_disp in rest_chunks:
                    # pipelined: each chunk's pull rides the NEXT
                    # window's execution (the gathers were dispatched
                    # before the drain and are ordered ahead of any
                    # re-seed by the st dependency chain); slots free
                    # NOW — the device already marked the rows DEAD.
                    # ctx refs snapshot here: the slot may be
                    # re-seeded before the ring delivers.
                    items = []
                    for row, lane in enumerate(part):
                        self.stats["device_steps"] += int(steps[lane])
                        if lane not in dead_set \
                                and lane not in spill_dropped:
                            items.append((row, ctxs[lane]))
                        ctxs[lane] = None
                        free.append(lane)
                    status[np.asarray(part, np.int32)] = DEAD
                    _submit_mat(pull, floors_c, items, t_disp)
                if declined:
                    # rare: held lanes the host would not resume
                    # (symbolic length, OOG, oversize, trivially-false
                    # path) retire through a supplementary dispatch —
                    # they must not stay held forever
                    st, dchunks = self._retire_chunked(
                        st, declined, _retire_floors)
                    for part, dpull, dfloors, _t in dchunks:
                        with _prof("retire_pull"):
                            d_host = _unpack_rows(dpull(), *dfloors)
                        _materialize_rows(part, d_host)
                # 3. trivially-false lanes still RUNNING on device: kill
                # them at the next dispatch (before it seeds anything) and
                # recycle their slots after it. Their host status stays
                # RUNNING so the loop always runs that dispatch.
                retired = set(fast) | set(rest) | set(declined)
                for lane in dead:
                    if lane not in retired:
                        kill.append(lane)
                # solver-killed lanes from the overlapped fork screen:
                # proved-UNSAT prefixes die at the next dispatch, same
                # protocol as trivially-false lanes. A lane that parked
                # or died in the meantime is skipped (its state already
                # materialized; the open-state screen prunes it later).
                for lane in screen_dead:
                    if (lane not in retired and lane not in dead_set
                            and status[lane] == Status.RUNNING
                            and ctxs[lane] is not None
                            and lane not in kill):
                        kill.append(lane)
                        self.stats["fork_killed"] += 1
                screen_dead = []
                # window-boundary STATIC retire (MTPU_STATIC,
                # docs/static_pass.md): lanes whose remaining
                # reachable-detector mask is dead against the active
                # mask ride the next dispatch's kill list with zero
                # solver/materialize work. Runs BEFORE the merge pass,
                # which then never pays fingerprint work for them.
                self._static_retire(status, ctxs, dead_set, kill,
                                    counts_h, resumes)
                # window-boundary lane merge/subsume (MTPU_MERGE,
                # docs/lane_merge.md): exact-frontier twins collapse
                # under an OR'd constraint suffix, implied siblings
                # retire subsumed — their kills ride the next dispatch
                # (same protocol as trivially-false lanes), BEFORE that
                # window executes, so a merged-away lane never runs
                # another step
                self._window_merge(st, status, ctxs, dead_set, kill,
                                   counts_h, resumes)
                # mid-flight wave export (MTPU_CKPT,
                # docs/checkpoint.md): a work-stealing client can take
                # the tail of the live wave at this boundary — the
                # lanes retire into complete mid-path GlobalStates and
                # ship; their slots free for the next dispatch
                if self.export_client is not None:
                    st = self._window_export(
                        st, status, ctxs, dead_set, kill, resumes,
                        steps, free, results, _retire_floors)
                # collect the NEXT overlapped screen batch: lanes that
                # gained path conditions this window and are still
                # running (their descendants subset-kill through the
                # per-explore registry once a prefix is refuted)
                if screen_on and forks:
                    touched = sorted({f[1] for f in forks}
                                     | {f[2] for f in forks})
                    pending_screen = [
                        (lane, [c for (_, c) in ctxs[lane].conds])
                        for lane in touched
                        if (status[lane] == Status.RUNNING
                            and lane not in dead_set
                            and lane not in kill
                            and ctxs[lane] is not None
                            and ctxs[lane].conds)
                    ][:256]
                    if pending_screen:
                        # submit NOW: a parallel pool solves while this
                        # thread packs/dispatches the next window and
                        # waits on the device pull (collected at the
                        # next overlapped phase — kills still land at
                        # dispatch k+2, same protocol as before)
                        screen_future = self._submit_fork_screen(
                            pending_screen, screen_registry)
                        pending_screen = []

                # width-demand sample: lanes concurrently occupied plus
                # entries still queued for a slot (what a wide-enough
                # engine would have run this window)
                peak_demand = max(peak_demand,
                                  n - len(free) + len(queue))
                running = int(np.sum(status == Status.RUNNING))
                if not running and not queue:
                    break
            # the last window has no successor dispatch to hide behind
            ring.flush()
        finally:
            self._explore_ctxs = None
            self._ring = None
            try:
                # exception mid-sweep: pending ring chunks are
                # deliberately NOT flushed (svm re-runs the entry
                # states host-side) — just stop the workers and book
                # the occupancy high-water mark
                ring.close()
                if ring.high_water > self.stats.get(
                        "ring_high_water", 0):
                    self.stats["ring_high_water"] = ring.high_water
                _SS().bump_max(ring_high_water=ring.high_water)
            except Exception:  # telemetry only
                pass
            trace.end("lane.explore",
                      windows=self.stats["windows"]
                      - stats0.get("windows", 0))
            # an exception mid-sweep raises to the caller; the
            # coverage of the windows that ran is kept all the same
            if not packed:
                self._visited_dev[code_bytes] = visited
                self.visited_by_code[code_bytes] = \
                    visited.cpu().numpy()[: cc.size]
            else:
                # per-member coverage: slice each segment out of the
                # arena bitmap and OR into the per-code map
                vh = visited.cpu().numpy()
                for m in mems:
                    cur = vh[m.base: m.base + len(m.code)]
                    prev = self.visited_by_code.get(m.code)
                    if prev is not None and prev.shape == cur.shape:
                        cur = cur | prev
                    self.visited_by_code[m.code] = cur
        self._release_state(st)
        # static jump-table consult (docs/static_pass.md): a symbolic-
        # dest JUMP park with a statically-proved singleton target
        # continues in place instead of dying in the interpreter
        # (per-code — stands down under a packed wave)
        if not packed:
            results = self._patch_jump_parks(results)
        global LAST_RUN_STATS
        delta = {k: v - stats0.get(k, 0) for k, v in self.stats.items()}
        if not packed \
                and peak_demand > PATH_HISTORY.get(code_bytes, 0):
            PATH_HISTORY[code_bytes] = peak_demand
        LAST_RUN_STATS = self.last_run_stats = delta
        for key, val in delta.items():
            RUN_STATS_TOTAL[key] = RUN_STATS_TOTAL.get(key, 0) + val
        if packed:
            return router.lists
        return {None: results}

    # -- device-state pooling ------------------------------------------------

    def _shape_key(self) -> tuple:
        mesh_key = None
        if self.mesh is not None:
            mesh_key = tuple(str(d) for d in self.mesh.devices.flat)
        return (self.n_lanes, str(self.device), mesh_key) \
            + tuple(sorted(self.lane_kwargs.items()))

    def _acquire_state(self):
        """A batch for an explore: pooled, else fresh; over the mesh a
        ``parallel/mesh.SymShards`` (each shard on its device)."""
        pool = _STATE_POOL.get(self._shape_key())
        if pool:
            return pool.pop()
        with _prof("init_lanes"):
            if self.mesh is not None:
                from ..parallel.mesh import shard_sym_lanes

                return shard_sym_lanes(self.mesh, self.n_lanes,
                                       **self.lane_kwargs)
            return symstep.init_sym_lanes(self.n_lanes, device=self.device,
                                          **self.lane_kwargs)

    def _release_state(self, st: SymLaneState) -> None:
        """Park the (all-DEAD) device buffers for the next explore —
        possibly by a different engine or contract. Stale plane contents
        are unreachable: seeding rewrites every live field of a row, and
        log counters were reset by the window dispatches."""
        pool = _STATE_POOL.setdefault(self._shape_key(), [])
        if len(pool) < 2:  # bound device memory held by idle batches
            pool.append(st)
