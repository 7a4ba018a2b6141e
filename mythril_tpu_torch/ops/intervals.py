"""Batched interval constraint evaluation: the forward interval screen,
in PyTorch and as kernel K5.

The counterpart of ``mythril_tpu/ops/intervals.py``; its docstring holds
the model. The union term DAG of many states' constraint systems is
linearized host-side into level-synchronous tables (``linearize``, a
copy), and each state's copy of the interval table is swept level by
level with unsigned-interval transfer functions: tables are (S, T, 8)
limb words, lo and hi, and a state is pruned when one of its assertions
comes back must-false.

This module gives, beside the host part:

- ``transfer_level_plain``: the interval transfer of one level in plain
  PyTorch, a line-by-line mirror of the JAX ``_transfer_level``;
- ``eval_level``: one forward level in place on the tables. On CPU
  tables it runs the plain version; on CUDA tables it launches K5,
  ``interval_level`` in ``csrc/screen.cu``, and never the plain version;
- the drivers ``eval_feasible``, ``eval_shadow``, ``prefilter_feasible``
  and ``shadow_prefilter``.

Tables hold uint32 limbs as int32 bit patterns. The JAX functions return
new tables; the port updates them in place (a level's nodes are never
arguments of the same level, so no node reads a row its level writes).
The state axis and the table rows pad to powers of two as in the JAX
package (its ``MYTHRIL_TPU_INTERVAL_CANONICAL`` default), so both
packages give the same encodings.
"""

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..smt import terms as T
from ..smt.interval import extract_bounds
from ..support.devices import resolve
from ..support.telemetry import trace
from . import bv256
from .bv256 import M32, i32, u32

# device opcodes (NOP = leaf/unsupported: table keeps its host-seeded value)
(
    NOP, ADD, SUB, MUL, UDIV, UREM, BAND, BOR, BXOR, BNOT, NEG, SHL, LSHR,
    COPY, SEXT, EXTRACT, CONCAT2, ITE, EQ, ULT, ULE, BAND2, BOR2, BNOT1,
    BXOR2, BITE,
) = range(26)

_BINOP_MAP = {
    T.ADD: ADD,
    T.SUB: SUB,
    T.MUL: MUL,
    T.UDIV: UDIV,
    T.UREM: UREM,
    T.BAND: BAND,
    T.BOR: BOR,
    T.BXOR: BXOR,
    T.SHL: SHL,
    T.LSHR: LSHR,
}

_EXPENSIVE_OPS = frozenset({MUL, UDIV, UREM})
_CHEAP_COVER = frozenset(range(1, 26)) - _EXPENSIVE_OPS


def _canonical_ops(ops: set) -> tuple:
    """A level's opcode set as the JAX package keys its level kernel:
    every cheap transfer function plus the expensive ones the level
    uses. The port has no compile key; the plain version computes the
    functions of this set, and the per-node opcode select makes the
    result the same for any cover of the level's opcodes."""
    return tuple(sorted(_CHEAP_COVER | (ops & _EXPENSIVE_OPS)))


#: the plain versions work on this many (state, row) pairs at a time,
#: so a wave's tables fit beside their int64 temporaries on the card
PLAIN_CHUNK_ROWS = 1 << 17


class EncodedDAG:
    """Host-side linearization of a term-DAG union into level tables
    (numpy arrays; the drivers copy them to the device)."""

    def __init__(self, n_nodes, levels, init_lo, init_hi, seed_idx, seed_lo,
                 seed_hi, dead, assert_idx, assert_mask, n_real=None,
                 host=None):
        self.n_nodes = n_nodes
        self.levels = levels  # list of dicts of per-level arrays
        self.init_lo = init_lo  # (T, 8) uint32 shared defaults
        self.init_hi = init_hi
        self.seed_idx = seed_idx  # (S, V) int32 node index (n = unused slot)
        self.seed_lo = seed_lo  # (S, V, 8)
        self.seed_hi = seed_hi
        self.dead = dead  # (S,) bool — contradictory bounds, pre-pruned
        self.assert_idx = assert_idx  # (S, A) int32 node index per assertion
        self.assert_mask = assert_mask  # (S, A) bool
        # logical state count: the state axis buckets to a power of two
        # (pad states seeded TOP, no live assertions, dead on arrival)
        self.n_real = seed_idx.shape[0] if n_real is None else n_real
        # host-side node tables (numpy; ops/propagate.py builds its
        # backward/product-domain plan from these)
        self.host = host or {}


def _word(v: int) -> np.ndarray:
    return bv256.int_to_limbs(v)


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def linearize(assertion_sets: Sequence[Sequence["T.Term"]],
              pin_bv: Optional[Dict[str, int]] = None,
              pin_bools: Optional[Dict[str, bool]] = None) -> EncodedDAG:
    """Topo-sort the union DAG, bake static node tables, and extract the
    per-state variable-bound seeds (a copy of the JAX ``linearize``).

    ``pin_bv``/``pin_bools`` pin named variables to point intervals —
    the model-shadow evaluation mode: every state shares one
    assignment, so the pins bake into the shared init tables, the
    per-state bound seeds are skipped, and a must-true assertion under
    the pins is exact (sound for proving SAT)."""
    assertion_sets = [
        [getattr(t, "raw", t) for t in s] for s in assertion_sets
    ]
    pinned = pin_bv is not None or pin_bools is not None
    pin_bv = pin_bv or {}
    pin_bools = pin_bools or {}
    # collect nodes iteratively (deep chains exceed recursion limits)
    depth: Dict[int, int] = {}
    nodes: Dict[int, "T.Term"] = {}
    stack: List["T.Term"] = [t for s in assertion_sets for t in s]
    while stack:
        cur = stack[-1]
        if cur.tid in depth:
            stack.pop()
            continue
        pending = [a for a in cur.args if a.tid not in depth]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        d = 1 + max((depth[a.tid] for a in cur.args), default=0)
        depth[cur.tid] = d
        nodes[cur.tid] = cur

    order = sorted(nodes.values(), key=lambda t: (depth[t.tid], t.tid))
    index = {t.tid: i for i, t in enumerate(order)}
    n = len(order)

    # table rows bucket to a power of two; the pad slot at index n and
    # above is never an argument of a real node, so writes landing
    # there are inert
    n_slots = _next_pow2(n + 1)

    init_lo = np.zeros((n_slots, bv256.NLIMBS), dtype=np.uint32)
    init_hi = np.zeros((n_slots, bv256.NLIMBS), dtype=np.uint32)
    dev_op = np.zeros(n, dtype=np.int32)
    args = np.zeros((n, 3), dtype=np.int32)
    mask_w = np.zeros((n, bv256.NLIMBS), dtype=np.uint32)
    aux = np.zeros((n, bv256.NLIMBS), dtype=np.uint32)

    for i, t in enumerate(order):
        op = t.op
        w = t.width if isinstance(t.width, int) else 0
        wide = w > 256
        if w and not wide:
            mask_w[i] = _word((1 << w) - 1)
        # default/seed abstraction
        if op == T.BV_CONST:
            if wide:
                # a >256-bit constant must be topped, not truncated:
                # truncation would manufacture a false tight interval
                init_hi[i] = _word((1 << 256) - 1)
            else:
                init_lo[i] = init_hi[i] = _word(t.val)
        elif op == T.TRUE:
            init_hi[i] = _word(1)  # (may_false=0, may_true=1)
        elif op == T.FALSE:
            init_lo[i] = _word(1)
        elif op == T.BOOL_VAR and t.name in pin_bools:
            # pinned definite bool: (may_false, may_true) = (!v, v)
            val = bool(pin_bools[t.name])
            init_lo[i] = _word(0 if val else 1)
            init_hi[i] = _word(1 if val else 0)
        elif t.is_bool:
            init_lo[i] = _word(1)
            init_hi[i] = _word(1)
        elif op == T.BV_VAR and not wide and w and t.name in pin_bv:
            # pinned point interval from the shadow model
            val = int(pin_bv[t.name]) & ((1 << w) - 1)
            init_lo[i] = init_hi[i] = _word(val)
        elif w:
            init_hi[i] = _word((1 << min(w, 256)) - 1)

        for k, a in enumerate(t.args[:3]):
            args[i, k] = index[a.tid]

        if wide:
            continue  # NOP: stays at top

        if op in _BINOP_MAP:
            dev_op[i] = _BINOP_MAP[op]
        elif op == T.BNOT:
            dev_op[i] = BNOT
        elif op == T.NEG:
            dev_op[i] = NEG
        elif op == T.ZEXT:
            dev_op[i] = COPY
        elif op == T.SEXT:
            iw = t.args[0].width
            if isinstance(iw, int) and iw <= 256:
                dev_op[i] = SEXT
                aux[i] = _word(1 << (iw - 1))
        elif op == T.EXTRACT:
            hi_b, lo_b = t.params
            dev_op[i] = EXTRACT
            aux[i] = _word((1 << (hi_b - lo_b + 1)) - 1)
            args[i, 1] = lo_b  # immediate, not a node index
            args[i, 2] = hi_b
        elif op == T.CONCAT:
            # 2-ary concat only; n-ary stays at top (sound)
            if len(t.args) == 2 and all(
                isinstance(a.width, int) and a.width <= 256 for a in t.args
            ):
                dev_op[i] = CONCAT2
                aux[i] = _word(t.args[1].width)
        elif op == T.ITE:
            dev_op[i] = ITE
        elif op == T.EQ:
            a, b = t.args
            if not (a.is_array or b.is_array or a.is_bool or b.is_bool):
                dev_op[i] = EQ
        elif op == T.ULT:
            dev_op[i] = ULT
        elif op == T.ULE:
            dev_op[i] = ULE
        elif op == T.AND:
            if len(t.args) == 2:
                dev_op[i] = BAND2
        elif op == T.OR:
            if len(t.args) == 2:
                dev_op[i] = BOR2
        elif op == T.NOT:
            dev_op[i] = BNOT1
        elif op == T.XOR:
            dev_op[i] = BXOR2
        elif op == T.BOOL_ITE:
            dev_op[i] = BITE
        # everything else (vars, SELECT/APPLY, SDIV/SREM, SLT/SLE) stays
        # NOP at its seeded default

    # level tables (levels that are all NOP are skipped), widths padded
    # to a power of two; pad rows point at node n with op NOP
    levels = []
    start = 0
    while start < n:
        d = depth[order[start].tid]
        end = start
        while end < n and depth[order[end].tid] == d:
            end += 1
        idx = np.arange(start, end, dtype=np.int32)
        if np.any(dev_op[idx] != NOP):
            w = _next_pow2(len(idx))
            pad = w - len(idx)
            levels.append(dict(
                node=np.concatenate([idx, np.full(pad, n, dtype=np.int32)]),
                op=np.concatenate([dev_op[idx],
                                   np.zeros(pad, dtype=np.int32)]),
                args=np.concatenate([args[idx],
                                     np.zeros((pad, 3), dtype=np.int32)]),
                mask=np.concatenate(
                    [mask_w[idx],
                     np.zeros((pad, bv256.NLIMBS), dtype=np.uint32)]),
                aux=np.concatenate(
                    [aux[idx],
                     np.zeros((pad, bv256.NLIMBS), dtype=np.uint32)]),
                ops_present=_canonical_ops(
                    set(dev_op[idx].tolist()) - {NOP}),
            ))
        start = end

    # per-state variable-bound seeds + assertion pointers (pinned mode
    # bakes the one shared assignment into the init tables above and
    # skips the syntactic bound seeds)
    n_states = len(assertion_sets)
    all_bounds = ([{} for _ in assertion_sets] if pinned
                  else [extract_bounds(s) for s in assertion_sets])
    max_v = _next_pow2(max((len(b) for b in all_bounds), default=1) or 1)
    max_a = _next_pow2(max((len(s) for s in assertion_sets), default=1)
                       or 1)
    # pad states carry no seeds and no live assertions and are marked
    # dead on arrival (callers slice verdicts back to n_real)
    s_rows = _next_pow2(n_states)
    seed_idx = np.full((s_rows, max_v), n, dtype=np.int32)
    seed_lo = np.zeros((s_rows, max_v, bv256.NLIMBS), dtype=np.uint32)
    seed_hi = np.zeros((s_rows, max_v, bv256.NLIMBS), dtype=np.uint32)
    dead = np.zeros(s_rows, dtype=bool)
    dead[n_states:] = True
    for s, bounds in enumerate(all_bounds):
        j = 0
        for var, lo, hi in bounds.values():
            if lo > hi:
                dead[s] = True
                break
            if var.tid in index:
                seed_idx[s, j] = index[var.tid]
                seed_lo[s, j] = _word(lo)
                seed_hi[s, j] = _word(hi)
                j += 1

    assert_idx = np.zeros((s_rows, max_a), dtype=np.int32)
    assert_mask = np.zeros((s_rows, max_a), dtype=bool)
    for s, assts in enumerate(assertion_sets):
        for j, t in enumerate(assts):
            assert_idx[s, j] = index[t.tid]
            assert_mask[s, j] = True

    return EncodedDAG(
        n, levels, init_lo, init_hi, seed_idx, seed_lo, seed_hi, dead,
        assert_idx, assert_mask, n_real=n_states,
        host=dict(terms=order, index=index, depth=depth, op=dev_op,
                  args=args, mask=mask_w, aux=aux, n_slots=n_slots),
    )


# ---------------------------------------------------------------------------
# device arrays
# ---------------------------------------------------------------------------


def words_to_device(arr, device) -> torch.Tensor:
    """uint32 numpy words -> their int32 bit patterns on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def ints_to_device(arr, device, dtype=torch.int32) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(arr))
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def level_to_device(level: dict, device) -> dict:
    """A level's host arrays as device tensors (words as int32 bit
    patterns, flags as uint8), ``ops_present`` kept as it is."""
    out = {}
    for key, val in level.items():
        if key == "ops_present":
            out[key] = val
        elif key in ("mask", "aux"):
            out[key] = words_to_device(val, device)
        elif np.asarray(val).dtype == bool:
            out[key] = ints_to_device(val, device, torch.uint8)
        else:
            out[key] = ints_to_device(val, device)
    return out


def state_chunks(n_states: int, rows_per_state: int):
    """Slices of the state axis holding about ``PLAIN_CHUNK_ROWS``
    (state, row) pairs each."""
    step = max(1, PLAIN_CHUNK_ROWS // max(rows_per_state, 1))
    for s0 in range(0, n_states, step):
        yield slice(s0, min(s0 + step, n_states))


# ---------------------------------------------------------------------------
# the plain version (u32-form int64 words, as ops/bv256.py computes)
# ---------------------------------------------------------------------------


def _ugt(a, b):
    return bv256.ult(b, a)


def _not(x):
    return M32 ^ x


def _where(c, x, y):
    """jnp.where with a (..., ) condition over (..., 8) words."""
    return torch.where(c[..., None] if c.dim() < x.dim() else c, x, y)


def _u32_const(v: int, like):
    out = torch.zeros_like(like)
    out[..., 0] = v
    return out


def smear_plain(x):
    """All bits at/below the most significant set bit."""
    for s in (1, 2, 4, 8, 16, 32, 64, 128):
        x = x | bv256.shr(x, _u32_const(s, x))
    return x


def _mk_bool(mf, mt):
    lo = torch.zeros(mf.shape + (bv256.NLIMBS,), dtype=torch.int64,
                     device=mf.device)
    hi = lo.clone()
    lo[..., 0] = mf.to(torch.int64)
    hi[..., 0] = mt.to(torch.int64)
    return lo, hi


def gather_rows(tab, s, idx):
    """``tab[s][:, idx]`` as u32-form words, out-of-range rows clamped
    (the JAX gather clamps)."""
    idx = idx.clamp(0, tab.shape[1] - 1).long()
    return u32(tab[s][:, idx])


def transfer_level_plain(level, lo_tab, hi_tab, s=slice(None)):
    """Interval transfer of one level's nodes for the states ``s``:
    (out_lo, out_hi) u32-form words of shape (states, W, 8), NOP and pad
    rows carrying their current value. A line-by-line mirror of the JAX
    ``_transfer_level``; ``level`` holds device tensors."""
    op = level["op"]
    node = level["node"]
    argi = level["args"]
    mask = u32(level["mask"])  # (W, 8)
    aux = u32(level["aux"])
    present = set(level["ops_present"]) & set(op.unique().tolist())

    def g(k):
        return gather_rows(lo_tab, s, argi[:, k]), \
            gather_rows(hi_tab, s, argi[:, k])

    alo, ahi = g(0)
    blo, bhi = g(1)
    batch = alo.shape[:-1]

    top_lo = torch.zeros_like(alo)
    top_hi = mask.expand(alo.shape)

    def iv(cond, lo, hi):
        """Select refined (lo, hi) where cond, else top."""
        return _where(cond, lo, top_lo), _where(cond, hi, top_hi)

    results = {}  # code -> (lo, hi)

    if ADD in present:
        s_lo, s_hi = bv256.add(alo, blo), bv256.add(ahi, bhi)
        add_ovf = bv256.ult(s_hi, ahi) | _ugt(s_hi, top_hi)
        results[ADD] = iv(~add_ovf, s_lo, s_hi)
    if SUB in present:
        can_sub = ~bv256.ult(alo, bhi)  # alo >= bhi
        results[SUB] = iv(
            can_sub, bv256.sub(alo, bhi), bv256.sub(ahi, blo))
    if MUL in present:
        plo, phi = bv256.mul_full(ahi, bhi)
        ok = bv256.is_zero(phi) & ~_ugt(plo, top_hi)
        results[MUL] = iv(ok, bv256.mul(alo, blo), plo)
    if UDIV in present:
        q1, _ = bv256.divmod_u(alo, bhi)
        q2, _ = bv256.divmod_u(ahi, blo)
        results[UDIV] = iv(~bv256.is_zero(blo), q1, q2)
    if UREM in present:
        # divisor may be 0 -> x % 0 = x (pass dividend interval)
        one = bv256.from_u32(torch.ones(batch, dtype=torch.int64,
                                        device=alo.device))
        bhi_m1 = bv256.sub(bhi, one)
        div_zero = bv256.is_zero(bhi)
        urem_lo = _where(div_zero, alo, top_lo)
        urem_hi = _where(
            div_zero, ahi,
            _where(~bv256.is_zero(blo), bhi_m1, top_hi))
        results[UREM] = (urem_lo, urem_hi)
    if BAND in present:
        results[BAND] = (top_lo, _where(bv256.ult(ahi, bhi), ahi, bhi))
    if BOR in present or BXOR in present:
        or_smear = smear_plain(ahi) | smear_plain(bhi)
        bor_hi = _where(bv256.ult(or_smear, top_hi), or_smear, top_hi)
        if BOR in present:
            results[BOR] = (_where(bv256.ult(alo, blo), blo, alo), bor_hi)
        if BXOR in present:
            results[BXOR] = (top_lo, bor_hi)
    if BNOT in present:
        results[BNOT] = (bv256.sub(top_hi, ahi), bv256.sub(top_hi, alo))
    if NEG in present:
        # (-x) mod 2^w — (2^256 - x) & mask == (2^w - x) for 0 < x <= 2^w
        zero = torch.zeros_like(alo)
        neg_exact = bv256.sub(zero, alo) & top_hi
        neg_lo_c = bv256.sub(zero, ahi) & top_hi
        neg_hi_c = bv256.sub(zero, alo) & top_hi
        a_const = bv256.eq(alo, ahi)
        a_pos = ~bv256.is_zero(alo)
        results[NEG] = (
            _where(a_const, neg_exact, _where(a_pos, neg_lo_c, top_lo)),
            _where(a_const, neg_exact, _where(a_pos, neg_hi_c, top_hi)),
        )
    if SHL in present:
        # constant in-range shift without overflow
        b_const = bv256.eq(blo, bhi)
        shl_hi_t = bv256.shl(ahi, bhi)
        shl_ok = (b_const & bv256.eq(bv256.shr(shl_hi_t, bhi), ahi)
                  & ~_ugt(shl_hi_t, top_hi))
        results[SHL] = iv(shl_ok, bv256.shl(alo, blo), shl_hi_t)
    if LSHR in present:
        results[LSHR] = (bv256.shr(alo, bhi), bv256.shr(ahi, blo))
    if COPY in present:
        results[COPY] = (alo, ahi)
    if SEXT in present:
        # provably non-negative input passes through
        sext_ok = bv256.ult(ahi, aux.expand(alo.shape))
        results[SEXT] = iv(sext_ok, alo, ahi)
    if EXTRACT in present:
        # args[:,1]=lo_b, args[:,2]=hi_b immediates, aux = field mask
        ext_mask = aux.expand(alo.shape)
        lo_b = bv256.from_u32(argi[:, 1]).expand(alo.shape)
        hi_b1 = bv256.from_u32(argi[:, 2] + 1).expand(alo.shape)
        same_high = bv256.eq(bv256.shr(alo, hi_b1), bv256.shr(ahi, hi_b1))
        slo_f = bv256.shr(alo, lo_b)
        shi_f = bv256.shr(ahi, lo_b)
        diff_ok = ~_ugt(bv256.sub(shi_f, slo_f), ext_mask)
        slo_m = slo_f & ext_mask
        shi_m = shi_f & ext_mask
        ext_ok = same_high & diff_ok & ~_ugt(slo_m, shi_m)
        # node width == field width, so top for EXTRACT is ext_mask == mask
        results[EXTRACT] = iv(ext_ok, slo_m, shi_m)
    if CONCAT2 in present:
        # (a << low_width) | b, bit-disjoint
        bw = bv256.from_u32(aux[:, 0]).expand(alo.shape)
        results[CONCAT2] = (
            bv256.shl(alo, bw) | blo, bv256.shl(ahi, bw) | bhi)
    if ITE in present:
        # ITE(cond, a, b): cond bool abs rides in limb 0 of arg0
        clo, chi = g(2)
        c_mf = alo[..., 0] != 0
        c_mt = ahi[..., 0] != 0
        results[ITE] = (
            _where(~c_mf, blo,
                   _where(~c_mt, clo,
                          _where(bv256.ult(blo, clo), blo, clo))),
            _where(~c_mf, bhi,
                   _where(~c_mt, chi,
                          _where(_ugt(bhi, chi), bhi, chi))),
        )

    # comparisons -> bool abs
    if EQ in present:
        disjoint = bv256.ult(ahi, blo) | bv256.ult(bhi, alo)
        all_const = (bv256.eq(alo, ahi) & bv256.eq(blo, bhi)
                     & bv256.eq(alo, blo))
        results[EQ] = _mk_bool(~all_const, ~disjoint)
    if ULT in present:
        lt_must = bv256.ult(ahi, blo)
        lt_never = ~bv256.ult(alo, bhi)  # alo >= bhi
        results[ULT] = _mk_bool(~lt_must, ~lt_never)
    if ULE in present:
        le_must = ~_ugt(ahi, blo)  # ahi <= blo
        le_never = _ugt(alo, bhi)
        results[ULE] = _mk_bool(~le_must, ~le_never)
    # bool connectives (abs in limb 0)
    if present & {BAND2, BOR2, BNOT1, BXOR2, BITE}:
        amf, amt = alo[..., 0] != 0, ahi[..., 0] != 0
        bmf, bmt = blo[..., 0] != 0, bhi[..., 0] != 0
        if BAND2 in present:
            results[BAND2] = _mk_bool(amf | bmf, amt & bmt)
        if BOR2 in present:
            results[BOR2] = _mk_bool(amf & bmf, amt | bmt)
        if BNOT1 in present:
            results[BNOT1] = _mk_bool(amt, amf)
        if BXOR2 in present:
            results[BXOR2] = _mk_bool(
                (amt & bmt) | (amf & bmf), (amt & bmf) | (amf & bmt))
        if BITE in present:
            clo, chi = g(2)
            cmf, cmt = clo[..., 0] != 0, chi[..., 0] != 0
            results[BITE] = _mk_bool(
                (amt & bmf) | (amf & cmf), (amt & bmt) | (amf & cmt))

    # select by opcode (pad/NOP rows keep their current value)
    out_lo = gather_rows(lo_tab, s, node)
    out_hi = gather_rows(hi_tab, s, node)
    for code, (rlo, rhi) in results.items():
        m = (op == code)[None, :, None]
        out_lo = torch.where(m, rlo, out_lo)
        out_hi = torch.where(m, rhi, out_hi)
    return out_lo, out_hi


def written_rows(level, n_rows: int):
    """(row positions, table rows) a level writes: its non-NOP nodes.
    A NOP or pad row would write back the value it read."""
    sel = torch.nonzero((level["op"] != NOP)
                        & (level["node"] < n_rows)).reshape(-1)
    return sel, level["node"][sel].long()


def eval_level_plain(level, lo_tab, hi_tab) -> None:
    """One forward level in place: transfer + overwrite (the JAX
    ``_eval_level``), in plain PyTorch, a chunk of states at a time."""
    sel, rows = written_rows(level, lo_tab.shape[1])
    for s in state_chunks(lo_tab.shape[0], level["op"].shape[0]):
        out_lo, out_hi = transfer_level_plain(level, lo_tab, hi_tab, s)
        lo_tab[s, rows] = i32(out_lo[:, sel])
        hi_tab[s, rows] = i32(out_hi[:, sel])


# ---------------------------------------------------------------------------
# kernel K5 (csrc/screen.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
#: every C entry of csrc/screen.cu with its argument types (K5-K8 all
#: bind through ``screen_lib``, so the library gets them all at once)
SCREEN_SIGS = {
    "interval_level": [_P, _P, _I, _I, _I] + [_P] * 6,
    "prop_fwd_level": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 3 + [_P] * 2,
    "prop_back_round": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 4 + [_P] * 3,
    "prop_back_shape": [_I, _I, _P],
    "prop_fwd_class": [_I],
    "prop_init": [_P] * 4 + [_I] * 2 + [_P] * 7 + [_I, _P, _P, _I, _P],
    "prop_exchange": [_P] * 4 + [_I] * 2 + [_P] * 3,
    "prop_verdicts": [_P] * 4 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 3,
    "prop_fixpoint": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P,
                      _I, _P, _I, _I, _P, _P, _P, _P],
    "prop_fixpoint_blocks": [],
}


def screen_lib():
    """(_build, the loaded csrc/screen.cu library)."""
    from .. import _build

    return _build, _build.lib("screen.cu", SCREEN_SIGS)


def check_tables(tabs, names) -> None:
    """Kernel arguments: CUDA int32 (S, T, 8) tables of one shape."""
    from .. import _build

    for t, name in zip(tabs, names):
        _build.need_cuda(t, torch.int32, name)
        if t.shape != tabs[0].shape or t.dim() != 3 \
                or t.shape[2] != bv256.NLIMBS:
            raise ValueError(f"{name}: expected (S, T, 8) like "
                             f"{tuple(tabs[0].shape)}")


def check_level(level, width: int) -> None:
    from .. import _build

    for key in ("node", "op", "args", "mask", "aux"):
        _build.need_cuda(level[key], torch.int32, f"level[{key!r}]")
    if level["op"].shape[0] != width or level["args"].shape != (width, 3):
        raise ValueError("level arrays of unequal widths")


def eval_level_kernel(level, lo_tab, hi_tab) -> None:
    """K5: one forward level in place, one thread per (state, node)."""
    check_tables((lo_tab, hi_tab), ("lo", "hi"))
    s, t = lo_tab.shape[:2]
    w = level["op"].shape[0]
    check_level(level, w)
    _build, lib = screen_lib()
    rc = lib.interval_level(
        _build.ptr(lo_tab), _build.ptr(hi_tab), s, t, w,
        _build.ptr(level["node"]), _build.ptr(level["op"]),
        _build.ptr(level["args"]), _build.ptr(level["mask"]),
        _build.ptr(level["aux"]), _build.stream(lo_tab.device))
    _build.LAUNCHES["interval_level"] += 1
    _build.check(lib, rc, "interval_level")


def eval_level(level, lo_tab, hi_tab, plain: bool = False) -> None:
    """One forward level in place: K5 on CUDA tables (unless ``plain``),
    the plain version on CPU tables."""
    if plain or lo_tab.device.type == "cpu":
        eval_level_plain(level, lo_tab, hi_tab)
    else:
        eval_level_kernel(level, lo_tab, hi_tab)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def seed_tables(init_lo, init_hi, seed_idx, seed_lo, seed_hi):
    """Per-state copies of the shared init tables with each state's
    variable-bound seeds scattered in; seed slots at rows past the
    table (the JAX ``mode="drop"``) are dropped."""
    n_states = seed_idx.shape[0]
    shape = (n_states,) + tuple(init_lo.shape)
    lo = init_lo.expand(shape).clone()
    hi = init_hi.expand(shape).clone()
    s_idx, v_idx = torch.nonzero(seed_idx < lo.shape[1], as_tuple=True)
    rows = seed_idx[s_idx, v_idx].long()
    lo[s_idx, rows] = seed_lo[s_idx, v_idx]
    hi[s_idx, rows] = seed_hi[s_idx, v_idx]
    return lo, hi


def _run_tables(enc: EncodedDAG, device, plain: bool = False):
    """Seed the per-state interval tables and sweep every level; returns
    (lo_tab, hi_tab, assert_idx, assert_mask) on ``device``, the shared
    core of the feasibility and shadow evaluations."""
    lo, hi = seed_tables(
        words_to_device(enc.init_lo, device),
        words_to_device(enc.init_hi, device),
        ints_to_device(enc.seed_idx, device),
        words_to_device(enc.seed_lo, device),
        words_to_device(enc.seed_hi, device))
    with trace.span("intervals.eval", states=enc.n_real,
                    levels=len(enc.levels)):
        for level in enc.levels:
            trace.call_jit("intervals.eval_level", eval_level,
                           level_to_device(level, device), lo, hi, plain)
    return (lo, hi, ints_to_device(enc.assert_idx, device).long(),
            ints_to_device(enc.assert_mask, device, torch.bool))


def _assert_rows(tab, assert_idx):
    """Limb 0 of each state's assertion rows: (S, A)."""
    rows = torch.arange(tab.shape[0], device=tab.device)[:, None]
    return tab[rows, assert_idx.clamp(0, tab.shape[1] - 1), 0]


def eval_feasible(enc: EncodedDAG, device=None,
                  plain: bool = False) -> np.ndarray:
    """Returns (n_real,) bool: True = state may be feasible (keep)."""
    lo, hi, aidx, amask = _run_tables(enc, resolve(device), plain)
    may_true = _assert_rows(hi, aidx) != 0
    ok = torch.all(may_true | ~amask, dim=1).cpu().numpy()
    return (ok & ~enc.dead)[:enc.n_real]


def eval_shadow(enc: EncodedDAG, device=None, plain: bool = False):
    """(proved, rejected) bool arrays for a model-pinned encoding.

    proved: every live assertion is MUST-true under the pinned model
    (a sound SAT proof); rejected: some live assertion is MUST-false
    (the model cannot survive). Neither flag set = the abstraction lost
    precision; the caller decides by exact host term-eval."""
    lo, hi, aidx, amask = _run_tables(enc, resolve(device), plain)
    may_false = _assert_rows(lo, aidx) != 0
    may_true = _assert_rows(hi, aidx) != 0
    proved = torch.all(~may_false | ~amask, dim=1).cpu().numpy()
    rejected = torch.any(~may_true & amask, dim=1).cpu().numpy()
    return proved[:enc.n_real], rejected[:enc.n_real]


def prefilter_feasible(assertion_sets, device=None) -> np.ndarray:
    """Host entry: linearize + evaluate. Soundness: only provably-unsat
    states report False."""
    return eval_feasible(linearize(assertion_sets), device)


def shadow_prefilter(delta_sets, bv_values: Dict[str, int],
                     bool_values: Dict[str, bool], device=None):
    """Device-batched model shadowing: evaluate each delta constraint
    set under one parent model pinned as point intervals. Returns
    (proved, rejected) per set — see eval_shadow. (The JAX package's
    verdict cache calls this as its tier 2; in the port that caller
    comes with the host bridge.)"""
    enc = linearize(delta_sets, pin_bv=bv_values, pin_bools=bool_values)
    return eval_shadow(enc, device)
