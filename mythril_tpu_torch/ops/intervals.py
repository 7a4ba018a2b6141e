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
- JAX's index rules (``gather_index``: a negative row wraps once, then
  clamps; ``scatter_index``: a negative node or seed slot wraps once,
  one still out of range is dropped), which K5, K6 and K7 all follow;
- K5 (``interval_levels`` in ``csrc/screen.cu``): ``interval_layout``,
  built once an encoding (``encoding_layout``) and copied to the card
  in one copy (``bind_layout``), and ``eval_levels_kernel``, the seeds
  and every level of it in one call; ``eval_levels_plain`` is its plain
  version (``scatter_seeds``, then ``eval_level_plain`` level by level);
- ``eval_level``: one forward level in place on the tables. On CPU
  tables it runs the plain version; on CUDA tables it launches K5 on
  the level's own layout, and never the plain version;
- the drivers ``eval_feasible``, ``eval_shadow``, ``prefilter_feasible``
  and ``shadow_prefilter``; on a card ``_run_tables`` clones the init
  tables once and calls K5 once, with no host wait.

Tables hold uint32 limbs as int32 bit patterns. The JAX functions return
new tables; the port updates them in place (a level's nodes are never
arguments of the same level in an encoding ``linearize`` makes; where a
wrapped index makes a level read a row it writes, the plain version
computes the level before it stores, and K5 stages it).
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


def gather_index(idx, n: int):
    """JAX's gather rule for row indices into ``n`` rows: a negative
    index wraps once (``i + n``), then an index out of range clamps into
    ``[0, n)``."""
    idx = torch.as_tensor(idx).long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def scatter_index(idx, n: int):
    """JAX's ``mode="drop"`` scatter rule for row indices into ``n``
    rows: (each index wrapped once where negative, whether it then lies
    in ``[0, n)``); the others are dropped."""
    idx = torch.as_tensor(idx).long()
    rows = torch.where(idx < 0, idx + n, idx)
    return rows, (rows >= 0) & (rows < n)


def last_of_each_row(rows, n: int):
    """Of entries naming rows ``rows`` (each in ``[0, n)``), whether each
    is the last to name its row: the write that stands where a scatter
    applies its updates in order."""
    pos = torch.arange(rows.numel(), device=rows.device)
    last = torch.full((n,), -1, dtype=torch.long, device=rows.device)
    last.scatter_reduce_(0, rows, pos, "amax")
    return last[rows] == pos


def gather_rows(tab, s, idx):
    """``tab[s][:, idx]`` as u32-form words, by JAX's gather rule
    (``gather_index``)."""
    return u32(tab[s][:, gather_index(idx, tab.shape[1]).to(tab.device)])


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
    """(row positions, table rows) a level writes: its non-NOP nodes,
    by JAX's ``mode="drop"`` rule (``scatter_index``: a negative node
    wraps once, one still out of range is dropped). A NOP or pad row
    would write back the value it read. Of two nodes naming one row,
    the later one's write stands (``linearize`` never makes two)."""
    rows, ok = scatter_index(level["node"], n_rows)
    sel = torch.nonzero((level["op"] != NOP) & ok).reshape(-1)
    rows = rows[sel]
    keep = last_of_each_row(rows, n_rows)
    return sel[keep], rows[keep]


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
    "interval_levels": [_P, _P, _I, _I] + [_P] * 8 + [_I, _I, _P, _P, _I,
                                                     _I, _P, _I, _P, _P],
    "interval_levels_blocks": [_I],
    "prop_fwd_level": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 6 + [_P] * 3,
    "prop_back_round": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 4 + [_P] * 3,
    "prop_back_shape": [_I, _I, _P],
    "prop_fwd_shape": [_I, _I, _P],
    "prop_fwd_class": [_I],
    "interval_reads": [_I],
    "prop_init": [_P] * 4 + [_I] * 2 + [_P] * 7 + [_I, _P, _P, _I, _P],
    "prop_exchange": [_P] * 4 + [_I] * 2 + [_P] * 3,
    "prop_verdicts": [_P] * 4 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 3,
    "prop_fixpoint": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I,
                      _P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    "prop_fixpoint_blocks": [_I],
}


def screen_lib():
    """(_build, the loaded csrc/screen.cu library)."""
    from .. import _build

    return _build, _build.lib("screen.cu", SCREEN_SIGS)


def fwd_classes() -> list:
    """The op class of each opcode (``fwd_class`` in csrc/screen.cu), by
    which K5's and K6's layouts order a level: 0 the bool-valued ops, 2
    the heavy transfers (MUL's 512-bit product, UDIV's and UREM's
    division, BOR's and BXOR's smear), 1 the rest."""
    if not _CLASSES:
        _build, lib = screen_lib()
        _CLASSES.extend(lib.prop_fwd_class(op) for op in range(32))
    return list(_CLASSES)


_CLASSES = []

#: what K5's transfer of an op reads (``iv_reads`` in csrc/screen.cu):
#: the low two bits the operand rows (0 for an op K5 has no transfer
#: for), then operand a, b or c read as a bool (limb 0 of lo and hi), the
#: mask, the aux, the aux's word 0 alone
IV_R_A0, IV_R_B0, IV_R_C0, IV_R_MASK, IV_R_AUX, IV_R_AUX0 = (
    4, 8, 16, 32, 64, 128)


def iv_reads() -> list:
    """What K5's transfer of each opcode reads (``IV_R_*`` bits), as the
    kernel compiles it (``interval_reads`` in csrc/screen.cu)."""
    if not _READS:
        _build, lib = screen_lib()
        _READS.extend(lib.interval_reads(op) for op in range(32))
    return list(_READS)


_READS = []


def check_tables(tabs, names) -> None:
    """Kernel arguments: CUDA int32 (S, T, 8) tables of one shape."""
    from .. import _build

    for t, name in zip(tabs, names):
        _build.need_cuda(t, torch.int32, name)
        if t.shape != tabs[0].shape or t.dim() != 3 \
                or t.shape[2] != bv256.NLIMBS:
            raise ValueError(f"{name}: expected (S, T, 8) like "
                             f"{tuple(tabs[0].shape)}")


#: K5's entry flags (``IV_*`` in csrc/screen.cu): operand a, b or c is a
#: row that no seed and no level of the layout writes, read from the
#: shared init tables (one copy for every state)
IV_SA, IV_SB, IV_SC = 1, 2, 4
#: K5's staged block (a level that reads a row it writes): a state at a
#: time, at most this many threads
IV_THREADS = 256
_UNARY = (BNOT, NEG, COPY, SEXT, EXTRACT, BNOT1)
_TERNARY = (ITE, BITE)


def _host_i32(x) -> np.ndarray:
    """A level array or a table as host int32 (uint32 words by their bit
    patterns)."""
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.uint32 \
        else x.astype(np.int32, copy=False)


_NREAD = np.full(32, 2, np.int64)
_NREAD[list(_UNARY)] = 1
_NREAD[list(_TERNARY)] = 3


def operand_reads(op) -> np.ndarray:
    """Operand rows each opcode reads: 1 (EXTRACT's second and third
    slots are immediates), 3 for ITE and BITE, else 2."""
    return _NREAD[np.asarray(op)]


def reads_own_rows(op, opnd, rows, n_rows: int) -> bool:
    """Whether a level reads a row it writes: one of its real entries
    (ops ``op``) reads an operand row (``opnd``, (n, 3) rows resolved by
    JAX's gather rule, ``gather_index``; as many as ``operand_reads``
    gives its op) that one of them writes (``rows``, resolved by the
    scatter rule, ``scatter_index``). JAX reads every operand before it
    scatters, so K5 and K6 then compute the whole level before they
    store (their staged launch). Numpy arrays."""
    nread = operand_reads(op)
    read = np.concatenate([opnd[nread > k, k] for k in range(3)])
    writes = np.zeros(n_rows, bool)
    writes[rows] = True
    return bool(writes[read].any())


def interval_layout(levels, n_rows: int, classes=None, init=None,
                    seed_idx=None) -> dict:
    """K5's layout of a run of forward levels over tables of ``n_rows``
    rows, built once an encoding, a plain function.

    Each level keeps its real entries only: not NOP, and a node that
    JAX's ``mode="drop"`` rule keeps (``scatter_index``; of two naming
    one row the later), ordered by (class, op), ``classes[op]`` the class
    of each opcode (``fwd_classes``; None: one class, 0), so each class
    of a level is one contiguous launch and a warp runs one op. Returns:

    - ``levels``: each level's own keys (``node``, ``op``, ``args``,
      ``mask``, ``aux``, ``ops_present``) in that order, as tensors,
      which the plain version takes as it takes the level;
    - ``ent`` ((N, 8) int32, the levels one after another): the node's
      row, op, the three operand rows by JAX's gather rule
      (``gather_index``), the raw second and third arguments (EXTRACT's
      immediates) and the ``IV_*`` flags; ``mask``, ``aux`` (N, 8);
    - ``lv`` ((L, 4) int32): each level's first entry, its end, and 1
      where one of its entries reads a row the level writes (K5 then
      computes the whole level before it stores, as JAX reads every
      operand before it scatters), 0;
    - ``counts`` (each level's entries a class), ``threads`` (the staged
      block) and ``stage_words`` (a staged block's slots, 16 words an
      entry; 0 where no level reads a row it writes).

    ``init`` ((init_lo, init_hi), each (n_rows, 8)) and ``seed_idx``
    ((S, V)) describe the tables the layout will run on, where they are
    the init tables with the seeds scattered in (``_run_tables``): a row
    that no seed and no level writes is then read from ``init``
    (``IV_SA``, ``IV_SB``, ``IV_SC``). Without them every operand is
    read from the state's table."""
    cls_of = np.zeros(32, np.int64) if classes is None \
        else np.asarray(classes, np.int64)
    static = np.zeros(n_rows, bool)
    if init is not None:
        static[:] = True
        if seed_idx is not None:
            rows, ok = scatter_index(_host_i32(seed_idx), n_rows)
            static[rows.numpy()[ok.numpy()]] = False
    picked = []
    for level in levels:
        op = _host_i32(level["op"])
        rows, ok = scatter_index(_host_i32(level["node"]), n_rows)
        sel = torch.from_numpy(np.flatnonzero((op != NOP) & ok.numpy()))
        keep = last_of_each_row(rows[sel], n_rows)
        sel, rows = sel[keep].numpy(), rows[sel][keep].numpy()
        order = np.argsort(cls_of[op[sel]] * 32 + op[sel], kind="stable")
        sel, rows = sel[order], rows[order]
        picked.append((sel, rows))
        static[rows] = False
    out = dict(levels=[], counts=[], n_rows=n_rows, stage_words=0)
    ent, masks, auxs, lv = [], [], [], []
    start = 0
    for level, (sel, rows) in zip(levels, picked):
        op = _host_i32(level["op"])[sel]
        node = _host_i32(level["node"])[sel]
        args = _host_i32(level["args"]).reshape(-1, 3)[sel]
        mask = _host_i32(level["mask"]).reshape(-1, bv256.NLIMBS)[sel]
        aux = _host_i32(level["aux"]).reshape(-1, bv256.NLIMBS)[sel]
        out["levels"].append(dict(
            node=torch.from_numpy(node), op=torch.from_numpy(op),
            args=torch.from_numpy(args), mask=torch.from_numpy(mask),
            aux=torch.from_numpy(aux),
            ops_present=tuple(sorted(set(op.tolist())))))
        opnd = gather_index(args, n_rows).numpy()
        nread = operand_reads(op)
        hazard = reads_own_rows(op, opnd, rows, n_rows)
        flags = (np.where(static[opnd[:, 0]], IV_SA, 0)
                 | np.where((nread > 1) & static[opnd[:, 1]], IV_SB, 0)
                 | np.where((nread > 2) & static[opnd[:, 2]], IV_SC, 0))
        ent.append(np.stack([rows, op, opnd[:, 0], opnd[:, 1], opnd[:, 2],
                             args[:, 1], args[:, 2], flags], 1))
        masks.append(mask)
        auxs.append(aux)
        n = len(sel)
        lv.append([start, start + n, int(hazard), 0])
        start += n
        out["counts"].append(np.bincount(cls_of[op], minlength=3).tolist())
        if hazard:
            out["stage_words"] = max(out["stage_words"], 16 * n)
    width = max((e - s for s, e, h, _ in lv if h), default=0)
    out["ent"] = np.concatenate(ent).astype(np.int32) if ent \
        else np.zeros((0, 8), np.int32)
    out["mask"] = np.concatenate(masks) if masks \
        else np.zeros((0, 8), np.int32)
    out["aux"] = np.concatenate(auxs) if auxs else np.zeros((0, 8), np.int32)
    out["lv"] = np.asarray(lv, np.int32).reshape(-1, 4)
    out["threads"] = min(IV_THREADS, max(32, -(-width // 32) * 32))
    return out


def iv_launch_shape(lay: dict, n_states: int, resident: int):
    """K5's launches for ``n_states`` states: [(level, class, blocks of
    ``IV_LEVEL_THREADS``)] for each class of a level, a thread a (state,
    entry) (the ``counts[level][class]`` entries from the level's first
    entry on, class by class), then (threads, blocks) of the staged
    block, a state a block at a time (block b takes states b, b +
    blocks, ...), no more blocks than states or than are resident at
    once (``resident``), so a staging buffer of ``blocks x
    stage_words`` words holds every block's."""
    launches = [(li, c, -(-n * n_states // IV_LEVEL_THREADS))
                for li, (cs, (_, _, hazard, _)) in enumerate(
                    zip(lay["counts"], lay["lv"])) if not hazard
                for c, n in enumerate(cs) if n and n_states]
    return launches, (lay["threads"], max(0, min(n_states, resident)))


#: the threads of a block of K5's level launches (``iv_level_kernel``)
IV_LEVEL_THREADS = 128
#: the sections of a bound layout, in the one buffer's order
_SECTIONS = ("ent", "mask", "aux")


def bind_layout(lay: dict, device, **arrays) -> dict:
    """The layout on ``device`` in one allocation, from one copy of one
    pinned host buffer: its ``ent``, ``mask`` and ``aux`` and the
    int32-convertible ``arrays`` (the init tables, seeds and assertion
    slots of ``_run_tables``), each a 16-byte-aligned view of the
    allocation under its own name, in its own shape; ``lv`` and
    ``counts`` stay on the host, which launches by them."""
    device = torch.device(device)
    # each part goes straight into the pinned buffer, numpy's assignment
    # casting it to int32 (uint32 words and bools by their bit patterns):
    # no intermediate copy, whose fresh host pages are slow to touch on a
    # card's host (PERF.md §6)
    parts = [(k, np.asarray(v.cpu() if torch.is_tensor(v) else v))
             for k, v in [(k, lay[k]) for k in _SECTIONS]
             + list(arrays.items())]
    offs, total = [], 0
    for _, x in parts:
        offs.append(total)
        total += -(-x.size // 4) * 4
    host = torch.empty(max(total, 4), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    for (_, x), off in zip(parts, offs):
        flat[off:off + x.size] = x.reshape(-1)
    buf = host.to(device, non_blocking=True)
    out = {k: v for k, v in lay.items() if k not in _SECTIONS}
    out.update(buf=buf, host=host, device=device)
    for (k, x), off in zip(parts, offs):
        out[k] = buf[off:off + x.size].view(x.shape)
    return out


_RESIDENT = {}


def eval_levels_kernel(lay: dict, lo_tab, hi_tab) -> None:
    """K5: a bound layout's seeds (where it has them, ``seed_idx``,
    ``seed_lo``, ``seed_hi``: a launch, a thread a state) and then every
    level of it, in place on CUDA tables: a launch a level and op class,
    a thread a (state, entry) (``csrc/screen.cu`` ``iv_level_kernel``),
    or for a level that reads a row it writes, one staged launch, a block
    a state (``iv_staged_kernel``). ``LAUNCHES["interval_level"]`` counts
    the CUDA launches, as the C side reports them."""
    check_tables((lo_tab, hi_tab), ("lo", "hi"))
    s, t = lo_tab.shape[:2]
    if t != lay["n_rows"] or lay["buf"].device != lo_tab.device:
        raise ValueError(f"K5: a layout of {lay['n_rows']} rows on "
                         f"{lay['buf'].device}, tables of {t} on "
                         f"{lo_tab.device}")
    if "seed_idx" in lay and lay["seed_idx"].shape[0] != s:
        raise ValueError(f"K5: seeds of {lay['seed_idx'].shape[0]} states "
                         f"for {s}")
    _build, lib = screen_lib()
    dev = lo_tab.device.index
    if dev not in _RESIDENT:
        _RESIDENT[dev] = lib.interval_levels_blocks(IV_THREADS)
    fixed, staged = _launch_args(lay, s, _RESIDENT[dev])
    blocks = staged[1]
    stage = torch.empty(blocks * lay["stage_words"], dtype=torch.int32,
                        device=lo_tab.device) \
        if lay["stage_words"] and s else None
    launched = ctypes.c_int(0)
    rc = lib.interval_levels(
        _build.ptr(lo_tab), _build.ptr(hi_tab), s, t, *fixed, *staged,
        None if stage is None else _build.ptr(stage), lay["stage_words"],
        ctypes.byref(launched), _build.stream(lo_tab.device))
    _build.LAUNCHES["interval_level"] += launched.value
    _build.check(lib, rc, "interval_levels")


def _launch_args(lay: dict, n_states: int, resident: int):
    """A bound layout's launch arguments, made once and kept on it: the
    pointers, seed slots, level count and the host arrays of class
    counts and staged levels; for ``n_states`` states the staged
    (threads, blocks)."""
    from .. import _build

    if "launch" not in lay:
        hazards = [int(h) for h in lay["lv"][:, 2]]
        lay["launch"] = (
            (_build.ptr(lay["ent"]), _build.ptr(lay["mask"]),
             _build.ptr(lay["aux"]),
             *(_build.ptr(lay[k]) if k in lay else None
               for k in ("init_lo", "init_hi", "seed_idx", "seed_lo",
                         "seed_hi")),
             lay["seed_idx"].shape[1] if "seed_idx" in lay else 0,
             len(hazards),
             _build.int_array([c for cs in lay["counts"] for c in cs]),
             _build.int_array(hazards)), {})
    fixed, shapes = lay["launch"]
    if n_states not in shapes:
        shapes[n_states] = iv_launch_shape(lay, n_states, resident)[1]
    return fixed, shapes[n_states]


def eval_level_kernel(level, lo_tab, hi_tab) -> None:
    """K5 on one level of any tables: the level's layout, which assumes
    nothing of the tables (every operand from the state's table)."""
    check_tables((lo_tab, hi_tab), ("lo", "hi"))
    for key in ("node", "op", "args", "mask", "aux"):
        if not torch.is_tensor(level[key]) or not level[key].is_cuda:
            raise ValueError(f"K5: level[{key!r}] is not a CUDA tensor")
    lay = interval_layout([level], lo_tab.shape[1], fwd_classes())
    eval_levels_kernel(bind_layout(lay, lo_tab.device), lo_tab, hi_tab)


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


def scatter_seeds(lo, hi, seed_idx, seed_lo, seed_hi) -> None:
    """Each state's variable-bound seeds into its rows of the tables, in
    place, by JAX's ``mode="drop"`` rule (``scatter_index``: a negative
    slot wraps once, one still out of range is dropped), slot by slot,
    so a later slot naming the same row wins."""
    rows, ok = scatter_index(seed_idx, lo.shape[1])
    for v in range(seed_idx.shape[1]):
        s = torch.nonzero(ok[:, v]).reshape(-1)
        r = rows[s, v]
        lo[s, r] = seed_lo[s, v]
        hi[s, r] = seed_hi[s, v]


def seed_tables(init_lo, init_hi, seed_idx, seed_lo, seed_hi):
    """Per-state copies of the shared init tables with each state's
    seeds scattered in (``scatter_seeds``): the plain version of K5's
    seeding."""
    shape = (seed_idx.shape[0],) + tuple(init_lo.shape)
    lo = init_lo.expand(shape).clone()
    hi = init_hi.expand(shape).clone()
    scatter_seeds(lo, hi, seed_idx, seed_lo, seed_hi)
    return lo, hi


def eval_levels_plain(lay: dict, lo_tab, hi_tab) -> None:
    """The plain version of ``eval_levels_kernel`` on the same layout:
    its seeds (where it has them) scattered in, then
    ``eval_level_plain`` over its levels in order."""
    dev = lo_tab.device
    if "seed_idx" in lay:
        scatter_seeds(lo_tab, hi_tab, *(lay[k].to(dev) for k in (
            "seed_idx", "seed_lo", "seed_hi")))
    for level in lay["levels"]:
        eval_level_plain({k: v.to(dev) if torch.is_tensor(v) else v
                          for k, v in level.items()}, lo_tab, hi_tab)


def encoding_layout(enc: EncodedDAG, device) -> dict:
    """K5's bound layout of an encoding (``interval_layout`` with the
    init tables and seeds it starts from, ordered by ``fwd_classes``), on
    ``device`` with the init tables, seeds and assertion slots in its one
    allocation; built at the first call and kept on the encoding."""
    key = ("k5", str(device))
    if key not in enc.host:
        lay = interval_layout(enc.levels, enc.init_lo.shape[0],
                              fwd_classes(), (enc.init_lo, enc.init_hi),
                              enc.seed_idx)
        enc.host[key] = bind_layout(
            lay, device, init_lo=enc.init_lo, init_hi=enc.init_hi,
            seed_idx=enc.seed_idx, seed_lo=enc.seed_lo, seed_hi=enc.seed_hi,
            assert_idx=enc.assert_idx, assert_mask=enc.assert_mask)
    return enc.host[key]


def _run_tables(enc: EncodedDAG, device, plain: bool = False):
    """Seed the per-state interval tables and sweep every level; returns
    (lo_tab, hi_tab, assert_idx, assert_mask) on ``device``, the shared
    core of the feasibility and shadow evaluations. On a card (unless
    ``plain``): the init tables cloned once a table and K5 once, which
    scatters the seeds and runs every level; no host wait before the
    launch."""
    device = torch.device(device)
    if plain or device.type == "cpu":
        lo, hi = seed_tables(
            words_to_device(enc.init_lo, device),
            words_to_device(enc.init_hi, device),
            ints_to_device(enc.seed_idx, device),
            words_to_device(enc.seed_lo, device),
            words_to_device(enc.seed_hi, device))
        with trace.span("intervals.eval", states=enc.n_real,
                        levels=len(enc.levels)):
            for level in enc.levels:
                trace.call_jit("intervals.eval_level", eval_level_plain,
                               level_to_device(level, device), lo, hi)
        return (lo, hi, ints_to_device(enc.assert_idx, device).long(),
                ints_to_device(enc.assert_mask, device, torch.bool))
    lay = encoding_layout(enc, device)
    shape = (enc.seed_idx.shape[0],) + tuple(lay["init_lo"].shape)
    lo = lay["init_lo"].expand(shape).clone()
    hi = lay["init_hi"].expand(shape).clone()
    with trace.span("intervals.eval", states=enc.n_real,
                    levels=len(enc.levels)):
        trace.call_jit("intervals.eval_levels", eval_levels_kernel, lay,
                       lo, hi)
    return lo, hi, lay["assert_idx"], lay["assert_mask"] != 0


def _assert_rows(tab, assert_idx):
    """Limb 0 of each state's assertion rows: (S, A), by JAX's gather
    rule."""
    rows = torch.arange(tab.shape[0], device=tab.device)[:, None]
    return tab[rows, gather_index(assert_idx, tab.shape[1]), 0]


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
