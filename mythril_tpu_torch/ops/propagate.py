"""Bidirectional fixpoint propagation over an EncodedDAG: the product-
domain screen, in PyTorch and as kernels K6-K8.

The counterpart of ``mythril_tpu/ops/propagate.py``; its docstring holds
the model. Per (state, node) the tables carry an interval [lo, hi]
(bools keep (may_false, may_true) in limb 0) and known bits (k0: bits
that must be 0, k1: bits that must be 1). One sweep is the forward
levels (interval and known-bits transfer, MET against the current
rows), a table-wide interval <-> known-bits exchange, the backward
rounds (inverse transfer functions gated per state on the parent's
abstraction, MET into their targets), and the exchange again. Sweeps
repeat until no table changes or ``SWEEP_CAP``. A state dies on a bit
forced both ways, an empty interval, a bool that can be neither, or a
must-false assertion; surviving states yield facts (``harvest``).

The host part (``build_plan``, ``harvest``, ``abstraction_sets``,
``prescreen``) is a copy. Each device step has a plain PyTorch version,
a line-by-line mirror of the JAX function, and a kernel in
``csrc/screen.cu``:

- ``fwd_level`` (JAX ``_fwd_level``): K6 ``prop_fwd_level``, which
  stages a level that reads a row it writes (``level_layout``'s
  ``hazard``), as JAX reads every operand before it scatters;
- ``back_round`` (JAX ``_back_round``): K7 ``prop_back_round``;
  both take the plan's kernel layout (``kernel_layout``: each level's
  and round's real entries only, ordered by op), built once a plan;
- ``init_tables``, ``exchange``, ``verdicts`` (JAX ``_init_tables``,
  ``_exchange_all``, ``_verdicts``): K8 ``prop_init``,
  ``prop_exchange``, ``prop_verdicts``.

On CPU tables a wrapper runs its plain version; on CUDA tables it
launches its kernel (``plain=True`` runs the plain version on the card,
for comparison). Tables are updated in place. The JAX ``_changed``
compares each sweep's start tables with its end tables; here every pass,
kernel or plain, sets a flag instead when it stores a word that differs
(refinement is monotone, so a changed word never returns to its start
value and the flag gives the same sweep count without copying the
tables). ``changed_plain`` is the JAX comparison, kept to check the
flag against.

Two drivers, chosen as the JAX package chooses them
(``MTPU_PROPAGATE_FUSE``, read once at import into ``FUSE``):
``_run_host`` sequences the passes from the host, a launch each, with
one changed-flag read per sweep; ``_fixpoint`` (the JAX ``_fixpoint``)
runs the whole fixpoint in one launch of kernel K11
(``csrc/screen.cu`` ``prop_fixpoint``), a block per system running the
K6-K8 device functions to that system's own fixpoint, or on CPU tables
``_fixpoint_plain``, which runs the plain passes in the same order on
the systems still changing. Both give the same tables, verdicts and
sweep count.

``prefilter_feasible`` banks its results in the run-wide verdict cache
(refuted sets recorded UNSAT, facts and bounds noted), and every screen
meets the static storage-ITE seeds (``_inject_static_seeds``) into its
init tables first, as the JAX package does.
"""

import logging
import os
from collections import namedtuple
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..smt import terms as T
from ..smt.solver.solver_statistics import SolverStatistics
from ..support.devices import resolve
from ..support.telemetry import trace
from . import bv256
from .bv256 import M32, i32, u32
from .intervals import (
    ADD, BAND, BAND2, BNOT, BNOT1, BOR, BOR2, BXOR, CONCAT2, COPY, EQ,
    EXTRACT, ITE, LSHR, NOP, SHL, SUB, ULE, ULT,
    EncodedDAG, _next_pow2, _not, _ugt, _where, check_tables,
    eval_feasible, fwd_classes, gather_index, gather_rows, ints_to_device,
    last_of_each_row, linearize, reads_own_rows, scatter_index,
    scatter_seeds, screen_lib, smear_plain,
    state_chunks, transfer_level_plain, words_to_device, written_rows,
)

log = logging.getLogger(__name__)

#: tri-state override for tests/bench (None = read MTPU_PROPAGATE)
FORCE: Optional[bool] = None


def enabled() -> bool:
    """The MTPU_PROPAGATE gate (default on). With the screen off every
    caller falls back to the forward interval-only path bit-for-bit."""
    if FORCE is not None:
        return bool(FORCE)
    return os.environ.get("MTPU_PROPAGATE", "1") != "0"


#: fixpoint sweep cap (each sweep = forward + exchange + backward +
#: exchange; the driver exits early when no table changes)
SWEEP_CAP = int(os.environ.get("MTPU_PROPAGATE_SWEEPS", "6"))
#: level-count ceiling: beyond it the screen falls back to the forward
#: interval-only pass
MAX_LEVELS = int(os.environ.get("MTPU_PROPAGATE_MAX_LEVELS", "96"))
#: the fused driver (kernel K11), opt-in as in the JAX package
FUSE = os.environ.get("MTPU_PROPAGATE_FUSE", "0") == "1"
#: duplicate-target backward rounds kept per level (further refiners of
#: an already-refined node are dropped — precision only, never
#: soundness)
MAX_BACK_ROUNDS = 4
#: harvested facts kept per surviving lane
FACT_CAP = 16

#: parent ops with inverse transfer functions, and which arg slots
#: each refines
_BACK_ROLES = {
    EQ: (0, 1), ULT: (0, 1), ULE: (0, 1),
    ADD: (0, 1), SUB: (0, 1),
    BAND: (0, 1), BOR: (0, 1), BXOR: (0, 1), BNOT: (0,),
    SHL: (0,), LSHR: (0,), COPY: (0,),
    EXTRACT: (0,), CONCAT2: (0, 1), ITE: (1, 2),
    BAND2: (0, 1), BOR2: (0, 1), BNOT1: (0,),
}


# ---------------------------------------------------------------------------
# host-side plan build (a copy)
# ---------------------------------------------------------------------------


class Plan:
    """Host arrays (numpy) + per-level op sets for one encoded wave."""

    def __init__(self, arrays, statics):
        self.arrays = arrays
        self.statics = statics


def build_plan(enc: EncodedDAG) -> Optional[Plan]:
    """Backward tables + product-domain statics from the host arrays
    linearize() left on the EncodedDAG. None when the DAG is too deep
    (caller falls back to the forward interval screen)."""
    host = enc.host
    if not host or not enc.levels or len(enc.levels) > MAX_LEVELS:
        return None
    order = host["terms"]
    dev_op = host["op"]
    args = host["args"]
    mask_w = host["mask"]
    aux = host["aux"]
    n = enc.n_nodes
    n_slots = host["n_slots"]

    isbool = np.zeros(n_slots, dtype=bool)
    numeric = np.zeros(n_slots, dtype=bool)
    wide = np.zeros(n_slots, dtype=bool)
    node_mask = np.zeros((n_slots, bv256.NLIMBS), dtype=np.uint32)
    for i, t in enumerate(order):
        if t.is_bool:
            isbool[i] = True
        elif not t.is_array and isinstance(t.width, int) and t.width >= 1:
            numeric[i] = True
            if t.width > 256:
                # topped cap: the table value is NOT the node's value,
                # so wide nodes keep full-range masks and are excluded
                # as backward targets (refining the cap is unsound)
                wide[i] = True
                node_mask[i] = 0xFFFFFFFF
            else:
                node_mask[i] = mask_w[i] if np.any(mask_w[i]) else \
                    bv256.int_to_limbs((1 << t.width) - 1)

    # initial known bits: out-of-width bits are known 0; point inits
    # (constants / pinned vars) are fully known
    init_lo = np.asarray(enc.init_lo)
    init_hi = np.asarray(enc.init_hi)
    init_k0 = np.zeros_like(init_lo)
    init_k1 = np.zeros_like(init_lo)
    num_nw = numeric & ~wide
    init_k0[num_nw] = ~node_mask[num_nw]
    point = num_nw & np.all(init_lo == init_hi, axis=-1)
    init_k1[point] = init_lo[point]
    init_k0[point] = ~init_lo[point]

    # per-level row flags for the forward meet
    levels = []
    for level in enc.levels:
        node = np.asarray(level["node"])
        in_range = node < n_slots
        safe = np.where(in_range, node, 0)
        levels.append(dict(
            {k: v for k, v in level.items() if k != "ops_present"},
            lvl_bool=np.where(in_range, isbool[safe], False),
            lvl_num=np.where(in_range, numeric[safe], False)))

    # backward rounds: entries (parent, role) grouped so each round's
    # targets are unique within its level
    back: List[list] = []
    back_ops: List[tuple] = []
    for level in enc.levels:
        node = np.asarray(level["node"])
        entries = []  # (round, parent, role, target, op)
        seen: Dict[int, int] = {}
        for i in node.tolist():
            if i >= n:
                continue
            op = int(dev_op[i])
            roles = _BACK_ROLES.get(op)
            if roles is None:
                continue
            for role in roles:
                tgt = int(args[i, role])
                if tgt >= n or wide[tgt]:
                    continue
                if not (numeric[tgt] or isbool[tgt]):
                    continue
                rnd = seen.get(tgt, 0)
                seen[tgt] = rnd + 1
                if rnd >= MAX_BACK_ROUNDS:
                    continue
                entries.append((rnd, i, role, tgt, op))
        rounds: List[dict] = []
        r_ops: List[tuple] = []
        n_rounds = max((e[0] for e in entries), default=-1) + 1
        for r in range(n_rounds):
            es = [e for e in entries if e[0] == r]
            w = _next_pow2(len(es))
            ops_set = set()
            parent = np.zeros(w, dtype=np.int32)
            role = np.zeros(w, dtype=np.int32)
            tgt = np.full(w, n_slots, dtype=np.int32)  # pad: dropped
            e_op = np.zeros(w, dtype=np.int32)  # pad: NOP
            for j, (_r, p, ro, tg, op) in enumerate(es):
                parent[j], role[j], tgt[j], e_op[j] = p, ro, tg, op
                ops_set.add(op)
            a_idx = args[np.minimum(parent, n - 1), 0].astype(np.int32)
            b_idx = args[np.minimum(parent, n - 1), 1].astype(np.int32)
            # EXTRACT stores its lo-bit immediate in args[:, 1]
            is_ext = e_op == EXTRACT
            lob = np.where(is_ext, b_idx, 0).astype(np.uint32)
            b_idx = np.where(is_ext, 0, b_idx).astype(np.int32)
            # ITE refines its arg-1/2 branches; the gate reads arg 0
            # (the condition), gathered through a_idx as usual
            c_idx = args[np.minimum(parent, n - 1), 2].astype(np.int32)
            rounds.append(dict(
                parent=np.minimum(parent, n_slots - 1),
                a=np.minimum(a_idx, n_slots - 1),
                b=np.minimum(b_idx, n_slots - 1),
                c=np.minimum(c_idx, n_slots - 1),
                tgt=tgt,
                tgt_c=np.minimum(tgt, n_slots - 1),
                role=role,
                op=e_op,
                pmask=node_mask[np.minimum(parent, n_slots - 1)],
                paux=aux[np.minimum(parent, n - 1)],
                lob=lob,
                tnum=numeric[np.minimum(tgt, n_slots - 1)]
                & (tgt < n_slots),
                tbool=isbool[np.minimum(tgt, n_slots - 1)]
                & (tgt < n_slots),
            ))
            r_ops.append(tuple(sorted(ops_set)))
        back.append(rounds)
        back_ops.append(tuple(r_ops))

    arrays = dict(
        init_lo=init_lo, init_hi=init_hi, init_k0=init_k0, init_k1=init_k1,
        numeric=numeric, isbool=isbool,
        seed_idx=np.asarray(enc.seed_idx), seed_lo=np.asarray(enc.seed_lo),
        seed_hi=np.asarray(enc.seed_hi),
        assert_idx=np.asarray(enc.assert_idx),
        assert_mask=np.asarray(enc.assert_mask),
        levels=tuple(levels),
        back=tuple(tuple(rnds) for rnds in back),
    )
    statics = (
        SWEEP_CAP,
        tuple(lvl["ops_present"] for lvl in enc.levels),
        tuple(back_ops),
    )
    return Plan(arrays, statics)


_WORD_KEYS = ("init_lo", "init_hi", "init_k0", "init_k1", "seed_lo",
              "seed_hi", "mask", "aux", "pmask", "paux", "lob")


def _to_device(d: dict, device) -> dict:
    out = {}
    for key, val in d.items():
        if key in _WORD_KEYS:
            out[key] = words_to_device(val, device)
        elif np.asarray(val).dtype == bool:
            out[key] = ints_to_device(val, device, torch.uint8)
        else:
            out[key] = ints_to_device(val, device)
    return out


def plan_to_device(plan: Plan, device) -> dict:
    """The plan's arrays on ``device``: words as int32 bit patterns,
    flags as uint8; levels carry their ``ops_present``, rounds theirs
    as ``ops``."""
    _cap, level_ops, back_ops = plan.statics
    core = _to_device({k: v for k, v in plan.arrays.items()
                       if k not in ("levels", "back")}, device)
    core["levels"] = [dict(_to_device(lvl, device), ops_present=ops)
                      for lvl, ops in zip(plan.arrays["levels"], level_ops)]
    core["back"] = [[dict(_to_device(r, device), ops=ops)
                     for r, ops in zip(rnds, r_ops)]
                    for rnds, r_ops in zip(plan.arrays["back"], back_ops)]
    return core


# ---------------------------------------------------------------------------
# plain versions (u32-form int64 words)
# ---------------------------------------------------------------------------


def _max_n(a, b):
    return _where(bv256.ult(a, b), b, a)


def _min_n(a, b):
    return _where(bv256.ult(b, a), b, a)


def _meet(cur, new, isbool, isnum):
    """Meet a candidate (lo, hi, k0, k1) against the current value:
    bools intersect their (mf, mt) bits, numerics take max-lo / min-hi
    and union the known-bit masks. Non-numeric non-bool rows (arrays,
    pads) pass the current value through."""
    clo, chi, ck0, ck1 = cur
    nlo, nhi, nk0, nk1 = new
    b = isbool[..., None]
    m = isnum[..., None]
    lo = torch.where(b, clo & nlo, torch.where(m, _max_n(clo, nlo), clo))
    hi = torch.where(b, chi & nhi, torch.where(m, _min_n(chi, nhi), chi))
    k0 = torch.where(m, ck0 | nk0, ck0)
    k1 = torch.where(m, ck1 | nk1, ck1)
    return lo, hi, k0, k1


def init_tables_plain(core):
    """Per-state product tables: the shared init rows, the seeds
    scattered in, every asserted root pinned TRUE (may_false := 0).
    Seed and assertion slots follow the JAX ``mode="drop"`` rule
    (``scatter_index``: a negative slot wraps once, one still outside
    the table is dropped), the seeds slot by slot (``scatter_seeds``)."""
    seed_idx = core["seed_idx"]
    n_states, n_rows = seed_idx.shape[0], core["init_lo"].shape[0]
    shape = (n_states,) + tuple(core["init_lo"].shape)
    lo, hi, k0, k1 = (core[k].expand(shape).clone()
                      for k in ("init_lo", "init_hi", "init_k0", "init_k1"))
    scatter_seeds(lo, hi, seed_idx, core["seed_lo"], core["seed_hi"])
    rows, ok = scatter_index(core["assert_idx"], n_rows)
    s_idx, a_idx = torch.nonzero((core["assert_mask"] != 0) & ok,
                                 as_tuple=True)
    lo[s_idx, rows[s_idx, a_idx], 0] = 0
    return lo, hi, k0, k1


def _exchange_rows(lo, hi, k0, k1, numeric):
    """``_exchange_all`` on u32-form rows."""
    m = numeric[..., None]
    known = _not(smear_plain(lo ^ hi))
    k1n = torch.where(m, k1 | (lo & known), k1)
    k0n = torch.where(m, k0 | (_not(lo) & known), k0)
    lon = torch.where(m, _max_n(lo, k1n), lo)
    hin = torch.where(m, _min_n(hi, _not(k0n)), hi)
    return lon, hin, k0n, k1n


def _store(tab, idx, new, changed) -> None:
    """tab[idx] = new, setting the changed flag (when given) if any word
    differs, as the kernels do."""
    if changed is not None and bool(torch.any(tab[idx] != new)):
        changed.fill_(1)
    tab[idx] = new


def exchange_plain(tabs, numeric, changed=None) -> None:
    """Table-wide interval <-> known-bits refinement (numeric rows), in
    place: shared leading bits of [lo, hi] become known; k1 is a sound
    lower bound and ~k0 a sound upper bound."""
    num = numeric != 0
    for s in state_chunks(tabs[0].shape[0], tabs[0].shape[1]):
        out = _exchange_rows(*(u32(t[s]) for t in tabs), num[None, :])
        for t, x in zip(tabs, out):
            _store(t, s, i32(x), changed)


def _fwd_rows(level, tabs, s):
    """The forward product-domain transfer of a level for states ``s``,
    met against the current rows: (lo, hi, k0, k1) of shape (s, W, 8)."""
    lo_tab, hi_tab, k0_tab, k1_tab = tabs
    out_lo, out_hi = transfer_level_plain(level, lo_tab, hi_tab, s)
    op = level["op"]
    node = level["node"]
    argi = level["args"]
    mask = u32(level["mask"])
    aux = u32(level["aux"])
    present = set(level["ops_present"]) & set(op.unique().tolist())

    def g(tab, k):
        return gather_rows(tab, s, argi[:, k])

    ak0, ak1 = g(k0_tab, 0), g(k1_tab, 0)
    bk0, bk1 = g(k0_tab, 1), g(k1_tab, 1)
    alo, ahi = g(lo_tab, 0), g(hi_tab, 0)
    blo, bhi = g(lo_tab, 1), g(hi_tab, 1)
    full_mask = mask.expand(ak0.shape)
    not_w = _not(full_mask)  # out-of-width bits (known 0 for w<=256)

    zero = torch.zeros_like(ak0)
    results = {}  # code -> (k0, k1)

    if BAND in present:
        results[BAND] = ((ak0 | bk0) | not_w, ak1 & bk1 & full_mask)
    if BOR in present:
        results[BOR] = ((ak0 & bk0) | not_w, (ak1 | bk1) & full_mask)
    if BXOR in present:
        results[BXOR] = (
            (((ak0 & bk0) | (ak1 & bk1)) & full_mask) | not_w,
            ((ak0 & bk1) | (ak1 & bk0)) & full_mask,
        )
    if BNOT in present:
        results[BNOT] = ((ak1 & full_mask) | not_w, ak0 & full_mask)
    if COPY in present:
        results[COPY] = (ak0 | not_w, ak1 & full_mask)
    if SHL in present:
        b_const = bv256.eq(blo, bhi)
        sk1 = bv256.shl(ak1, blo) & full_mask
        sk0 = (bv256.shl(ak0, blo) | _not(bv256.shl(full_mask, blo))) \
            & full_mask
        results[SHL] = (_where(b_const, sk0 | not_w, not_w),
                        _where(b_const, sk1, zero))
    if LSHR in present:
        b_const = bv256.eq(blo, bhi)
        surviving = bv256.shr(full_mask, blo)
        results[LSHR] = (
            _where(b_const,
                   (bv256.shr(ak0, blo) & surviving) | _not(surviving),
                   not_w),
            _where(b_const, bv256.shr(ak1, blo) & surviving, zero),
        )
    if EXTRACT in present:
        field = aux.expand(ak0.shape)
        lo_b = bv256.from_u32(argi[:, 1]).expand(ak0.shape)
        results[EXTRACT] = (
            (bv256.shr(ak0, lo_b) & field) | _not(field),
            bv256.shr(ak1, lo_b) & field,
        )
    if CONCAT2 in present:
        bw = bv256.from_u32(aux[:, 0]).expand(ak0.shape)
        low = _not(bv256.shl(torch.full_like(bw, M32), bw))
        results[CONCAT2] = (
            ((bv256.shl(ak0, bw) | (bk0 & low)) & full_mask) | not_w,
            (bv256.shl(ak1, bw) | (bk1 & low)) & full_mask,
        )
    if ADD in present or SUB in present:
        a_full = bv256.is_zero(_not(ak0 | ak1))
        b_full = bv256.is_zero(_not(bk0 | bk1))
        both = a_full & b_full
        if ADD in present:
            sm = bv256.add(ak1, bk1) & full_mask
            results[ADD] = (_where(both, _not(sm), zero),
                            _where(both, sm, zero))
        if SUB in present:
            d = bv256.sub(ak1, bk1) & full_mask
            results[SUB] = (_where(both, _not(d), zero),
                            _where(both, d, zero))
    if ITE in present:
        c_mf = alo[..., 0] != 0
        c_mt = ahi[..., 0] != 0
        ck0, ck1 = g(k0_tab, 2), g(k1_tab, 2)
        results[ITE] = (
            _where(~c_mf, bk0, _where(~c_mt, ck0, bk0 & ck0)),
            _where(~c_mf, bk1, _where(~c_mt, ck1, bk1 & ck1)),
        )

    nk0, nk1 = zero, zero
    for code, (rk0, rk1) in results.items():
        m = (op == code)[None, :, None]
        nk0 = torch.where(m, rk0, nk0)
        nk1 = torch.where(m, rk1, nk1)

    # known-bits refutation of EQ: a bit one side must set and the
    # other must clear makes the equality MUST-false
    if EQ in present:
        conflict = ~bv256.is_zero((ak1 & bk0) | (ak0 & bk1))
        m = (op == EQ)[None, :] & conflict
        out_hi[..., 0] = torch.where(m, 0, out_hi[..., 0])

    cur = tuple(gather_rows(t, s, node) for t in tabs)
    return _meet(cur, (out_lo, out_hi, nk0, nk1),
                 level["lvl_bool"][None, :] != 0,
                 level["lvl_num"][None, :] != 0)


def fwd_level_plain(level, tabs, changed=None) -> None:
    """Forward product-domain transfer of one level, MET against the
    current tables, in place (the JAX ``_fwd_level``)."""
    sel, rows = written_rows(level, tabs[0].shape[1])
    for s in state_chunks(tabs[0].shape[0], level["op"].shape[0]):
        out = _fwd_rows(level, tabs, s)
        for t, x in zip(tabs, out):
            _store(t, (s, rows), i32(x[:, sel]), changed)


def _back_rows(rnd, tabs, s):
    """Candidates of one backward round for states ``s``, met into the
    targets' current rows: (lo, hi, k0, k1) of shape (s, W, 8)."""
    lo_tab, hi_tab, k0_tab, k1_tab = tabs
    present = set(rnd["ops"])
    op = rnd["op"]
    role = rnd["role"]

    def g(tab, idx):
        return gather_rows(tab, s, idx)

    p, ai, bi = rnd["parent"], rnd["a"], rnd["b"]
    rlo, rhi = g(lo_tab, p), g(hi_tab, p)
    rk0, rk1 = g(k0_tab, p), g(k1_tab, p)
    alo, ahi = g(lo_tab, ai), g(hi_tab, ai)
    ak0, ak1 = g(k0_tab, ai), g(k1_tab, ai)
    blo, bhi = g(lo_tab, bi), g(hi_tab, bi)
    bk0, bk1 = g(k0_tab, bi), g(k1_tab, bi)
    cur = tuple(g(t, rnd["tgt_c"]) for t in tabs)
    cur_lo, cur_hi, cur_k0, cur_k1 = cur

    pmask = u32(rnd["pmask"]).expand(rlo.shape)
    r0 = (role == 0)[None, :]
    r1 = (role == 1)[None, :]
    r2 = (role == 2)[None, :]
    # sibling of the refined arg (binary numeric rules)
    slo = _where(r0, blo, alo)
    shi = _where(r0, bhi, ahi)
    sk0 = _where(r0, bk0, ak0)
    sk1 = _where(r0, bk1, ak1)

    mtrue = rlo[..., 0] == 0   # parent bool cannot be false
    mfalse = rhi[..., 0] == 0  # parent bool cannot be true
    one = bv256.from_u32(torch.ones(rlo.shape[:-1], dtype=torch.int64,
                                    device=rlo.device))
    zero = torch.zeros_like(rlo)
    empty_lo, empty_hi = one, zero  # meet target -> empty interval

    results = {}  # code -> (lo, hi, k0, k1) candidate (vs cur default)

    if EQ in present:
        gate = mtrue
        results[EQ] = (
            _where(gate, slo, cur_lo), _where(gate, shi, cur_hi),
            _where(gate, sk0, cur_k0), _where(gate, sk1, cur_k1),
        )
    for code in (ULT, ULE):
        if code not in present:
            continue
        n_lo, n_hi = cur_lo, cur_hi
        if code == ULT:
            # a < b: a <= b.hi-1, b >= a.lo+1; !(a < b): a >= b.lo,
            # b <= a.hi
            bhi_m1 = bv256.sub(bhi, one)
            alo_p1 = bv256.add(alo, one)
            t0 = mtrue & ~bv256.is_zero(bhi)
            t1 = mtrue & ~bv256.is_zero(alo_p1)
            n_hi = _where(t0 & r0, bhi_m1, n_hi)
            n_lo = _where(mfalse & r0, blo, n_lo)
            n_lo = _where(t1 & r1, alo_p1, n_lo)
            n_hi = _where(mfalse & r1, ahi, n_hi)
        else:
            # a <= b: a <= b.hi, b >= a.lo; !(a <= b): a >= b.lo+1,
            # b <= a.hi-1
            blo_p1 = bv256.add(blo, one)
            ahi_m1 = bv256.sub(ahi, one)
            n_hi = _where(mtrue & r0, bhi, n_hi)
            n_lo = _where((mfalse & ~bv256.is_zero(blo_p1)) & r0,
                          blo_p1, n_lo)
            n_lo = _where(mtrue & r1, alo, n_lo)
            n_hi = _where((mfalse & ~bv256.is_zero(ahi)) & r1,
                          ahi_m1, n_hi)
        results[code] = (n_lo, n_hi, cur_k0, cur_k1)
    if ADD in present:
        s_hi = bv256.add(ahi, bhi)
        no_ovf = ~(bv256.ult(s_hi, ahi) | _ugt(s_hi, pmask))
        ok_lo = ~bv256.ult(rlo, shi)
        ok_hi = ~bv256.ult(rhi, slo)
        c_lo = _where(ok_lo, bv256.sub(rlo, shi), zero)
        c_hi = bv256.sub(rhi, slo)
        n_lo = _where(no_ovf, _where(ok_hi, c_lo, empty_lo), cur_lo)
        n_hi = _where(no_ovf, _where(ok_hi, c_hi, empty_hi), cur_hi)
        results[ADD] = (n_lo, n_hi, cur_k0, cur_k1)
    if SUB in present:
        # forward-exact gate: a >= b guaranteed (alo >= bhi)
        gate = ~bv256.ult(alo, bhi)
        # role 0 (a = r + b) under add no-wrap; role 1 (b = a - r)
        s2 = bv256.add(rhi, bhi)
        no_ovf = ~(bv256.ult(s2, rhi) | _ugt(s2, pmask))
        a_lo, a_hi = bv256.add(rlo, blo), s2
        ok_lo = ~bv256.ult(alo, rhi)
        ok_hi = ~bv256.ult(ahi, rlo)
        b_lo = _where(ok_lo, bv256.sub(alo, rhi), zero)
        b_hi = bv256.sub(ahi, rlo)
        b_lo = _where(ok_hi, b_lo, empty_lo)
        b_hi = _where(ok_hi, b_hi, empty_hi)
        n_lo = _where(gate & no_ovf & r0, a_lo,
                      _where(gate & r1, b_lo, cur_lo))
        n_hi = _where(gate & no_ovf & r0, a_hi,
                      _where(gate & r1, b_hi, cur_hi))
        results[SUB] = (n_lo, n_hi, cur_k0, cur_k1)
    if BAND in present:
        results[BAND] = (cur_lo, cur_hi, cur_k0 | (rk0 & sk1),
                         cur_k1 | (rk1 & pmask))
    if BOR in present:
        results[BOR] = (cur_lo, cur_hi, cur_k0 | (rk0 & pmask),
                        cur_k1 | (rk1 & sk0))
    if BXOR in present:
        results[BXOR] = (
            cur_lo, cur_hi,
            cur_k0 | (((rk0 & sk0) | (rk1 & sk1)) & pmask),
            cur_k1 | (((rk1 & sk0) | (rk0 & sk1)) & pmask),
        )
    if BNOT in present:
        results[BNOT] = (cur_lo, cur_hi, cur_k0 | (rk1 & pmask),
                         cur_k1 | (rk0 & pmask))
    if SHL in present:
        b_const = bv256.eq(blo, bhi)
        surviving = bv256.shr(pmask, blo)
        results[SHL] = (
            cur_lo, cur_hi,
            _where(b_const, cur_k0 | (bv256.shr(rk0, blo) & surviving),
                   cur_k0),
            _where(b_const, cur_k1 | (bv256.shr(rk1, blo) & surviving),
                   cur_k1),
        )
    if LSHR in present:
        b_const = bv256.eq(blo, bhi)
        results[LSHR] = (
            cur_lo, cur_hi,
            _where(b_const, cur_k0 | (bv256.shl(rk0, blo) & pmask), cur_k0),
            _where(b_const, cur_k1 | (bv256.shl(rk1, blo) & pmask), cur_k1),
        )
    if COPY in present:
        results[COPY] = (_max_n(cur_lo, rlo), _min_n(cur_hi, rhi),
                         cur_k0 | rk0, cur_k1 | rk1)
    if EXTRACT in present:
        field = u32(rnd["paux"]).expand(rlo.shape)
        lo_b = bv256.from_u32(rnd["lob"]).expand(rlo.shape)
        results[EXTRACT] = (
            cur_lo, cur_hi,
            cur_k0 | bv256.shl(rk0 & field, lo_b),
            cur_k1 | bv256.shl(rk1 & field, lo_b),
        )
    if CONCAT2 in present:
        bw = bv256.from_u32(rnd["paux"][:, 0]).expand(rlo.shape)
        hi_surv = bv256.shr(pmask, bw)
        low = _not(bv256.shl(torch.full_like(bw, M32), bw))
        results[CONCAT2] = (
            cur_lo, cur_hi,
            cur_k0 | _where(r0, bv256.shr(rk0, bw) & hi_surv, rk0 & low),
            cur_k1 | _where(r0, bv256.shr(rk1, bw) & hi_surv, rk1 & low),
        )
    if ITE in present:
        # args = (cond, then, else): cond's bool abs gathered via a;
        # a known branch equals the parent
        c_t = alo[..., 0] == 0  # cond must-true
        c_f = ahi[..., 0] == 0  # cond must-false
        gate = (c_t & r1) | (c_f & r2)
        results[ITE] = (
            _where(gate, rlo, cur_lo), _where(gate, rhi, cur_hi),
            _where(gate, rk0, cur_k0), _where(gate, rk1, cur_k1),
        )
    # bool unit propagation: the sibling's abs gathered like the
    # numeric rules (limb 0 carries (mf, mt))
    s_mt = slo[..., 0] == 0  # sibling must-true
    s_mf = shi[..., 0] == 0  # sibling must-false

    def limb0(x, clear):
        x = x.clone()
        x[..., 0] = torch.where(clear, 0, x[..., 0])
        return x

    if BAND2 in present:
        results[BAND2] = (limb0(cur_lo, mtrue), limb0(cur_hi, mfalse & s_mt),
                          cur_k0, cur_k1)
    if BOR2 in present:
        results[BOR2] = (limb0(cur_lo, mtrue & s_mf), limb0(cur_hi, mfalse),
                         cur_k0, cur_k1)
    if BNOT1 in present:
        results[BNOT1] = (limb0(cur_lo, mfalse), limb0(cur_hi, mtrue),
                          cur_k0, cur_k1)

    n_lo, n_hi, n_k0, n_k1 = cur
    for code, (xlo, xhi, xk0, xk1) in results.items():
        m = (op == code)[None, :, None]
        n_lo = torch.where(m, xlo, n_lo)
        n_hi = torch.where(m, xhi, n_hi)
        n_k0 = torch.where(m, xk0, n_k0)
        n_k1 = torch.where(m, xk1, n_k1)
    return _meet(cur, (n_lo, n_hi, n_k0, n_k1),
                 rnd["tbool"][None, :] != 0, rnd["tnum"][None, :] != 0)


def back_round_plain(rnd, tabs, changed=None) -> None:
    """One backward round in place (the JAX ``_back_round``): every
    candidate is computed from the pre-round tables, then written to
    its target by JAX's ``mode="drop"`` rule (``scatter_index``: a
    negative target wraps once; pads, past the table, are dropped; of
    two naming one row the later)."""
    n_rows = tabs[0].shape[1]
    rows, ok = scatter_index(rnd["tgt"], n_rows)
    sel = torch.nonzero(ok).reshape(-1)
    rows = rows[sel]
    keep = last_of_each_row(rows, n_rows)
    sel, rows = sel[keep], rows[keep]
    for s in state_chunks(tabs[0].shape[0], rnd["op"].shape[0]):
        out = _back_rows(rnd, tabs, s)
        for t, x in zip(tabs, out):
            _store(t, (s, rows), i32(x[:, sel]), changed)


def conflict_rows(core, tabs, s):
    """(states, rows) bool for the states ``s`` (a slice): the rows in
    conflict (a bit forced both ways or an empty interval on a numeric
    row, a bool pinned neither true nor false)."""
    numeric, isbool = core["numeric"] != 0, core["isbool"] != 0
    lo, hi, k0, k1 = (u32(t[s]) for t in tabs)
    bitconf = ~bv256.is_zero(k0 & k1)
    emptyiv = bv256.ult(hi, lo)
    boolempty = (lo[..., 0] == 0) & (hi[..., 0] == 0)
    return (numeric[None, :] & (bitconf | emptyiv)) \
        | (isbool[None, :] & boolempty)


def verdicts_plain(core, tabs):
    """(ok, contra) per state: a state dies on a bit forced both ways,
    an empty numeric interval, a bool pinned neither-true-nor-false, or
    a must-false assertion."""
    contra = torch.cat([
        torch.any(conflict_rows(core, tabs, s), dim=1)
        for s in state_chunks(tabs[0].shape[0], tabs[0].shape[1])])
    rows = torch.arange(tabs[1].shape[0], device=tabs[1].device)[:, None]
    aidx = gather_index(core["assert_idx"], tabs[1].shape[1])
    may_true = tabs[1][rows, aidx, 0] != 0
    ok = torch.all(may_true | (core["assert_mask"] == 0), dim=1) & ~contra
    return ok, contra


def changed_plain(prev, tabs) -> bool:
    """Whether any table differs from its copy ``prev`` (the JAX
    ``_changed``)."""
    return any(bool(torch.any(x != y)) for x, y in zip(prev, tabs))


# ---------------------------------------------------------------------------
# the kernel layout of K6 and K7
# ---------------------------------------------------------------------------

#: K7's staging words of an entry with a numeric target, by rule: lo and
#: hi (interval rules), k0 and k1 (known-bits rules) or all four; a bool
#: target, and the bool rules, stage limb 0 of lo and hi (2 words)
_NUM_SLOT = {ULT: 16, ULE: 16, ADD: 16, SUB: 16, BAND: 16, BOR: 16,
             BXOR: 16, BNOT: 16, SHL: 16, LSHR: 16, EXTRACT: 16,
             CONCAT2: 16, EQ: 32, COPY: 32, ITE: 32}
_BOOL_RULES = (BAND2, BOR2, BNOT1)
#: K7's block (and K6's on a staged level): at most this many threads,
#: a warp at least
BACK_THREADS = 256


def staged_threads(n: int) -> int:
    """The block of a staged launch of ``n`` entries (K7's rounds, K6's
    hazardous levels): enough warps for an entry a thread, at most
    ``BACK_THREADS``."""
    return min(BACK_THREADS, max(32, -(-n // 32) * 32))


def fwd_stage_words(n: int) -> int:
    """K6's staging a block for a staged level of ``n`` nodes
    (``fwd_block``): a slot of 32 words a node (the candidate's lo, hi
    and known bits), each 16-byte aligned."""
    return 32 * n


def _lookup(table, ops):
    lut = torch.zeros(32, dtype=torch.long, device=ops.device)
    for op, v in table.items():
        lut[op] = v
    return lut[ops.long()]


def _take(d: dict, order) -> dict:
    return {k: (v[order] if torch.is_tensor(v) else v) for k, v in d.items()}


def level_layout(level: dict, n_rows: int, classes=None) -> dict:
    """A level's real nodes (not NOP, a node JAX's ``mode="drop"``
    scatter keeps, ``scatter_index``: the rows the JAX ``_fwd_level``
    writes; of two naming one row the later), ordered by (class, op),
    ``classes[op]`` the class of each opcode (K6's, ``fwd_classes``;
    None: one class, 0): the level's own keys in that order, which the
    plain version takes as it takes the level, and K6's ``ent`` ((n, 8)
    int32: the node's row, op, the three argument rows by JAX's gather
    rule, ``gather_index``, the raw second and third arguments, the row
    flags) and ``counts`` (nodes a class). A level's nodes are distinct
    and each writes only its own row, so their order does not change
    the result. ``hazard``: whether a node reads a row the level writes
    (``intervals.reads_own_rows``, K5's rule: only a wrapped index makes
    one); K6 then runs the level as one staged launch of ``threads``
    threads a block and ``stage_words`` words of staging a block
    (``fwd_stage_words``; 0 without the hazard)."""
    op, node = level["op"], level["node"]
    node_rows, ok = scatter_index(node, n_rows)
    real = torch.nonzero((op != NOP) & ok).reshape(-1)
    real = real[last_of_each_row(node_rows[real], n_rows)]
    cls = _lookup(dict(enumerate(classes or ())), op[real])
    order = real[torch.sort(cls * 32 + op[real].long(), stable=True).indices]
    out = _take(level, order)
    args = out["args"].long()
    rows = gather_index(args, n_rows)
    flags = (out["lvl_bool"] != 0).long() | ((out["lvl_num"] != 0).long() << 1)
    out["ent"] = torch.stack(
        [node_rows[order], out["op"].long(), rows[:, 0], rows[:, 1],
         rows[:, 2], args[:, 1], args[:, 2], flags], 1).to(torch.int32)
    out["counts"] = torch.bincount(cls, minlength=3).tolist()
    out["n_rows"] = n_rows
    n = order.numel()
    out["hazard"] = reads_own_rows(out["op"].cpu().numpy(),
                                   rows.cpu().numpy(),
                                   node_rows[order].cpu().numpy(), n_rows)
    out["threads"] = staged_threads(n)
    out["stage_words"] = fwd_stage_words(n) if out["hazard"] else 0
    return out


def round_layout(rnd: dict, n_rows: int) -> dict:
    """A round's real entries (target inside the table: the JAX
    ``mode="drop"`` drops the rest), ordered by (op, role, bool target):
    the round's own keys in that order, which the plain version takes,
    and K7's ``ent`` ((n, 8) int32: parent, a, b, tgt, tgt_c, code =
    op | role << 8 | (tbool | tnum << 1) << 16, the staging slot's word
    offset, lob) and ``stage_words`` (the flags, one word an entry,
    rounded to four; then the numeric slots, 16-byte aligned; then the
    2-word slots; the whole rounded to four, so that a block's part of
    a global buffer starts 16-byte aligned). A round's targets are
    distinct, and every entry reads the pre-round rows, so the order
    does not change the result. Targets follow JAX's ``mode="drop"``
    rule (``scatter_index``; of two naming one row the later), the
    other rows its gather rule (``gather_index``)."""
    tgt_rows, ok = scatter_index(rnd["tgt"], n_rows)
    real = torch.nonzero(ok).reshape(-1)
    real = real[last_of_each_row(tgt_rows[real], n_rows)]
    key = (rnd["op"][real].long() * 4 + rnd["role"][real].long()) * 2 \
        + (rnd["tbool"][real] != 0).long()
    order = real[torch.sort(key, stable=True).indices]
    out = _take(rnd, order)
    n = order.numel()
    op = out["op"].long()
    tb, tn = out["tbool"] != 0, out["tnum"] != 0
    l0 = tb | (tn & torch.isin(op, torch.tensor(_BOOL_RULES,
                                                  device=op.device)))
    num = torch.where(tn & ~l0, _lookup(_NUM_SLOT, op), 0)
    l0w = torch.where(l0, 2, 0)
    flags_w = -(-n // 4) * 4
    num_end = flags_w + int(num.sum())
    soff = torch.where(l0, num_end + torch.cumsum(l0w, 0) - l0w,
                       flags_w + torch.cumsum(num, 0) - num)
    code = op | (out["role"].long() << 8) \
        | ((tb.long() | (tn.long() << 1)) << 16)
    rows = [gather_index(out[k], n_rows)
            for k in ("parent", "a", "b", "tgt_c")]
    out["ent"] = torch.stack(
        rows[:3] + [tgt_rows[order], rows[3], code, soff,
                    out["lob"].long()], 1).to(torch.int32)
    out["stage_words"] = -(-(num_end + int(l0w.sum())) // 4) * 4
    out["n_rows"] = n_rows
    return out


def kernel_layout(core: dict) -> dict:
    """K6's and K7's layout of the plan: ``levels`` and ``back`` as in
    ``core``, each level and round holding its real entries only
    (``level_layout``, ``round_layout``). Built at the first call on
    ``core`` and kept there; on a CUDA plan the levels are ordered by
    K6's op classes, each level and round also gets its launch
    arguments, checked once (``launch``), and the rounds whose staging
    outgrows a block's shared memory share one global buffer
    (``stage``)."""
    if "layout" not in core:
        n_rows = core["init_lo"].shape[0]
        cuda = core["init_lo"].is_cuda
        classes = fwd_classes() if cuda else None
        lay = dict(levels=[level_layout(lv, n_rows, classes)
                           for lv in core["levels"]],
                   back=[[round_layout(r, n_rows) for r in rs]
                         for rs in core["back"]])
        if cuda:
            _bind(lay, core["seed_idx"].shape[0])
        core["layout"] = lay
    return core["layout"]


def _bind(lay: dict, n_states: int) -> None:
    """Each level's and round's launch arguments: checked pointers, the
    class counts; for a round and a staged level its block, ``grid``
    (the blocks resident at once, an occupancy query), its blocks (the
    grid, and no more than the plan's ``n_states`` where it stages in
    global memory) and where it stages: the rounds and levels whose
    staging outgrows a block's shared memory share one global buffer
    (``stage``), launched one after another on one stream."""
    import ctypes

    _build, lib = screen_lib()
    rounds = [r for rs in lay["back"] for r in rs]
    staged = [lv for lv in lay["levels"] if lv["hazard"]]
    for lv in lay["levels"]:
        _build.need_cuda(lv["ent"], torch.int32, "level ent")
        for key in ("mask", "aux"):
            _build.need_cuda(lv[key], torch.int32, f"level[{key!r}]")
    for rnd in rounds:
        for key in ("ent", "pmask", "paux"):
            _build.need_cuda(rnd[key], torch.int32, f"round[{key!r}]")
    shapes = []
    for x in rounds + staged:
        threads = staged_threads(x["ent"].shape[0])
        out = (ctypes.c_int * 2)()
        shape = lib.prop_fwd_shape if "hazard" in x else lib.prop_back_shape
        _build.check(lib, shape(threads, x["stage_words"], out),
                     "prop_fwd_shape" if "hazard" in x else "prop_back_shape")
        x["grid"], smem = out[0], bool(out[1])
        shapes.append((threads, out[0] if smem else min(out[0], n_states),
                       smem))
    glob = [x["stage_words"] * blocks for x, (_, blocks, smem)
            in zip(rounds + staged, shapes) if not smem]
    stage = None
    if glob:
        lay["stage"] = torch.empty(max(max(glob), 1), dtype=torch.int32,
                                   device=(rounds + staged)[0]["ent"].device)
        stage = _build.ptr(lay["stage"])
    for rnd, (threads, blocks, smem) in zip(rounds, shapes):
        rnd["launch"] = (_build.ptr(rnd["ent"]), _build.ptr(rnd["pmask"]),
                         _build.ptr(rnd["paux"]), rnd["ent"].shape[0],
                         rnd["stage_words"], threads, blocks,
                         None if smem else stage)
    shaped = {id(lv): sh for lv, sh in zip(staged, shapes[len(rounds):])}
    for lv in lay["levels"]:
        threads, blocks, smem = shaped.get(id(lv), (0, 0, True))
        lv["launch"] = (_build.ptr(lv["ent"]), _build.ptr(lv["mask"]),
                        _build.ptr(lv["aux"]), lv["counts"],
                        lv["stage_words"], threads, blocks,
                        None if smem else stage)


# ---------------------------------------------------------------------------
# kernels K6-K8 (csrc/screen.cu)
# ---------------------------------------------------------------------------

_TAB_NAMES = ("lo", "hi", "k0", "k1")


def _flag_ptr(_build, changed):
    if changed is None:
        return None
    _build.need_cuda(changed, torch.int32, "changed")
    return _build.ptr(changed)


def fwd_level_kernel(level, tabs, changed=None) -> None:
    """K6: one forward level, ``level`` a level of ``kernel_layout``:
    a launch per op class present (``fwd_classes``), a thread per (state,
    real node), the node fastest, so a warp runs neighbouring nodes of
    one op; each op loads only what its transfer and the meet read. A
    level that reads a row it writes (``hazard``) is one staged launch,
    a block a state: every node's met rows into the block's staging
    (shared memory, or the plan's global buffer past a block's), one
    barrier, then the stores. Sets ``changed[0]`` when it stores a word
    that differs."""
    from .. import _build

    check_tables(tabs, _TAB_NAMES)
    s, t = tabs[0].shape[:2]
    ent, mask, aux, counts, words, threads, blocks, stage = _bound(
        level, t, "K6")
    flag = _flag_ptr(_build, changed)
    _build, lib = screen_lib()
    rc = lib.prop_fwd_level(*[_build.ptr(x) for x in tabs], s, t, ent, mask,
                            aux, *counts, words, threads, min(s, blocks),
                            stage, flag, _build.stream(tabs[0].device))
    if s:
        _build.LAUNCHES["prop_fwd_level"] += (
            int(sum(counts) > 0) if words else sum(1 for c in counts if c))
    _build.check(lib, rc, "prop_fwd_level")


def back_round_kernel(rnd, tabs, changed=None) -> None:
    """K7: one backward round, ``rnd`` a round of ``kernel_layout``. A
    block takes a state at a time: each thread computes its entries'
    candidates from the pre-round rows (each rule loading only what it
    and the meet read) and stages the rows that differ in the round's
    staging (shared memory, or the plan's global buffer where a round's
    staging outgrows a block's), then, after one barrier, stores them;
    so a target that another entry reads as parent, sibling or
    condition is read before it is written, as in the JAX
    gather-then-scatter. Sets ``changed[0]`` when it stores a word that
    differs."""
    from .. import _build

    check_tables(tabs, _TAB_NAMES)
    s, t = tabs[0].shape[:2]
    ent, pmask, paux, n, words, threads, blocks, stage = _bound(rnd, t, "K7")
    flag = _flag_ptr(_build, changed)
    _build, lib = screen_lib()
    rc = lib.prop_back_round(*[_build.ptr(x) for x in tabs], s, t, ent, pmask,
                             paux, n, words, threads, min(s, blocks), stage,
                             flag, _build.stream(tabs[0].device))
    if s and n:
        _build.LAUNCHES["prop_back_round"] += 1
    _build.check(lib, rc, "prop_back_round")


def _bound(entry, n_rows, what):
    """The launch arguments ``kernel_layout`` bound to a level or round
    of a CUDA plan."""
    if "launch" not in entry:
        raise ValueError(f"{what} takes a level or round of "
                         f"kernel_layout(core) on a CUDA plan")
    if n_rows != entry["n_rows"]:
        raise ValueError(f"{what}: tables of {n_rows} rows for a plan of "
                         f"{entry['n_rows']}")
    return entry["launch"]


def _check_core(_build, core, keys):
    for key in keys:
        want = torch.uint8 if key in ("numeric", "isbool", "assert_mask") \
            else torch.int32
        _build.need_cuda(core[key], want, key)


def init_tables_kernel(core):
    """K8 ``prop_init``: the four tables, a block per state."""
    from .. import _build

    keys = ("init_lo", "init_hi", "init_k0", "init_k1", "seed_idx",
            "seed_lo", "seed_hi", "assert_idx", "assert_mask")
    _check_core(_build, core, keys)
    n_states, n_v = core["seed_idx"].shape
    n_rows = core["init_lo"].shape[0]
    tabs = tuple(torch.empty((n_states, n_rows, bv256.NLIMBS),
                             dtype=torch.int32, device=core["init_lo"].device)
                 for _ in range(4))
    _build, lib = screen_lib()
    rc = lib.prop_init(
        *[_build.ptr(x) for x in tabs], n_states, n_rows,
        *[_build.ptr(core[k]) for k in keys[:7]], n_v,
        _build.ptr(core["assert_idx"]), _build.ptr(core["assert_mask"]),
        core["assert_idx"].shape[1], _build.stream(tabs[0].device))
    _build.LAUNCHES["prop_tables"] += 1
    _build.check(lib, rc, "prop_init")
    return tabs


def exchange_kernel(tabs, numeric, changed=None) -> None:
    """K8 ``prop_exchange``: one thread per (state, row)."""
    from .. import _build

    check_tables(tabs, _TAB_NAMES)
    _build.need_cuda(numeric, torch.uint8, "numeric")
    s, t = tabs[0].shape[:2]
    flag = _flag_ptr(_build, changed)
    _build, lib = screen_lib()
    rc = lib.prop_exchange(*[_build.ptr(x) for x in tabs], s, t,
                           _build.ptr(numeric), flag,
                           _build.stream(tabs[0].device))
    _build.LAUNCHES["prop_tables"] += 1
    _build.check(lib, rc, "prop_exchange")


def verdicts_kernel(core, tabs):
    """K8 ``prop_verdicts``: a block per state reduces its rows."""
    from .. import _build

    check_tables(tabs, _TAB_NAMES)
    _check_core(_build, core, ("numeric", "isbool", "assert_idx",
                               "assert_mask"))
    s, t = tabs[0].shape[:2]
    _build, lib = screen_lib()
    ok = torch.empty(s, dtype=torch.uint8, device=tabs[0].device)
    contra = torch.empty_like(ok)
    rc = lib.prop_verdicts(
        *[_build.ptr(x) for x in tabs], s, t, _build.ptr(core["numeric"]),
        _build.ptr(core["isbool"]), _build.ptr(core["assert_idx"]),
        _build.ptr(core["assert_mask"]), core["assert_idx"].shape[1],
        _build.ptr(ok), _build.ptr(contra), _build.stream(tabs[0].device))
    _build.LAUNCHES["prop_tables"] += 1
    _build.check(lib, rc, "prop_verdicts")
    return ok != 0, contra != 0


def _plain(plain, x) -> bool:
    return plain or x.device.type == "cpu"


def init_tables(core, plain=False):
    if _plain(plain, core["init_lo"]):
        return init_tables_plain(core)
    return init_tables_kernel(core)


def fwd_level(level, tabs, changed=None, plain=False) -> None:
    if _plain(plain, tabs[0]):
        fwd_level_plain(level, tabs, changed)
    else:
        fwd_level_kernel(level, tabs, changed)


def back_round(rnd, tabs, changed=None, plain=False) -> None:
    if _plain(plain, tabs[0]):
        back_round_plain(rnd, tabs, changed)
    else:
        back_round_kernel(rnd, tabs, changed)


def exchange(tabs, numeric, changed=None, plain=False) -> None:
    if _plain(plain, tabs[0]):
        exchange_plain(tabs, numeric, changed)
    else:
        exchange_kernel(tabs, numeric, changed)


def verdicts(core, tabs, plain=False):
    if _plain(plain, tabs[0]):
        return verdicts_plain(core, tabs)
    return verdicts_kernel(core, tabs)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def sweep(core, tabs, changed=None, plain=False) -> None:
    """One sweep in place: forward levels, exchange, backward rounds in
    reverse level order, exchange. The kernels take the plan's kernel
    layout, the plain versions the plan as the JAX package builds it."""
    lay = core if _plain(plain, tabs[0]) else kernel_layout(core)
    for level in lay["levels"]:
        trace.call_jit("propagate.fwd_level", fwd_level, level, tabs,
                       changed, plain)
    exchange(tabs, core["numeric"], changed, plain)
    for rounds in reversed(lay["back"]):
        for rnd in rounds:
            trace.call_jit("propagate.back_round", back_round, rnd, tabs,
                           changed, plain)
    exchange(tabs, core["numeric"], changed, plain)


def _run_host(core, cap: int, plain: bool = False):
    """Host-sequenced sweeps (the JAX ``_run_host``), one changed-flag
    readback per sweep for the fixpoint early exit: every pass sets the
    flag when it stores a different word, which stands for the JAX
    comparison of a sweep's start and end tables because refinement is
    monotone (a changed word never returns). Returns (tables, ok,
    contra, sweeps)."""
    tabs = init_tables(core, plain)
    flag = torch.zeros(1, dtype=torch.int32, device=tabs[0].device)
    sweeps = 0
    for _ in range(cap):
        flag.zero_()
        sweep(core, tabs, flag, plain)
        sweeps += 1
        if not bool(flag.item()):
            break
    ok, contra = verdicts(core, tabs, plain)
    return tabs, ok, contra, sweeps


def _fixpoint_plain(core, cap: int):
    """The fused driver's plain version: init, then sweeps of the plain
    passes in the order of ``sweep``, each on the systems that changed
    in the sweep before (all of them first), a system dropping out at
    its first sweep that leaves its tables equal; then the verdicts.
    Returns (tables, ok, contra, sweeps, each system's sweeps), sweeps
    the most any system ran."""
    tabs = init_tables_plain(core)
    active = torch.arange(tabs[0].shape[0], device=tabs[0].device)
    per = torch.zeros(active.numel(), dtype=torch.int32, device=active.device)
    sweeps = 0
    for _ in range(cap):
        if active.numel() == 0:
            break
        sub = tuple(t[active] for t in tabs)
        prev = tuple(t.clone() for t in sub)
        sweep(core, sub, plain=True)
        sweeps += 1
        per[active] += 1
        for t, x in zip(tabs, sub):
            t[active] = x
        moved = torch.zeros(active.numel(), dtype=torch.bool,
                            device=active.device)
        for x, y in zip(prev, sub):
            moved |= (x != y).flatten(1).any(dim=1)
        active = active[moved]
    ok, contra = verdicts_plain(core, tabs)
    return tabs, ok, contra, sweeps, per


def _offsets(xs, device):
    off = [0]
    for x in xs:
        off.append(off[-1] + x["ent"].shape[0])
    return torch.tensor(off, dtype=torch.int32, device=device)


def _fused_plan(core) -> dict:
    """What K11 reads of the plan: the kernel layout's levels and rounds
    (in run order: levels from the last, each level's rounds in order),
    their ``ent``, ``mask``, ``aux`` (``pmask``, ``paux``) arrays
    concatenated, their offsets, each level's ``hazard`` flag (``lhaz``:
    K11 stages that level, as K6 does, in its own instance, ``haz``)
    and the largest staging of a round or a flagged level. Built at the
    first fused call on ``core`` and kept there."""
    if "fused" not in core:
        from .. import _build

        dev = core["init_lo"].device
        lay = kernel_layout(core)
        levels = lay["levels"]
        rounds = [r for rs in reversed(lay["back"]) for r in rs]
        lv = [torch.cat([x[k] for x in levels]) for k in ("ent", "mask",
                                                          "aux")]
        rd = [torch.cat([x[k] for x in rounds]) for k in ("ent", "pmask",
                                                          "paux")]
        core["fused"] = dict(
            lv=lv, rd=rd, lv_ptrs=_build.ptr_array(lv),
            rd_ptrs=_build.ptr_array(rd), loff=_offsets(levels, dev),
            roff=_offsets(rounds, dev), n_levels=len(levels),
            n_rounds=len(rounds),
            lhaz=torch.tensor([int(x["hazard"]) for x in levels] or [0],
                              dtype=torch.int32, device=dev),
            haz=any(x["hazard"] for x in levels),
            stage_w=max([x["stage_words"] for x in rounds + levels] + [4]))
    return core["fused"]


#: K11's resident blocks by (device, the staging instance) (an occupancy
#: query)
_FIXPOINT_BLOCKS = {}


def fixpoint_kernel(core, cap: int):
    """K11 ``prop_fixpoint``: the whole fixpoint in one launch, a block
    per system at a time (see ``csrc/screen.cu``). Returns (tables, ok,
    contra, sweeps, each system's sweeps), as ``_fixpoint_plain``."""
    from .. import _build

    keys = ("init_lo", "init_hi", "init_k0", "init_k1", "seed_idx",
            "seed_lo", "seed_hi", "assert_idx", "assert_mask")
    _check_core(_build, core, keys + ("numeric", "isbool"))
    dev = core["init_lo"].device
    n_states, n_v = core["seed_idx"].shape
    n_rows = core["init_lo"].shape[0]
    fp = _fused_plan(core)
    tabs = tuple(torch.empty((n_states, n_rows, bv256.NLIMBS),
                             dtype=torch.int32, device=dev)
                 for _ in range(4))
    _build, lib = screen_lib()
    key = (str(dev), fp["haz"])
    if key not in _FIXPOINT_BLOCKS:
        _FIXPOINT_BLOCKS[key] = lib.prop_fixpoint_blocks(int(fp["haz"]))
    blocks = min(n_states, _FIXPOINT_BLOCKS[key])
    stage_w = fp["stage_w"]
    stage = torch.empty((max(blocks, 1), stage_w), dtype=torch.int32,
                        device=dev)
    ok = torch.empty(n_states, dtype=torch.uint8, device=dev)
    contra = torch.empty_like(ok)
    per = torch.zeros(n_states, dtype=torch.int32, device=dev)
    rc = lib.prop_fixpoint(
        _build.ptr_array(tabs), n_states, n_rows, fp["lv_ptrs"],
        _build.ptr(fp["loff"]), _build.ptr(fp["lhaz"]), int(fp["haz"]),
        fp["n_levels"], fp["rd_ptrs"],
        _build.ptr(fp["roff"]), fp["n_rounds"],
        _build.ptr_array([core[k] for k in keys]), n_v,
        core["assert_idx"].shape[1], _build.ptr(core["numeric"]),
        _build.ptr(core["isbool"]), int(cap), _build.ptr(stage), stage_w,
        blocks, _build.ptr(ok), _build.ptr(contra), _build.ptr(per),
        _build.stream(dev))
    _build.LAUNCHES["prop_fixpoint"] += 1
    _build.check(lib, rc, "prop_fixpoint")
    sweeps = int(per.max()) if n_states else 0
    return tabs, ok != 0, contra != 0, sweeps, per


def _fixpoint(core, cap: int, plain: bool = False):
    """The fused driver: K11 on CUDA tables, ``_fixpoint_plain`` on CPU
    tables or with ``plain``. Returns (tables, ok, contra, sweeps)."""
    if _plain(plain, core["init_lo"]):
        return _fixpoint_plain(core, cap)[:4]
    return fixpoint_kernel(core, cap)[:4]


def run(enc: EncodedDAG, device=None, plain: bool = False):
    """(keep, tables, sweeps) for an encoded wave, or None when the plan
    falls outside the fixpoint's envelope (caller uses the forward
    interval screen on the SAME encoding). ``FUSE`` picks the fused
    driver."""
    plan = build_plan(enc)
    if plan is None:
        return None
    core = plan_to_device(plan, resolve(device))
    driver = _fixpoint if FUSE else _run_host
    with trace.span("propagate.fixpoint", states=enc.n_real,
                    fused=FUSE) as sp:
        tabs, ok, _contra, sweeps = driver(core, plan.statics[0], plain)
        sp.set(sweeps=sweeps)
    keep = ok.cpu().numpy()[:enc.n_real] & ~np.asarray(enc.dead[:enc.n_real])
    return keep, tabs, sweeps


# ---------------------------------------------------------------------------
# harvest: learned facts for surviving lanes (a copy)
# ---------------------------------------------------------------------------

#: free BV variables per constraint term, memoized process-wide by tid
#: (terms are interned, so the support set is immutable)
_SUPPORT_CACHE: Dict[int, frozenset] = {}


def _free_bv_vars(t: "T.Term") -> frozenset:
    got = _SUPPORT_CACHE.get(t.tid)
    if got is None:
        out, seen, stack = set(), set(), [t]
        while stack:
            cur = stack.pop()
            if cur.tid in seen:
                continue
            seen.add(cur.tid)
            if cur.op == T.BV_VAR:
                out.add(cur.tid)
            stack.extend(cur.args)
        if len(_SUPPORT_CACHE) > 1 << 20:
            _SUPPORT_CACHE.clear()
        got = _SUPPORT_CACHE[t.tid] = frozenset(out)
    return got


def _limbs_to_ints(arr: np.ndarray) -> np.ndarray:
    """(..., 8) uint32 -> object-dtype python ints, vectorized."""
    arr = np.asarray(arr).view(np.uint32)
    out = arr[..., 0].astype(object)
    for i in range(1, bv256.NLIMBS):
        out = out | (arr[..., i].astype(object) << (32 * i))
    return out


def _var_rows(enc: EncodedDAG):
    return [i for i, t in enumerate(enc.host["terms"])
            if t.op == T.BV_VAR and isinstance(t.width, int)
            and 1 <= t.width <= 256]


def _var_values(tabs, var_rows):
    """(lo, hi, k0, k1) of the variable rows as python ints: four
    (S, V) object arrays."""
    vi = torch.as_tensor(var_rows, dtype=torch.long, device=tabs[0].device)
    return tuple(_limbs_to_ints(t[:, vi].cpu().numpy()) for t in tabs)


def harvest(enc: EncodedDAG, lo, hi, k0, k1, keep: np.ndarray):
    """Per-state learned facts for surviving lanes, as
    ``{state index: (fact terms, {var_tid: (var, lo, hi)})}``.

    A fact is an implied consequence of the state's asserted set:
    a variable pinned to a constant (``v == c``), a bound strictly
    tighter than the syntactic seed (``c <= v`` / ``v <= c``), or a
    forced bit mask beyond what the interval already implies
    (``v & known == ones``). Sound to assert ahead of the real
    constraints in any query over the same set."""
    order = enc.host["terms"]
    var_rows = _var_rows(enc)
    if not var_rows:
        return {}
    vlo, vhi, vk0, vk1 = _var_values((lo, hi, k0, k1), var_rows)

    # the syntactic seed bounds, to emit only STRICTLY tighter facts
    seed_idx = np.asarray(enc.seed_idx)
    seed_lo = _limbs_to_ints(np.asarray(enc.seed_lo))
    seed_hi = _limbs_to_ints(np.asarray(enc.seed_hi))
    row_of = {r: j for j, r in enumerate(var_rows)}

    out = {}
    for s in range(enc.n_real):
        if not keep[s]:
            continue
        support = set()
        for t in _state_terms(enc, s):
            support |= _free_bv_vars(t)
        if not support:
            continue
        seeds = {}
        for v in range(seed_idx.shape[1]):
            j = row_of.get(int(seed_idx[s, v]))
            if j is not None:
                seeds[j] = (int(seed_lo[s, v]), int(seed_hi[s, v]))
        facts: List["T.Term"] = []
        bounds: Dict[int, tuple] = {}
        for j, r in enumerate(var_rows):
            t = order[r]
            if t.tid not in support:
                continue
            w = t.width
            m = (1 << w) - 1
            lo_i, hi_i = int(vlo[s, j]), int(vhi[s, j])
            k0_i, k1_i = int(vk0[s, j]), int(vk1[s, j])
            if lo_i > hi_i or (k0_i & k1_i):
                continue  # contradictory lane rows never become facts
            slo, shi = seeds.get(j, (0, m))
            if lo_i > slo or hi_i < shi:
                bounds[t.tid] = (t, lo_i, hi_i)
            if len(facts) >= FACT_CAP:
                continue
            if lo_i == hi_i:
                facts.append(T.mk_eq(t, T.bv_const(lo_i & m, w)))
                continue
            if lo_i > slo:
                facts.append(T.mk_ule(T.bv_const(lo_i & m, w), t))
            if hi_i < shi and len(facts) < FACT_CAP:
                facts.append(T.mk_ule(t, T.bv_const(hi_i & m, w)))
            known = (k0_i | k1_i) & m
            # skip bit masks the interval already implies (the shared
            # leading bits of [lo, hi])
            span = lo_i ^ hi_i
            lead = ~((1 << span.bit_length()) - 1) & m
            if known & ~lead and len(facts) < FACT_CAP:
                facts.append(T.mk_eq(
                    T.mk_and(t, T.bv_const(known, w)),
                    T.bv_const(k1_i & m & known, w)))
        if facts or bounds:
            out[s] = (facts, bounds)
    return out


def _state_terms(enc: EncodedDAG, s: int):
    """The raw assertion terms of state s (host assert table rows)."""
    idx = np.asarray(enc.assert_idx)[s]
    mask = np.asarray(enc.assert_mask)[s]
    order = enc.host["terms"]
    return [order[int(i)] for i, live in zip(idx, mask) if live]


# ---------------------------------------------------------------------------
# host entry points
# ---------------------------------------------------------------------------

#: one screened wave: the keep mask, the fixpoint's sweeps (None when
#: the wave fell back to the forward interval screen) and the harvested
#: facts of the surviving sets
Screen = namedtuple("Screen", "keep sweeps facts")


def _inject_static_seeds(enc: EncodedDAG) -> None:
    """Meet the static storage-ITE candidate hulls
    (analysis/static_pass/deps.static_seed_rows) into the encoding's
    shared init tables BEFORE the fixpoint/interval screen runs: the
    hull is implied by the term structure (an ITE's value is always
    one of its leaves), so the tighter seed removes only states the
    term provably cannot reach — same soundness contract as the
    syntactic bound seeds. Counted as ``static_facts_seeded``."""
    from ..analysis.static_pass import deps as static_deps

    rows = static_deps.static_seed_rows(enc)
    if not rows:
        return
    from .intervals import _word

    init_lo = np.asarray(enc.init_lo).copy()
    init_hi = np.asarray(enc.init_hi).copy()
    for i, (lo, hi) in rows.items():
        if i >= init_lo.shape[0]:
            continue
        init_lo[i] = _word(lo)
        init_hi[i] = _word(hi)
    enc.init_lo = init_lo
    enc.init_hi = init_hi
    SolverStatistics().bump(static_facts_seeded=len(rows))


def screen(assertion_sets: Sequence[Sequence], device=None,
           plain: bool = False) -> Screen:
    """Linearize, meet the static seeds, run the fixpoint (or, outside
    its envelope, the forward interval screen on the same encoding)
    and harvest facts for the surviving sets."""
    sets = [[getattr(t, "raw", t) for t in s] for s in assertion_sets]
    enc = linearize(sets)
    _inject_static_seeds(enc)
    got = run(enc, device, plain)
    if got is None:
        return Screen(eval_feasible(enc, device, plain), None, {})
    keep, tabs, sweeps = got
    return Screen(keep, sweeps, harvest(enc, *tabs, keep))


def prefilter_feasible(assertion_sets: Sequence[Sequence],
                       device=None) -> np.ndarray:
    """Drop-in for ops/intervals.prefilter_feasible with the product
    domain, bidirectional sweeps, UNSAT recording and fact harvest.
    Sound: only provably-unsat states report False. Bumps
    ``propagate_kills``, ``propagate_sweeps`` and ``facts_harvested``,
    and banks the result in the run-wide verdict cache: killed sets are
    sound UNSAT proofs, surviving sets note their learned facts as
    solver hints and their propagated bounds for tier-3 inheritance."""
    got = screen(assertion_sets, device)
    if got.sweeps is None:
        return got.keep
    ss = SolverStatistics()
    ss.bump(propagate_kills=int(len(got.keep) - int(got.keep.sum())),
            propagate_sweeps=got.sweeps)
    n_facts = sum(len(facts) for facts, _ in got.facts.values())
    if n_facts:
        ss.bump(facts_harvested=n_facts)
    from ..smt.solver import verdicts as verdict_mod

    vc = verdict_mod.cache()
    if vc is not None:
        sets = [[getattr(t, "raw", t) for t in s] for s in assertion_sets]
        for s, ok_s in enumerate(got.keep):
            tids = tuple(t.tid for t in sets[s])
            if tids and not ok_s:
                vc.record(tids, verdict_mod.UNSAT)
        for s, (facts, bounds) in got.facts.items():
            tids = tuple(t.tid for t in sets[s])
            if not tids:
                continue
            if facts:
                vc.note_facts(tids, facts)
            if bounds:
                vc.absorb_bounds(tids, bounds)
    return got.keep


def abstraction_sets(assertion_sets: Sequence[Sequence], device=None
                     ) -> Optional[List[Optional[Dict[int, tuple]]]]:
    """Per-set variable abstractions from the product-domain fixpoint:
    ``{var_tid: (lo, hi, k0, k1)}`` for every free BV variable of each
    assertion set, with the interval<->known-bits exchange already
    applied. A set the fixpoint refutes maps to ``None`` (bottom).
    Returns ``None`` when the plan falls outside the kernel envelope."""
    sets = [[getattr(t, "raw", t) for t in s] for s in assertion_sets]
    enc = linearize(sets)
    got = run(enc, device)
    if got is None:
        return None
    keep, tabs, _sweeps = got
    order = enc.host["terms"]
    var_rows = _var_rows(enc)
    if not var_rows:
        return [None if not keep[s] else {}
                for s in range(enc.n_real)]
    vlo, vhi, vk0, vk1 = _var_values(tabs, var_rows)
    out: List[Optional[Dict[int, tuple]]] = []
    for s in range(enc.n_real):
        if not keep[s]:
            out.append(None)
            continue
        support = set()
        for t in _state_terms(enc, s):
            support |= _free_bv_vars(t)
        d: Dict[int, tuple] = {}
        for j, r in enumerate(var_rows):
            t = order[r]
            if t.tid not in support:
                continue
            lo_i, hi_i = int(vlo[s, j]), int(vhi[s, j])
            k0_i, k1_i = int(vk0[s, j]), int(vk1[s, j])
            if lo_i > hi_i or (k0_i & k1_i):
                d = None  # contradictory row missed by the verdict
                break
            d[t.tid] = (lo_i, hi_i, k0_i, k1_i)
        out.append(d)
    return out


def prescreen(term_sets: Sequence[Sequence], undecided: Sequence[int],
              device=None) -> Dict[int, bool]:
    """{query index: False} kills for a discharge/check_batch wave,
    under the device-screen gates (MTPU_PROPAGATE, lane config, batch
    threshold). A device call that raises is counted in the pruner's
    STATS and re-raised."""
    from ..models import pruner
    from ..support.devices import effective_tpu_lanes

    out: Dict[int, bool] = {}
    if not enabled():
        return out
    todo = [i for i in undecided if term_sets[i]]
    if (not todo or len(todo) < pruner.DEVICE_BATCH_THRESHOLD
            or not effective_tpu_lanes()):
        return out
    try:
        keep = prefilter_feasible([term_sets[i] for i in todo], device)
    except Exception:
        pruner._stat_add(device_failures=1)
        raise
    for i, k in zip(todo, keep):
        if not k:
            out[i] = False
    return out
