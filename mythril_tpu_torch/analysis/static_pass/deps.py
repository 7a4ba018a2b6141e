"""Interprocedural storage read/write dependence and its two
consumers: transaction-sequence pruning and static fact seeding.

Per recovered function entry (selectors.py), the forward-reachable
aggregate over the PR-7 block summaries yields the function's storage
read set, write set, write-VALUE set, and effect flags — each either a
complete frozenset of concrete words (the value-set analysis proved
every operand lies in it) or ``None`` ("could be anything").

Consumer 1 — tx-sequence pruning (svm's pre-round screen, counted as
``static_tx_prunes``): an open state that finished round *i* inside
function *f* need not explore function *g* in round *i+1* when *g*
provably cannot observe anything *f* did:

* FINAL round: ``writes(f) ∩ reads(g) = ∅`` with both sets complete,
  *f* effect-free (no CALL-family/CREATE/SELFDESTRUCT reachable — its
  only state effect is its storage writes plus the received call
  value) and *g* balance-blind (no CALL-family/CREATE/SELFDESTRUCT/
  BALANCE/SELFBALANCE reachable — the one extra thing *f* changed, the
  contract balance, is invisible to it). Every issue *g* could mint
  after *f* was already mintable when *g* ran from *f*'s pre-state in
  round *i* — the engine explored exactly that sibling branch — so
  the ordering is redundant, and nothing consumes the combined state.
* NON-final round: additionally the symmetric conditions AND
  ``writes(f) ∩ writes(g) = ∅`` must hold — then (f,g) and (g,f)
  commute to the SAME world state and only the canonical order
  (smaller selector first) keeps exploring; the pruned ordering's
  third-transaction coverage survives through the kept one.

Consumer 2 — static fact seeding (``static_facts_seeded``): codes
whose write summaries are complete keep storage select/ITE chains
fully concrete, so a symbolic-slot SLOAD reduces (smt.terms.mk_select)
to an ITE tree over concrete leaves. ``candidate_facts`` collects the
leaf set (a per-PC value-set product: every leaf was pinned by a
PUSH-fed SSTORE) and mints implied facts — a pinned constant for a
singleton, a small disjunction otherwise — that seed the PR-5
propagation pass's init tables and assert ahead of Z3 through the
existing verdict-cache fact channel. The facts are implied by the
TERM STRUCTURE alone (an ITE's value is always one of its leaves), so
asserting them can never change a verdict or model set; the static
summary is the engagement gate that keeps the walk off codes whose
chains cannot stay concrete.
"""

import logging
import threading
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

from . import dataflow
from .cfg import CFG

log = logging.getLogger(__name__)

#: aggregated set-width cap, matching summaries._AGG_K
_AGG_K = 64

#: fact candidate caps: an ITE tree with more leaves than this (or
#: deeper than the depth cap) yields no fact — the disjunction would
#: not help the solver anyway
FACT_CANDIDATES_CAP = 8
_FACT_DEPTH_CAP = 64

_BALANCE_OPS = frozenset(("BALANCE", "SELFBALANCE"))
_EFFECT_OPS = frozenset(("CALL", "CALLCODE", "DELEGATECALL",
                         "STATICCALL", "CREATE", "CREATE2",
                         "SELFDESTRUCT"))


class FunctionDeps(NamedTuple):
    """Aggregated storage/effect footprint of one function entry."""

    entry: int
    #: complete concrete SLOAD slots reachable from entry, or None
    reads: Optional[FrozenSet[int]]
    #: complete concrete SSTORE slots reachable from entry, or None
    writes: Optional[FrozenSet[int]]
    #: CALL-family/CREATE/SELFDESTRUCT reachable (external effects)
    has_effects: bool
    #: BALANCE/SELFBALANCE reachable (balance-observing)
    reads_balance: bool


def _union(a, b):
    if a is None or b is None:
        return None
    u = a | b
    return u if len(u) <= _AGG_K else None


def analyze(cfg: CFG, per_block, selector_map: Dict[int, int]
            ) -> Dict[int, FunctionDeps]:
    """{entry byte pc -> FunctionDeps} for every recovered entry.

    ``per_block`` is summaries.summarize_blocks' product — the write
    slots/values there come from the same converged VSA entry stacks,
    so the aggregates inherit its soundness contract (a complete set
    over-approximates every concrete operand)."""
    if not cfg.blocks:
        return {}
    # per-block effect/balance flags from the raw instruction stream
    effects = []
    balance = []
    for block in cfg.blocks:
        ops = {ins.op for ins in block.instrs}
        effects.append(bool(ops & _EFFECT_OPS))
        balance.append(bool(ops & _BALANCE_OPS))
    out: Dict[int, FunctionDeps] = {}
    for entry in set(selector_map.values()):
        bi = cfg.block_at.get(entry)
        if bi is None:
            continue
        reach = dataflow.reachable_from(cfg, (bi,))
        reads: Optional[frozenset] = frozenset()
        writes: Optional[frozenset] = frozenset()
        has_effects = False
        reads_balance = False
        for ri in reach:
            summ = per_block.get(cfg.blocks[ri].start)
            if summ is None:
                reads = writes = None
            else:
                reads = _union(reads, summ.reads)
                writes = _union(writes, summ.writes)
            has_effects = has_effects or effects[ri]
            reads_balance = reads_balance or balance[ri]
        out[entry] = FunctionDeps(entry, reads, writes,
                                  has_effects, reads_balance)
    return out


# -- the independence relation ----------------------------------------------


def _one_sided(f: FunctionDeps, g: FunctionDeps) -> bool:
    """g after f is redundant: g cannot observe f's effects."""
    if f.writes is None or g.reads is None:
        return False
    if f.has_effects:
        return False   # f touched more than storage
    if g.has_effects or g.reads_balance:
        return False   # g could observe f's received call value
    return not (f.writes & g.reads)


def prunable(f: FunctionDeps, g: FunctionDeps, final_round: bool
             ) -> bool:
    """May the (f then g) ordering be skipped? See module docstring
    for the soundness argument of each arm."""
    if not _one_sided(f, g):
        return False
    if final_round:
        return True
    # commuting pair, canonical order keeps exploring
    if not _one_sided(g, f):
        return False
    if f.writes is None or g.writes is None or (f.writes & g.writes):
        return False
    return True


def excluded_selectors(info, prev_entry: Optional[int],
                       final_round: bool) -> List[int]:
    """Selectors the next transaction from this open state may skip,
    given the previous transaction ran the function at ``prev_entry``.
    Empty when anything is unknown (no recovery, unknown previous
    function, incomplete summaries)."""
    sel_map = getattr(info, "selector_map", None) or {}
    func_deps = getattr(info, "func_deps", None) or {}
    if prev_entry is None or not sel_map:
        return []
    f = func_deps.get(prev_entry)
    if f is None:
        return []
    prev_sel = None
    for sel, entry in sel_map.items():
        if entry == prev_entry:
            prev_sel = sel
            break
    out = []
    for sel, entry in sel_map.items():
        g = func_deps.get(entry)
        if g is None:
            continue
        if not prunable(f, g, final_round):
            continue
        if not final_round and prev_sel is not None and prev_sel > sel:
            continue  # canonical order: the (g, f) ordering survives
        if not final_round and prev_sel is None:
            continue
        out.append(sel)
    return sorted(out)


# -- static fact seeding -----------------------------------------------------

_REG_LOCK = threading.Lock()
#: code hashes registered by svm for the current process whose write
#: summaries are complete — the engagement gate for the fact walk
_PINNABLE_CODES: Dict[str, bool] = {}
#: tid -> tuple of candidate ints | None (memoized ITE-leaf walks)
_CAND_MEMO: Dict[int, Optional[Tuple[int, ...]]] = {}
#: top-level constraint tid -> tuple of (term, candidates) hits
_SET_MEMO: Dict[int, tuple] = {}
_MEMO_CAP = 1 << 16


def reset_facts() -> None:
    with _REG_LOCK:
        _PINNABLE_CODES.clear()
        _CAND_MEMO.clear()
        _SET_MEMO.clear()


def register_code(info) -> None:
    """svm calls this once per analyzed code: codes whose write-value
    summaries are complete open the fact gate for the run."""
    pinnable = bool(getattr(info, "writes_complete", False))
    with _REG_LOCK:
        if len(_PINNABLE_CODES) > 256:
            _PINNABLE_CODES.clear()
        _PINNABLE_CODES[info.code_hash] = pinnable


def fact_gate_open() -> bool:
    with _REG_LOCK:
        return any(_PINNABLE_CODES.values())


def candidate_facts(raw) -> Optional[Tuple[int, ...]]:
    """The constant leaf set of an ITE tree (sorted tuple), or None
    when any leaf is non-constant or the caps trip. Implied fact:
    the term's value is ALWAYS one of the leaves, whatever the
    conditions evaluate to."""
    memo_hit = _CAND_MEMO.get(raw.tid)
    if memo_hit is not None or raw.tid in _CAND_MEMO:
        return memo_hit
    leaves = set()
    ok = True
    stack = [(raw, 0)]
    while stack:
        t, d = stack.pop()
        if d > _FACT_DEPTH_CAP or len(leaves) > FACT_CANDIDATES_CAP:
            ok = False
            break
        op = getattr(t, "op", None)
        if op == "bv_const":
            leaves.add(t.val)
        elif op == "ite":
            stack.append((t.args[1], d + 1))
            stack.append((t.args[2], d + 1))
        else:
            ok = False
            break
    result = tuple(sorted(leaves)) \
        if ok and leaves and len(leaves) <= FACT_CANDIDATES_CAP else None
    if len(_CAND_MEMO) > _MEMO_CAP:
        _CAND_MEMO.clear()
    _CAND_MEMO[raw.tid] = result
    return result


def _walk_constraint(raw) -> tuple:
    """(term, candidates) pairs for every maximal bounded ITE tree in
    one constraint term; memoized per constraint tid."""
    hit = _SET_MEMO.get(raw.tid)
    if hit is not None:
        return hit
    out = []
    seen = set()
    stack = [raw]
    while stack:
        t = stack.pop()
        if t.tid in seen:
            continue
        seen.add(t.tid)
        if getattr(t, "op", None) == "ite" \
                and isinstance(t.width, int) and t.width <= 256:
            cands = candidate_facts(t)
            if cands is not None and len(cands) > 1:
                out.append((t, cands))
                continue  # maximal tree recorded; skip its interior
        stack.extend(t.args)
    result = tuple(out)
    if len(_SET_MEMO) > _MEMO_CAP:
        _SET_MEMO.clear()
    _SET_MEMO[raw.tid] = result
    return result


def static_hints_for_set(raws) -> list:
    """Implied raw fact terms for one constraint set — asserted ahead
    of the real constraints by the solver seams (smt/solver/batch.py
    _hints_for, support/model.get_model). Empty unless the fact gate
    is open (MTPU_TAINT on and a registered code is pinnable)."""
    from . import taint_enabled

    if not taint_enabled() or not fact_gate_open():
        return []
    try:
        from ...smt import terms as T
    except Exception:
        return []
    facts = []
    seen = set()
    for raw in raws:
        for t, cands in _walk_constraint(raw):
            if t.tid in seen:
                continue
            seen.add(t.tid)
            eqs = [T.mk_eq(t, T.bv_const(c, t.width)) for c in cands]
            facts.append(eqs[0] if len(eqs) == 1
                         else T.mk_bool_or(*eqs))
    if facts:
        try:
            from ...smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(static_facts_seeded=len(facts))
        except Exception:
            pass
    return facts


def static_eq_refuted(raws) -> bool:
    """O(1)-per-constraint refutation: ``EQ(storage-ITE-tree, const)``
    with the constant outside the tree's leaf set is UNSAT on its own
    (the tree's value is always one of its leaves), so the whole set
    is. Catches holes INSIDE the interval hull the interval screen
    cannot see (e.g. leaves {0, 7} against ``== 3``). Gated like the
    other fact consumers."""
    from . import taint_enabled

    if not taint_enabled() or not fact_gate_open():
        return False
    for raw in raws:
        if getattr(raw, "op", None) != "eq":
            continue
        a, b = raw.args
        if getattr(a, "op", None) == "bv_const":
            a, b = b, a
        if getattr(b, "op", None) != "bv_const" \
                or getattr(a, "op", None) != "ite":
            continue
        cands = candidate_facts(a)
        if cands is not None and b.val not in cands:
            try:
                from ...smt.solver.solver_statistics import (
                    SolverStatistics,
                )

                SolverStatistics().bump(static_facts_seeded=1)
            except Exception:
                pass
            return True
    return False


def static_seed_rows(enc) -> Dict[int, Tuple[int, int]]:
    """{node-table row -> (lo, hi)} interval pins for an EncodedDAG's
    bounded-ITE rows (the PR-5 propagation seed injection): the
    candidate hull is implied by the term, so meeting it into the
    init tables only removes states the term provably cannot reach.
    Empty unless the fact gate is open."""
    from . import taint_enabled

    if not taint_enabled() or not fact_gate_open():
        return {}
    out: Dict[int, Tuple[int, int]] = {}
    try:
        order = enc.host["terms"]
    except Exception:
        return {}
    for i, t in enumerate(order):
        if getattr(t, "op", None) != "ite":
            continue
        if not isinstance(t.width, int) or t.width > 256:
            continue
        cands = candidate_facts(t)
        if cands is not None and len(cands) >= 1:
            out[i] = (cands[0], cands[-1])
    return out
