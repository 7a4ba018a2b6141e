"""Lane merging and path subsumption at window/round boundaries.

Path count is the enemy at scale: fork storms explode into thousands of
lanes, many of which are control-flow REJOINS of the same prefix — a
diamond in the CFG produces two lanes whose execution frontier (pc,
stack, memory, storage writes, gas) is bit-identical and whose only
difference is the path-constraint suffix accumulated through the
diamond. The CFLOBDD bounded-model-checking line (PAPERS.md) collapses
exactly this redundancy with decision-diagram state sharing; the device
analog implemented here is cheaper and cruder, and runs at the two
natural quiescence points:

* the lane engine's WINDOW boundary (laser/lane_engine.py
  ``_window_merge``): a device kernel fingerprints every live lane's
  frontier (the ``_merge_fingerprint`` extension of the
  ``_dedup_canon``/``_unique_table`` record-dedup machinery to whole
  LANES), exact-frontier twins are grouped host-side, and
* svm's ROUND boundary (laser/svm.py ``_execute_transactions``): the
  drained open-state worklist is merged host-side before re-seeding the
  next transaction round (``merge_open_states``).

Within a group of exact-frontier twins, three collapses apply (all
planned by ``plan_group``):

1. **duplicate merge** — members whose constraint tid-SETS are equal are
   one path counted twice (device forks never simplify; re-tested
   branch conditions mint ``[c, c]`` next to ``[c]``); the duplicate
   retires. Counted as ``lanes_merged``.
2. **subsumption** — member B retires into member A when B provably
   implies A (``region(B) ⊆ region(A)``): either B's constraint tid-set
   is a superset of A's (syntactic implication — monotonicity of
   conjunction), or every constraint of A not already in B is
   ``must_be_true`` under B's interval×known-bits abstraction — the
   ops/propagate.py product-domain tables when the propagation pass is
   live (``abstraction_sets``), else the verdict cache's tier-3 bounds
   (which absorb the fork screen's propagated bounds, so the device
   tables are reused rather than recomputed). The subsumed lane retires
   WITHOUT any solver work. Counted as ``lanes_subsumed``.
3. **OR-merge** — the incomparable remainder merges into ONE lane whose
   path constraint is the common positional prefix plus the OR of the
   members' suffixes, built at the ``mythril_tpu_torch/smt`` term layer
   (``suffix_or``) so the tid stays hash-consed and verdict-cache-
   fingerprintable. The OR carries a ``MergeProvenance`` annotation
   listing every disjunct, so ``support/model.get_model`` can
   re-concretize a SINGLE witness path for detection-module reports
   (``support.model.witness_paths``). Counted as ``lanes_merged`` (one
   per retired sibling) and ``or_terms_built``.

Soundness: duplicates and subsumption only ever DROP a lane whose
feasible region is contained in a surviving sibling's over the SAME
frontier — every concrete execution of the dropped lane is an execution
of the survivor, so no detection site or feasibility verdict is lost.
The OR-merge preserves the union region exactly (``∨`` of the suffixes
under the shared prefix); a query against the merged lane is SAT iff it
was SAT against at least one sibling. Gated run-wide by ``MTPU_MERGE``
(default on; ``MTPU_MERGE=0`` restores the unmerged behavior
bit-for-bit) and validated by issue-set identity across the fixture
corpus (tests/test_lane_merge.py, bench.py --smoke stage 7).

Counters (SolverStatistics → batch_counters → both telemetry plugins,
bench detail blocks, shard reports, the bench_corpus aggregate):
``lanes_merged``, ``lanes_subsumed``, ``merge_rounds``,
``or_terms_built``, ``gas_widened_lanes``.  See docs/lane_merge.md.
"""

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..smt import And, Bool, Or
from ..smt import terms as T
from ..smt.expression import Expression

log = logging.getLogger(__name__)

#: tri-state override for tests/bench (None = read MTPU_MERGE)
FORCE: Optional[bool] = None


def enabled() -> bool:
    """The MTPU_MERGE gate (default on). Off, neither boundary runs any
    merge work — today's behavior bit-for-bit."""
    if FORCE is not None:
        return bool(FORCE)
    return os.environ.get("MTPU_MERGE", "1") != "0"


def subsume_enabled() -> bool:
    """Sub-gate for the abstraction-containment subsumption tier
    (tid-superset subsumption is pure set algebra and always on with
    the pass)."""
    return os.environ.get("MTPU_MERGE_SUBSUME", "1") != "0"


def gas_widen_enabled() -> bool:
    """Gas-widening sub-gate (MTPU_MERGE_GASWIDEN, default on):
    uneven-gas rejoin arms fingerprint equal, and the survivor's
    ctx-level gas offsets widen to the group's interval hull — a sound
    over-approximation of the per-path gas accounting, which was
    already an interval. Off, the gas interval re-joins the exact twin
    key and only gas-identical arms merge (the pre-widening
    behavior)."""
    return enabled() and \
        os.environ.get("MTPU_MERGE_GASWIDEN", "1") != "0"


def spill_merge_enabled() -> bool:
    """Merge-before-spill sub-gate (docs/drain_pipeline.md "streaming
    retire"): run the window-boundary fingerprint twin-collapse over
    the retired SPILL CANDIDATES before they materialize into the host
    worklist, so the spill/refill regime stops re-executing rejoin
    twins it would have merged at the next dispatch. Rides the merge
    master gate (MTPU_MERGE) and the streaming-pipeline master gate
    (lane_engine.stream_enabled / MTPU_STREAM); MTPU_SPILL_MERGE=0
    switches just this pass off."""
    if not enabled():
        return False
    try:
        from .lane_engine import stream_enabled

        if not stream_enabled():
            return False
    except Exception:  # pragma: no cover - lane path optional
        return False
    return os.environ.get("MTPU_SPILL_MERGE", "1") != "0"


def propagate_abstractions_enabled() -> bool:
    """RECOMPUTE subsumption abstractions with a fresh
    ops/propagate.py fixpoint dispatch (MTPU_MERGE_PROPAGATE=1,
    default off). The default path instead REUSES the product-domain
    tables the fork screen already computed: its harvested bounds land
    in the verdict cache (absorb_bounds), and ``bounds_for`` serves
    them here with zero device work — a fresh fixpoint per boundary
    measured ~50x the whole merge pass in per-DAG-shape XLA compiles,
    for precision the banked bounds already carry."""
    return os.environ.get("MTPU_MERGE_PROPAGATE", "0") == "1"


class MergeProvenance:
    """Annotation carried by a merged OR constraint: the ordered
    disjunct list (each a tuple of raw suffix terms), so a satisfying
    model can be re-concretized to a single original path — see
    support/model.witness_paths. Hash/eq by identity: each merge event
    is its own provenance."""

    __slots__ = ("disjuncts",)

    def __init__(self, disjuncts: Tuple[Tuple["T.Term", ...], ...]):
        self.disjuncts = disjuncts

    def __repr__(self) -> str:
        return f"MergeProvenance({len(self.disjuncts)} paths)"

    # annotations live in sets; identity semantics keep distinct merge
    # events distinct even over identical suffix tuples
    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other

    # checkpoint/sidecar pickling: identity does not survive a process
    # hop, but the disjunct terms do (term-safe pickler)
    def __reduce__(self):
        return (MergeProvenance, (self.disjuncts,))


def note_retired(n: int) -> None:
    """Book n merge-retired lanes/states against the pruner's screen
    stats (models/pruner.py STATS['merge_retired']): each one is a
    constraint system the screens and solver never see."""
    try:
        from ..models.pruner import _stat_add

        _stat_add(merge_retired=n)
    except Exception:
        pass


def split_prefix(cond_lists: Sequence[Sequence[Bool]]) -> int:
    """Length of the longest common POSITIONAL prefix (by term tid)
    across the given condition lists."""
    if not cond_lists:
        return 0
    p = 0
    shortest = min(len(cl) for cl in cond_lists)
    first = cond_lists[0]
    while p < shortest and all(
            cl[p].raw is first[p].raw for cl in cond_lists[1:]):
        p += 1
    return p


def suffix_or(suffixes: Sequence[Sequence[Bool]]) -> Bool:
    """The OR of per-path suffix conjunctions, built at the term layer
    (hash-consed; annotations of the member conditions union through),
    annotated with the disjunct provenance."""
    from ..smt.solver.solver_statistics import SolverStatistics

    conjs = [And(*list(sfx)) if sfx else Bool(T.bool_t(True))
             for sfx in suffixes]
    orb = Or(*conjs)
    orb.annotate(MergeProvenance(
        tuple(tuple(c.raw for c in sfx) for sfx in suffixes)))
    SolverStatistics().bump(or_terms_built=1)
    return orb


class MergePlan:
    """plan_group result: ``keep`` is the surviving member index;
    ``new_conds`` (or None for no change) is the survivor's replacement
    condition list with ``prefix_len`` original positions retained;
    ``dropped`` maps retired member index -> "merged" | "subsumed"."""

    __slots__ = ("keep", "new_conds", "prefix_len", "dropped")

    def __init__(self, keep, new_conds, prefix_len, dropped):
        self.keep = keep
        self.new_conds = new_conds
        self.prefix_len = prefix_len
        self.dropped = dropped


def _abstraction_memos(cond_lists: Sequence[Sequence[Bool]]
                       ) -> List[Optional[Dict[int, tuple]]]:
    """Per-list {var_tid: (lo, hi)} interval memos for the implication
    checks, from the strongest available abstraction source:

    * the ops/propagate.py product-domain fixpoint tables when the
      propagation pass is live (known bits fold into the interval
      through the table-wide exchange, so the memo carries them);
    * else the verdict cache's tier-3 bounds — which ABSORB the
      propagated bounds the fork screen already computed for these very
      cond sets (docs/propagation.md), so the device tables are reused
      without a second dispatch;
    * else the raw syntactic extraction.

    ``None`` marks a list the source proved contradictory (bottom —
    contained in everything)."""
    raws_lists = [[c.raw for c in cl] for cl in cond_lists]
    if propagate_abstractions_enabled():
        # a device call that raises raises to the caller
        from ..ops import propagate

        if propagate.enabled():
            got = propagate.abstraction_sets(raws_lists)
            if got is not None:
                return [
                    None if d is None else {
                        vt: (lo, hi)
                        for vt, (lo, hi, _k0, _k1) in d.items()}
                    for d in got
                ]
    memos: List[Optional[Dict[int, tuple]]] = []
    try:
        from ..smt.solver import verdicts as verdict_mod

        vc = verdict_mod.cache()
    except Exception:
        vc = None
    from ..smt.interval import extract_bounds

    for raws in raws_lists:
        try:
            tids = tuple(t.tid for t in raws)
            bounds = vc.bounds_for(raws, tids) if vc is not None \
                else extract_bounds(raws)
            memo: Optional[Dict[int, tuple]] = {}
            for vt, (_var, lo, hi) in bounds.items():
                if lo > hi:
                    memo = None  # contradictory: bottom
                    break
                memo[vt] = (lo, hi)
            memos.append(memo)
        except Exception:
            memos.append({})  # TOP: subsumes nothing, safe
    return memos


def _implies(cond_list: Sequence[Bool], tidset: frozenset,
             target: Sequence[Bool],
             memo: Optional[Dict[int, tuple]]) -> bool:
    """True when the constraint set behind (tidset, memo) provably
    implies every condition of ``target``: each target condition is
    either a member of the set itself or must-true under the set's
    sound interval abstraction."""
    from ..smt.interval import must_be_true

    if memo is None:
        return True  # bottom implies everything
    for c in target:
        if c.raw.tid in tidset:
            continue
        try:
            if not must_be_true(c.raw, dict(memo)):
                return False
        except Exception:
            return False
    return True


def plan_group(cond_lists: Sequence[Sequence[Bool]],
               subsume: bool = True) -> Optional[MergePlan]:
    """Collapse plan for a group of exact-frontier twins distinguished
    only by their condition lists. Returns None when nothing collapses.

    Order of tiers: duplicate/superset retirement (pure tid-set
    algebra), abstraction subsumption (interval implication — no solver
    work), then the OR-merge of the incomparable remainder."""
    n = len(cond_lists)
    if n < 2:
        return None
    tidsets = [frozenset(c.raw.tid for c in cl) for cl in cond_lists]
    dropped: Dict[int, str] = {}

    # tier 1: equal tid-sets are duplicates (merged); proper supersets
    # imply their subset sibling and retire subsumed. Scanning in
    # ascending set size keeps the WEAKEST representative.
    order = sorted(range(n), key=lambda i: (len(tidsets[i]), i))
    alive: List[int] = []
    for i in order:
        winner = None
        for j in alive:
            if tidsets[j] <= tidsets[i]:
                winner = j
                break
        if winner is None:
            alive.append(i)
        else:
            dropped[i] = ("merged" if tidsets[winner] == tidsets[i]
                          else "subsumed")

    # tier 2: abstraction subsumption between the incomparable rest —
    # B retires when its interval×known-bits abstraction proves every
    # condition of a surviving sibling A (region(B) ⊆ region(A))
    if subsume and subsume_enabled() and len(alive) > 1:
        memos = _abstraction_memos([cond_lists[i] for i in alive])
        for bi, b in enumerate(alive):
            if b in dropped:
                continue
            for a in alive:
                if a is b or a in dropped:
                    continue
                if _implies(cond_lists[b], tidsets[b], cond_lists[a],
                            memos[bi]):
                    dropped[b] = "subsumed"
                    break

    survivors = [i for i in alive if i not in dropped]
    keep = min(survivors) if survivors else min(alive)
    new_conds = None
    prefix_len = 0
    if len(survivors) >= 2:
        lists = [list(cond_lists[i]) for i in survivors]
        prefix_len = split_prefix(lists)
        orb = suffix_or([cl[prefix_len:] for cl in lists])
        keep = survivors[0]
        base = list(cond_lists[keep][:prefix_len])
        new_conds = base if orb.is_true else base + [orb]
        for i in survivors[1:]:
            dropped[i] = "merged"
    if not dropped:
        return None
    return MergePlan(keep, new_conds, prefix_len, dropped)


# ---------------------------------------------------------------------------
# svm round-boundary open-state merge
# ---------------------------------------------------------------------------


def _canon(v):
    """Canonical hashable encoding of an annotation/storage payload for
    merge-key equality: terms by tid, containers recursively, plain
    scalars as-is. Raises TypeError on anything it cannot canonize —
    the owning state then never merges (exactness over coverage)."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, Expression):
        return ("t", v.raw.tid)
    if isinstance(v, T.Term):
        return ("t", v.tid)
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("s",) + tuple(sorted((_canon(x) for x in v), key=repr))
    if isinstance(v, dict):
        return ("d",) + tuple(sorted(
            ((_canon(k), _canon(x)) for k, x in v.items()), key=repr))
    raise TypeError(f"uncanonizable {type(v).__name__}")


def _canon_annotation(a):
    """Canonical key for a state annotation: type plus canonized
    attribute payload (both __dict__ and __slots__ layouts)."""
    state = getattr(a, "__dict__", None)
    if state is None:
        slots = []
        for klass in type(a).__mro__:
            slots.extend(getattr(klass, "__slots__", ()))
        state = {s: getattr(a, s) for s in slots if hasattr(a, s)}
    return ("ann", type(a).__module__, type(a).__qualname__,
            _canon(state))


def _ann_signature(a):
    """Group-key component for one world-state annotation. Dependency
    annotations (the dependency pruner's per-path block/slot tracking)
    key only on their merge-INVARIANT part — states differing in path
    history still merge, with the payloads unioned by _merge_ann
    (union = more pruner wake-ups = sound). Everything else keys on
    full canonical content (merge requires equality)."""
    from ..analysis.issue_annotation import IssueAnnotation
    from .plugin.plugins.plugin_annotations import WSDependencyAnnotation

    if isinstance(a, WSDependencyAnnotation):
        return ("wsdep", len(a.annotations_stack),
                tuple(bool(d.has_call) for d in a.annotations_stack))
    if isinstance(a, IssueAnnotation):
        # issue records copy BY REFERENCE across forks (__copy__ is
        # self), so twins descending from one annotated ancestor share
        # the instance and merge; states carrying DISTINCT issue
        # records stay apart — each instance must survive for the
        # issue-annotation reporting mode
        return ("issue", id(a))
    return _canon_annotation(a)


def _merge_dep(x, y):
    """Union two DependencyAnnotations (relaxed merge_annotation: the
    reference protocol requires equal paths, but exact-frontier twins
    reached the rejoin through DIFFERENT arms — the union records
    reads/writes against every block either path visited, so the
    dependency pruner wakes at least as often as it would for either
    original path)."""
    from .plugin.plugins.plugin_annotations import DependencyAnnotation

    if x is y:
        return x
    merged = DependencyAnnotation()
    merged.has_call = x.has_call or y.has_call
    merged.path = list(x.path) + [p for p in y.path if p not in x.path]
    merged.blocks_seen = x.blocks_seen | y.blocks_seen
    merged.storage_loaded = set(x.storage_loaded) | set(y.storage_loaded)
    for k in set(x.storage_written) | set(y.storage_written):
        merged.storage_written[k] = (
            set(x.storage_written.get(k, ()))
            | set(y.storage_written.get(k, ())))
    return merged


def _merge_ann(a, b):
    """Merged annotation for one aligned position of two twins'
    annotation lists; raises when the pair cannot merge (the caller
    then skips the whole group)."""
    from .state.annotation import MergeableStateAnnotation
    from .plugin.plugins.plugin_annotations import WSDependencyAnnotation

    if a is b:
        return a
    if isinstance(a, WSDependencyAnnotation) \
            and isinstance(b, WSDependencyAnnotation):
        out = WSDependencyAnnotation()
        out.annotations_stack = [
            _merge_dep(x, y)
            for x, y in zip(a.annotations_stack, b.annotations_stack)]
        return out
    if isinstance(a, MergeableStateAnnotation) \
            and isinstance(b, MergeableStateAnnotation) \
            and a.check_merge_annotation(b):
        return a.merge_annotation(b)
    if _canon_annotation(a) == _canon_annotation(b):
        return a
    raise ValueError("unmergeable annotation pair")


def _ws_merge_key(ws) -> Optional[tuple]:
    """Frontier fingerprint of an open WorldState — everything the next
    transaction round reads EXCEPT the path constraints. None marks a
    state that must not merge (uncanonizable payloads). The CFG node is
    deliberately excluded: sibling end states carry distinct nodes, and
    the survivor's node is a valid representative of one disjunct
    (reports re-concretize through the merge provenance)."""
    try:
        accts = []
        for addr in sorted(ws._accounts):
            a = ws._accounts[addr]
            st = a.storage
            accts.append((
                addr,
                _canon(a.nonce),
                id(a.code),
                bool(a.deleted),
                st._standard_storage.raw.tid,
                _canon(st._printable_storage),
                _canon(st.keys_get),
                _canon(st.keys_set),
                tuple(sorted(st.storage_keys_loaded)),
            ))
        return (
            tuple(accts),
            ws.balances.raw.tid,
            ws.starting_balances.raw.tid,
            tuple(id(t) for t in ws.transaction_sequence),
            tuple(_ann_signature(a) for a in ws._annotations),
        )
    except Exception:
        return None


def merge_open_states(open_states: List) -> List:
    """Round-boundary host-side merge of the drained open-state
    worklist (svm re-seeds the next transaction round from the result).
    Exact-frontier twins merge under an OR'd constraint suffix;
    implied siblings retire subsumed. With MTPU_MERGE=0 (or fewer than
    two states) the input list returns untouched."""
    if not enabled() or len(open_states) < 2:
        return open_states
    from ..smt.solver.solver_statistics import SolverStatistics
    from ..support.telemetry import trace
    from .state.constraints import Constraints

    with trace.span("merge.open_states", n=len(open_states)):
        return _merge_open_states_inner(open_states,
                                        SolverStatistics, Constraints)


def _merge_open_states_inner(open_states, SolverStatistics,
                             Constraints):

    groups: Dict[tuple, List[int]] = {}
    for i, ws in enumerate(open_states):
        key = _ws_merge_key(ws)
        if key is not None:
            groups.setdefault(key, []).append(i)
    if not any(len(g) > 1 for g in groups.values()):
        return open_states

    drop: Dict[int, str] = {}
    merged = subsumed = 0
    for g in groups.values():
        if len(g) < 2:
            continue
        plan = plan_group(
            [list(open_states[i].constraints) for i in g])
        if plan is None:
            continue
        survivor = open_states[g[plan.keep]]
        # fold every retired twin's annotations into the survivor
        # FIRST — an unmergeable pair cancels the whole group (the
        # group signature makes this rare: only positions the
        # signature could not pin exactly can differ)
        try:
            anns = list(survivor._annotations)
            for mi in plan.dropped:
                other = open_states[g[mi]]._annotations
                anns = [_merge_ann(a, b)
                        for a, b in zip(anns, other)]
        except Exception:
            log.debug("annotation merge failed; group kept apart",
                      exc_info=True)
            continue
        survivor._annotations = anns
        if plan.new_conds is not None:
            survivor.constraints = Constraints(list(plan.new_conds))
        # static tx-prune tag (svm._tag_last_function): the survivor
        # now represents every dropped disjunct, so the
        # previous-function tag only survives when ALL of them agree —
        # else the next round's independence screen must not prune on
        # a function the merged-away disjunct never ran
        try:
            tag = getattr(survivor, "_mtpu_last_fentry", None)
            for mi in plan.dropped:
                other = getattr(open_states[g[mi]],
                                "_mtpu_last_fentry", None)
                if other != tag:
                    tag = None
                    break
            survivor._mtpu_last_fentry = tag
        except Exception:
            pass
        for mi, reason in plan.dropped.items():
            drop[g[mi]] = reason
            if reason == "merged":
                merged += 1
            else:
                subsumed += 1
    if not drop:
        return open_states
    SolverStatistics().bump(lanes_merged=merged,
                            lanes_subsumed=subsumed, merge_rounds=1)
    note_retired(len(drop))
    log.info("open-state merge: %d states -> %d (%d merged, %d "
             "subsumed)", len(open_states), len(open_states) - len(drop),
             merged, subsumed)
    return [ws for i, ws in enumerate(open_states) if i not in drop]
