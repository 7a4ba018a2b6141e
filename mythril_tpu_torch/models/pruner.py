"""Batch feasibility pre-filter for open world states.

This is the engine-facing seam of the TPU lane pruner (SURVEY.md §2.10,
solver-level row): before per-state solver queries, all open states'
constraint systems are screened with the interval domain. Small batches use
the host transfer functions (mythril_tpu_torch/smt/interval.py); larger batches
are linearized and evaluated vectorized on device
(mythril_tpu_torch/ops/intervals.py), controlled by support_args.args.tpu_lanes.

A device call that raises is counted in ``STATS["device_failures"]``
and raised to the caller: the host screen answers only batches under
the device threshold, never one whose device call failed (the JAX
package's fallback and its backoff are not ported). ``device`` names
where a device screen runs: the card unless the caller names another.
"""

import logging
import threading
from typing import List

from ..smt.interval import state_infeasible
from ..support.support_args import args

log = logging.getLogger(__name__)

#: guards STATS: the round-boundary
#: async open-state screen (laser/svm.py + smt/solver/pool.py) runs
#: this module from an orchestration thread concurrently with the
#: main thread's fork pruning, and unguarded `+=` would drop counts
_stats_lock = threading.Lock()


def _stat_add(**deltas) -> None:
    with _stats_lock:
        for k, v in deltas.items():
            STATS[k] += v


def _raws(constraints) -> list:
    return [getattr(c, "raw", c) for c in constraints]


def _all_constraints(constraints):
    """Constraints + the run's keccak axioms (get_all_constraints) —
    the axioms confine hash terms to high intervals, which is what lets
    the screen refute `hash == small-constant` probes. Plain lists
    (tests, pre-built sets) pass through."""
    getter = getattr(constraints, "get_all_constraints", None)
    return getter() if getter is not None else list(constraints)


def _interval_infeasible(constraints) -> bool:
    """Host interval screen routed through the run-wide verdict cache
    (smt/solver/verdicts.py): the screen seeds from the longest cached
    prefix's variable bounds (tier 3) and records refutations so
    descendant sets across windows and call sites die by ancestor
    subsumption. Falls back to plain state_infeasible when the cache is
    disabled.

    The static-fact tier runs first (PR 8,
    analysis/static_pass/deps.static_eq_refuted): an equality pinning
    a storage-ITE tree to a constant outside its leaf set is UNSAT by
    term structure alone — a hole INSIDE the interval hull neither
    the bounds walk nor tier 3 can see, answered with zero solver or
    interval work."""
    raws = [getattr(c, "raw", c) for c in constraints]
    try:
        from ..analysis.static_pass import deps as static_deps

        if static_deps.static_eq_refuted(raws):
            return True
    except Exception:
        pass
    try:
        from ..smt.solver import verdicts

        vc = verdicts.cache()
        if vc is not None:
            return vc.interval_unsat(raws)
    except Exception:
        pass
    return state_infeasible(raws)

# below this many states the host loop beats device dispatch overhead
DEVICE_BATCH_THRESHOLD = 8


def _device_threshold() -> int:
    """The batch size from which a screen runs on the device (the port
    has no tunneled backend, so one threshold serves)."""
    return DEVICE_BATCH_THRESHOLD

#: cumulative effectiveness counters (read by bench configs / -v4
#: diagnostics): items screened through the interval domain, items
#: pruned by it, and how many ran on the device vs host transfer
#: functions, and device calls that raised (each re-raised).
STATS = {"screened": 0, "pruned": 0, "device_screened": 0,
         "device_failures": 0,
         # states/lanes the merge pass (laser/merge.py) retired BEFORE
         # they could reach this screen: every one is a whole
         # constraint system that never costs an interval row, a
         # device dispatch slot, or a solver query here
         "merge_retired": 0}


def _verdict_kills(open_states: List) -> List:
    """Exact/ancestor verdict kills BEFORE any screen: prior-window
    proofs and migration-sidecar replays (docs/work_stealing.md) drop
    states with zero interval or solver work. Without this the device
    screen path bypasses the run-wide cache entirely, so a thief would
    re-screen constraint sets its victim already refuted. Shadow tier
    deliberately skipped — this pass must stay O(lookup) per state."""
    try:
        from ..smt.solver import verdicts

        vc = verdicts.cache()
        if vc is None:
            return open_states
        out = []
        for ws in open_states:
            try:
                raws = [c.raw for c in
                        _all_constraints(ws.constraints)
                        if type(c) != bool]
                verdict, _ = vc.probe(raws, shadow=False)
            except Exception:
                verdict = None
            if verdict != verdicts.UNSAT:
                out.append(ws)
        return out
    except Exception:
        return open_states


def prefilter_world_states(open_states: List, device=None) -> List:
    """Drop world states with an interval-infeasible constraint. Sound:
    only provably-unsat states are removed. A device call that raises
    is counted and raised."""
    from ..support.devices import effective_tpu_lanes

    kept = _verdict_kills(open_states)
    if len(kept) < len(open_states):
        _stat_add(screened=len(open_states) - len(kept),
                  pruned=len(open_states) - len(kept))
        log.info("verdict-cache pre-pass dropped %d open states",
                 len(open_states) - len(kept))
    open_states = kept
    if effective_tpu_lanes() and len(open_states) >= _device_threshold():
        try:
            out = _prefilter_device(open_states, device)
        except Exception:
            _stat_add(device_failures=1)
            raise
        _stat_add(screened=len(open_states),
                  pruned=len(open_states) - len(out),
                  device_screened=len(open_states))
        return out
    out = []
    dropped = 0
    for ws in open_states:
        try:
            infeasible = _interval_infeasible(
                list(_all_constraints(ws.constraints)))
        except Exception as e:
            log.debug("interval screening failed: %s", e)
            infeasible = False
        if infeasible:
            dropped += 1
        else:
            out.append(ws)
    _stat_add(screened=len(open_states), pruned=dropped)
    if dropped:
        log.info("interval pre-filter dropped %d open states", dropped)
    return out


def _screen_interval(items: List, get_constraints, device=None) -> List:
    """Shared interval screen: device-batched when large enough, host
    transfer functions otherwise. Sound — only provably-unsat items are
    dropped. A device call that raises is counted in
    ``STATS["device_failures"]`` and re-raised: the host screen never
    stands in for it."""
    from ..support.devices import effective_tpu_lanes

    out = None
    if effective_tpu_lanes() and len(items) >= _device_threshold():
        try:
            keep = _device_prefilter(
                [_raws(get_constraints(it)) for it in items], device)
        except Exception:
            _stat_add(device_failures=1)
            raise
        out = [it for it, k in zip(items, keep) if k]
        _stat_add(device_screened=len(items))
    if out is None:
        out = []
        for it in items:
            try:
                if _interval_infeasible(list(get_constraints(it))):
                    continue
            except Exception:
                pass
            out.append(it)
    dropped = len(items) - len(out)
    _stat_add(screened=len(items), pruned=dropped)
    if dropped:
        log.info("interval pre-filter dropped %d/%d", dropped,
                 len(items))
    return out


def prune_feasible_states(states: List) -> List:
    """Per-fork feasibility pruning (svm pruning_factor path,
    reference svm.py:319-326): screen the batch through the interval
    domain first and only the survivors pay a solver `is_possible`
    check (which keeps the reference's timeout-means-possible
    semantics).

    With the persistent solver pool enabled the surviving siblings
    solve CONCURRENTLY across the pool workers (check_batch's pooled
    wave); the verdicts still gate the fork on the spot — deferring
    them would change which states the strategy explores next. The
    pruner's fully-async seams are the lane engine's fork screen
    (submit at drain k, collect at drain k+1) and svm's round-boundary
    open-state prefetch, both of which feed the same verdict cache
    this path reads (docs/solver_pool.md)."""
    if not states:
        return states
    survivors = _screen_interval(
        states,
        lambda s: _all_constraints(s.world_state.constraints))
    from ..laser.state.constraints import Constraints

    if survivors and all(
        isinstance(s.world_state.constraints, Constraints)
        for s in survivors
    ):
        # fork siblings share their constraint prefix by construction:
        # the batched discharge asserts it once and subset-kills
        # UNSAT supersets (support/model.check_batch; is_possible
        # semantics preserved, including timeout-means-possible).
        # Single survivors route through the same seam so the run-wide
        # verdict cache answers already-proved prefixes.
        from ..support.model import check_batch

        keep = check_batch(
            [s.world_state.constraints for s in survivors])
        return [s for s, ok in zip(survivors, keep) if ok]
    return [
        s for s in survivors
        if s.world_state.constraints.is_possible()
    ]


def _device_prefilter(assertion_sets, device=None):
    """The device feasibility screen: the bidirectional product-domain
    fixpoint (ops/propagate.py — kills more lanes AND harvests facts
    that hint the surviving solves) when MTPU_PROPAGATE is on, the
    forward interval-only pass (ops/intervals.py) otherwise —
    bit-for-bit the pre-propagation behavior."""
    from ..ops import propagate

    if propagate.enabled():
        return propagate.prefilter_feasible(assertion_sets, device)
    from ..ops.intervals import prefilter_feasible

    return prefilter_feasible(assertion_sets, device)


def _prefilter_device(open_states: List, device=None) -> List:
    keep = _device_prefilter(
        [[c.raw for c in _all_constraints(ws.constraints)]
         for ws in open_states], device
    )
    out = [ws for ws, k in zip(open_states, keep) if k]
    dropped = len(open_states) - len(out)
    if dropped:
        log.info(
            "device interval pre-filter dropped %d/%d open states",
            dropped, len(open_states),
        )
    return out
