"""Batch feasibility screen: the pruner's seam to the device screens.

The counterpart of ``mythril_tpu/models/pruner.py`` as far as the
device screens reach: before per-state solver queries, a batch of
constraint systems is screened in the interval domain. Batches of
``DEVICE_BATCH_THRESHOLD`` or more run on the card
(``_device_prefilter``: the product-domain fixpoint of ops/propagate.py,
or with MTPU_PROPAGATE=0 the forward interval screen of
ops/intervals.py); smaller ones use the host transfer functions
(smt/interval.py). A device call that raises is counted in
``STATS["device_failures"]`` and raised to the caller; the JAX
package's fallback to the host screen, and its backoff, are not
ported.

Not here yet, each attaching with the host bridge: the verdict-cache
and static-fact tiers of the host screen (the JAX
``_interval_infeasible``; the port's host screen is
``state_infeasible``), ``_verdict_kills``, ``prefilter_world_states``
and ``prune_feasible_states``, which need the world states of
``laser/state``.
"""

import logging
import threading
from typing import List

from ..smt.interval import state_infeasible

log = logging.getLogger(__name__)

#: guards STATS (the JAX package runs this module from an orchestration
#: thread concurrently with the main thread's fork pruning)
_stats_lock = threading.Lock()


def _stat_add(**deltas) -> None:
    with _stats_lock:
        for k, v in deltas.items():
            STATS[k] += v


# below this many states the host loop beats device dispatch overhead
DEVICE_BATCH_THRESHOLD = 8

#: cumulative counters: items screened through the interval domain,
#: items pruned by it, how many ran on the device, and device calls
#: that raised (each re-raised to the caller)
STATS = {"screened": 0, "pruned": 0, "device_screened": 0,
         "device_failures": 0}


def _raws(constraints) -> list:
    return [getattr(c, "raw", c) for c in constraints]


def _screen_interval(items: List, get_constraints, device=None) -> List:
    """Shared interval screen: device-batched when large enough, host
    transfer functions otherwise. Sound — only provably-unsat items are
    dropped. ``device`` is where the device screen runs (the card
    unless the caller names another). A device call that raises is
    counted in ``STATS["device_failures"]`` and re-raised: the host
    screen never stands in for it."""
    from ..support.devices import effective_tpu_lanes

    if effective_tpu_lanes() and len(items) >= DEVICE_BATCH_THRESHOLD:
        try:
            keep = _device_prefilter(
                [_raws(get_constraints(it)) for it in items], device)
        except Exception:
            _stat_add(device_failures=1)
            raise
        out = [it for it, k in zip(items, keep) if k]
        _stat_add(device_screened=len(items))
    else:
        out = []
        for it in items:
            try:
                if state_infeasible(_raws(get_constraints(it))):
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


def _device_prefilter(assertion_sets, device=None):
    """The device feasibility screen: the bidirectional product-domain
    fixpoint (ops/propagate.py) when MTPU_PROPAGATE is on, the forward
    interval-only pass (ops/intervals.py) otherwise."""
    from ..ops import intervals, propagate

    if propagate.enabled():
        return propagate.prefilter_feasible(assertion_sets, device)
    return intervals.prefilter_feasible(assertion_sets, device)
