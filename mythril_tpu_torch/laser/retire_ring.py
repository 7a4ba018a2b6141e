"""Bounded retire/materialize ring (docs/drain_pipeline.md,
"streaming retire").

The lane engine's window boundary retires parked lanes as CHUNKED
device gathers (laser/lane_engine.py `_retire_chunked`) whose D2H pulls
and GlobalState rebuilds are deferred behind the next window's device
execution. This module owns the deferral structure: a bounded ring of
submitted chunks feeding a small materialization worker pool, with
DELIVERY ORDER into the svm worklist guaranteed to be submit order
regardless of worker count.

Why a ring and not the old ad-hoc `pending_mat` list: the daemon-scale
target (ROADMAP item 1) packs thousands of small contracts into wide
windows whose terminal storms retire tens of thousands of lanes per
boundary. An unbounded deferral list makes peak host memory
proportional to the storm; the ring bounds it — when the ring is full,
`submit` drains the OLDEST entry inline (backpressure: the device
gather already happened, only its pull/rebuild lands early).

Worker policy (`MTPU_MAT_WORKERS`):

* **K=1 (the default — single-CPU container constraint, see
  ROADMAP's perf-gate note):** no threads at all. Chunks queue at
  submit and are pulled+materialized inline at `flush`, exactly where
  the engine's old `_flush_pending` ran — behavior identical to the
  pre-ring build, with the overlap coming from the `copy_to_host_async`
  started at dispatch time (the PR-1 drain trick applied to the retire
  side). The win on this box is overlap-bound; the structure is what
  scales.
* **K>=2:** worker threads pull and materialize chunks as they are
  submitted (term interning flips to its thread-safe miss path via the
  sanctioned `smt.terms.set_thread_safe_interning` helper — the same
  seam the solver pool uses). Results are buffered per sequence number
  and `flush` delivers them in submit order, so the worklist the svm
  sees is IDENTICAL to the K=1 run's (tests/test_stream_retire.py
  gates this).

Failure policy: a job that raises is re-raised at flush time on the
engine thread (the engine's existing explore-failure path then falls
back to the host interpreter — degraded, never wrong)."""

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

log = logging.getLogger(__name__)

#: default ring capacity (chunks). Each entry holds one retire chunk's
#: device arrays + item list — at the default MTPU_RETIRE_CHUNK=1024
#: and full plane caps that is a few MB per entry, so the default
#: bounds deferred host memory to tens of MB at any width.
DEFAULT_CAPACITY = 16


def owner_of(ctx):
    """The owner tag riding a lane ctx (cross-tenant wave packing,
    docs/daemon.md §wave packing) — None outside packed explores.

    This is the ONE sanctioned read of the per-lane owner tag (lint
    rule 10 `owner-tag-read-outside-ring`): routing decisions must
    flow through the ring's delivery seam, so a tenant's states can
    never be consumed under another tenant's identity by an ad-hoc
    attribute peek."""
    return getattr(ctx, "owner", None)


class TenantRouter:
    """Per-tenant delivery sink for packed waves: one worklist per
    owner tag, appended in ring-delivery order — which the ring pins
    to submit order regardless of worker count — so each tenant's
    worklist is IDENTICAL to the one its solo explore would build.
    Quacks like the plain ``results`` list for the ring's
    ``sink.extend`` contract, but takes (owner, state) pairs."""

    def __init__(self, owners):
        self.lists = {owner: [] for owner in owners}

    def deliver(self, owner, state) -> None:
        self.lists[owner].append(state)

    def append(self, pair) -> None:
        owner, state = pair
        self.lists[owner].append(state)

    def extend(self, pairs) -> None:
        for owner, state in pairs:
            self.lists[owner].append(state)


# -- persistent materialization worker pool (ROADMAP item 3b) ---------------
#
# K>=2 rings used to spawn their own worker threads per explore; at
# daemon scale that is thousands of short-lived threads per corpus.
# The pool below is process-wide: the first K>=2 ring spawns the
# workers, every later ring reuses them (`mat_pool_reuses`), and jobs
# from concurrent rings interleave safely — delivery order is pinned
# per ring by its own seq-ordered pending deque, not by completion
# order. K=1 stays zero-thread by construction.

_POOL_CV = threading.Condition()
_POOL_QUEUE: deque = deque()
_POOL_THREADS: List[threading.Thread] = []


def _pool_worker() -> None:
    while True:
        with _POOL_CV:
            while not _POOL_QUEUE:
                _POOL_CV.wait()
            job = _POOL_QUEUE.popleft()
        job.run()


def _ensure_pool(workers: int) -> bool:
    """Grow the shared pool to at least ``workers`` threads; True when
    the pool already satisfied the request (a reuse)."""
    with _POOL_CV:
        need = workers - len(_POOL_THREADS)
        if need <= 0:
            return True
        for i in range(need):
            t = threading.Thread(
                target=_pool_worker,
                name=f"retire-mat-{len(_POOL_THREADS)}",
                daemon=True)
            t.start()
            _POOL_THREADS.append(t)
        return False


def ring_capacity() -> int:
    """MTPU_RETIRE_RING (chunks held before backpressure); min 1."""
    try:
        return max(1, int(os.environ.get("MTPU_RETIRE_RING",
                                         str(DEFAULT_CAPACITY))))
    except ValueError:
        return DEFAULT_CAPACITY


class _Job:
    __slots__ = ("seq", "pull", "build", "submitted_at", "result",
                 "error", "done")

    def __init__(self, seq: int, pull: Callable, build: Callable):
        self.seq = seq
        self.pull = pull          # () -> host rows payload
        self.build = build        # payload -> List[GlobalState]
        self.submitted_at = time.perf_counter()
        self.result: Optional[list] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    def run(self) -> None:
        try:
            self.result = self.build(self.pull())
        except BaseException as e:  # re-raised on the engine thread
            self.error = e
        finally:
            self.done.set()


class RetireRing:
    """Bounded, order-preserving retire/materialize pipeline stage."""

    def __init__(self, workers: int = 1,
                 capacity: Optional[int] = None,
                 sink: Optional[list] = None):
        self.workers = max(1, int(workers))
        self.capacity = capacity if capacity else ring_capacity()
        #: delivery target (the engine's results list); flush() extends
        #: it in submit order
        self.sink = sink if sink is not None else []
        self._pending: deque = deque()  # jobs awaiting delivery
        self._seq = 0
        self.high_water = 0
        if self.workers > 1:
            # worker materialization interns terms concurrently with
            # the engine thread's drain: flip the interning miss path
            # to its serialized mode (idempotent, process-wide)
            from ..smt import terms as T

            T.set_thread_safe_interning(True)
            # persistent pool (ROADMAP item 3b): threads spawn once
            # per process and amortize across explores AND requests
            if _ensure_pool(self.workers):
                from ..smt.solver.solver_statistics import (
                    SolverStatistics,
                )

                SolverStatistics().bump(mat_pool_reuses=1)

    # -- engine side ---------------------------------------------------------

    def submit(self, pull: Callable, build: Callable,
               payload=None) -> None:
        """Queue one retired chunk for ordered delivery. When the ring
        is full the OLDEST pending entry is delivered inline first
        (bounded deferral; the overlap lost is one chunk's worth).

        ``payload`` is the chunk's ALREADY-PULLED host row dict, when
        the engine has one (the fast-retire path): the ring parks it
        through the state codec (support/state_codec.py) — sibling
        lanes share all but O(1) of their planes, so the rows the ring
        retains between submit and flush compress per-column against
        the previous lane. ``pull`` stays the fallback when the codec
        declines (off, or no byte win); deferred device pulls
        (payload None) are untouched — their bytes live on the device
        until flush."""
        if payload is not None and self.workers == 1:
            # K>=2 rings materialize at submit on the worker pool —
            # nothing is parked long enough to be worth encoding
            try:
                from ..support import state_codec

                blob = state_codec.encode_rows(payload)
            except Exception:  # codec trouble never stalls retire
                blob = None
            if blob is not None:
                from ..support.state_codec import decode_rows

                def pull(_blob=blob):  # noqa: F811 - parked form
                    return decode_rows(_blob)
        while len(self._pending) >= self.capacity:
            self._deliver_one()
        job = _Job(self._seq, pull, build)
        self._seq += 1
        self._pending.append(job)
        self.high_water = max(self.high_water, len(self._pending))
        if self.workers > 1:
            with _POOL_CV:
                _POOL_QUEUE.append(job)
                _POOL_CV.notify()

    def _deliver_one(self) -> None:
        job = self._pending.popleft()
        if self.workers > 1:
            job.done.wait()
        else:
            job.run()
        if job.error is not None:
            raise job.error
        self.sink.extend(job.result or ())

    def flush(self) -> None:
        """Deliver every pending chunk into the sink, in submit order.
        The engine calls this in the overlapped phase after the next
        window's dispatch (and once at explore end)."""
        while self._pending:
            self._deliver_one()

    def pending_ctx_sources(self) -> list:
        """Best-effort introspection for the SIGTERM live dump
        (lane_engine.live_seed_states): the `build` closures of pending
        jobs expose their (row, ctx) item lists via a `ring_items`
        attribute when the engine attached one. Signal-safe: reads
        only."""
        out = []
        for job in list(self._pending):
            items = getattr(job.build, "ring_items", None)
            if items:
                out.extend(ctx for _row, ctx in items if ctx is not None)
        return out

    def close(self) -> None:
        """Detach from the shared worker pool (pending jobs are NOT
        delivered — call flush first). The pool threads themselves are
        process-wide and persist for the next explore/request
        (ROADMAP item 3b); undelivered queued jobs from this ring
        still run harmlessly (their results are simply dropped with
        the ring)."""
        self._pending.clear()
