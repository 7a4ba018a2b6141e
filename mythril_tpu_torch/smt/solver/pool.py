"""Persistent pool of parallel solver workers: trie-sharded discharge
with prefix affinity, portfolio racing, and async discharge futures.

PRs 1-3 pipelined the drain, cached verdicts run-wide and sharded
contracts across ranks — but every surviving feasibility query still
executed sequentially in ONE solver context on one thread, and the
corpus long pole (BENCH_r05: `calls.sol.o`, 21.7 s of a 41.4 s run) is
solver-bound, not device-bound. SMT-COMP-style portfolio/parallel
solving (PAPERS: *Bitwuzla at the SMT-COMP 2020*) wins wall-clock on
exactly this query mix by running MORE solver contexts, not smarter
single ones. This module supplies the contexts:

* **K persistent workers** (threads — the native CDCL runs behind
  ctypes, which releases the GIL for the whole solve, so worker solves
  genuinely overlap; K from ``MTPU_SOLVER_WORKERS`` / ``args.solver_workers``,
  default ``min(4, cpu)``). Each worker owns a long-lived incremental
  session (``core._IncrementalSession`` via ``core.set_thread_session``):
  terms it has blasted stay blasted, its learned clauses and
  assumption-trail prefixes persist across calls for the life of the
  run.
* **prefix affinity**: the batched discharge partitions its query trie
  into subtrees (by root constraint tid) and the pool pins each
  subtree to one worker for the whole run — shared prefixes are
  asserted once per WORKER per RUN, extending batch.py's per-call
  prefix dedup to run scope. `affinity_prefix_hits` counts queries
  that landed on a worker already holding part of their prefix.
* **portfolio racing**: a query that comes back UNKNOWN from a short
  first budget escalates to two concurrent attacks — the owning
  worker continues its incremental session (learned clauses retained)
  while a second thread re-attacks one-shot (fresh instance + equality
  propagation, the tactic diversity our pipeline actually has). The
  first definitive verdict calls ``RaceToken.interrupt()`` and the
  loser exits at its next solve slice; a loser NEVER overwrites a
  winner (the token latches under a lock).
* **async futures**: ``submit_async`` runs an orchestration callable
  (a whole discharge / check_batch) on a small side executor and
  returns a :class:`PoolFuture`; the caller collects at the next
  window/round boundary and the future books the solver time that ran
  while the caller was doing other work as ``async_overlap_ms``.
* **worker death**: an unexpected exception escaping a task kills the
  worker; its in-flight and queued items are handed back to the
  caller marked for SERIAL re-discharge (never a lost or false
  verdict), `worker_deaths` counts it, and the pool respawns a fresh
  worker (fresh session) before the next wave.

Serial fallback: at K=1 the pool reports ``parallel == False`` and
every call site keeps today's single-context code path bit-for-bit.

Thread-safety contract (docs/solver_pool.md): term interning flips to
its guarded miss path before the first worker starts; the verdict
cache, SubsetRegistry, ModelCache and SolverStatistics each carry one
coarse lock; only proofs are ever published cross-thread.
"""

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from . import core
from .solver_statistics import SolverStatistics

SAT, UNSAT, UNKNOWN = core.SAT, core.UNSAT, core.UNKNOWN

log = logging.getLogger(__name__)

#: sentinel result for tasks whose worker died: the caller must
#: re-discharge these serially (pool.map_wave docstring)
NEEDS_SERIAL = object()

#: short first-attempt budget before a query escalates to a race
RACE_FIRST_TIMEOUT_S = 0.25
RACE_FIRST_CONFLICTS = 4096

#: orchestration threads for submit_async (discharge futures); solve
#: workers never run orchestration tasks, so a future that fans out
#: onto the workers cannot deadlock against them
_ASYNC_THREADS = 2


def _default_workers() -> int:
    env = os.environ.get("MTPU_SOLVER_WORKERS")
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            log.warning("bad MTPU_SOLVER_WORKERS=%r; using auto", env)
    try:
        from ...support.support_args import args

        if getattr(args, "solver_workers", None):
            return max(1, int(args.solver_workers))
    except Exception:
        pass
    return max(1, min(4, os.cpu_count() or 1))


class RaceToken:
    """First-definitive-verdict-wins latch for a portfolio race. The
    loser polls ``cancelled`` between solve slices (core check's
    ``cancel`` seam) and exits without publishing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self.winner: Optional[str] = None
        self.ctx = None

    def cancelled(self) -> bool:
        return self._event.is_set()

    def interrupt(self) -> None:
        """Stop every still-running racer at its next slice."""
        self._event.set()

    def win(self, tactic: str, ctx) -> bool:
        """Latch a definitive verdict; False if another tactic already
        won (the loser's result is discarded, never overwrites)."""
        with self._lock:
            if self.winner is not None:
                return False
            self.winner = tactic
            self.ctx = ctx
        self.interrupt()
        return True


class _Task:
    __slots__ = ("fn", "done", "result", "needs_serial")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.needs_serial = False


class _Worker:
    def __init__(self, pool: "SolverPool", idx: int):
        self.pool = pool
        self.idx = idx
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.queue: deque = deque()
        self.dead = False
        self.thread = threading.Thread(
            target=self._loop, name=f"mtpu-solver-{idx}", daemon=True)
        self.thread.start()

    def submit(self, task: _Task) -> bool:
        with self.lock:
            if self.dead:
                return False
            self.queue.append(task)
            self.cond.notify()
            return True

    def _loop(self) -> None:
        # the worker's private incremental session lives in core's
        # thread-locals: every core.check() on this thread uses it
        # lock-free, and reset_session() retires it via the generation
        # stamp without cross-thread teardown
        core.ensure_thread_session()
        while True:
            with self.lock:
                while not self.queue and not self.dead:
                    self.cond.wait()
                if self.dead:
                    return
                task = self.queue.popleft()
            try:
                inject = self.pool.fail_injector
                if inject is not None:
                    inject(self.idx, task)
                from ...support.telemetry import trace

                with trace.span("solver.pooled_task",
                                worker=self.idx):
                    task.result = task.fn()
                task.done.set()
            except Exception as e:
                # unexpected failure: this worker's session may be
                # poisoned — mark the in-flight query and everything
                # still queued here for SERIAL re-discharge on the
                # caller (verdicts are re-derived, never guessed) and
                # retire the worker; the pool respawns a fresh one
                # (fresh session) before the next wave.
                log.warning("solver worker %d died: %r", self.idx, e)
                SolverStatistics().bump(worker_deaths=1)
                task.needs_serial = True
                task.done.set()
                with self.lock:
                    self.dead = True
                    drained = list(self.queue)
                    self.queue.clear()
                for t in drained:
                    t.needs_serial = True
                    t.done.set()
                return

    def kill(self) -> None:
        with self.lock:
            self.dead = True
            drained = list(self.queue)
            self.queue.clear()
            self.cond.notify_all()
        for t in drained:
            t.needs_serial = True
            t.done.set()


class PoolFuture:
    """Result handle for submit_async. ``result()`` blocks until the
    task finishes; the first collection books the portion of the
    task's wall time that ran while the caller was elsewhere as
    ``async_overlap_ms`` (total duration minus the caller's blocked
    wait — the solver CPU time that actually hid behind device
    execution or other host work)."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._t_submit = time.perf_counter()
        self._t_done: Optional[float] = None
        self._collected = False

    def _finish(self, result=None, exc: Optional[BaseException] = None):
        self._result = result
        self._exc = exc
        self._t_done = time.perf_counter()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def duration_ms(self) -> float:
        if self._t_done is None:
            return 0.0
        return (self._t_done - self._t_submit) * 1000.0

    def result(self, timeout: Optional[float] = None):
        t0 = time.perf_counter()
        if not self._event.wait(timeout):
            raise TimeoutError("solver pool future still running")
        if not self._collected:
            self._collected = True
            blocked_ms = (time.perf_counter() - t0) * 1000.0
            overlap = max(0.0, self.duration_ms - blocked_ms)
            SolverStatistics().bump(async_overlap_ms=overlap)
        if self._exc is not None:
            raise self._exc
        return self._result


class SolverPool:
    """See module docstring. One instance per process (get_pool)."""

    def __init__(self, workers: Optional[int] = None,
                 racing: bool = True,
                 first_timeout_s: float = RACE_FIRST_TIMEOUT_S,
                 first_conflicts: int = RACE_FIRST_CONFLICTS):
        self.n_workers = workers if workers else _default_workers()
        self.racing = racing
        self.first_timeout_s = first_timeout_s
        self.first_conflicts = first_conflicts
        #: test hook: callable(worker_idx, task) raised from a worker
        #: simulates an unexpected solver exception (worker death)
        self.fail_injector: Optional[Callable] = None
        self._lock = threading.Lock()
        self._workers: List[Optional[_Worker]] = []
        self._affinity: Dict[object, int] = {}
        self._wave_load: List[int] = []
        self._async_workers: List[_Worker] = []
        self._started = False
        SolverStatistics().pool_workers = self.n_workers

    # -- lifecycle ---------------------------------------------------------

    @property
    def parallel(self) -> bool:
        """True when pooled discharge should engage; at K=1 every call
        site keeps the serial single-context path bit-for-bit."""
        return self.n_workers > 1

    def _start(self) -> None:
        with self._lock:
            if self._started:
                return
            # the workers intern terms (ackermann vars, substitution
            # results) concurrently with the main thread: the miss
            # path must be serialized BEFORE the first worker exists
            from .. import terms as T

            T.set_thread_safe_interning(True)
            self._workers = [_Worker(self, i)
                             for i in range(self.n_workers)]
            self._wave_load = [0] * self.n_workers
            self._started = True

    def _ensure_workers(self) -> None:
        self._start()
        with self._lock:
            for i, w in enumerate(self._workers):
                if w is None or w.dead:
                    self._workers[i] = _Worker(self, i)

    def shutdown(self) -> None:
        """Stop worker threads (tests / reconfiguration)."""
        with self._lock:
            workers = [w for w in self._workers if w is not None]
            workers += self._async_workers
            self._workers = []
            self._async_workers = []
            self._started = False
        for w in workers:
            w.kill()

    # -- trie-subtree affinity --------------------------------------------

    def worker_for(self, root_key) -> int:
        """The worker pinned to a discharge subtree (the trie root's
        constraint tid). First sight assigns the least-loaded worker
        THIS wave and the pin persists for the run, so a subtree's
        shared prefix stays blasted in one session across calls."""
        with self._lock:
            w = self._affinity.get(root_key)
            if w is None:
                w = min(range(self.n_workers),
                        key=lambda i: self._wave_load[i])
                self._affinity[root_key] = w
            self._wave_load[w] += 1
            return w

    def begin_wave(self) -> None:
        """Reset the per-wave load balance counters (affinity pins are
        kept — they are the point)."""
        with self._lock:
            self._wave_load = [0] * self.n_workers

    # -- wave execution ----------------------------------------------------

    def map_wave(self, items: List[Tuple[object, Callable]]) -> List:
        """Run ``(root_key, fn)`` items on the workers with subtree
        affinity; returns results in input order. An item whose worker
        died comes back as NEEDS_SERIAL — the caller re-runs it through
        its serial path (same screens, same budgets), so a death can
        slow a wave but never change a verdict."""
        self._ensure_workers()
        self.begin_wave()
        ss = SolverStatistics()
        ss.bump(queries_pooled=len(items))
        tasks: List[_Task] = []
        for root_key, fn in items:
            t = _Task(fn)
            tasks.append(t)
            w = self._workers[self.worker_for(root_key)]
            if w is None or not w.submit(t):
                t.needs_serial = True
                t.done.set()
        out = []
        for t in tasks:
            t.done.wait()
            out.append(NEEDS_SERIAL if t.needs_serial else t.result)
        return out

    # -- portfolio racing --------------------------------------------------

    def race(self, work, timeout_s: float, conflict_budget: int):
        """Re-attack a hard query (first short budget returned UNKNOWN)
        with two concurrent tactics; returns the winning CheckContext
        or None when both exhausted their budgets.

        Tactic ``incremental`` continues on the CALLING thread's
        session — its learned clauses from the first attempt carry
        over. Tactic ``oneshot`` solves on a fresh instance with
        equality propagation (core's one-shot pipeline), the
        preprocessing diversity that pays off exactly when the
        incremental attack is stuck. The first definitive verdict
        interrupts the other via the RaceToken."""
        from ...support.telemetry import trace

        ss = SolverStatistics()
        ss.bump(portfolio_races=1)
        token = RaceToken()

        def attack(tactic: str, force_oneshot: bool) -> None:
            try:
                with trace.query_context(tier="pool.race",
                                         tactic=tactic):
                    ctx = core.check(
                        work, timeout_s=timeout_s,
                        conflict_budget=conflict_budget,
                        cancel=token.cancelled,
                        force_oneshot=force_oneshot,
                    )
            except Exception as e:  # a racer, never an error path
                log.debug("race tactic %s failed: %s", tactic, e)
                return
            if ctx.status in (SAT, UNSAT) and token.win(tactic, ctx):
                ss.bump_race_win(tactic)

        with trace.span("solver.race", n=len(work)) as sp:
            rival = threading.Thread(
                target=attack, args=("oneshot", True),
                name="mtpu-race-oneshot", daemon=True)
            rival.start()
            attack("incremental", False)
            rival.join()
            sp.set(winner=token.winner or "none")
        return token.ctx

    def solve_query(self, work, timeout_s: float, conflict_budget: int):
        """One pooled query: short-budget first attempt on this
        thread's session, then (racing on) the 2-tactic portfolio
        escalation. Returns a CheckContext.

        With warm-store routing history for this query's shape
        (support/warm_store.py, docs/warm_store.md) the first attempt
        uses the LEARNED tactic and budget instead of the fixed short
        incremental probe, and the race is demoted to the fallback —
        it only runs when the routed try comes back UNKNOWN. Shapes
        with no history keep today's escalation bit-for-bit."""
        from ...support.telemetry import trace

        route = None
        try:
            from ...support import warm_store

            route = warm_store.route_for_query(len(work), timeout_s)
        except (KeyboardInterrupt, MemoryError):
            raise  # fatal, never a degrade
        except Exception:  # a hint, never an error path
            route = None
        if route is not None:
            r_tactic, r_budget = route
            t0 = time.monotonic()
            with trace.query_context(tier="pool.first",
                                     tactic="routed." + r_tactic):
                ctx = core.check(work,
                                 timeout_s=min(r_budget, timeout_s),
                                 conflict_budget=conflict_budget,
                                 force_oneshot=r_tactic == "oneshot")
            if ctx.status != UNKNOWN:
                SolverStatistics().bump(route_first_try_wins=1)
                return ctx
            if not self.racing:
                return ctx
            remaining = max(timeout_s - (time.monotonic() - t0),
                            0.25 * timeout_s)
            won = self.race(work, remaining, conflict_budget)
            return won if won is not None else ctx
        first_to = timeout_s
        first_cb = conflict_budget
        escalate = self.racing and (
            timeout_s > self.first_timeout_s
            or (conflict_budget or 0) > self.first_conflicts)
        if escalate:
            first_to = min(timeout_s, self.first_timeout_s)
            if conflict_budget:
                first_cb = min(conflict_budget, self.first_conflicts)
            else:
                first_cb = self.first_conflicts
        t0 = time.monotonic()
        from ...support.telemetry import trace

        with trace.query_context(tier="pool.first"):
            ctx = core.check(work, timeout_s=first_to,
                             conflict_budget=first_cb)
        if ctx.status != UNKNOWN or not escalate:
            return ctx
        # the race budget is the NOMINAL remainder, floored at a
        # quarter of the full budget: under K-way CPU contention the
        # wall-measured remainder can hit zero while the first attempt
        # was merely starved, and an UNKNOWN that never races defeats
        # the escalation (the floor costs at most 1.25x the serial
        # per-query budget, paid concurrently across workers)
        remaining = max(timeout_s - (time.monotonic() - t0),
                        0.25 * timeout_s)
        won = self.race(work, remaining, conflict_budget)
        return won if won is not None else ctx

    # -- async orchestration ----------------------------------------------

    def submit_async(self, fn: Callable) -> PoolFuture:
        """Run ``fn`` on the orchestration side-executor; the caller
        collects the PoolFuture at its next window/round boundary.
        With the pool disabled (K=1) the task runs inline and a
        completed future returns — call sites need no second code
        path for the serial fallback."""
        fut = PoolFuture()
        if not self.parallel:
            try:
                fut._finish(result=fn())
            except BaseException as e:
                fut._finish(exc=e)
            return fut
        self._start()
        with self._lock:
            if not self._async_workers:
                self._async_workers = [
                    _AsyncRunner(f"mtpu-solver-async-{i}")
                    for i in range(_ASYNC_THREADS)]
            runner = min(self._async_workers, key=lambda r: r.load)

        def run():
            try:
                fut._finish(result=fn())
            except BaseException as e:
                fut._finish(exc=e)

        runner.submit_fn(run)
        return fut


class _AsyncRunner:
    """Minimal FIFO thread for orchestration tasks (discharge
    futures). Separate from the solve workers so a future that fans
    out onto them cannot deadlock."""

    def __init__(self, name: str):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.queue: deque = deque()
        self.load = 0
        self.dead = False
        self.thread = threading.Thread(target=self._loop, name=name,
                                       daemon=True)
        self.thread.start()

    def submit_fn(self, fn) -> None:
        with self.lock:
            self.queue.append(fn)
            self.load += 1
            self.cond.notify()

    def kill(self) -> None:
        with self.lock:
            self.dead = True
            self.queue.clear()
            self.cond.notify_all()

    def _loop(self) -> None:
        while True:
            with self.lock:
                while not self.queue and not self.dead:
                    self.cond.wait()
                if self.dead:
                    return
                fn = self.queue.popleft()
            try:
                fn()
            finally:
                with self.lock:
                    self.load -= 1


_POOL: Optional[SolverPool] = None
_POOL_LOCK = threading.Lock()


def get_pool() -> SolverPool:
    """The process-wide pool, built lazily from env/args config."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = SolverPool()
    return _POOL


def configure_pool(workers: Optional[int] = None, racing: bool = True,
                   first_timeout_s: float = RACE_FIRST_TIMEOUT_S,
                   first_conflicts: int = RACE_FIRST_CONFLICTS,
                   ) -> SolverPool:
    """Replace the process pool (tests, bench stages, corpus CLI).
    Stops the previous pool's workers; their sessions are garbage."""
    global _POOL
    with _POOL_LOCK:
        old, _POOL = _POOL, None
    if old is not None:
        old.shutdown()
    pool = SolverPool(workers=workers, racing=racing,
                      first_timeout_s=first_timeout_s,
                      first_conflicts=first_conflicts)
    with _POOL_LOCK:
        _POOL = pool
    return pool


def reset_pool_sessions() -> None:
    """Retire every worker session (rides core.reset_session's
    generation bump — nothing to do here beyond the core call; kept
    as an explicit seam for callers that import only the pool)."""
    core.reset_session()
