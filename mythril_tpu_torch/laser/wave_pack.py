"""Cross-tenant wave packing: co-schedule several requests' lanes in
one device wave (docs/daemon.md §wave packing; master gate ``MTPU_PACK``
default ON, ``=0`` bit-for-bit one-request-per-wave).

The resident daemon (PR 14) serves a queue of small contracts one at a
time: each request dispatches its own mostly-padding device wave and
pays the whole window boundary alone. This module closes ROADMAP item
1's batching half (and item 3c's drain-side twin): compatible requests
run as ONE :class:`PackGroup`, their analyses interleaved on a strict
baton — exactly one member executes host work at any instant — and
their lane waves folded into one packed explore
(``LaneEngine.explore_packed`` over a ``compile_packed_code`` segment
arena) whose retires route back per tenant through the retire ring's
:class:`~mythril_tpu_torch.laser.retire_ring.TenantRouter`.

**The baton.** Every member runs its unmodified analyzer pipeline
(``MythrilAnalyzer.fire_lasers``) on its own thread, but only the
baton holder executes; the others are parked in ``Condition.wait``.
A member yields the baton at exactly two points: when its svm sweep
wants a device wave (``_Client.explore`` — the wave barrier), and when
its analysis finishes. Per-analysis global state swaps at every switch
through seams that already exist for alternating analyzers:

* ``RunContext.activate`` — keccak axioms, model caches, the serial
  solver session, detector-module issue lists, the Args flag values
  (each member's own ``checkpoint_file``/timeout snapshot re-applies);
* ``TimeHandler.snapshot/restore`` — one member's deadline re-arm
  never widens or shortens another's window;
* ``warm_store.swap_analysis`` — the begin/end-analysis bracket (code
  hash, verdict-bank mark, static keys) parks with its member, so
  per-request banks keep per-code attribution.

**The wave barrier.** A member arriving at the barrier parks its
(code, entry states) submission and hands the baton on. When every
live member is parked at the barrier, the LAST arrival becomes the
dispatcher: one submission runs the member's own engine solo
(bit-for-bit the unpacked path — this is also why a pack degenerates
gracefully as members finish at different speeds), two or more run as
one packed explore on a shared engine sized for the combined wave.
Results deliver per owner; a dispatch exception is delivered to every
waiting member, whose sweep raises it: each of those requests ends
with the error (no member re-runs its states on the host). The baton
walks the members as each wakes.

**Attribution.** SolverStatistics counters are snapshot/diffed at
every baton switch and credited to the member that held it; a packed
dispatch's own delta books to the group's shared bucket
(``shared_counters``), so per-request reports never bleed counters
across members (tests/test_wave_pack.py). Drain-time site firing
inside a packed explore activates the lane owner's RunContext
(``LaneEngine.owner_context``), so issues land in the owning request's
detector lists.
"""

import logging
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

_TLS = threading.local()

#: largest combined member count per pack (admission-side cap)
DEFAULT_PACK_MAX = 4


def enabled() -> bool:
    """MTPU_PACK master gate (default on; =0 one-request-per-wave)."""
    return os.environ.get("MTPU_PACK", "1") != "0"


def pack_max() -> int:
    try:
        return max(2, int(os.environ.get("MTPU_PACK_MAX",
                                         str(DEFAULT_PACK_MAX))))
    except ValueError:
        return DEFAULT_PACK_MAX


def current_client():
    """The pack client of the calling thread (None outside member
    threads) — consulted by svm._lane_engine_sweep at the explore
    seam."""
    return getattr(_TLS, "client", None)


_RUNNABLE, _WAVE, _DONE = range(3)
_PENDING = object()
_UNSET = object()


class _Member:
    def __init__(self, group: "PackGroup", owner, run_fn):
        self.group = group
        self.owner = owner
        self.run_fn = run_fn
        self.state = _RUNNABLE
        self.result = None
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None
        # context parked at switch-out
        self.run_ctx = None
        self.th_deadline = None
        self.warm_state = _UNSET
        self.counters: Dict[str, float] = {}
        # wave barrier submission / delivery
        self.wave = None           # (laser, engine, code, states)
        self.wave_result = _PENDING


class _Client:
    """Thread-local explore interceptor for one member."""

    def __init__(self, group: "PackGroup", member: _Member):
        self.group = group
        self.member = member

    def explore(self, laser, engine, code, states):
        return self.group._wave_barrier(self.member, laser, engine,
                                        code, states)


class PackGroup:
    """One co-scheduled batch of requests (see module docstring)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._members: List[_Member] = []
        self._by_owner: Dict[object, _Member] = {}
        self._turn: Optional[_Member] = None
        self.shared_counters: Dict[str, float] = {}
        self._c_mark: Optional[dict] = None

    # -- public API ----------------------------------------------------------

    def add_member(self, owner, run_fn) -> None:
        m = _Member(self, owner, run_fn)
        self._members.append(m)
        self._by_owner[owner] = m

    def run(self) -> Dict[object, _Member]:
        """Run every member to completion (the caller's thread only
        coordinates); returns {owner: member} with result/error and
        the per-member counter deltas."""
        assert self._members, "empty pack"
        for m in self._members:
            m.thread = threading.Thread(
                target=self._thread_body, args=(m,),
                name=f"mtpu-pack-{m.owner}", daemon=True)
            m.thread.start()
        with self._cond:
            self._turn = self._members[0]
            self._cond.notify_all()
        for m in self._members:
            m.thread.join()
        return dict(self._by_owner)

    # -- counter attribution -------------------------------------------------

    @staticmethod
    def _counters_now() -> dict:
        from ..smt.solver.solver_statistics import SolverStatistics

        return {k: v
                for k, v in SolverStatistics().batch_counters().items()
                if isinstance(v, (int, float))}

    def _credit(self, into: Dict[str, float]) -> None:
        """Close the open counter interval into ``into``."""
        if self._c_mark is None:
            return
        now = self._counters_now()
        for k, v in now.items():
            d = v - self._c_mark.get(k, 0)
            if d:
                into[k] = round(into.get(k, 0) + d, 1)
        self._c_mark = None

    def counters_for(self, owner) -> Dict[str, float]:
        """Finalize and return the member's attributed counter deltas
        (called from the member's own thread while it holds the
        baton — the open interval closes into the member first)."""
        m = self._by_owner[owner]
        self._credit(m.counters)
        self._c_mark = self._counters_now()
        return dict(m.counters)

    # -- context switching ---------------------------------------------------

    def _switch_out(self, m: _Member) -> None:
        from ..laser.time_handler import time_handler
        from ..support import run_context, warm_store

        m.run_ctx = run_context.current()
        m.th_deadline = time_handler.snapshot()
        m.warm_state = warm_store.swap_analysis(None)
        self._credit(m.counters)

    def _switch_in(self, m: _Member) -> None:
        from ..laser.time_handler import time_handler
        from ..support import warm_store

        if m.run_ctx is not None:
            m.run_ctx.activate()
        if m.th_deadline is not None:
            time_handler.restore(m.th_deadline)
        warm_store.swap_analysis(
            None if m.warm_state is _UNSET else m.warm_state)
        m.warm_state = _UNSET
        self._c_mark = self._counters_now()

    @contextmanager
    def owner_context(self, owner):
        """Activate ``owner``'s RunContext for a drain-time site
        firing inside a packed explore (LaneEngine.owner_context)."""
        from ..support import run_context

        m = self._by_owner.get(owner)
        target = m.run_ctx if m is not None else None
        prev = run_context.current()
        if target is None or target is prev:
            yield
            return
        target.activate()
        try:
            yield
        finally:
            if prev is not None:
                prev.activate()

    # -- baton / barrier machinery ------------------------------------------

    def _next_runnable(self) -> Optional[_Member]:
        for m in self._members:
            if m.state == _RUNNABLE:
                return m
        return None

    def _thread_body(self, m: _Member) -> None:
        _TLS.client = _Client(self, m)
        try:
            with self._cond:
                while self._turn is not m:
                    self._cond.wait()
            self._switch_in(m)
            try:
                m.result = m.run_fn()
            except BaseException as e:  # delivered to the daemon
                m.error = e
                log.debug("pack member %s failed: %s", m.owner, e)
            with self._cond:
                self._credit(m.counters)
                m.state = _DONE
                self._hand_over()
        finally:
            _TLS.client = None

    def _hand_over(self) -> None:
        """Pass the baton onward (callers hold the lock). When no
        member is runnable but some wait at the wave barrier, the
        CALLING thread dispatches their wave — it is the only thread
        awake."""
        nxt = self._next_runnable()
        if nxt is not None:
            self._turn = nxt
            self._cond.notify_all()
            return
        waiting = [w for w in self._members if w.state == _WAVE]
        if waiting:
            self._run_wave(waiting)
            self._turn = waiting[0]
            self._cond.notify_all()
            return
        self._turn = None
        self._cond.notify_all()

    def _wave_barrier(self, m: _Member, laser, engine, code, states):
        """The explore seam: park this member's wave, pass the baton,
        dispatch when last, resume with the delivered result."""
        with self._cond:
            m.wave = (laser, engine, code, list(states))
            m.wave_result = _PENDING
            m.state = _WAVE
            # SIGTERM coverage: these states left the worklist — the
            # live-dump path re-enters them (checkpoint.py)
            laser._pack_pending_states = m.wave[3]
            self._switch_out(m)
            self._hand_over()
            while not (self._turn is m
                       and m.wave_result is not _PENDING):
                self._cond.wait()
            result = m.wave_result
            m.wave_result = _PENDING
            m.wave = None
            laser._pack_pending_states = None
        self._switch_in(m)
        if isinstance(result, BaseException):
            raise result
        return result

    # -- wave dispatch -------------------------------------------------------

    def _run_wave(self, waiting: List[_Member]) -> None:
        """Dispatch the parked submissions (callers hold the lock; the
        device work runs on the calling thread). One waiter runs its
        own engine solo — bit-for-bit the unpacked path; two or more
        fold into one packed explore. Counter deltas of the dispatch
        book to the group's shared bucket."""
        self._c_mark = self._counters_now()
        try:
            if len(waiting) == 1:
                w = waiting[0]
                _laser, engine, code, states = w.wave
                w.wave_result = engine.explore(code, states)
            else:
                by_owner = self._explore_packed(waiting)
                for w in waiting:
                    w.wave_result = by_owner[w.owner]
        except (KeyboardInterrupt, MemoryError):
            raise
        except BaseException as e:
            # every waiter's sweep raises it: its request ends with
            # the error
            for w in waiting:
                w.wave_result = e
        finally:
            self._credit(self.shared_counters)
            for w in waiting:
                w.state = _RUNNABLE

    def _explore_packed(self, waiting: List[_Member]) -> dict:
        from .lane_engine import pick_width

        first = waiting[0].wave[1]
        # the packed wave is no wider than the widest member's solo
        # wave would have been (admission requires equal tpu_lanes, so
        # this is the shared cap): packing then strictly RAISES
        # per-dispatch occupancy, and an entry backlog drains over
        # extra seed windows exactly like an overloaded solo wave.
        # pick_width still applies the capacity autoprobe clamp.
        cap = max(w.wave[1].n_lanes for w in waiting)
        entries = sum(len(w.wave[3]) for w in waiting)
        width = pick_width(cap, entries)
        engine = _pack_engine(width, first)
        engine.owner_context = self.owner_context
        try:
            out = engine.explore_packed([
                (w.wave[2], w.wave[3], w.owner) for w in waiting])
        finally:
            engine.owner_context = None
        # per-member coverage lands on the MEMBER's engine, where its
        # svm reads it after the sweep
        for w in waiting:
            code = w.wave[2]
            vis = engine.visited_by_code.get(code)
            if vis is not None:
                w.wave[1].visited_by_code[code] = vis
        return out


#: packed engines persist like svm's per-code engines: keyed by the
#: shared config so the device planes, jit variants and object tables
#: stay warm across packs (bounded — the state pool caps device
#: memory per shape)
_PACK_ENGINES: Dict[tuple, object] = {}


def _pack_engine(width: int, template_engine):
    from .lane_engine import LaneEngine

    key = (width, template_engine.blocked_ops,
           tuple(id(a) for a in template_engine.adapters),
           template_engine.slim_stop)
    engine = _PACK_ENGINES.get(key)
    if engine is None:
        engine = LaneEngine(
            n_lanes=width,
            blocked_ops=set(template_engine.blocked_ops),
            adapters=list(template_engine.adapters),
            slim_stop=template_engine.slim_stop)
        if len(_PACK_ENGINES) > 8:
            _PACK_ENGINES.pop(next(iter(_PACK_ENGINES)))
        _PACK_ENGINES[key] = engine
    return engine
