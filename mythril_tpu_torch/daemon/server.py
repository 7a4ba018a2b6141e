"""The resident analysis daemon (docs/daemon.md).

``myth serve --out-dir DIR`` runs one :class:`AnalysisDaemon`: a
long-lived process listening on a Unix-domain socket
(``DIR/daemon.sock`` by default) whose requests all share the state
that is expensive to rebuild per process:

* the **kernels and code planes** — every CUDA kernel is built once
  at startup (no request pays a build; a failed build ends the
  daemon), and lane_engine's compiled-code planes persist across
  requests (``compile_reuse_hits`` counts a code-plane hit whose
  compile was paid by an EARLIER request);
* the **static-pass memo** (cold-slot import rule unchanged) and the
  process-wide verdict cache;
* **one warm-store directory** (``DIR/warm``) serving every tenant —
  the PR-13 cross-run half and this daemon are the two halves of
  ROADMAP item 1;
* the **solver pool + incremental sessions** kept hot:
  ``core.set_keep_sessions(True)`` makes ``reset_session``'s
  per-analysis retirement a no-op (sessions hold only universally
  valid clauses, so this is a perf policy, not a soundness one —
  see core.reset_session), and the serving thread pins its own
  session so K=1 keeps warm state too.

**Isolation** rides the seams PR 12 hardened: every request gets a
fresh ``MythrilAnalyzer`` (own RunContext: keccak axioms, model
caches, detector issue lists, Args snapshot), ``fire_lasers`` resets
the per-analysis globals (``reset_analysis_state`` /
``TimeHandler.clear``), and telemetry/flight-recorder scope rebinds
to the request's own ``DIR/requests/<id>/`` directory.

**Scheduling**: the queue orders by the persisted cost model —
``DIR/stats.json`` walls (EMA-merged across requests and corpus
runs) drive LPT (when a worker frees it takes the longest predicted
pending request; requests predicted above the fair share
``total/workers`` are flagged splittable for the migration layer),
with FIFO as the fallback whenever no pending request has a known
cost. ``queue_wait_ms`` books the enqueue→start latency.

**Drain/resume** rides the PR-10 live-checkpoint path: SIGTERM
persists the queue (pending + in-flight) to ``DIR/daemon_queue.json``
and lets the flight recorder dump the in-flight analysis's live lane
plane into its per-request checkpoint; a restarted daemon adopts the
completed requests' done-rows (``DIR/requests/<id>.json``),
re-enqueues the interrupted request FIRST (``requests_resumed``) and
its analysis resumes from the checkpoint instead of restarting.
"""

import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time
from hashlib import sha256
from pathlib import Path
from typing import Dict, List, Optional

from . import SOCKET_NAME, protocol

log = logging.getLogger(__name__)

#: daemon_queue.json format version (skewed files are ignored whole —
#: a restarted daemon then simply starts with an empty queue)
QUEUE_VERSION = 1

#: request fields a client may set, with defaults (the analyze
#: surface the daemon accepts). The analyzer-relevant knobs all
#: travel with the request — identity with a one-shot run holds only
#: when BOTH ran the same flags, so the client sends its own values
#: rather than trusting the server's defaults to match
#: (pruning_factor alone flips on the execution-timeout value).
REQUEST_DEFAULTS = {
    "code": None,            # hex bytecode (required)
    "bin_runtime": True,     # False = creation bytecode
    "name": None,            # cost-model key (e.g. fixture basename)
    "timeout": 60,           # execution_timeout seconds
    "tpu_lanes": 0,          # lane-engine width (0 = host)
    "transaction_count": 2,
    "modules": None,         # detector subset (None = all)
    "outform": "json",       # rendered output format for the client
    "strategy": "bfs",
    "max_depth": 128,
    "call_depth_limit": 3,
    "loop_bound": 3,
    "create_timeout": 10,
    "solver_timeout": 10000,  # ms
    "no_onchain_data": True,
    "pruning_factor": None,
    "unconstrained_storage": False,
    "disable_dependency_pruning": False,
    "transaction_sequences": None,
}


def _now_ms() -> float:
    return time.monotonic() * 1000.0


class Request:
    """One queued analysis submission."""

    _SEQ = [0]

    def __init__(self, payload: dict, conn=None, resumed: bool = False):
        self.conn = conn
        self.resumed = resumed
        self.params = dict(REQUEST_DEFAULTS)
        for key in REQUEST_DEFAULTS:
            if key in payload and payload[key] is not None:
                self.params[key] = payload[key]
        code = self.params.get("code")
        if not isinstance(code, str) or not code:
            raise ValueError("analyze request needs hex 'code'")
        self.params["code"] = code = code.lower().replace("0x", "")
        self.code_hash = sha256(code.encode()).hexdigest()
        # the id names filesystem entries under requests/ — a
        # client-supplied one must not traverse out of it
        rid = str(payload.get("id") or self.code_hash[:16])
        if not rid.replace("-", "").replace("_", "").isalnum() \
                or len(rid) > 64:
            rid = self.code_hash[:16]
        self.id = rid
        Request._SEQ[0] += 1
        self.seq = Request._SEQ[0]
        self.enqueued_ms = _now_ms()
        self.splittable = False
        self.predicted_s: Optional[float] = None

    @property
    def cost_key(self) -> str:
        """stats.json key: the client's name (so daemon submissions
        share cost history with corpus runs over the same out-dir),
        else a stable code-hash key."""
        return self.params.get("name") or ("code:" + self.code_hash[:16])

    def to_dict(self) -> dict:
        return {"id": self.id, "resumed": self.resumed,
                "params": dict(self.params)}


class AnalysisDaemon:
    """See module docstring. One instance per ``myth serve``."""

    def __init__(self, out_dir, socket_path: Optional[str] = None,
                 workers: int = 1, keep_sessions: bool = True):
        self.out = Path(out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.socket_path = str(socket_path or self.out / SOCKET_NAME)
        self.workers = max(1, int(workers))
        self.keep_sessions = keep_sessions
        self.queue_path = self.out / "daemon_queue.json"
        self.requests_dir = self.out / "requests"
        self.requests_dir.mkdir(exist_ok=True)
        # RLock: the SIGTERM handler runs ON the serving (main)
        # thread and must be able to snapshot the queue even when it
        # interrupted a short critical section that already holds the
        # lock — a plain Lock would deadlock the dying process
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[Request] = []
        #: worker idx -> the request(s) it is serving (one normally;
        #: several when a packed wave co-schedules a batch —
        #: docs/daemon.md §wave packing)
        self._active: Dict[int, List[Request]] = {}
        self._stop = threading.Event()
        self._drain = True
        self._listener = None
        self._threads: List[threading.Thread] = []
        self._stats: Dict[str, dict] = {}
        self._completed = 0
        #: session code-affinity (see _retire_sessions_on_code_change)
        self._last_code_hash: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------

    def _configure_shared_state(self) -> None:
        """Arm the process-wide state every request shares. On the card
        (unless ``args.device`` names the CPU) every kernel is built
        first, so no request pays a build; a missing card or a failed
        build raises and ends the daemon."""
        from ..parallel.cost_model import load_stats, load_width_clamp
        from ..smt.solver import core
        from ..support import telemetry, warm_store
        from ..support.devices import resolve

        if resolve().type == "cuda":
            from .. import _build

            took = _build.build_all()
            if took:
                log.info("kernels built in %.1f s: %s",
                         max(took.values()), ", ".join(sorted(took)))
        telemetry.configure(out_dir=str(self.out), rank=0)
        warm_store.configure(str(self.out))
        self._stats = load_stats(self.out)
        load_width_clamp(self.out)
        if self.keep_sessions:
            # satellite 2 (docs/daemon.md §shared-state): the
            # per-analysis session retirement becomes a no-op so
            # worker sessions stay hot across requests
            core.set_keep_sessions(True)

    def run(self) -> int:
        """Bind, adopt a persisted queue, serve until shutdown.

        The MAIN thread is analysis worker 0 and the accept loop runs
        in the background — not the other way around — because signal
        handlers run on the main thread: a SIGTERM then freezes the
        in-flight analysis at a bytecode boundary while the flight
        recorder snapshots its live lane plane, exactly the
        consistency the one-shot/corpus SIGTERM path relies on. (At
        --workers K>1 the side workers keep running through a dump;
        their requests resume from their round-boundary checkpoints
        instead of a mid-round plane — K=1 is the default per the
        single-CPU pool policy.)"""
        self._configure_shared_state()
        self._adopt_persisted_queue()
        self._listener = protocol.listen_unix(self.socket_path)
        self._install_sigterm()
        for i in range(1, self.workers):
            t = threading.Thread(target=self._worker_loop, args=(i,),
                                 name=f"mtpu-daemon-worker-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        accept = threading.Thread(target=self._accept_loop,
                                  name="mtpu-daemon-accept",
                                  daemon=True)
        accept.start()
        log.info("daemon listening on %s (out-dir %s, %d worker%s)",
                 self.socket_path, self.out, self.workers,
                 "" if self.workers == 1 else "s")
        print(f"daemon ready on {self.socket_path}", flush=True)
        try:
            self._worker_loop(0)
            # graceful stop (shutdown op): drain=True finishes the
            # whole queue; drain=False finishes in-flight requests
            # and persists the pending tail for a successor to adopt
            with self._cond:
                while self._active or (self._drain and self._pending):
                    self._cond.wait(timeout=0.5)
            if not self._drain:
                self._persist_queue(include_active=False)
        finally:
            self._teardown()
        return 0

    def _teardown(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def _install_sigterm(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)
        except (ValueError, OSError):  # pragma: no cover - exotic env
            return

        def handler(signum, frame):
            # drain order matters: the queue file must land BEFORE the
            # flight recorder's live dump (the dump can only make the
            # interrupted request MORE resumable, never less), and both
            # before the process dies
            self._persist_queue(include_active=True)
            self._stop.set()
            from ..support.telemetry import flightrec

            flightrec.dump("SIGTERM")
            self._teardown()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):  # pragma: no cover - exotic env
            pass

    # -- queue persistence / adoption --------------------------------------

    def _persist_queue(self, include_active: bool = False) -> None:
        """Atomically write the resumable queue snapshot."""
        with self._lock:
            pending = [r.to_dict() for r in self._pending]
            interrupted = [r.to_dict() for reqs in
                           self._active.values() for r in reqs] \
                if include_active else []
        payload = {"version": QUEUE_VERSION, "pending": pending,
                   "interrupted": interrupted}
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.out),
                                       prefix=".queue-")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.queue_path)
        except OSError as e:  # best-effort: drain must still proceed
            log.warning("queue persist failed: %s", e)

    def _adopt_persisted_queue(self) -> None:
        """Re-enqueue what a SIGTERM'd predecessor left: interrupted
        requests FIRST (their per-request checkpoint resumes them),
        then the still-pending tail in its original order. Done-rows
        under requests/ need no adoption — they are served by id."""
        if not self.queue_path.exists():
            return
        from ..smt.solver.solver_statistics import SolverStatistics

        try:
            payload = json.loads(self.queue_path.read_text())
            if payload.get("version") != QUEUE_VERSION:
                raise ValueError("queue version skew")
        except (KeyboardInterrupt, MemoryError):
            raise
        except Exception as e:
            log.warning("persisted queue unreadable (%s); starting "
                        "empty", e)
            try:
                os.replace(self.queue_path,
                           str(self.queue_path) + ".corrupt")
            except OSError:
                pass
            return
        adopted = resumed = 0
        for row in payload.get("interrupted") or ():
            try:
                req = Request(row.get("params") or {}, resumed=True)
                req.id = str(row.get("id") or req.id)
                self._pending.append(req)
                resumed += 1
            except Exception as e:
                log.warning("interrupted row dropped: %s", e)
        for row in payload.get("pending") or ():
            try:
                req = Request(row.get("params") or {},
                              resumed=bool(row.get("resumed")))
                req.id = str(row.get("id") or req.id)
                self._pending.append(req)
                adopted += 1
            except Exception as e:
                log.warning("pending row dropped: %s", e)
        if resumed:
            SolverStatistics().bump(requests_resumed=resumed)
        try:
            os.unlink(self.queue_path)
        except OSError:
            pass
        if adopted or resumed:
            log.info("adopted persisted queue: %d interrupted, %d "
                     "pending", resumed, adopted)

    # -- accept / dispatch -------------------------------------------------

    def _accept_loop(self) -> None:
        self._listener.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except TimeoutError:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                raise
            t = threading.Thread(target=self._handle_conn,
                                 args=(conn,), daemon=True)
            t.start()

    def _handle_conn(self, conn) -> None:
        try:
            msg = protocol.recv_frame(conn)
        except protocol.ProtocolError as e:
            self._safe_send(conn, {"event": "error", "error": str(e)})
            conn.close()
            return
        if not isinstance(msg, dict):
            conn.close()
            return
        op = msg.get("op")
        try:
            if op == "analyze":
                self._op_analyze(conn, msg)
                return  # conn ownership moved to the worker
            if op == "ping":
                from ..smt.solver.solver_statistics import (
                    SolverStatistics,
                )

                ss = SolverStatistics()
                with self._lock:
                    self._safe_send(conn, {
                        "event": "pong", "pid": os.getpid(),
                        "queued": len(self._pending),
                        "active": sum(len(reqs) for reqs in
                                      self._active.values()),
                        "completed": self._completed,
                        "counters": {
                            "daemon_requests": ss.daemon_requests,
                            "queue_wait_ms": round(
                                ss.queue_wait_ms, 1),
                            "requests_resumed": ss.requests_resumed,
                            "compile_reuse_hits":
                                ss.compile_reuse_hits,
                            "waves_packed": ss.waves_packed,
                            "pack_members": ss.pack_members,
                            "pack_occupancy_pct": round(
                                ss.pack_occupancy_pct, 1),
                            "dispatches_saved": ss.dispatches_saved,
                            "lane_windows": ss.lane_windows,
                            "mat_pool_reuses": ss.mat_pool_reuses,
                        }})
            elif op == "result":
                self._op_result(conn, msg)
            elif op == "status":
                self._op_status(conn)
            elif op == "shutdown":
                self._drain = bool(msg.get("drain", True))
                self._safe_send(conn, {"event": "stopping",
                                       "drain": self._drain})
                self._stop.set()
            else:
                self._safe_send(conn, {"event": "error",
                                       "error": f"unknown op {op!r}"})
        finally:
            if op != "analyze":
                conn.close()

    def _op_analyze(self, conn, msg) -> None:
        try:
            req = Request(msg, conn=conn)
        except ValueError as e:
            self._safe_send(conn, {"event": "error", "error": str(e)})
            conn.close()
            return
        # the queued ack goes out BEFORE the request becomes visible
        # to a worker — otherwise an idle worker's "started" can beat
        # it onto the stream
        with self._lock:
            self._pending.append(req)
            self._annotate_costs()
            pos = len(self._pending)
            self._pending.pop()
        self._safe_send(conn, {
            "event": "queued", "id": req.id, "pos": pos,
            "predicted_s": req.predicted_s,
            "splittable": req.splittable})
        with self._cond:
            self._pending.append(req)
            self._cond.notify()

    def _op_result(self, conn, msg) -> None:
        rid = str(msg.get("id") or "")
        if not rid or len(rid) > 64 or \
                not rid.replace("-", "").replace("_", "").isalnum():
            # ids name files under requests/ — refuse traversal shapes
            self._safe_send(conn, {"event": "unknown", "id": rid})
            return
        row = self.requests_dir / (rid + ".json")
        if rid and row.exists():
            try:
                self._safe_send(conn, json.loads(row.read_text()))
                return
            except (OSError, json.JSONDecodeError):
                pass
        with self._lock:
            live = any(r.id == rid for r in self._pending) or any(
                r.id == rid for reqs in self._active.values()
                for r in reqs)
        self._safe_send(conn, {"event": "pending" if live
                               else "unknown", "id": rid})

    def _op_status(self, conn) -> None:
        with self._lock:
            self._annotate_costs()
            self._safe_send(conn, {
                "event": "status",
                "queued": [{"id": r.id, "cost_key": r.cost_key,
                            "predicted_s": r.predicted_s,
                            "splittable": r.splittable,
                            "resumed": r.resumed}
                           for r in self._pending],
                "active": [r.id for reqs in self._active.values()
                           for r in reqs],
                "completed": self._completed,
                "workers": self.workers})

    @staticmethod
    def _safe_send(conn, obj) -> None:
        """A client that hung up (or an adopted request with no
        client at all — conn None) must never take the daemon, or a
        request whose done-row still has to land, with it."""
        if conn is None:
            return
        try:
            protocol.send_frame(conn, obj)
        except (OSError, protocol.ProtocolError):
            pass

    # -- cost-model scheduling ---------------------------------------------

    def _annotate_costs(self) -> None:
        """Predicted wall + splittable flag per pending request
        (callers hold the lock). Mirrors cost_model.predict_costs /
        splittable_set: unknown code hashes inherit the known median;
        nothing splits at one worker."""
        known = {}
        for r in self._pending:
            entry = self._stats.get(r.cost_key)
            if entry and entry.get("wall_s") is not None:
                known[r] = max(float(entry["wall_s"]), 1e-3)
        if not known:
            for r in self._pending:
                r.predicted_s = None
                r.splittable = False
            return
        ordered = sorted(known.values())
        median = ordered[len(ordered) // 2]
        total = 0.0
        for r in self._pending:
            r.predicted_s = round(known.get(r, median), 3)
            total += r.predicted_s
        fair = total / self.workers
        for r in self._pending:
            r.splittable = (self.workers > 1
                            and r.predicted_s is not None
                            and r.predicted_s > fair)

    def _pop_scheduled(self) -> Request:
        """Next request for a freed worker (callers hold the lock,
        queue non-empty): LPT — the longest predicted pending request
        — when any pending request has cost-model history, FIFO
        otherwise. A resumed request always goes first: its tenant
        has already waited one daemon lifetime."""
        for r in self._pending:
            if r.resumed:
                self._pending.remove(r)
                return r
        self._annotate_costs()
        if all(r.predicted_s is None for r in self._pending):
            return self._pending.pop(0)
        req = min(self._pending,
                  key=lambda r: (-(r.predicted_s or 0.0), r.seq))
        self._pending.remove(req)
        return req

    # -- the analysis worker ------------------------------------------------

    def _worker_loop(self, idx: int) -> None:
        from ..smt.solver import core

        if self.keep_sessions:
            # this thread's private incremental session: survives
            # across requests (reset_session keep-mode) and keeps
            # K=1 serving warm, exactly like a pool worker's
            core.ensure_thread_session()
        while True:
            with self._cond:
                while not self._pending and not self._stop.is_set():
                    self._cond.wait(timeout=0.5)
                if self._stop.is_set() and (not self._pending
                                            or not self._drain):
                    return
                if not self._pending:
                    continue
                req = self._pop_scheduled()
                # cross-tenant wave packing (docs/daemon.md §wave
                # packing): co-schedulable small requests ride the
                # same device waves as one PackGroup
                peers = self._pop_pack_peers(req)
                batch = [req] + peers
                self._active[idx] = batch
            try:
                if peers:
                    self._run_packed(batch)
                else:
                    self._run_request(req)
            except (KeyboardInterrupt, MemoryError):
                raise
            except Exception:
                # one poisoned request must not take the serving
                # thread down with it — the next queued tenant is
                # unrelated
                log.exception("request %s crashed the worker path",
                              req.id)
            finally:
                with self._cond:
                    self._active.pop(idx, None)
                    self._completed += len(batch)
                    self._cond.notify_all()

    # -- cross-tenant wave packing (docs/daemon.md §wave packing) ----------

    @staticmethod
    def _pack_shape(req: Request) -> tuple:
        """The admission key: every analyzer-relevant knob EXCEPT the
        code itself (and the cost-model name). Two requests with equal
        shapes run identical round structures — same strategy, tx
        count, timeouts, module set, lane width — which is what lets
        their waves fold without per-member divergence in engine
        config."""
        p = req.params
        return tuple(
            (k, json.dumps(p.get(k), sort_keys=True, default=str))
            for k in sorted(REQUEST_DEFAULTS)
            if k not in ("code", "name"))

    @staticmethod
    def _pack_width_clamp() -> int:
        """Combined-width admission bound: the capacity autoprobe's
        tightest persisted clamp across shapes when any was ever
        recorded (docs/drain_pipeline.md; clamps are per pow2 shape —
        admission has no single request shape, so the conservative
        min binds), else 0 = unbounded (pick_width still right-sizes
        the packed wave per its own shape)."""
        try:
            from ..laser.lane_engine import capacity_clamp

            return int(capacity_clamp() or 0)
        except Exception:
            return 0

    def _pop_pack_peers(self, head: Request) -> List[Request]:
        """Pull pending requests co-schedulable with ``head`` (callers
        hold the lock): MTPU_PACK on, lane mode, identical pack shape,
        combined lane width under the autoprobe clamp, at most
        MTPU_PACK_MAX members. Resumed requests stay solo — their
        checkpoint-resume path wants the exact solo seams it dumped
        under. With fewer than 2 compatible requests admitted the
        one-request-per-wave path is untouched by construction."""
        from ..laser import wave_pack

        if not wave_pack.enabled() or not self._pending:
            return []
        if int(head.params.get("tpu_lanes") or 0) <= 0 \
                or head.resumed:
            return []
        shape = self._pack_shape(head)
        clamp = self._pack_width_clamp()
        total = int(head.params["tpu_lanes"])
        cap = wave_pack.pack_max()
        peers: List[Request] = []
        for r in list(self._pending):
            if len(peers) + 1 >= cap:
                break
            if r.resumed or self._pack_shape(r) != shape:
                continue
            width = int(r.params["tpu_lanes"])
            if clamp and total + width > clamp:
                continue
            total += width
            peers.append(r)
        for r in peers:
            self._pending.remove(r)
        return peers

    def _run_packed(self, reqs: List[Request]) -> None:
        """Serve a co-scheduled batch as one PackGroup: each member
        runs the full `_run_request` path on its own member thread
        (strictly baton-serialized), their waves fold into packed
        explores, and per-request counters come from the group's
        snapshot/diff attribution instead of the solo c0/c1 diff."""
        from ..laser import wave_pack
        from ..smt.solver import core

        log.info("wave packing: co-scheduling %d requests (%s)",
                 len(reqs), ", ".join(r.id for r in reqs))
        if self.keep_sessions:
            # interleaved member codes share no constraint structure;
            # a session kept across the pack boundary would drag dead
            # clauses (the 11x pathology) — start fresh and re-key
            # the code affinity after the pack
            core.reset_session(force=True)
        self._last_code_hash = None
        group = wave_pack.PackGroup()
        for req in reqs:
            group.add_member(
                req.id, lambda r=req: self._run_request(r, pack=group))
        members = group.run()
        for req in reqs:
            m = members.get(req.id)
            if m is not None and m.error is not None:
                log.error("packed request %s leaked an error: %s",
                          req.id, m.error)

    def _retire_sessions_on_code_change(self, req: Request) -> None:
        """Session keep-alive is CODE-AFFINE: sessions stay hot across
        re-submissions of the same code hash (same hash-consed term
        DAG — already-blasted clauses and valid unsat cores, the win
        the keep-alive exists for) but retire when the tenant's code
        changes. Unrelated contracts share no constraint structure,
        so a kept session would only drag dead clauses through every
        solve — an 18-fixture sweep through one kept session measured
        later contracts at up to 11x their fresh-session wall, the
        same pathology reset_session was built against."""
        if not self.keep_sessions:
            return
        if self._last_code_hash is not None \
                and req.code_hash != self._last_code_hash:
            from ..smt.solver import core

            core.reset_session(force=True)
        self._last_code_hash = req.code_hash

    def _bump_compile_epoch(self) -> None:
        """New request epoch for the jit-cache reuse accounting —
        lazily, so a host-only daemon never imports the lane stack."""
        le = sys.modules.get("mythril_tpu_torch.laser.lane_engine")
        if le is not None:
            try:
                le.REQUEST_EPOCH[0] += 1
            except Exception:  # pragma: no cover - accounting only
                pass

    def _run_request(self, req: Request, pack=None) -> None:
        from ..smt.solver.solver_statistics import SolverStatistics
        from ..support.telemetry import trace

        ss = SolverStatistics()
        wait_ms = max(0.0, _now_ms() - req.enqueued_ms)
        self._bump_compile_epoch()
        if pack is None:
            self._retire_sessions_on_code_change(req)
        self._safe_send(req.conn, {"event": "started", "id": req.id,
                                   "resumed": req.resumed})
        t0 = time.perf_counter()
        # packed members: the solo c0/c1 diff would bleed every
        # co-scheduled member's work into this row — the group's
        # baton-boundary snapshot/diff attribution replaces it
        c0 = {k: v for k, v in ss.batch_counters().items()
              if isinstance(v, (int, float))} if pack is None else None
        ss.bump(daemon_requests=1, queue_wait_ms=wait_ms)
        try:
            with trace.span("daemon.request", id=req.id,
                            resumed=req.resumed,
                            packed=pack is not None):
                row = self._analyze(req)
        except (KeyboardInterrupt, MemoryError):
            raise
        except Exception as e:
            log.exception("request %s failed", req.id)
            self._safe_send(req.conn, {
                "event": "error", "id": req.id,
                "error": f"{type(e).__name__}: {e}"})
            if req.conn is not None:
                req.conn.close()
            return
        wall = time.perf_counter() - t0
        row["event"] = "report"
        row["id"] = req.id
        row["resumed"] = req.resumed
        row["wall_s"] = round(wall, 3)
        row["queue_wait_ms"] = round(wait_ms, 1)
        if pack is None:
            c1 = ss.batch_counters()
            row["counters"] = {
                k: round(c1[k] - v, 1) for k, v in c0.items()
                if isinstance(c1.get(k), (int, float))}
        else:
            row["counters"] = pack.counters_for(req.id)
            row["packed"] = True
            row["counters_shared"] = dict(pack.shared_counters)
        self._persist_done_row(req, row)
        self._record_cost(req, wall)
        self._safe_send(req.conn, row)
        if req.conn is not None:
            req.conn.close()

    def _analyze(self, req: Request) -> dict:
        """One isolated analysis inside the resident process — the
        same analyzer pipeline the one-shot CLI runs, so reports are
        identical by construction."""
        from ..orchestration.mythril_analyzer import MythrilAnalyzer
        from ..orchestration.mythril_disassembler import (
            MythrilDisassembler,
        )
        from ..support import telemetry
        from ..support.analysis_args import make_cmd_args
        from ..support.checkpoint import live_enabled

        p = req.params
        req_dir = self.requests_dir / req.id
        req_dir.mkdir(exist_ok=True)
        # per-request telemetry scope: a crash/SIGTERM dump lands in
        # THIS request's directory, beside its resume checkpoint
        telemetry.configure(out_dir=str(req_dir))
        ckpt = str(req_dir / "resume.ckpt") if live_enabled() else None
        disassembler = MythrilDisassembler(eth=None)
        address, contract = disassembler.load_from_bytecode(
            p["code"], bin_runtime=bool(p["bin_runtime"]))
        from ..parallel.cost_model import warm_path_history

        if p.get("name"):
            warm_path_history(contract.disassembly, p["name"],
                              self._stats)
        analyzer = MythrilAnalyzer(
            disassembler=disassembler,
            cmd_args=make_cmd_args(
                execution_timeout=int(p["timeout"]),
                tpu_lanes=int(p["tpu_lanes"]),
                max_depth=int(p["max_depth"]),
                call_depth_limit=int(p["call_depth_limit"]),
                loop_bound=int(p["loop_bound"]),
                create_timeout=int(p["create_timeout"]),
                solver_timeout=int(p["solver_timeout"]),
                no_onchain_data=bool(p["no_onchain_data"]),
                pruning_factor=p["pruning_factor"],
                unconstrained_storage=bool(
                    p["unconstrained_storage"]),
                disable_dependency_pruning=bool(
                    p["disable_dependency_pruning"]),
                transaction_sequences=p["transaction_sequences"],
                checkpoint=ckpt),
            strategy=str(p["strategy"]), address=address)
        report = analyzer.fire_lasers(
            modules=list(p["modules"]) if p.get("modules") else None,
            transaction_count=int(p["transaction_count"]))
        if ckpt:
            # a finished request must never "resume" into a no-op
            for leftover in (ckpt, ckpt + ".verdicts"):
                try:
                    os.unlink(leftover)
                except OSError:
                    pass
        issues = report.sorted_issues()
        outform = str(p.get("outform") or "json")
        renderers = {"json": report.as_json,
                     "jsonv2": report.as_swc_standard_format,
                     "text": report.as_text,
                     "markdown": report.as_markdown}
        render = renderers.get(outform, report.as_json)
        return {
            "output": render(),
            "outform": outform,
            # the analyzer records a contract's failed analysis (a lane
            # dispatch that raised, packed or solo) in the report, which
            # the rendered output does not show: the row names it
            "exceptions": list(report.exceptions),
            "issue_count": len(issues),
            "issues": [{"swc-id": i["swc-id"], "title": i["title"],
                        "function": i.get("function"),
                        "address": i.get("address")}
                       for i in issues],
        }

    def _persist_done_row(self, req: Request, row: dict) -> None:
        """Atomic done-row under requests/<id>.json: a restarted
        daemon (or a reconnecting client) serves completed work by id
        instead of re-running it."""
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.requests_dir),
                                       prefix=".row-")
            with os.fdopen(fd, "w") as f:
                json.dump(row, f)
            os.replace(tmp, self.requests_dir / (req.id + ".json"))
        except OSError as e:  # bookkeeping only
            log.debug("done-row write failed: %s", e)

    def _record_cost(self, req: Request, wall: float) -> None:
        """Feed the measured wall back into stats.json (EMA merge —
        the same file corpus runs maintain) so the NEXT submission of
        this code schedules on real history."""
        from ..parallel.cost_model import load_stats, save_stats

        row = {"contract": req.cost_key, "wall_s": round(wall, 3)}
        try:
            save_stats(self.out, [row], telemetry={})
            self._stats = load_stats(self.out)
        except Exception as e:  # cost model is advisory
            log.debug("cost record failed: %s", e)


def serve(out_dir, socket_path: Optional[str] = None,
          workers: int = 1, keep_sessions: Optional[bool] = None) -> int:
    """``myth serve`` entry: run a daemon until shutdown/SIGTERM.
    ``MTPU_DAEMON_KEEP_SESSIONS=0`` restores per-analysis session
    retirement (the parity-test/off switch for satellite 2)."""
    if keep_sessions is None:
        keep_sessions = os.environ.get(
            "MTPU_DAEMON_KEEP_SESSIONS", "1") != "0"
    daemon = AnalysisDaemon(out_dir, socket_path=socket_path,
                            workers=workers,
                            keep_sessions=keep_sessions)
    return daemon.run()
