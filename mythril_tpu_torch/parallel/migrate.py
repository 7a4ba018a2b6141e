"""Cost-aware intra-contract work sharding for corpus mode
(docs/work_stealing.md; SURVEY §2.10, distributed-backend row: work
moves between hosts over DCN when a shard drains early — not just
unstarted contracts, but the open-state wave of a HALF-FINISHED
analysis).

Mechanism: the engine's open world states collapse to the serializable
core the checkpoint format already carries (support/checkpoint.py:
flat term-table, keccak-manager state, tx counter). A loaded victim
answers drained thieves by exporting slices of its open states as
checkpoint-format batches; a thief resumes one through the ordinary
checkpoint machinery (same contract, same remaining rounds) with its
own engine and detector set, then ships the issues it found back. The
victim merges them through Report.append_issue — the same dedup path
an unsplit analysis uses — so the merged report is identical to a
no-migration run.

Three scheduler upgrades over the original reactive halving bus:

* **mid-round yield** — the victim's exploration loop polls the
  steal-request flag every K processed states (laser/svm.py), so open
  states that finished the current transaction round migrate while
  the round is still running, not only at its boundary: a long-pole
  contract sheds work during its first round.
* **multi-way offers** — the wave splits proportionally across ALL
  idle ranks (k trailing slices, one offer each) instead of halving
  to one thief; the O_CREAT|O_EXCL claim protocol and the dead-thief
  local-resume fallback apply per offer, so k batches generalize for
  free.
* **verdict-cache shipping** — each batch carries a sidecar of PR-2
  verdict-cache proofs (ancestor-UNSAT fingerprints and cached
  models) restricted to the shipped states' constraint prefixes,
  re-fingerprinted on the thief's term table at load: the thief never
  re-proves what the victim already settled (its screen registers
  them as `queries_saved`).

Coordination rides the corpus mode's shared --out-dir filesystem
(which rank 0's merge already requires): request/offer/result files
plus O_CREAT|O_EXCL claim files for atomicity. A crashed thief leaves
a claimed-but-unanswered offer; the victim falls back to resuming the
batch locally once every other rank is done or the thief writes a
failure marker — work can migrate, but never be lost. While the
victim is still analyzing it heartbeats its own offer files, and the
dead-thief clock measures against the freshest of claim and offer
mtimes: a slow-but-live thief holding a claim is never misclassified
as dead (and the batch double-executed) just because the victim's
analysis outlived CLAIMED_WAIT_S.

Tested end-to-end by tests/test_migration.py: rigged two- and
four-rank corpora where mid-flight analyses migrate with identical
merged reports.
"""

import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..support.telemetry import trace

log = logging.getLogger(__name__)


class _StalenessClock:
    """Monotonic staleness for heartbeat files. File mtimes are WALL
    times set by another host's clock: comparing them against this
    process's ``time.time()`` made the dead-thief timeout wrong by
    exactly any NTP step (or cross-host clock skew) during a long
    corpus run. The mtime is therefore used only as a change DETECTOR:
    staleness is measured on this process's monotonic clock from the
    moment it last OBSERVED the mtime change. First observation counts
    as fresh — a genuinely dead peer's file then ages out after one
    full timeout of observed silence, which is the conservative side
    (work is re-run late, never lost or double-run early)."""

    def __init__(self):
        self._seen: Dict[str, tuple] = {}  # path -> (mtime, mono)

    def age(self, *paths) -> float:
        """Monotonic seconds since the freshest of `paths` last
        changed; +inf when none exists."""
        now = time.monotonic()
        best = None
        for p in paths:
            key = str(p)
            try:
                mtime = os.stat(key).st_mtime
            except OSError:
                continue
            prev = self._seen.get(key)
            if prev is None or prev[0] != mtime:
                self._seen[key] = (mtime, now)
                cur = 0.0
            else:
                cur = now - prev[1]
            best = cur if best is None else min(best, cur)
        return best if best is not None else float("inf")

#: how long a victim waits on a CLAIMED offer after every other rank
#: reported done (a live thief answers in far less; a dead one never)
CLAIMED_WAIT_S = float(os.environ.get("MTPU_MIGRATE_WAIT", "60"))

#: exploration-loop states processed between steal-request polls
#: (laser/svm.py mid-round yield); splittable contracts poll 8x as
#: often — they are the long poles the schedule pre-declared unable
#: to amortize
MIDROUND_K = int(os.environ.get("MTPU_MIDROUND_K", "512"))

#: ship verdict-cache sidecars with exported batches (default on;
#: "0" disables for A/B runs)
SHIP_VERDICTS = os.environ.get("MTPU_SHIP_VERDICTS", "1") != "0"

#: online cost-model refinement: a contract whose open wave reaches
#: this many states is a long pole whatever the prior-run stats said —
#: it flips to the eager (8x) mid-round poll rate for the rest of its
#: analysis (parallel/cost_model.py handles the prior-seeded half)
SPLIT_EAGER_FORKS = int(os.environ.get("MTPU_SPLIT_EAGER_FORKS", "128"))

#: mid-flight wave splitting (docs/checkpoint.md): minimum live
#: in-flight states before a worklist/lane-plane slice is worth an
#: offer, and the monotonic cooldown between in-flight exports (a
#: thief's request file stays fresh while it chews a batch — without
#: the cooldown a victim could starve itself feeding one slow thief)
MIDFLIGHT_MIN_LIVE = int(os.environ.get("MTPU_MIDFLIGHT_MIN", "8"))
MIDFLIGHT_COOLDOWN_S = float(
    os.environ.get("MTPU_MIDFLIGHT_COOLDOWN", "2.0"))


def code_identity(contract) -> str:
    """The checkpoint code binding (support/checkpoint.py owns it)."""
    from ..support.checkpoint import code_identity as _ci

    return _ci(contract)


def _claim(path: Path) -> bool:
    """Atomic cross-rank claim via O_CREAT|O_EXCL on the shared dir."""
    try:
        fd = os.open(str(path), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        return True
    except FileExistsError:
        return False


class MigrationBus:
    """One per corpus rank; mediates offers through the shared dir."""

    def __init__(self, out_dir: str, rank: int, num_ranks: int,
                 timeout: int = 60, tpu_lanes: int = 0):
        self.dir = Path(out_dir) / "migrate"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self.num_ranks = num_ranks
        self.timeout = timeout
        self.tpu_lanes = tpu_lanes
        #: offers this rank published and must resolve before its
        #: contract report finalizes: offer id -> meta dict
        self.outstanding = {}
        self._offer_seq = 0
        #: set by the victim hook while a contract is being analyzed
        self.current_contract: Optional[str] = None
        #: contract paths the LPT schedule pre-declared splittable
        #: (cost above total/n_ranks — parallel/cost_model.py)
        self.splittable = set()
        self._split_eager = False
        #: round context for mid-round yields, set by svm at each
        #: round start: (next_round, tx_count, address)
        self._round: Optional[tuple] = None
        #: shard-report observability (docs/work_stealing.md)
        self.stats = {
            "states_migrated": 0,   # open states exported (victim)
            "batches_out": 0,       # offers published (victim)
            "batches_in": 0,        # migrated batches served (thief)
            "midround_exports": 0,  # export waves fired mid-round
            "midflight_steals": 0,  # offers that split a LIVE wave
            #                         (in-flight states, not finished
            #                         ones — docs/checkpoint.md)
            "steal_latency_s": 0.0,  # request -> first claimed batch
        }
        #: monotonic stamp of the last in-flight export (cooldown)
        self._midflight_last = 0.0
        self._req_cache: Optional[tuple] = None
        self._victim_hb: Optional[_Heartbeat] = None
        #: monotonic change-observation clock for every peer
        #: heartbeat file this bus judges staleness on (request files,
        #: claim files, its own offer metas)
        self._stale = _StalenessClock()

    @property
    def yield_every(self) -> int:
        """svm's mid-round poll period for the CURRENT contract."""
        return max(MIDROUND_K // 8, 1) if self._split_eager \
            else MIDROUND_K

    # -- signals -------------------------------------------------------------

    def request_work(self) -> None:
        (self.dir / f"request_{self.rank}").touch()

    def withdraw_request(self) -> None:
        try:
            (self.dir / f"request_{self.rank}").unlink()
        except FileNotFoundError:
            pass

    def _pending_requests(self, max_age: float = 0.25) -> List[int]:
        """Other ranks' LIVE work requests. A polling thief refreshes
        its request file every loop (and heartbeats it while analyzing
        a batch), so a request untouched for CLAIMED_WAIT_S is a dead
        rank's leftover and must not gate anyone's local fallback.
        Results are memoized for `max_age` seconds: the mid-round
        yield polls every K processed states and must not turn the
        exploration loop into a glob loop."""
        now = time.monotonic()
        if (self._req_cache is not None
                and now - self._req_cache[0] < max_age):
            return self._req_cache[1]
        out = []
        for p in self.dir.glob("request_*"):
            rank = int(p.name.split("_")[1])
            if rank == self.rank:
                continue
            # staleness on the MONOTONIC observation clock, not wall
            # vs mtime (NTP steps corrupted the dead-thief cutoff)
            if self._stale.age(p) > CLAIMED_WAIT_S:
                continue
            out.append(rank)
        self._req_cache = (now, out)
        return out

    def mark_done(self) -> None:
        (self.dir / f"done_{self.rank}").touch()

    def others_done(self) -> bool:
        return all(
            (self.dir / f"done_{r}").exists()
            for r in range(self.num_ranks) if r != self.rank
        )

    # -- victim side ---------------------------------------------------------

    def begin_round(self, next_round: int, tx_count: int,
                    address) -> None:
        """svm hook at each transaction-round start: the context a
        mid-round yield needs to stamp its exported batches."""
        self._round = (next_round, tx_count, address)

    def midround_yield(self, laser) -> None:
        """svm hook, fired every `yield_every` processed states: open
        states that already FINISHED the current round (accumulating in
        laser.open_states while the round's worklist still executes)
        migrate to idle ranks without waiting for the boundary. When
        the finished wave cannot shed — a single giant round with few
        completions, or the run's FINAL round (no rounds left for its
        open states) — the live worklist itself splits instead
        (midflight_yield, docs/checkpoint.md)."""
        ctx = self._round
        if ctx is None:
            return
        if (not self._split_eager
                and len(laser.open_states) >= SPLIT_EAGER_FORKS):
            self._split_eager = True  # first-round fork count refines
            #                           the prior-seeded cost estimate
        next_round, tx_count, address = ctx
        if next_round < tx_count and len(laser.open_states) >= 2 \
                and self._pending_requests():
            if self._export_wave(laser.open_states, next_round,
                                 tx_count, address):
                self.stats["midround_exports"] += 1
                return
        self.midflight_yield(laser)

    def midflight_yield(self, laser) -> int:
        """Split the LIVE in-flight wave (docs/checkpoint.md): tail
        slices of the svm worklist — states mid-way through the
        current round — export as inflight checkpoint batches that a
        thief finishes with its own engine. This is what makes a
        single giant round sheddable: the PR-3 bus could only move
        states that had already finished a round. Gated by MTPU_CKPT;
        returns offers published."""
        from ..support.checkpoint import live_enabled

        if not live_enabled() or self.current_contract is None:
            return 0
        ctx = self._round
        if ctx is None:
            return 0
        if time.monotonic() - self._midflight_last \
                < MIDFLIGHT_COOLDOWN_S:
            return 0
        work_list = getattr(laser, "work_list", None)
        if work_list is None or len(work_list) < MIDFLIGHT_MIN_LIVE:
            return 0
        thieves = self._pending_requests()
        if not thieves:
            return 0
        from .cost_model import midwave_share

        next_round, tx_count, address = ctx
        share = midwave_share(len(work_list), len(thieves))
        if share < 1:
            return 0
        published = 0
        for _ in range(len(thieves)):
            if len(work_list) - share < 1:
                break
            chunk = work_list[len(work_list) - share:]
            if not self._publish_offer(chunk, next_round, tx_count,
                                       address, inflight=True):
                break
            # trim AFTER the successful save, like the finished-state
            # export: an aborted offer leaves its states local
            del work_list[len(work_list) - share:]
            published += 1
        if published:
            self._midflight_last = time.monotonic()
        return published

    def lane_export_client(self):
        """The lane engine's window-boundary export protocol
        (lane_engine._window_export): `want(live)` sizes the slice,
        `deliver(states)` publishes it as an inflight offer. None when
        live checkpointing is off — the engine seam then never
        engages."""
        from ..support.checkpoint import live_enabled

        if not live_enabled():
            return None
        return _LaneExportClient(self)

    def on_round_end(self, laser, next_round: int, tx_count: int,
                     address) -> None:
        """svm hook (laser/svm.py _execute_transactions): split the
        round's surviving open states across drained thieves, in
        place."""
        if next_round >= tx_count:
            return  # no rounds left: nothing worth migrating
        if len(laser.open_states) < 2:
            return
        if not self._pending_requests():
            return
        self._export_wave(laser.open_states, next_round, tx_count,
                          address)

    def _export_wave(self, states: List, next_round: int,
                     tx_count: int, address) -> int:
        """Multi-way export: split the wave's tail proportionally
        across all idle ranks (k slices for k thieves, the victim
        keeps at least an equal share), one claim-protocol offer per
        slice. Trims `states` in place; returns offers published."""
        if self.current_contract is None:
            return 0
        thieves = self._pending_requests()
        n = len(states)
        k = min(len(thieves), n - 1)
        if k < 1:
            return 0
        share = n // (k + 1)
        if share < 1:
            return 0
        published = 0
        for _ in range(k):
            # always the current tail slice: the victim's own work
            # continues from the head
            chunk = states[len(states) - share:]
            if not self._publish_offer(chunk, next_round, tx_count,
                                       address, inflight=False):
                continue
            # trim AFTER the successful save: an aborted offer must
            # leave its states with the victim
            del states[len(states) - share:]
            published += 1
        return published

    def _publish_offer(self, chunk: List, next_round: int,
                       tx_count: int, address,
                       inflight: bool = False) -> bool:
        """Write one claim-protocol offer for `chunk`: the checkpoint
        batch (finished open states, or the live in-flight plane when
        ``inflight``), the verdict/static sidecars, and the meta file
        thieves glob for. The caller trims its state list only on
        True."""
        if self.current_contract is None:
            return False
        from ..smt import BitVec
        from ..support.checkpoint import save_checkpoint

        addr = address.value if isinstance(address, BitVec) \
            else address
        code_id = self._current_code_id
        ship = self._verdict_payload(chunk) if SHIP_VERDICTS else None
        self._offer_seq += 1
        offer_id = f"{self.rank}_{self._offer_seq}"
        batch = self.dir / f"offer_{offer_id}.batch"
        if inflight:
            save_checkpoint(str(batch), next_round, [], addr, code_id,
                            include_modules=False, inflight=chunk)
        else:
            save_checkpoint(str(batch), next_round, chunk, addr,
                            code_id, include_modules=False)
        if not batch.exists():  # save is best-effort; keep states
            return False
        paths = [batch]
        if ship:
            side = self.dir / f"offer_{offer_id}.verdicts"
            from ..support.checkpoint import save_verdict_sidecar

            entries = self._entries_for(chunk, ship)
            # the sidecar REFERENCES the batch's shared term table
            # (state codec): its entries' terms are mostly the shipped
            # states' constraint prefixes, so it ships only the rows
            # it adds. A thief that finds the batch missing or skewed
            # drops the sidecar whole and re-proves.
            if entries and save_verdict_sidecar(side, entries,
                                                table_from=batch):
                paths.append(side)
        # static-pass results ship like verdict sidecars
        # (docs/static_pass.md): pure per-code-hash data, so the
        # thief seeds its memo instead of re-deriving CFG/masks
        try:
            from ..analysis.static_pass import memo as static_memo
            from ..support.checkpoint import save_static_sidecar

            sentries = static_memo.export_entries()
            if sentries:
                sside = self.dir / f"offer_{offer_id}.static"
                if save_static_sidecar(sside, sentries):
                    paths.append(sside)
        except Exception as e:
            log.debug("static sidecar export failed: %s", e)
        meta = {
            "contract": self.current_contract,
            "code_id": code_id,
            "tx_count": tx_count,
            "round": next_round,
            "victim": self.rank,
            "states": len(chunk),
            "inflight": bool(inflight),
        }
        meta_path = self.dir / f"offer_{offer_id}.meta.json"
        tmp = meta_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, meta_path)  # thieves glob for *.meta.json
        paths.append(meta_path)
        # a live victim keeps its offer files fresh: the dead-
        # thief clock must not start while the victim is still
        # analyzing (see _collect)
        if self._victim_hb is None:
            self._victim_hb = _Heartbeat()
            self._victim_hb.start()
        self._victim_hb.add_paths(*paths)
        self.outstanding[offer_id] = meta
        self.stats["states_migrated"] += len(chunk)
        self.stats["batches_out"] += 1
        if inflight:
            self.stats["midflight_steals"] += 1
            try:
                from ..smt.solver.solver_statistics import (
                    SolverStatistics,
                )

                SolverStatistics().bump(midflight_steals=1,
                                        lanes_exported=len(chunk))
            except Exception:  # telemetry only
                pass
        trace.event("migrate.offer", offer=offer_id,
                    states=len(chunk), round=next_round,
                    inflight=bool(inflight))
        log.info("rank %d: migrated %d %s states (offer %s)",
                 self.rank, len(chunk),
                 "in-flight" if inflight else "open", offer_id)
        return True

    @staticmethod
    def _constraints_of(state):
        """The constraint set of either an open WorldState or an
        in-flight GlobalState (mid-flight offers ship the latter)."""
        ws = getattr(state, "world_state", None)
        return (ws if ws is not None else state).constraints

    def _verdict_payload(self, states: List):
        """Pre-export feasibility screen over the shipped slice: the
        states' verdicts land in the run-wide cache (the victim pays
        one warm-cache discharge it would otherwise pay at the next
        round's prune) so the sidecars carry EXACT full-set proofs,
        not just ancestor prefixes. Returns the cache, or None."""
        try:
            from ..smt.solver import verdicts as verdict_mod
            from ..support.model import check_batch

            vc = verdict_mod.cache()
            if vc is None:
                return None
            check_batch([self._constraints_of(s) for s in states])
            return vc
        except Exception as e:
            log.debug("pre-export screen failed (%s); shipping "
                      "prefix proofs only", e)
            try:
                from ..smt.solver import verdicts as verdict_mod

                return verdict_mod.cache()
            except Exception:
                return None

    @classmethod
    def _entries_for(cls, chunk: List, vc) -> List:
        """Cached proofs restricted to the chunk's constraint
        prefixes, as picklable (terms, verdict, model) triples."""
        try:
            term_lists = []
            for state in chunk:
                constraints = cls._constraints_of(state)
                getter = getattr(constraints, "get_all_constraints",
                                 None)
                cons = getter() if getter else list(constraints)
                term_lists.append(
                    [c.raw for c in cons if type(c) != bool])
            return vc.export_entries(term_lists)
        except Exception as e:
            log.debug("verdict export failed (%s)", e)
            return []

    def begin_contract(self, contract_path: str, contract) -> None:
        self.current_contract = contract_path
        self._current_code_id = code_identity(contract)
        self._split_eager = contract_path in self.splittable
        self._round = None

    def finalize_contract(self, report) -> int:
        """Wait for every outstanding offer's result and merge its
        issues into the victim's report (append_issue dedups exactly
        as an unsplit run would). Unclaimed/failed offers are resumed
        locally. Returns the number of batches a REMOTE rank actually
        analyzed (local fallbacks are not migrations)."""
        # the victim stops refreshing its offer files HERE: from this
        # point the dead-thief clock in _collect runs against the
        # thief's own claim heartbeat
        if self._victim_hb is not None:
            self._victim_hb.stop()
            self._victim_hb = None
        merged = 0
        for offer_id, meta in list(self.outstanding.items()):
            issues, remote = self._collect(offer_id, meta)
            for issue in issues:
                report.append_issue(issue)
            if remote:
                merged += 1
            del self.outstanding[offer_id]
        self.current_contract = None
        self._round = None
        self._split_eager = False
        return merged

    def _collect(self, offer_id: str,
                 meta: dict) -> Tuple[List, bool]:
        result = self.dir / f"result_{offer_id}.pkl"
        failed = self.dir / f"failed_{offer_id}"
        claim = self.dir / f"claim_{offer_id}"
        meta_path = self.dir / f"offer_{offer_id}.meta.json"
        while True:
            if result.exists():
                try:
                    return _load_issues(result), True
                except Exception as e:
                    log.warning("migrated result unreadable (%s); "
                                "re-running locally", e)
                    break
            if failed.exists():
                break
            if not claim.exists():
                # nobody is working on it. If no thief is even asking
                # (or everyone else is done), claim it ourselves and
                # resume locally — two victims waiting on each other's
                # offers must not deadlock. The claim keeps a late
                # thief from duplicating the work.
                if ((not self._pending_requests(max_age=0.0)
                     or self.others_done())
                        and _claim(claim)):
                    break
            else:
                # a live thief heartbeats the claim file; only a STALE
                # claim times out. The clock measures from the FRESHEST
                # of the claim and the offer meta: while the victim was
                # still analyzing it heartbeated its own offer files,
                # so a thief that claimed long before the victim got
                # here is never raced with a duplicate local run just
                # because the victim's analysis outlived the timeout.
                # Staleness is monotonic-observed (see _StalenessClock)
                # — a wall-clock step can no longer declare a live
                # thief dead (or keep a dead one alive).
                if self._stale.age(claim, meta_path) > CLAIMED_WAIT_S:
                    log.warning("offer %s claimed but never answered; "
                                "re-running locally", offer_id)
                    trace.event("migrate.dead_thief", offer=offer_id)
                    break
            time.sleep(0.2)
        # local fallback: resume the batch with this rank's own engine
        return analyze_batch(
            meta, self.dir / f"offer_{offer_id}.batch",
            self.timeout, self.tpu_lanes,
            work_tag=f"victim{self.rank}"), False

    # -- thief side ----------------------------------------------------------

    def serve_offers_until_done(self) -> int:
        """Drained rank: advertise, then claim and run migrated batches
        until every other rank is done. Returns batches served."""
        served = 0
        t_request = time.perf_counter()
        first_claim: Optional[float] = None
        self.request_work()
        try:
            while True:
                took = False
                # a live poller keeps its request fresh: victims treat
                # stale request files as a dead thief's leftovers
                self.request_work()
                for meta_path in sorted(self.dir.glob("offer_*.meta.json")):
                    offer_id = meta_path.name[len("offer_"):
                                              -len(".meta.json")]
                    if (self.dir / f"result_{offer_id}.pkl").exists():
                        continue
                    if not _claim(self.dir / f"claim_{offer_id}"):
                        continue
                    if first_claim is None:
                        first_claim = time.perf_counter() - t_request
                        self.stats["steal_latency_s"] = round(
                            first_claim, 3)
                    trace.event("migrate.claim", offer=offer_id)
                    took = True
                    if self._run_offer(offer_id, meta_path):
                        served += 1
                        self.stats["batches_in"] += 1
                if not took:
                    if self.others_done():
                        return served
                    time.sleep(0.2)
        finally:
            self.withdraw_request()

    def _run_offer(self, offer_id: str, meta_path: Path) -> bool:
        try:
            meta = json.loads(meta_path.read_text())
            claim = self.dir / f"claim_{offer_id}"
            request = self.dir / f"request_{self.rank}"
            with _Heartbeat(claim, request):
                issues = analyze_batch(
                    meta, self.dir / f"offer_{offer_id}.batch",
                    self.timeout, self.tpu_lanes,
                    work_tag=f"thief{self.rank}",
                    verdicts_path=self.dir
                    / f"offer_{offer_id}.verdicts")
            _dump_issues(self.dir / f"result_{offer_id}.pkl", issues)
            log.info("rank %d: served migrated batch %s (%d issues)",
                     self.rank, offer_id, len(issues))
            return True
        except Exception as e:
            log.warning("migrated batch %s failed (%s)", offer_id, e)
            (self.dir / f"failed_{offer_id}").touch()
            return False


class _Heartbeat:
    """Background toucher: keeps claim/request/offer files' mtimes
    fresh while their owner is alive, so staleness checks can tell a
    slow worker from a dead one at any analysis length. Paths may be
    added while running (the victim's offer set grows per export)."""

    PERIOD_S = 5.0

    def __init__(self, *paths: Path):
        self._paths = list(paths)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def add_paths(self, *paths: Path) -> None:
        self._paths.extend(paths)

    def _run(self):
        while not self._stop.wait(self.PERIOD_S):
            for p in list(self._paths):
                try:
                    os.utime(p)
                except OSError:
                    pass

    def start(self) -> "_Heartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class _LaneExportClient:
    """Window-boundary export protocol between the lane engine and the
    migration bus (lane_engine._window_export, docs/checkpoint.md).
    `want(live)` sizes the slice to take from the live wave's tail —
    nonzero only when thieves are asking, the wave is big enough, and
    the cooldown has elapsed; `deliver(states)` publishes the
    materialized lanes as one inflight offer (False = the engine parks
    them locally instead — work moves, never lost)."""

    def __init__(self, bus: "MigrationBus"):
        self.bus = bus

    def want(self, live: int) -> int:
        bus = self.bus
        if bus.current_contract is None or bus._round is None:
            return 0
        if live < MIDFLIGHT_MIN_LIVE:
            return 0
        if time.monotonic() - bus._midflight_last \
                < MIDFLIGHT_COOLDOWN_S:
            return 0
        thieves = bus._pending_requests()
        if not thieves:
            return 0
        from .cost_model import midwave_share

        # one offer per boundary: the next window's boundary serves
        # any remaining thieves (the wave re-sizes in between)
        return midwave_share(live, len(thieves))

    def deliver(self, states) -> bool:
        bus = self.bus
        ctx = bus._round
        if ctx is None or not states:
            return False
        next_round, tx_count, address = ctx
        if bus._publish_offer(list(states), next_round, tx_count,
                              address, inflight=True):
            bus._midflight_last = time.monotonic()
            return True
        return False


def analyze_batch(meta: dict, batch_path, timeout: int,
                  tpu_lanes: int, work_tag: str = "local",
                  verdicts_path=None) -> List:
    """Resume a migrated batch through the ordinary checkpoint
    machinery: same contract, remaining transaction rounds, this
    rank's own engine + full detector set; returns Issue objects.
    The batch is COPIED to a private work file first — the resuming
    engine's checkpoint sink writes its own progress there, and the
    shared offer file must stay immutable for fallback. A verdict
    sidecar, when present, replays the victim's cached proofs into
    this process's run-wide verdict cache before the resume (the
    terms re-intern locally, so the fingerprints re-derive here)."""
    from ..orchestration.mythril_analyzer import MythrilAnalyzer
    from ..orchestration.mythril_disassembler import MythrilDisassembler
    from ..support.analysis_args import make_cmd_args
    from ..support.checkpoint import RESUME_STATS

    if verdicts_path is not None:
        try:
            from ..smt.solver import verdicts as verdict_mod
            from ..support.checkpoint import load_verdict_sidecar

            vc = verdict_mod.cache()
            entries = load_verdict_sidecar(verdicts_path) \
                if vc is not None else []
            if entries:
                n = vc.import_entries(entries)
                trace.event("migrate.replay", verdicts=n,
                            batch=Path(batch_path).name)
                log.info("replayed %d shipped verdicts for batch %s",
                         n, Path(batch_path).name)
        except Exception as e:
            log.debug("verdict replay failed (%s); re-proving", e)
        # the static sidecar rides beside the verdict one (same
        # offer id, .static suffix); adopt it before the resume so
        # the engines see warm static-pass memo entries
        try:
            from ..analysis.static_pass import memo as static_memo
            from ..support.checkpoint import load_static_sidecar

            static_path = Path(str(verdicts_path)).with_suffix(
                ".static")
            sentries = load_static_sidecar(static_path)
            if sentries:
                static_memo.import_entries(sentries)
        except Exception as e:
            log.debug("static sidecar import failed: %s", e)

    batch_path = Path(batch_path)
    work = batch_path.with_name(
        f"{batch_path.stem}.{work_tag}.work")
    shutil.copyfile(batch_path, work)
    disassembler = MythrilDisassembler(eth=None)
    code = Path(meta["contract"]).read_text().strip()
    address, _ = disassembler.load_from_bytecode(code, bin_runtime=True)
    cmd_args = make_cmd_args(
        execution_timeout=timeout, tpu_lanes=tpu_lanes,
        checkpoint=str(work))
    analyzer = MythrilAnalyzer(
        disassembler=disassembler, cmd_args=cmd_args, strategy="bfs",
        address=address)
    loaded0 = RESUME_STATS["loaded"]
    report = analyzer.fire_lasers(modules=None,
                                  transaction_count=meta["tx_count"])
    if RESUME_STATS["loaded"] == loaded0:
        # the batch did not resume (corrupt file / identity mismatch):
        # the run above was a FULL re-analysis — correct after dedup,
        # but a migration that silently cost a whole contract must be
        # loud
        log.warning("migrated batch %s did not resume; a full "
                    "re-analysis ran instead", batch_path.name)
    return list(report.issues.values())


def _dump_issues(path: Path, issues: List) -> None:
    from ..support.checkpoint import dump_with_terms

    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        dump_with_terms(f, issues)
    os.replace(tmp, path)


def _load_issues(path: Path) -> List:
    from ..support.checkpoint import load_with_terms

    with open(path, "rb") as f:
        return load_with_terms(f)
