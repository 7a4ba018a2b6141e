"""Multi-host corpus mode: contract-shard scheduling over DCN.

The reference's only multi-machine story is "run 30 `myth` processes"
(/root/reference/tests/integration_tests/parallel_test.py:8-16). The
TPU-native equivalent (SURVEY.md §2.10, distributed-backend row) is a
jax.distributed process group: every host joins one coordinator, takes
a deterministic disjoint shard of the contract corpus, analyzes it with
its own engine (host interpreter or lane engine over its local chips),
and the group barriers on JAX collectives — the same transport that
would carry cross-host lane traffic — before rank 0 merges the shard
reports.

Run one process per host:

    python -m mythril_tpu_torch.parallel.corpus \
        --coordinator HOST:PORT --num-processes N --process-id I \
        --out-dir DIR file1.sol.o file2.sol.o ...

CPU-testable with local processes (tests/test_corpus_distributed.py
drives two coordinator-connected processes on a virtual CPU backend).
"""

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

log = logging.getLogger(__name__)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join the torch.distributed process group (idempotent); returns
    this process's rank. The rendezvous is a ``TCPStore`` at the
    coordinator's HOST:PORT, which rank 0 serves: it is the key-value
    channel the barrier and the work claims ride, and the gloo group is
    built over it. With no coordinator configured, runs standalone as
    rank 0 of 1."""
    from datetime import timedelta

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    coordinator = coordinator or os.environ.get("MTPU_COORDINATOR")
    if coordinator is None:
        return 0
    if num_processes is None:
        num_processes = int(os.environ["MTPU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["MTPU_PROCESS_ID"])
    host, _, port = coordinator.rpartition(":")
    # connect every rank NOW, while every rank is at the same startup
    # point: rank 0's store waits for all workers, and the group's
    # handshake completes here, not deep inside one rank's analysis
    # (where it would serialize the corpus at another rank's pace
    # instead of letting ranks drain early and steal work)
    store = dist.TCPStore(
        host, int(port), num_processes, process_id == 0,
        timeout=timedelta(milliseconds=_BARRIER_TIMEOUT_MS),
        wait_for_workers=True)
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes)
    return process_id


def shard_corpus(paths: Sequence[str], process_id: int,
                 num_processes: int) -> List[str]:
    """Deterministic disjoint round-robin shard (sorted order, so every
    rank computes the same assignment without communicating)."""
    ordered = sorted(paths)
    return [p for i, p in enumerate(ordered)
            if i % num_processes == process_id]


#: coordination-barrier timeout: generous — ranks arrive as their
#: shards finish, and the slowest shard bounds the spread
_BARRIER_TIMEOUT_MS = int(
    os.environ.get("MTPU_BARRIER_TIMEOUT_MS", str(30 * 60 * 1000)))


def _barrier(name: str) -> None:
    """Group-wide barrier over the rendezvous store (a no-op
    standalone): each rank adds one to the barrier's counter, the last
    to arrive sets its release key, and every rank waits for that key
    up to ``_BARRIER_TIMEOUT_MS``. Rank 0 serves the store, so it
    leaves only after every rank has seen the release."""
    from datetime import timedelta

    import torch.distributed as dist

    if not dist.is_initialized():
        return
    store = dist.distributed_c10d._get_default_store()
    n = dist.get_world_size()
    key = f"mtpu_barrier:{name}"
    if store.add(key, 1) == n:
        store.set(key + ":release", "1")
    store.wait([key + ":release"],
               timedelta(milliseconds=_BARRIER_TIMEOUT_MS))
    if store.add(key + ":left", 1) == n:
        store.set(key + ":gone", "1")
    if dist.get_rank() == 0:
        store.wait([key + ":gone"],
                   timedelta(milliseconds=_BARRIER_TIMEOUT_MS))


def default_analyze(path: str, timeout: int = 60,
                    tpu_lanes: int = 0, bus=None,
                    stats: Optional[dict] = None) -> dict:
    """One contract end to end with the full default detector set.

    MTPU_ANALYZE_DELAY (test support): extra sleep per contract,
    simulating per-host wall latency (solver waits, device round
    trips) on test boxes where every rank shares one CPU — scheduling
    properties like work-stealing makespan are only observable when
    work is not purely CPU-bound. Either uniform seconds ("1.5") or
    per-contract-name substring rules ("metacoin=4.0,nonascii=0.2"),
    so rigged corpora keep their weight imbalance however fast the
    underlying analysis gets."""
    spec = os.environ.get("MTPU_ANALYZE_DELAY", "0") or "0"
    delay = 0.0
    if "=" in spec:
        name = Path(path).name
        for rule in spec.split(","):
            pat, _, secs = rule.partition("=")
            if pat and pat in name:
                delay = float(secs)
                break
    else:
        delay = float(spec)
    if delay:
        time.sleep(delay)

    from ..orchestration.mythril_analyzer import MythrilAnalyzer
    from ..orchestration.mythril_disassembler import MythrilDisassembler
    from ..support.analysis_args import make_cmd_args

    disassembler = MythrilDisassembler(eth=None)
    code = Path(path).read_text().strip()
    address, _ = disassembler.load_from_bytecode(code, bin_runtime=True)
    contract = disassembler.contracts[-1]
    if stats:
        # persisted fork peak seeds lane_engine.PATH_HISTORY so
        # pick_width engages a wide engine on the FIRST sweep of a
        # known wide-forking contract (parallel/cost_model.py)
        from .cost_model import warm_path_history

        warm_path_history(contract.disassembly, Path(path).name, stats)
    # per-contract live checkpointing (MTPU_CKPT, docs/checkpoint.md):
    # round snapshots (and a SIGTERM/fatal live dump) land under
    # --out-dir/ckpt/<name>.ckpt, so a killed rank's restart resumes
    # the interrupted contract instead of re-running it from zero.
    # Removed again after a completed analysis — a finished contract
    # must never "resume" into a no-op on the next corpus run.
    ckpt_path = None
    try:
        from ..support.checkpoint import live_enabled
        from ..support.telemetry import flightrec

        out_root = flightrec.configured_dir()
        if out_root and live_enabled():
            ckpt_dir = Path(out_root) / "ckpt"
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            ckpt_path = str(ckpt_dir / (Path(path).name + ".ckpt"))
    except Exception:
        ckpt_path = None
    cmd_args = make_cmd_args(execution_timeout=timeout,
                             tpu_lanes=tpu_lanes,
                             migration_bus=bus,
                             checkpoint=ckpt_path)
    analyzer = MythrilAnalyzer(
        disassembler=disassembler, cmd_args=cmd_args, strategy="bfs",
        address=address,
    )
    migrated = 0
    if bus is not None:
        bus.begin_contract(path, contract)
    tx_count = int(os.environ.get("MTPU_CORPUS_TX", "2") or 2)
    report = analyzer.fire_lasers(modules=None,
                                  transaction_count=tx_count)
    if bus is not None:
        # merge issues from batches other ranks analyzed for us —
        # append_issue dedups exactly as the unsplit run would
        migrated = bus.finalize_contract(report)
    if ckpt_path:
        for leftover in (ckpt_path, ckpt_path + ".verdicts"):
            try:
                os.unlink(leftover)
            except OSError:
                pass
    issues = report.sorted_issues()
    out = {
        "contract": Path(path).name,
        "issues": len(issues),
        "swc": sorted({i["swc-id"] for i in issues}),
    }
    from .cost_model import observed_fork_peak

    peak = observed_fork_peak(contract.disassembly)
    if peak:
        out["fork_peak"] = peak
    if migrated:
        out["migrated_batches"] = migrated
    return out


def _kv_client():
    """The rendezvous store's key-value channel (None when standalone),
    the channel the work-stealing claims ride: ``key_value_increment``
    is ``TCPStore.add``, an atomic fetch-add (exactly one rank sees
    1)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    store = dist.distributed_c10d._get_default_store()

    class _StoreClient:
        @staticmethod
        def key_value_increment(key, amount):
            return store.add(key, amount)

    return _StoreClient()


def _claim(client, item: str, owner: bool) -> bool:
    """Atomically claim a work item group-wide. Newer jax exposes the
    coordinator's atomic fetch-add (key_value_increment: exactly one
    rank sees 1); older builds (e.g. 0.4.37) only have key_value_set,
    whose allow_overwrite=False default REJECTS a second insert — so
    exactly one rank's set succeeds and the rest see ALREADY_EXISTS.
    On a degraded coordinator the OWNER keeps its shard (work must
    never be dropped; the worst case is duplicate analysis, which the
    merge dedups) while thieves claim nothing."""
    key = f"mtpu_claim:{item}"
    try:
        if hasattr(client, "key_value_increment"):
            return client.key_value_increment(key, 1) == 1
        client.key_value_set(key, "1")
        return True
    except Exception as e:
        if "exists" in str(e).lower():  # lost the claim race
            return False
        log.warning("work-claim failed (%s); %s", e,  # pragma: no cover
                    "owner keeps the item" if owner
                    else "not stealing")
        return owner


def run_corpus(paths: Sequence[str], out_dir: str, process_id: int,
               num_processes: int,
               analyze: Callable[[str], dict] = default_analyze,
               steal: bool = True, bus=None) -> dict:
    """Analyze this rank's shard — then STEAL unstarted contracts from
    other ranks' shards (SURVEY §2.10 distributed-backend row: work
    moves between hosts over DCN when a shard drains early). Each item
    is started under an atomic coordinator-side claim, so a stolen item
    never runs twice; thieves walk victim shards tail-first while
    owners work head-first, keeping contention at the boundary. Then
    write shard_<rank>.json, barrier, and (rank 0) merge every shard
    into corpus_report.json."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # per-rank observability (docs/observability.md): arm the crash
    # flight recorder + slow-query log against --out-dir — a rank that
    # dies mid-shard leaves --out-dir/flightrec/ instead of a
    # truncated log. Span tracing stays governed by MTPU_TRACE.
    from ..support import telemetry

    telemetry.configure(out_dir=str(out), rank=process_id)
    # cross-run warm store (support/warm_store.py): bind the
    # code-hash-keyed entry store to --out-dir/warm so re-analyses of
    # a re-submitted corpus start from prior proofs/static artifacts/
    # routing history. MTPU_WARM=0 (or --no-warm-store on the
    # analyzers) keeps behavior bit-for-bit cold.
    from ..support import warm_store

    warm_store.configure(str(out))
    # cost-aware LPT when a prior run left stats.json in --out-dir,
    # deterministic round-robin otherwise; long-pole contracts above
    # the perfect-balance share are pre-declared splittable so the
    # migration bus sheds their waves aggressively
    # (parallel/cost_model.py, docs/work_stealing.md)
    from .cost_model import load_stats, load_width_clamp, make_shards

    stats = load_stats(out)
    # capacity-autoprobe warm start: a width that kernel-faulted a
    # prior run over this --out-dir clamps pick_width from the first
    # sweep (lane_engine.capacity_clamp consults cost_model)
    load_width_clamp(out)
    shards, splittable = make_shards(paths, num_processes, stats)
    shard = shards[process_id]
    if bus is not None:
        bus.splittable = set(splittable)
    client = _kv_client() if num_processes > 1 else None
    results = []
    t0 = time.perf_counter()

    # crash-restart bookkeeping (docs/checkpoint.md): each completed
    # contract leaves an atomic result row under --out-dir/done/; a
    # restarted run (same --out-dir, after SIGKILL/SIGTERM/power loss)
    # adopts those rows and re-runs only the interrupted contract —
    # which then RESUMES from its per-contract checkpoint (see
    # default_analyze) instead of starting over. MTPU_CKPT=0 disables
    # both halves.
    from ..support.checkpoint import live_enabled as _ckpt_on

    done_dir = out / "done"
    done_rows = {}
    if _ckpt_on():
        done_dir.mkdir(exist_ok=True)
        report_file = out / "corpus_report.json"
        if report_file.exists():
            # the previous run over this --out-dir COMPLETED: its
            # done-rows and per-contract checkpoints are leftovers,
            # not resumable state — a fresh run must re-analyze, not
            # adopt (the stats.json LPT warm start is separate and
            # survives). Removing the report is what makes a crash of
            # THIS run distinguishable from a completed one.
            try:
                report_file.unlink()
            except OSError:
                pass
            for stale in list(done_dir.glob("*.json")) + list(
                    (out / "ckpt").glob("*")):
                try:
                    stale.unlink()
                except OSError:
                    pass
        for row_file in done_dir.glob("*.json"):
            try:
                row = json.loads(row_file.read_text())
                done_rows[row["path"]] = row
            except Exception:
                continue

    def _mark_done(r):
        if not _ckpt_on():
            return
        try:
            from hashlib import sha256

            name = sha256(r["path"].encode()).hexdigest()[:24]
            tmp = done_dir / (name + ".tmp")
            tmp.write_text(json.dumps(r))
            os.replace(tmp, done_dir / (name + ".json"))
        except Exception as e:  # bookkeeping only
            log.debug("done-row write failed: %s", e)

    def _run_one(path, stolen_from=None):
        prior = done_rows.get(str(path))
        if prior is not None:
            log.info("restart: %s already completed in a previous "
                     "run; adopting its result", path)
            results.append(prior)
            return
        t_c = time.perf_counter()
        try:
            r = analyze(path)
        except Exception as e:  # keep sweeping — reference parity with
            # the analyzer's per-contract exception capture
            log.warning("analysis of %s failed: %s", path, e)
            r = {"contract": Path(path).name, "error": type(e).__name__}
        r["path"] = str(path)  # merge dedups on the full path
        r.setdefault("wall_s", round(time.perf_counter() - t_c, 3))
        if stolen_from is not None:
            r["stolen_from"] = stolen_from
        results.append(r)
        _mark_done(r)

    for path in shard:
        if client is not None and steal and not _claim(client, path,
                                                       owner=True):
            log.info("rank %d: %s already claimed by a thief",
                     process_id, path)
            continue
        _run_one(path)
    if client is not None and steal:
        # drained: steal the tail of the busiest-looking victims
        for victim in range(num_processes):
            if victim == process_id:
                continue
            for path in reversed(shards[victim]):
                if _claim(client, path, owner=False):
                    log.info("rank %d: stole %s from rank %d",
                             process_id, path, victim)
                    _run_one(path, stolen_from=victim)
    migrated_served = 0
    if bus is not None:
        # whole contracts exhausted: this rank will publish no more
        # offers (mark it BEFORE serving, so every rank entering the
        # serve phase lets the others' serve loops terminate), then
        # serve migrated PATH BATCHES from ranks still mid-analysis
        bus.mark_done()
        migrated_served = bus.serve_offers_until_done()
    shard_report = {
        "process_id": process_id,
        "num_processes": num_processes,
        "wall_s": round(time.perf_counter() - t0, 2),
        "stolen": sum(1 for r in results if "stolen_from" in r),
        "migrated_batches_served": migrated_served,
        "migrated_batches_out": sum(
            r.get("migrated_batches", 0) for r in results),
        "results": results,
    }
    if bus is not None:
        shard_report["migration"] = dict(bus.stats)
    try:
        # this rank's solver counter block (verdict-cache reuse,
        # shipped/replayed proofs, queries_saved) — the steal smoke
        # gates on the THIEF's queries_saved being positive
        from ..smt.solver.solver_statistics import SolverStatistics

        shard_report["solver"] = SolverStatistics().batch_counters()
    except Exception:  # telemetry only
        pass
    try:
        # this rank's native metrics (per-tactic solver-wall
        # histograms, xla compile counts, span stats) ride the same
        # shard-report/merge path as the solver counters
        from ..support.telemetry import metrics as telemetry_metrics
        from ..support.telemetry import trace

        shard_report["metrics"] = telemetry_metrics.registry(
        ).export_state()
        if trace.enabled():
            trace.export_chrome_trace(
                out / f"trace_rank{process_id}.json",
                rank=process_id)
            trace.export_jsonl(
                out / f"trace_rank{process_id}.jsonl",
                rank=process_id)
    except Exception:  # telemetry only
        pass
    (out / f"shard_{process_id}.json").write_text(
        json.dumps(shard_report))
    _barrier("mythril_tpu_corpus_done")
    if process_id != 0:
        return shard_report
    merged = {"num_processes": num_processes, "contracts": [],
              "total_issues": 0, "errors": 0, "stolen": 0,
              "shards": []}
    seen = set()
    for rank in range(num_processes):
        shard_file = out / f"shard_{rank}.json"
        if not shard_file.exists():
            raise FileNotFoundError(
                f"{shard_file} missing after the corpus barrier: "
                "--out-dir must be a filesystem shared by every host "
                "(NFS/GCS mount) — each rank writes its shard report "
                "there for rank 0 to merge"
            )
        data = json.loads(shard_file.read_text())
        merged["shards"].append(
            {"process_id": rank, "wall_s": data["wall_s"],
             "n": len(data["results"]),
             "stolen": data.get("stolen", 0),
             "migrated_batches_served":
                 data.get("migrated_batches_served", 0),
             "migrated_batches_out":
                 data.get("migrated_batches_out", 0),
             "migration": data.get("migration", {}),
             "solver": data.get("solver", {}),
             "metrics": data.get("metrics", {})})
        merged["stolen"] += data.get("stolen", 0)
        for r in data["results"]:
            key = r.get("path", r["contract"])
            if key in seen:  # duplicate = degraded-coordinator rerun
                continue
            seen.add(key)
            merged["contracts"].append(r)
            merged["total_issues"] += r.get("issues", 0)
            merged["errors"] += 1 if "error" in r else 0
    merged["contracts"].sort(key=lambda r: r["contract"])
    # per-rank wall imbalance: 1.0 = perfect balance, and the makespan
    # metric the work-sharding scheduler is judged on (ISSUE 3 gates
    # max <= 1.5x mean on the rigged long-pole corpus)
    walls = [s["wall_s"] for s in merged["shards"]] or [0.0]
    mean = sum(walls) / len(walls)
    merged["wall_imbalance"] = round(max(walls) / mean, 3) \
        if mean > 0 else 1.0
    for key in ("states_migrated", "batches_out", "batches_in",
                "midround_exports", "midflight_steals"):
        merged[key] = sum(s["migration"].get(key, 0)
                          for s in merged["shards"])
    # corpus-wide metrics aggregate: per-rank registry states merge
    # (counters/histograms sum, gauges max) — the structured twin of
    # the summed migration counters above
    merged_metrics = None
    try:
        from ..support.telemetry import metrics as telemetry_metrics

        merged_metrics = telemetry_metrics.merge_states(
            [s.get("metrics") for s in merged["shards"]])
        merged["metrics"] = merged_metrics
    except Exception:  # telemetry only
        pass
    (out / "corpus_report.json").write_text(json.dumps(merged))
    # persist per-contract walls + fork peaks: the NEXT run over this
    # --out-dir seeds its LPT schedule and pick_width warm start from
    # them (parallel/cost_model.py); the merged telemetry block (per-
    # tactic solver-wall histograms) rides along for future solver
    # routing (ROADMAP open item 3)
    from .cost_model import save_stats

    save_stats(out, merged["contracts"], telemetry=merged_metrics)
    # warm-store GC (tools/warm_gc.py is the standalone twin): cap
    # --out-dir/warm by entry count/age so a long-lived corpus dir
    # cannot grow without bound (LRU by mtime; env-tunable caps)
    try:
        if warm_store.active():  # MTPU_WARM=0 must touch NO store file
            gc = warm_store.gc_store()
            if gc.get("removed"):
                log.info("warm store gc: removed %d entries (%d kept)",
                         len(gc["removed"]), gc["kept"])
    except Exception as e:  # housekeeping only
        log.debug("warm store gc failed: %s", e)
    return merged


def main(argv=None) -> int:
    if os.environ.get("MTPU_CORPUS_LOG"):
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--coordinator", default=None,
                        help="HOST:PORT of rank 0 (omit = standalone)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="defaults to $MTPU_NUM_PROCESSES or 1")
    parser.add_argument("--process-id", type=int, default=None,
                        help="defaults to $MTPU_PROCESS_ID or 0")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--timeout", type=int, default=60)
    parser.add_argument("--tpu-lanes", type=int, default=0)
    parser.add_argument("--solver-workers", type=int, default=None,
                        help="persistent solver pool width per rank "
                        "(smt/solver/pool.py; default: "
                        "$MTPU_SOLVER_WORKERS or min(4, cpu); 1 = "
                        "serial single-context solving)")
    parser.add_argument("--no-steal", action="store_true",
                        help="static shards only (no cross-host "
                        "work-stealing when a shard drains early)")
    parser.add_argument("--migrate", action="store_true",
                        help="also migrate PATH BATCHES: a drained "
                        "rank takes half of a busy rank's open-state "
                        "wave mid-analysis (parallel/migrate.py)")
    parser.add_argument("files", nargs="+")
    args = parser.parse_args(argv)

    if args.solver_workers is not None:
        from ..smt.solver.pool import configure_pool
        from ..support.support_args import args as sargs

        sargs.solver_workers = args.solver_workers
        configure_pool(workers=args.solver_workers)
    rank = init_distributed(args.coordinator, args.num_processes,
                            args.process_id)
    num_processes = args.num_processes or int(
        os.environ.get("MTPU_NUM_PROCESSES", 1))
    bus = None
    if args.migrate and num_processes > 1:
        from .migrate import MigrationBus

        bus = MigrationBus(args.out_dir, rank, num_processes,
                           timeout=args.timeout,
                           tpu_lanes=args.tpu_lanes)
    from .cost_model import load_stats

    stats = load_stats(args.out_dir)
    report = run_corpus(
        args.files, args.out_dir, rank, num_processes,
        analyze=lambda p: default_analyze(
            p, timeout=args.timeout, tpu_lanes=args.tpu_lanes,
            bus=bus, stats=stats),
        steal=not args.no_steal, bus=bus,
    )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
