"""Query counter/timer singleton (reference parity:
mythril/laser/smt/solver/solver_statistics.py:8-43 — restructured
around a timing context manager; the decorator form the reference uses
is kept as a thin shim over it)."""

import functools
import threading
from contextlib import contextmanager

from ...support.support_utils import Singleton


class SolverStatistics(object, metaclass=Singleton):
    """Tracks SMT query count and cumulative solver wall time, plus the
    batched-discharge and drain-pipeline counters (smt/solver/batch.py,
    laser/lane_engine.py — see docs/drain_pipeline.md). Queries count at
    the solver core (core.check) — the fresh-solve entry every
    cache/screen layer bottoms out in — so `query_count` is authoritative
    and always live; `enabled` is kept only for API compatibility."""

    def __init__(self):
        self.enabled = False
        # counter lock: solver-pool workers (smt/solver/pool.py)
        # update the hot counters concurrently, and `x += 1` is a
        # load/add/store sequence the GIL does NOT make atomic. Every
        # concurrent update site routes through bump(); single-threaded
        # sites keep plain assignments (exact by construction).
        self._lock = threading.Lock()
        self.query_count = 0
        self.solver_time = 0.0
        # batched feasibility discharge (smt/solver/batch.py +
        # support/model.check_batch)
        self.batch_count = 0          # discharge batches issued
        self.batch_queries = 0        # feasibility queries batched
        self.batch_solve_calls = 0    # queries that reached a solver
        self.prefix_dedup_hits = 0    # terms reused already-blasted
        self.subset_kills = 0         # UNSAT via recorded subset
        self.sat_subsumed = 0         # SAT via recorded superset
        self.quick_sat_hits = 0       # SAT via a sibling's cached model
        # run-wide verdict cache (smt/solver/verdicts.py — see
        # docs/feasibility_cache.md)
        self.verdict_hits = 0         # exact-key verdict reuse
        self.verdict_shadows = 0      # SAT via a parent model shadow
        self.verdict_shadow_rejects = 0  # deltas that broke the model
        self.verdict_unsat_kills = 0  # ancestor-UNSAT subsumption
        self.verdict_bound_seeds = 0  # interval screens seeded from a
        #                               cached parent prefix
        # device bidirectional propagation screen (ops/propagate.py —
        # see docs/propagation.md)
        self.propagate_kills = 0      # lanes refuted by the product-
        #                               domain fixpoint screen
        self.propagate_sweeps = 0     # fixpoint sweeps executed
        self.facts_harvested = 0      # learned facts read back for
        #                               surviving lanes
        self.hinted_solves = 0        # solver calls that asserted
        #                               harvested facts as hints
        # window/round-boundary lane merge + path subsumption
        # (laser/merge.py — see docs/lane_merge.md)
        self.lanes_merged = 0         # twins collapsed under an OR'd
        #                               constraint (incl. duplicates)
        self.lanes_subsumed = 0       # lanes retired because a sibling
        #                               provably covers their region
        self.merge_rounds = 0         # boundary passes that collapsed
        #                               at least one lane/state
        self.or_terms_built = 0       # disjunction terms minted by
        #                               merge events
        # static bytecode pre-analysis (analysis/static_pass/ — see
        # docs/static_pass.md)
        self.static_blocks = 0        # basic blocks recovered (fresh
        #                               analyses only, memo hits skip)
        self.static_jumps_resolved = 0  # jump sites with a complete
        #                                 static target set
        self.static_retired_lanes = 0  # lanes/states retired because
        #                                no active detector site is
        #                                reachable (zero solver work)
        self.static_pruner_skips = 0  # dependency-pruner wake-up
        #                               probes answered by concrete
        #                               set-disjointness
        # taint/dependence dataflow layer (analysis/static_pass/
        # taint.py, deps.py — see docs/static_pass.md)
        self.taint_mask_drops = 0     # anchor sites whose gen bit a
        #                               fresh refined plane dropped
        self.static_tx_prunes = 0     # tx-pair orderings excluded by
        #                               the static independence screen
        self.static_facts_seeded = 0  # implied storage facts seeded
        #                               into solves/propagation
        self.static_memo_evictions = 0  # static memo LRU cap
        #                                 evictions (re-analysis risk)
        # verified closed-form loop summaries (analysis/static_pass/
        # loop_summary.py — see docs/static_pass.md)
        self.loop_summaries_verified = 0  # instance classes whose
        #                                   closed form proved UNSAT-
        #                                   refutable (trusted)
        self.loop_summaries_rejected = 0  # verification failures —
        #                                   those loops keep unrolling
        self.loops_summarized_lanes = 0   # states whose loop handling
        #                                   a summary served (applied
        #                                   or bound-retired)
        self.unroll_iters_saved = 0       # loop iterations never
        #                                   executed thanks to applied
        #                                   summaries
        # verdict-cache shipping over the migration bus
        # (parallel/migrate.py — see docs/work_stealing.md)
        self.verdicts_shipped = 0     # entries exported with batches
        self.verdicts_replayed = 0    # shipped entries re-recorded
        #                               on the thief's term table
        # window-boundary lane-plane checkpointing
        # (support/checkpoint.py — see docs/checkpoint.md)
        self.lanes_exported = 0       # in-flight states exported from
        #                               a live wave (worklist slices +
        #                               device lanes, victim side)
        self.lanes_imported = 0       # in-flight states resumed into
        #                               a run (thief / restart side)
        self.midflight_steals = 0     # offers published that split a
        #                               live wave mid-round
        self.resume_rounds = 0        # interrupted rounds finished
        #                               from a restored live plane
        # gas-widening lane merge (laser/merge.py —
        # see docs/lane_merge.md)
        self.gas_widened_lanes = 0    # uneven-gas rejoin arms merged
        #                               under a widened interval
        # streaming retire/materialize pipeline (laser/lane_engine.py
        # _retire_chunked / _spill_merge, laser/retire_ring.py — see
        # docs/drain_pipeline.md "streaming retire")
        self.retire_chunks = 0        # bounded retire gathers issued
        self.retire_overlap_ms = 0.0  # deferred-pull wall hidden
        #                               behind the next window's
        #                               device execution
        self.spill_merged_lanes = 0   # spill candidates collapsed
        #                               before materialization
        self.ring_high_water = 0      # peak retire-ring occupancy
        #                               (gauge: bump_max)
        # cross-run warm store (support/warm_store.py — see
        # docs/warm_store.md)
        self.warm_hits = 0            # analyses that adopted a store
        #                               entry for their code hash
        self.warm_misses = 0          # analyses that started cold
        #                               with the store active
        self.verdicts_warmed = 0      # banked proofs replayed from a
        #                               prior run's entry
        self.facts_warmed = 0         # fact/bound banks replayed
        self.static_warmed = 0        # static-pass memo entries
        #                               adopted (cold slots only)
        self.route_first_try_wins = 0  # solver queries settled by the
        #                                learned first-try tactic and
        #                                budget (no escalation needed)
        # resident analysis daemon (mythril_tpu_torch/daemon/ — see
        # docs/daemon.md)
        self.daemon_requests = 0      # requests served by a resident
        #                               daemon (one per submission)
        self.queue_wait_ms = 0.0      # enqueue -> start latency summed
        #                               over requests (cost-model
        #                               scheduling visibility)
        self.requests_resumed = 0     # interrupted requests a
        #                               restarted daemon re-enqueued
        #                               from the persisted queue
        self.compile_reuse_hits = 0   # jit-cache hits (code planes +
        #                               window variants) whose compile
        #                               was paid by an EARLIER request
        # cross-tenant wave packing (docs/daemon.md §wave packing)
        self.waves_packed = 0         # packed explores run (>=2
        #                               members sharing one wave)
        self.pack_members = 0         # member requests folded into
        #                               packed explores, summed
        self.pack_occupancy_pct = 0.0  # peak live-lane share of a
        #                                wave's width (gauge:
        #                                bump_max; both modes book it,
        #                                packed waves run fuller)
        self.dispatches_saved = 0     # per packed window: one fewer
        #                               dispatch than solo waves would
        #                               have paid, per extra tenant
        self.lane_windows = 0         # fused window dispatches issued
        #                               (the denominator the packed
        #                               bench gate compares)
        self.mat_pool_reuses = 0      # K>=2 retire rings that reused
        #                               the process-wide worker pool
        #                               instead of spawning threads
        # shared-structure state codec (support/state_codec.py,
        # docs/state_codec.md): every spill/checkpoint/offer/warm
        # payload's byte ledger
        self.codec_bytes_raw = 0      # bytes the legacy per-payload
        #                               layout would have written
        self.codec_bytes_encoded = 0  # bytes the codec actually wrote
        self.codec_ref_hits = 0       # parts/columns delta-encoded
        #                               against a reference
        self.codec_fallback_whole = 0  # parts/columns stored whole
        #                                (chain heads + no-win deltas)
        self.codec_drop_whole = 0     # decode-side payloads dropped
        #                               whole (corrupt/skew/missing
        #                               reference — never partially
        #                               adopted)
        # window-pipeline overlap (laser/lane_engine.explore)
        self.overlap_idle_ms = 0.0    # device idle while host drained
        self.overlap_busy_ms = 0.0    # host work overlapped with device
        self.device_wait_ms = 0.0     # host blocked on the window pull
        # persistent solver pool (smt/solver/pool.py — see
        # docs/solver_pool.md)
        self.pool_workers = 0         # configured worker count (gauge)
        self.queries_pooled = 0       # queries dispatched to workers
        self.portfolio_races = 0      # escalations to a 2-tactic race
        self.races_won_by_tactic = {}  # tactic -> race wins
        self.worker_deaths = 0        # workers lost to an exception
        self.affinity_prefix_hits = 0  # queries landing on a worker
        #                                already holding their prefix
        self.async_overlap_ms = 0.0   # discharge_async solver time
        #                               hidden behind caller work
        # metrics-registry absorption (support/telemetry/metrics.py):
        # the registry snapshot carries this whole counter block under
        # the "solver" key, so structured exports (flight recorder,
        # shard reports, stats.json) see every counter without the
        # call sites changing — the attribute API above stays the shim
        try:
            from ...support.telemetry import metrics as _metrics

            _metrics.register_provider("solver", self._registry_view)
        except Exception:  # telemetry only
            pass

    def _registry_view(self) -> dict:
        """The full counter block as the metrics registry's `solver`
        provider: batch_counters plus the core query count/wall."""
        d = self.batch_counters()
        d["query_count"] = self.query_count
        d["solver_time_s"] = round(self.solver_time, 3)
        return d

    def bump(self, **deltas) -> None:
        """Atomically add deltas to counters (the only update path
        safe from solver-pool worker threads)."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def bump_max(self, **values) -> None:
        """Atomically raise gauge counters to at least the given
        values (high-water marks: ring occupancy peaks)."""
        with self._lock:
            for name, value in values.items():
                if value > getattr(self, name):
                    setattr(self, name, value)

    def bump_race_win(self, tactic: str) -> None:
        with self._lock:
            wins = self.races_won_by_tactic
            wins[tactic] = wins.get(tactic, 0) + 1

    def batch_counters(self) -> dict:
        """The batch/overlap counter block (benchmarks, plugins)."""
        return {
            "batch_count": self.batch_count,
            "batch_queries": self.batch_queries,
            "batch_solve_calls": self.batch_solve_calls,
            "prefix_dedup_hits": self.prefix_dedup_hits,
            "subset_kills": self.subset_kills,
            "sat_subsumed": self.sat_subsumed,
            "quick_sat_hits": self.quick_sat_hits,
            "verdict_hits": self.verdict_hits,
            "verdict_shadows": self.verdict_shadows,
            "verdict_shadow_rejects": self.verdict_shadow_rejects,
            "verdict_unsat_kills": self.verdict_unsat_kills,
            "verdict_bound_seeds": self.verdict_bound_seeds,
            "propagate_kills": self.propagate_kills,
            "propagate_sweeps": self.propagate_sweeps,
            "facts_harvested": self.facts_harvested,
            "hinted_solves": self.hinted_solves,
            "lanes_merged": self.lanes_merged,
            "lanes_subsumed": self.lanes_subsumed,
            "merge_rounds": self.merge_rounds,
            "or_terms_built": self.or_terms_built,
            "static_blocks": self.static_blocks,
            "static_jumps_resolved": self.static_jumps_resolved,
            "static_retired_lanes": self.static_retired_lanes,
            "static_pruner_skips": self.static_pruner_skips,
            "taint_mask_drops": self.taint_mask_drops,
            "static_tx_prunes": self.static_tx_prunes,
            "static_facts_seeded": self.static_facts_seeded,
            "static_memo_evictions": self.static_memo_evictions,
            "loop_summaries_verified": self.loop_summaries_verified,
            "loop_summaries_rejected": self.loop_summaries_rejected,
            "loops_summarized_lanes": self.loops_summarized_lanes,
            "unroll_iters_saved": self.unroll_iters_saved,
            "verdicts_shipped": self.verdicts_shipped,
            "verdicts_replayed": self.verdicts_replayed,
            "lanes_exported": self.lanes_exported,
            "lanes_imported": self.lanes_imported,
            "midflight_steals": self.midflight_steals,
            "resume_rounds": self.resume_rounds,
            "gas_widened_lanes": self.gas_widened_lanes,
            "retire_chunks": self.retire_chunks,
            "retire_overlap_ms": round(self.retire_overlap_ms, 1),
            "spill_merged_lanes": self.spill_merged_lanes,
            "ring_high_water": self.ring_high_water,
            "warm_hits": self.warm_hits,
            "warm_misses": self.warm_misses,
            "verdicts_warmed": self.verdicts_warmed,
            "facts_warmed": self.facts_warmed,
            "static_warmed": self.static_warmed,
            "route_first_try_wins": self.route_first_try_wins,
            "daemon_requests": self.daemon_requests,
            "queue_wait_ms": round(self.queue_wait_ms, 1),
            "requests_resumed": self.requests_resumed,
            "compile_reuse_hits": self.compile_reuse_hits,
            "waves_packed": self.waves_packed,
            "pack_members": self.pack_members,
            "pack_occupancy_pct": round(self.pack_occupancy_pct, 1),
            "dispatches_saved": self.dispatches_saved,
            "lane_windows": self.lane_windows,
            "mat_pool_reuses": self.mat_pool_reuses,
            "codec_bytes_raw": self.codec_bytes_raw,
            "codec_bytes_encoded": self.codec_bytes_encoded,
            "codec_ref_hits": self.codec_ref_hits,
            "codec_fallback_whole": self.codec_fallback_whole,
            "codec_drop_whole": self.codec_drop_whole,
            # every screen-answered query is a solver round trip that
            # never happened (the acceptance metric bench.py reports)
            "queries_saved": (
                self.subset_kills + self.sat_subsumed
                + self.quick_sat_hits + self.verdict_hits
                + self.verdict_shadows + self.verdict_unsat_kills
            ),
            "overlap_idle_ms": round(self.overlap_idle_ms, 1),
            "overlap_busy_ms": round(self.overlap_busy_ms, 1),
            "device_wait_ms": round(self.device_wait_ms, 1),
            # persistent solver pool (docs/solver_pool.md)
            "pool_workers": self.pool_workers,
            "queries_pooled": self.queries_pooled,
            "portfolio_races": self.portfolio_races,
            "races_won_by_tactic": dict(self.races_won_by_tactic),
            "worker_deaths": self.worker_deaths,
            "affinity_prefix_hits": self.affinity_prefix_hits,
            "async_overlap_ms": round(self.async_overlap_ms, 1),
        }

    @contextmanager
    def measure(self):
        """Compatibility shim: query counting/timing moved into the
        solver core (core.check), where every cache and screen layer
        bottoms out — counting here as well double-counted wrapped
        callers, and quick-sat/lru hits that never reach the core no
        longer inflate `query_count` (the batched discharge reads the
        delta to tell a cache hit from a real solve)."""
        yield

    def __repr__(self):
        return (
            f"Query count: {self.query_count} "
            f"Solver time: {self.solver_time}"
        )


def stat_smt_query(func):
    """Wrap an SMT check call in the statistics measurement."""

    @functools.wraps(func)
    def wrapper(*fargs, **fkwargs):
        with SolverStatistics().measure():
            return func(*fargs, **fkwargs)

    return wrapper
