"""Single source of truth for rendering the solver counter block.

PRs 4-8 each hand-wired new ``SolverStatistics.batch_counters`` keys
into four-plus places (two plugins, bench detail, shard reports) and
kept them in sync by review. This module makes the rendering
declarative: both telemetry plugins (laser/plugin/plugins/
benchmark.py and instruction_profiler.py) are thin renderers over
``counter_lines``, and the counter-drift guard
(tests/test_counter_drift.py) asserts ``covered_keys()`` equals the
``batch_counters`` key set — a counter added without a render line is
a TEST FAILURE, not a review catch.
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

#: (label, doc, gate, pairs) — gate () renders always, a tuple of
#: keys renders when any is truthy, a callable gets the counter dict.
#: pairs are (display_name, counter_key).
Gate = Union[Tuple[str, ...], Callable[[dict], bool]]

GROUPS: Sequence[Tuple[str, str, Gate, Tuple[Tuple[str, str], ...]]] = (
    ("Batched discharge", "docs/drain_pipeline.md", (), (
        ("batches", "batch_count"),
        ("queries", "batch_queries"),
        ("solve_calls", "batch_solve_calls"),
        ("prefix_dedup", "prefix_dedup_hits"),
        ("subset_kills", "subset_kills"),
        ("sat_subsumed", "sat_subsumed"),
        ("quick_sat", "quick_sat_hits"),
    )),
    ("Verdict cache", "docs/feasibility_cache.md", (), (
        ("hits", "verdict_hits"),
        ("unsat_kills", "verdict_unsat_kills"),
        ("shadows", "verdict_shadows"),
        ("shadow_rejects", "verdict_shadow_rejects"),
        ("bound_seeds", "verdict_bound_seeds"),
        ("queries_saved", "queries_saved"),
    )),
    ("Drain overlap", "docs/drain_pipeline.md",
     ("overlap_idle_ms", "overlap_busy_ms", "device_wait_ms"), (
        ("idle_ms", "overlap_idle_ms"),
        ("busy_ms", "overlap_busy_ms"),
        ("device_wait_ms", "device_wait_ms"),
    )),
    ("Propagation", "docs/propagation.md",
     ("propagate_kills", "facts_harvested", "hinted_solves"), (
        ("kills", "propagate_kills"),
        ("sweeps", "propagate_sweeps"),
        ("facts", "facts_harvested"),
        ("hinted_solves", "hinted_solves"),
    )),
    ("Lane merge", "docs/lane_merge.md",
     ("lanes_merged", "lanes_subsumed"), (
        ("merged", "lanes_merged"),
        ("subsumed", "lanes_subsumed"),
        ("rounds", "merge_rounds"),
        ("or_terms", "or_terms_built"),
        ("gas_widened", "gas_widened_lanes"),
    )),
    ("Solver pool", "docs/solver_pool.md",
     lambda c: c.get("pool_workers", 0) > 1
     or bool(c.get("queries_pooled")), (
        ("workers", "pool_workers"),
        ("pooled", "queries_pooled"),
        ("races", "portfolio_races"),
        ("race_wins", "races_won_by_tactic"),
        ("affinity_hits", "affinity_prefix_hits"),
        ("deaths", "worker_deaths"),
        ("async_overlap_ms", "async_overlap_ms"),
    )),
    ("Static pass", "docs/static_pass.md",
     ("static_blocks", "static_retired_lanes",
      "static_pruner_skips"), (
        ("blocks", "static_blocks"),
        ("jumps_resolved", "static_jumps_resolved"),
        ("retired", "static_retired_lanes"),
        ("pruner_skips", "static_pruner_skips"),
    )),
    ("Static taint/deps", "docs/static_pass.md",
     ("taint_mask_drops", "static_tx_prunes", "static_facts_seeded",
      "static_memo_evictions"), (
        ("mask_drops", "taint_mask_drops"),
        ("tx_prunes", "static_tx_prunes"),
        ("facts_seeded", "static_facts_seeded"),
        ("memo_evictions", "static_memo_evictions"),
    )),
    ("Loop summaries", "docs/static_pass.md",
     ("loop_summaries_verified", "loop_summaries_rejected",
      "loops_summarized_lanes", "unroll_iters_saved"), (
        ("verified", "loop_summaries_verified"),
        ("rejected", "loop_summaries_rejected"),
        ("lanes", "loops_summarized_lanes"),
        ("iters_saved", "unroll_iters_saved"),
    )),
    ("Verdict shipping", "docs/work_stealing.md",
     ("verdicts_shipped", "verdicts_replayed"), (
        ("shipped", "verdicts_shipped"),
        ("replayed", "verdicts_replayed"),
    )),
    ("Streaming retire", "docs/drain_pipeline.md",
     ("retire_chunks", "spill_merged_lanes"), (
        ("chunks", "retire_chunks"),
        ("pull_overlap_ms", "retire_overlap_ms"),
        ("spill_merged", "spill_merged_lanes"),
        ("ring_high_water", "ring_high_water"),
    )),
    ("State codec", "docs/state_codec.md",
     ("codec_bytes_raw", "codec_bytes_encoded", "codec_ref_hits",
      "codec_drop_whole"), (
        ("raw_bytes", "codec_bytes_raw"),
        ("encoded_bytes", "codec_bytes_encoded"),
        ("ref_hits", "codec_ref_hits"),
        ("whole", "codec_fallback_whole"),
        ("dropped", "codec_drop_whole"),
    )),
    ("Warm store", "docs/warm_store.md",
     ("warm_hits", "warm_misses", "verdicts_warmed",
      "static_warmed", "route_first_try_wins"), (
        ("hits", "warm_hits"),
        ("misses", "warm_misses"),
        ("verdicts_warmed", "verdicts_warmed"),
        ("facts_warmed", "facts_warmed"),
        ("static_warmed", "static_warmed"),
        ("route_wins", "route_first_try_wins"),
    )),
    ("Daemon", "docs/daemon.md",
     ("daemon_requests", "requests_resumed",
      "compile_reuse_hits"), (
        ("requests", "daemon_requests"),
        ("queue_wait_ms", "queue_wait_ms"),
        ("resumed", "requests_resumed"),
        ("compile_reuse", "compile_reuse_hits"),
    )),
    ("Wave packing", "docs/daemon.md",
     ("waves_packed", "dispatches_saved", "mat_pool_reuses"), (
        ("waves", "waves_packed"),
        ("members", "pack_members"),
        ("occupancy_pct", "pack_occupancy_pct"),
        ("dispatches_saved", "dispatches_saved"),
        ("windows", "lane_windows"),
        ("mat_pool_reuses", "mat_pool_reuses"),
    )),
    ("Checkpoint/resume", "docs/checkpoint.md",
     ("lanes_exported", "lanes_imported", "midflight_steals",
      "resume_rounds"), (
        ("exported", "lanes_exported"),
        ("imported", "lanes_imported"),
        ("midflight_steals", "midflight_steals"),
        ("resume_rounds", "resume_rounds"),
    )),
)


def covered_keys() -> set:
    """Every batch_counters key some group renders (the drift-guard
    contract: this must equal set(batch_counters().keys()))."""
    out = set()
    for _label, _doc, gate, pairs in GROUPS:
        out.update(key for _disp, key in pairs)
        if isinstance(gate, tuple):
            out.update(gate)
    return out


def _gated(gate: Gate, counters: dict) -> bool:
    if callable(gate):
        try:
            return bool(gate(counters))
        except Exception:
            return True
    if not gate:
        return True
    return any(counters.get(k) for k in gate)


def counter_lines(counters: dict, always: bool = False) -> List[str]:
    """Human-readable group lines over a batch_counters dict — the
    shared body of both telemetry plugins' reports. ``always``
    renders gated-off groups too (tests, verbose dumps)."""
    lines = []
    for label, _doc, gate, pairs in GROUPS:
        if not (always or _gated(gate, counters)):
            continue
        parts = []
        for disp, key in pairs:
            parts.append("{}={}".format(disp, counters.get(key, 0)))
        lines.append("{}: {}".format(label, " ".join(parts)))
    return lines
