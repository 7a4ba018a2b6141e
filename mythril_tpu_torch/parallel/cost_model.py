"""Per-contract cost model for corpus scheduling (docs/work_stealing.md).

BENCH_r05 showed the corpus makespan pinned at `max(contract walls)`:
per-contract LPT cannot scale past the slowest contract, exactly the
per-program cost skew path explosion induces in bounded symbolic
execution. This module supplies the planning half of the fix:

* **stats persistence** — after every corpus run, rank 0 writes
  ``--out-dir/stats.json`` with each contract's measured wall time and
  fork-peak (the PATH_HISTORY worklist peak), merged over prior runs
  (wall: exponential moving average; fork peak: running max).
* **cost prediction** — the next run over the same ``--out-dir`` seeds
  per-contract cost estimates from the persisted walls (unknown
  contracts get the known median), refined online from first-round
  fork counts by the migration bus.
* **LPT-with-splitting schedule** — contracts sort by predicted cost
  descending onto the least-loaded rank (deterministic: every rank
  computes the same assignment from the same stats file, no
  communication). Contracts predicted above ``total / n_ranks`` are
  pre-declared SPLITTABLE: no static schedule can amortize them, so
  the migration bus sheds their open-state waves aggressively
  (mid-round, multi-way — parallel/migrate.py) instead of waiting for
  a thief to ask at a round boundary.
* **pick_width warm start** — persisted fork peaks seed
  ``lane_engine.PATH_HISTORY`` so the first sweep of a known
  wide-forking contract engages a wide engine (and the tunneled
  break-even gate) without re-learning the fork scale.
"""

import json
import logging
import os
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

log = logging.getLogger(__name__)

#: host-observed worklist peaks keyed by concrete code bytes. Filled
#: by svm's fork-scale recorder on EVERY run — including host-only
#: corpus runs, which have no lane engine (and must not import jax
#: just to record a peak). observed_fork_peak merges this table with
#: lane_engine.PATH_HISTORY when the lane path is loaded, so
#: stats.json carries real fork peaks either way (ROADMAP open item:
#: host-only runs used to persist fork_peak: 0).
HOST_PEAKS: Dict[bytes, int] = {}


def _light_code_bytes(code_obj) -> Optional[bytes]:
    """Concrete bytecode of a Disassembly without touching the lane
    path (mirror of lane_engine.code_to_bytes minus the symbolic-tuple
    folding, which needs support_utils only)."""
    bc = getattr(code_obj, "bytecode", None)
    if isinstance(bc, str):
        try:
            return bytes.fromhex(bc.replace("0x", ""))
        except ValueError:
            return None
    if isinstance(bc, (bytes, bytearray)):
        return bytes(bc)
    if isinstance(bc, tuple):
        try:
            from ..support.support_utils import fold_concrete_bytes

            norm = fold_concrete_bytes(bc)
            if all(isinstance(b, int) for b in norm):
                return bytes(norm)
        except Exception:
            return None
    return None


def record_host_peak(code_obj, peak: int) -> None:
    """Record a host-worklist fork peak for a contract's code (svm's
    fork-scale recorder; running max)."""
    code = _light_code_bytes(code_obj)
    if code and peak > HOST_PEAKS.get(code, 0):
        HOST_PEAKS[code] = peak

#: live-width clamps discovered by the lane engine's capacity
#: autoprobe (lane_engine.note_kernel_fault), keyed by the pow2
#: REQUEST shape that faulted (0 = the legacy shape-blind scalar, kept
#: for old stats files and old warm entries). A 256k probe's clamp
#: binds only 256k requests — a transient large-shape fault must not
#: starve the 32k path that never faulted (each shape pays at most
#: one probe session instead). Persisted into stats.json beside the
#: cost model so subsequent runs (and the daemon's schedulers) clamp
#: pick_width instead of re-faulting.
WIDTH_CLAMPS: Dict[int, int] = {}

#: legacy mirror of the shape-blind entry (WIDTH_CLAMPS[0]) — old
#: readers (pre-map warm entries) keep working; new code should call
#: width_clamp_for.
WIDTH_CLAMP: Optional[int] = None


def clamp_shape(width: int) -> int:
    """The pow2 clamp bucket of a requested width."""
    width = max(int(width), 1)
    return 1 << (width - 1).bit_length()


def record_width_clamp(width: int, shape: Optional[int] = None) -> None:
    """Record an autoprobe clamp (running min per shape — a tighter
    bound from any source wins). ``shape`` is the pow2 request shape
    whose probe session produced it; None records the legacy
    shape-blind entry (applies to every shape, as before PR 17)."""
    global WIDTH_CLAMP
    if not width:
        return
    key = clamp_shape(shape) if shape else 0
    cur = WIDTH_CLAMPS.get(key)
    if cur is None or width < cur:
        WIDTH_CLAMPS[key] = int(width)
    if key == 0:
        WIDTH_CLAMP = WIDTH_CLAMPS[0]


def width_clamp_for(width: int) -> Optional[int]:
    """The clamp binding a request of `width`: the entry for its own
    pow2 shape and the legacy shape-blind entry (key 0), whichever is
    tighter; None when neither exists. Entries for OTHER shapes never
    bind — the per-shape map exists precisely so a 256k fault cannot
    clamp the 32k path."""
    cands = [v for k, v in WIDTH_CLAMPS.items()
             if k == 0 or k == clamp_shape(width)]
    return min(cands) if cands else None


def load_width_clamp(out_dir) -> Optional[Dict[int, int]]:
    """Seed WIDTH_CLAMPS from a prior run's stats.json (corpus warm
    start — called beside load_stats). The persisted value is a
    per-shape map ({"<pow2 shape>": clamp}); a legacy scalar (pre-map
    stats file) still loads, as the shape-blind key-0 entry. Returns
    the map in force (empty dict = no clamp)."""
    path = Path(out_dir) / STATS_NAME
    try:
        if path.exists():
            clamp = json.loads(path.read_text()).get("lane_width_clamp")
            if isinstance(clamp, dict):
                for key, val in clamp.items():
                    if val:
                        record_width_clamp(
                            int(val),
                            shape=int(key) if int(key) else None)
            elif clamp:
                record_width_clamp(int(clamp))
    except Exception as e:  # pragma: no cover - warm start best-effort
        log.debug("width-clamp load failed: %s", e)
    return dict(WIDTH_CLAMPS)


STATS_NAME = "stats.json"

#: wall-time EMA weight for the newest observation
_EMA_ALPHA = 0.5


def _quarantine_stats(path: Path) -> None:
    """Move a corrupt stats file aside (``stats.json.corrupt``) so
    the next save starts from a clean slate instead of re-reading —
    and re-failing on — the same truncated bytes every run. Best
    effort; the quarantined copy is kept for post-mortems."""
    try:
        os.replace(path, str(path) + ".corrupt")
        log.warning("quarantined corrupt stats file as %s",
                    str(path) + ".corrupt")
    except OSError as e:  # pragma: no cover - fs races only
        log.debug("stats quarantine failed: %s", e)


def load_stats(out_dir) -> Dict[str, dict]:
    """{contract basename: {"wall_s": float, "fork_peak": int}} from a
    prior run's stats file, or {} when absent. A corrupt/truncated
    file (a crash mid-write predating the tmp+rename save, or disk
    damage) is tolerated — scheduling falls back to cold — and
    QUARANTINED so it cannot shadow every later run."""
    path = Path(out_dir) / STATS_NAME
    try:
        if not path.exists():
            return {}
        data = json.loads(path.read_text())
        if not isinstance(data, dict):
            raise ValueError("stats payload is not an object")
        contracts = data.get("contracts", {})
        return {str(k): v for k, v in contracts.items()
                if isinstance(v, dict)}
    except (KeyboardInterrupt, MemoryError):
        raise
    except Exception as e:
        log.warning("stats load failed (%s); scheduling cold", e)
        _quarantine_stats(path)
        return {}


def save_stats(out_dir, results: Sequence[dict],
               telemetry: Optional[dict] = None) -> None:
    """Merge this run's per-contract observations into stats.json
    (atomic replace; best-effort). `results` rows carry ``contract``
    (basename), ``wall_s``, and optionally ``fork_peak``.

    A ``telemetry`` block (support/telemetry/metrics.py export_state
    shape — per-tactic solver-wall histograms, xla compile counts)
    persists beside the cost model; when None, this process's own
    registry state is used. load_stats ignores it, so the LPT warm
    start is unaffected — it is the raw material for learned
    per-contract solver routing (ROADMAP open item 3)."""
    out = Path(out_dir)
    prior = load_stats(out)
    for r in results:
        name = r.get("contract")
        wall = r.get("wall_s")
        if not name or wall is None:
            continue
        entry = prior.setdefault(name, {})
        old = entry.get("wall_s")
        entry["wall_s"] = round(
            wall if old is None
            else _EMA_ALPHA * wall + (1 - _EMA_ALPHA) * old, 3)
        peak = int(r.get("fork_peak", 0) or 0)
        entry["fork_peak"] = max(peak, int(entry.get("fork_peak", 0)))
    if telemetry is None:
        try:
            from ..support.telemetry import metrics as _metrics

            telemetry = _metrics.registry().export_state()
        except Exception:
            telemetry = None
    payload = {"version": 1, "contracts": prior}
    # capacity-autoprobe clamps (running min per pow2 request shape
    # over prior runs): the engine side reads them back through
    # load_width_clamp/width_clamp_for so a shape that faulted once
    # never faults this fleet again — and a shape that never faulted
    # is never clamped by another's probe. A legacy scalar prior (or
    # one written by a pre-map build) merges as the shape-blind key-0
    # entry, and the persisted value is a {"<shape>": clamp} map.
    merged: Dict[int, int] = dict(WIDTH_CLAMPS)
    try:
        old = Path(out) / STATS_NAME
        if old.exists():
            prior_clamp = json.loads(old.read_text()).get(
                "lane_width_clamp")
            if isinstance(prior_clamp, dict):
                items = ((int(k), v) for k, v in prior_clamp.items())
            elif prior_clamp:
                items = ((0, prior_clamp),)
            else:
                items = ()
            for key, val in items:
                if val and (key not in merged or int(val) < merged[key]):
                    merged[key] = int(val)
    except Exception:
        pass
    if merged:
        payload["lane_width_clamp"] = {
            str(k): v for k, v in sorted(merged.items())}
    if telemetry:
        payload["telemetry"] = telemetry
    try:
        # atomic tmp+fsync+rename: a SIGTERM (or power loss) mid-write
        # must never truncate the cost model the next warm-start
        # schedule reads — the rename only lands a fully-flushed file,
        # and an interrupted write leaves the previous stats intact
        fd, tmp = tempfile.mkstemp(dir=str(out), prefix=".stats-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, out / STATS_NAME)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception as e:  # pragma: no cover - best-effort by design
        log.warning("stats save failed (%s)", e)


def predict_costs(paths: Sequence[str],
                  stats: Dict[str, dict]) -> Optional[Dict[str, float]]:
    """{path: predicted wall seconds}; None when no contract in the
    corpus has a prior (the caller falls back to round-robin, which
    stays deterministic with zero information)."""
    known = {}
    for p in paths:
        entry = stats.get(Path(p).name)
        if entry and entry.get("wall_s") is not None:
            known[p] = max(float(entry["wall_s"]), 1e-3)
    if not known:
        return None
    ordered = sorted(known.values())
    median = ordered[len(ordered) // 2]
    return {p: known.get(p, median) for p in paths}


def lpt_schedule(paths: Sequence[str], costs: Dict[str, float],
                 num_processes: int) -> List[List[str]]:
    """Longest-processing-time-first assignment onto `num_processes`
    ranks; ties break on the sorted path so every rank derives the
    identical schedule independently."""
    loads = [0.0] * num_processes
    shards: List[List[str]] = [[] for _ in range(num_processes)]
    for p in sorted(paths, key=lambda p: (-costs[p], p)):
        r = min(range(num_processes), key=lambda i: (loads[i], i))
        shards[r].append(p)
        loads[r] += costs[p]
    return shards


def splittable_set(paths: Sequence[str], costs: Dict[str, float],
                   num_processes: int) -> Set[str]:
    """Contracts predicted above the perfect-balance share
    ``total / n_ranks``: the long poles no static schedule can
    amortize — pre-declared for aggressive intra-contract sharding."""
    if num_processes <= 1 or not paths:
        return set()
    fair = sum(costs[p] for p in paths) / num_processes
    return {p for p in paths if costs[p] > fair}


def midwave_share(live: int, thieves: int, keep_min: int = 1) -> int:
    """Per-thief slice of a live IN-FLIGHT wave (docs/checkpoint.md:
    mid-flight wave splitting over the migration bus): an equal split
    across the victim and k thieves — the same proportional policy the
    finished-state export uses — floored so the victim always keeps at
    least ``keep_min`` states. 0 when the wave is too small to shed.
    One place for the policy so the svm worklist export and the lane
    engine's window-boundary export cannot drift."""
    if live <= keep_min or thieves < 1:
        return 0
    share = live // (thieves + 1)
    return max(0, min(share, live - keep_min))


def make_shards(paths: Sequence[str], num_processes: int,
                stats: Optional[Dict[str, dict]] = None,
                ) -> Tuple[List[List[str]], Set[str]]:
    """(per-rank shards, splittable paths). Cost-aware LPT when any
    prior exists, deterministic round-robin otherwise — both computed
    identically on every rank without communication."""
    costs = predict_costs(paths, stats or {})
    if costs is None:
        ordered = sorted(paths)
        return ([[p for i, p in enumerate(ordered)
                  if i % num_processes == r]
                 for r in range(num_processes)], set())
    return (lpt_schedule(paths, costs, num_processes),
            splittable_set(paths, costs, num_processes))


def warm_path_history(disassembly, name: str,
                      stats: Dict[str, dict]) -> None:
    """Seed lane_engine.PATH_HISTORY (pick_width / device_break_even)
    from a persisted fork peak, best-effort."""
    entry = stats.get(name)
    peak = int((entry or {}).get("fork_peak", 0) or 0)
    if peak <= 0:
        return
    try:
        from ..laser.lane_engine import PATH_HISTORY, code_to_bytes

        code = code_to_bytes(disassembly)
        if code and peak > PATH_HISTORY.get(code, 0):
            PATH_HISTORY[code] = peak
    except Exception:  # pragma: no cover - lane path optional
        pass


def observed_fork_peak(disassembly) -> int:
    """The fork peak recorded for a contract's code during this
    process's analyses: the max of the host-worklist table (filled on
    every run, including host-only) and — only when the lane path is
    already loaded — the lane engine's device-observed PATH_HISTORY.
    0 when nothing was recorded."""
    code = _light_code_bytes(disassembly)
    if code is None:
        return 0
    peak = int(HOST_PEAKS.get(code, 0))
    le = sys.modules.get("mythril_tpu_torch.laser.lane_engine")
    if le is not None:
        try:
            peak = max(peak, int(le.PATH_HISTORY.get(code, 0)))
        except Exception:  # pragma: no cover - lane path optional
            pass
    return peak
