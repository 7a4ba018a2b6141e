"""Profile the PyTorch port on the card: where the time goes.

    python3 tools/prof_torch_port.py [--k 12] [--lanes 4096]
    python3 tools/prof_torch_port.py --screen [--systems 8192] [--off]
    python3 tools/prof_torch_port.py --analyze calls.sol.o
    python3 tools/prof_torch_port.py --packed [--k 11] [--lanes 4096]

Without ``--screen`` or ``--analyze``: runs the device loop
(``support/device_loop.DeviceLoop``) on ``build_symbolic_contract(k)``
once to warm up (kernel builds, allocator), once timed on the host
clock, then once under ``torch.profiler``, and prints the card, both
wall times, the device time summed over kernels, the device busy share of the
profiled wall, and the kernels by device time.

With ``--analyze``: ``myth analyze`` of one vendored fixture through the
port with the corpus flags (``support/lane_compare.analyze_argv``), once
to warm up and once timed, its wall broken into the lane engine's
window dispatch (launches to the window's outputs on the host), the
host drain of records and forks, materialize, the K9 fingerprint, the
device screens (every call of the interval and propagation screens,
timed to their verdicts), the solver's queries and the rest of the
host; then once under ``torch.profiler`` for the device busy share.

With ``--packed``: the four members of chip_smoke.py's packed explore
(``support/runs.pack_codes``) explored solo, one engine each, and
packed into one ``LaneEngine.explore_packed``, in turns (solo, packed,
packed, solo) on the host clock; then one packed explore under
``cProfile`` (the host functions by cumulative time) and one under
``torch.profiler`` (the device busy share).

With ``--screen``: the same for ``models/pruner._screen_interval`` over
the ``bench_prefilter`` wave (``support/screen_waves.prefilter_wave``),
propagation on (``--off``: the forward interval pass), and the host
stages of one screen timed apart: linearize, the plan and its copy to
the card, the fixpoint (or interval sweep) to its verdicts, the
harvest.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mythril_tpu_torch.laser import lane_engine as le  # noqa: E402
from mythril_tpu_torch.support import device_loop  # noqa: E402
from mythril_tpu_torch.support.contracts import (  # noqa: E402
    build_symbolic_contract,
)
from mythril_tpu_torch.support.devices import resolve  # noqa: E402


def _explore(dev, k, lanes):
    code, _ = build_symbolic_contract(k)
    eng = device_loop.DeviceLoop(n_lanes=lanes, device=dev)
    return eng.explore(code, [device_loop.tx_entry_seed(eng.objects, 1, 512)])


def _analyze_parts(name):
    """One timed ``myth analyze`` of fixture ``name``: (wall s, {part:
    s}, issues, engine stats)."""
    from mythril_tpu_torch.ops import intervals, propagate
    from mythril_tpu_torch.smt.solver.solver_statistics import (
        SolverStatistics,
    )
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.lane_compare import (
        CREATION_FIXTURES, INPUTS,
    )

    screens = [0.0]

    def timed(mod, fname):
        fn = getattr(mod, fname)

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                screens[0] += time.perf_counter() - t0

        setattr(mod, fname, wrapper)
        return fn

    saved = [(m, f, timed(m, f)) for m, f in (
        (propagate, "prefilter_feasible"), (propagate, "abstraction_sets"),
        (intervals, "prefilter_feasible"), (intervals, "shadow_prefilter"))]
    ss = SolverStatistics()
    ss.enabled, ss.solver_time = True, 0.0
    le.PROF_ON = True
    le.PROF.clear()
    try:
        report, stats, wall = runs.analyze(
            (INPUTS / name).read_text().strip(),
            bin_runtime=name not in CREATION_FIXTURES, tx_count=2,
            tpu_lanes=64, solver_timeout=15000)
    finally:
        le.PROF_ON = False
        ss.enabled = False
        for m, f, fn in saved:
            setattr(m, f, fn)
    p = le.PROF
    parts = {
        "window dispatch": p.get("window_exec", 0) + p.get("window_pull", 0)
        + p.get("retire_dispatch", 0) + p.get("retire_pull", 0)
        + p.get("logs_escalate", 0) + p.get("flog_escalate", 0)
        + p.get("init_lanes", 0) + p.get("seed_pack", 0),
        "host drain": p.get("drain_py", 0) + p.get("resume_host", 0),
        "materialize": p.get("materialize", 0)
        + stats.get("overlap_mat_ms", 0) / 1e3,
        "K9 fingerprint": p.get("merge_fp", 0),
        "device screens": screens[0],
        "solver": ss.solver_time,
    }
    parts["rest of the host"] = wall - sum(parts.values())
    return wall, parts, len(report.issues), stats


def _screen_stages(dev, systems, off):
    """Wall seconds of one screen's host stages, each ended by a
    synchronize."""
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P

    out = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return val

    enc = stage("linearize", lambda: I.linearize(systems))
    if off:
        stage("interval sweep + verdicts", lambda: I.eval_feasible(enc, dev))
        return out
    plan = stage("build_plan", lambda: P.build_plan(enc))
    core = stage("plan to the card", lambda: P.plan_to_device(plan, dev))
    tabs, ok, _, sweeps = stage(
        "fixpoint + verdicts", lambda: P._run_host(core, plan.statics[0]))
    keep = ok.cpu().numpy()[:enc.n_real] & ~enc.dead[:enc.n_real]
    stage("harvest", lambda: P.harvest(enc, *tabs, keep))
    out["sweeps"] = sweeps
    return out


def _packed(k, lanes, card):
    import cProfile
    import pstats

    from mythril_tpu_torch.support import runs

    codes = runs.pack_codes(k)
    entries = []
    for code in codes:
        le.PATH_HISTORY[code] = lanes
        entries.append(runs.entry_states(code.hex(), tpu_lanes=lanes))

    def solo():
        return [len(le.LaneEngine(n_lanes=lanes).explore(c, list(s)))
                for c, s in zip(codes, entries)]

    def packed():
        out = le.LaneEngine(n_lanes=lanes).explore_packed(
            [(c, list(s), i) for i, (c, s) in enumerate(zip(codes, entries))])
        return [len(out[i]) for i in range(len(codes))]

    print(f"card: {card}")
    for name, fn in (("solo", solo), ("packed", packed), ("packed", packed),
                     ("solo", solo)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parked = fn()
        torch.cuda.synchronize()
        print(f"{name:7s} k={k} lanes={lanes}: parked {parked}, wall "
              f"{time.perf_counter() - t0:.3f} s")
    prof = cProfile.Profile()
    prof.enable()
    packed()
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(15)
    _, wall, rows = _profile(packed)
    dev_us = sum(e.self_device_time_total for e in rows)
    print(f"packed under torch.profiler: wall {wall:.3f} s, device "
          f"{dev_us / 1e3:.3f} ms, busy share {dev_us / 1e6 / wall:.4f}")


def _profile(fn):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return res, wall, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--screen", action="store_true")
    ap.add_argument("--systems", type=int, default=8192)
    ap.add_argument("--off", action="store_true")
    ap.add_argument("--analyze", metavar="FIXTURE")
    ap.add_argument("--packed", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.packed:
        _packed(args.k, args.lanes, card)
        return 0
    if args.analyze:
        _analyze_parts(args.analyze)  # warm: builds, allocator, caches
        wall, parts, n_issues, stats = _analyze_parts(args.analyze)
        print(f"card: {card}")
        print(f"analyze {args.analyze}: {n_issues} issues, wall "
              f"{wall:.3f} s, {stats.get('windows', 0)} windows, "
              f"{stats.get('forks', 0)} forks, "
              f"{stats.get('device_steps', 0)} device steps")
        for part, sec in parts.items():
            print(f"  {part:20s} {sec:8.3f} s {sec / wall:6.3f}")
        res, pwall, rows = _profile(lambda: _analyze_parts(args.analyze))
        dev_us = sum(e.self_device_time_total for e in rows)
        print(f"under the profiler: wall {pwall:.3f} s, device "
              f"{dev_us / 1e3:.3f} ms, busy share {dev_us / 1e6 / pwall:.4f}")
        for e in rows[:15]:
            print(f"  {e.key[:60]:60s} {e.count:7d} "
                  f"{e.self_device_time_total / 1e3:10.3f}")
        return 0
    if args.screen:
        from mythril_tpu_torch.models import pruner
        from mythril_tpu_torch.ops import propagate
        from mythril_tpu_torch.support.screen_waves import prefilter_wave

        propagate.FORCE = False if args.off else None
        systems, _ = prefilter_wave(args.systems)

        def run():
            return pruner._screen_interval(systems, lambda s: s)

        what = (f"screen of {args.systems} systems, propagation "
                f"{'off' if args.off else 'on'}")
        size = lambda kept: f"{len(kept)} kept"  # noqa: E731
    else:
        def run():
            return _explore(dev, args.k, args.lanes)

        what = f"k={args.k} lanes={args.lanes}"
        size = lambda res: (f"{res['paths']} paths, "  # noqa: E731
                            f"{len(res['windows'])} windows")
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    res, wall, rows = _profile(run)
    dev_us = sum(e.self_device_time_total for e in rows)
    print(f"card: {card}")
    print(f"{what}: {size(res)}, wall {plain_wall * 1e3:.3f} ms "
          f"({wall * 1e3:.3f} ms under the profiler)")
    print(f"device time {dev_us / 1e3:.3f} ms, busy share "
          f"{dev_us / 1e6 / wall:.3f}")
    if args.screen:
        stages = _screen_stages(dev, systems, args.off)
        print("host stages (s): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in stages.items()))
    print(f"{'kernel':60s} {'calls':>7s} {'device ms':>10s} {'share':>6s}")
    for e in rows[:25]:
        print(f"{e.key[:60]:60s} {e.count:7d} "
              f"{e.self_device_time_total / 1e3:10.3f} "
              f"{e.self_device_time_total / max(dev_us, 1):6.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
