"""Profile the PyTorch port on the card: where the time goes.

    python3 tools/prof_torch_port.py [--k 12] [--lanes 4096]
    python3 tools/prof_torch_port.py --screen [--systems 8192] [--off]

Without ``--screen``: runs ``LaneEngine.explore`` on
``build_symbolic_contract(k)`` once to warm up (kernel builds,
allocator), once timed on the host clock, then once under
``torch.profiler``, and prints the card, both wall times, the device
time summed over kernels, the device busy share of the profiled wall,
and the kernels by device time.

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
from mythril_tpu_torch.support.contracts import (  # noqa: E402
    build_symbolic_contract,
)
from mythril_tpu_torch.support.devices import resolve  # noqa: E402


def _explore(dev, k, lanes):
    code, _ = build_symbolic_contract(k)
    eng = le.LaneEngine(n_lanes=lanes, device=dev)
    return eng.explore(code, [le.tx_entry_seed(eng.objects, 1, 512)])


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
    args = ap.parse_args(argv)
    dev = resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
