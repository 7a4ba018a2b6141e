"""Profile the PyTorch port's main path on the card: where the device
time goes.

    python3 tools/prof_torch_port.py [--k 12] [--lanes 4096]

Runs ``LaneEngine.explore`` on ``build_symbolic_contract(k)`` once to
warm up (kernel builds, allocator), once timed on the host clock, then
once under ``torch.profiler``, and prints the card, both wall times, the
device time summed over kernels, the device busy share of the profiled
wall, and the kernels by device time.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _explore(dev, args.k, args.lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _explore(dev, args.k, args.lanes)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = _explore(dev, args.k, args.lanes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in rows)
    print(f"card: {card}")
    print(f"k={args.k} lanes={args.lanes}: "
          f"{res['paths']} paths, {len(res['windows'])} windows, wall "
          f"{plain_wall * 1e3:.3f} ms ({wall * 1e3:.3f} ms under the "
          f"profiler)")
    print(f"device time {dev_us / 1e3:.3f} ms, busy share "
          f"{dev_us / 1e6 / wall:.3f}")
    print(f"{'kernel':60s} {'calls':>7s} {'device ms':>10s} {'share':>6s}")
    for e in rows[:25]:
        print(f"{e.key[:60]:60s} {e.count:7d} "
              f"{e.self_device_time_total / 1e3:10.3f} "
              f"{e.self_device_time_total / max(dev_us, 1):6.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
