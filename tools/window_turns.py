"""One kernel group's call and device times of one tree of this repo, to
compare two commits in turns on one card.

    python3 tools/window_turns.py [window|k9k10] [--tree DIR]

Imports ``mythril_tpu_torch`` from ``DIR`` (default: this checkout; an
older commit unpacked with ``git archive`` works the same way, as long
as the group's functions take the arguments they take here) and
``chip_smoke.py``'s inputs and timers from this checkout. The groups:

- ``window`` (the default): K2's ``prologue_kernel`` and K4's
  ``epilogue_kernel`` on the window of the device loop with the most
  seeds (K2) and the most live records and parked lanes (K4) at 64
  lanes (k=6), 512 lanes (k=9) and 4096 lanes (k=12), and on
  ``check_window``'s (4096 lanes, 512 seeds); means of 5, the state
  reused as the engine's is, after a first call;
- ``k9k10``: K10's ``run_kernel`` on ``bench_device``'s batch (32768
  lanes, the bench contract, to the end), on a 4096-lane shard of it,
  and on 131072 lanes of ``init_lanes``' default planes (the lane mix
  contract, 4096 steps); ``sharded_run`` of the 32768 lanes on 8 shards
  of the card; K9's ``merge_fingerprint_kernel`` on the k=12 main
  path's state after its first window at 4096 lanes and at the corpus's
  64. Means of 3 (K9's of 5), each K10 run on a fresh batch.

For each: the call on CUDA events and the device time queued behind a
spin kernel after an L2 flush. Prints one JSON line with the card's
name and power limit. Run e.g. parent, change, change, parent, each in
its own process.
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window_times(cs, dev, timed) -> None:
    """K2's and K4's times (the ``window`` group)."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep

    inputs = {f"{n} lanes, k={k} loop": cs.window_inputs(dev, n, k)
              for n, k in ((64, 6), (512, 9), (cs.MAIN_LANES, cs.MAIN_K))}
    st, cc, (i32b, u8b, k, pv) = cs.seeded_state(dev, cs.MAIN_LANES // 8)
    pro = (cs.clone_state(st), i32b, u8b, k, pv)
    le.prologue_kernel(st, i32b, u8b, k, pv)
    vis = torch.zeros(cc.packed.shape[0], dtype=torch.bool, device=dev)
    st, _ = symstep.sym_run_kernel(cc, st, le.DEFAULT_WINDOW,
                                   symstep.SYM_EXECUTABLE, None, vis)
    canon = le.dedup_kernel(st)
    inputs["4096 lanes, 512 seeds (check_window)"] = (
        pro, (st, cc, canon, le.DEFAULT_STEP_BUDGET, 1))
    for what, (pro, epi) in inputs.items():
        for name, kern, call_args in (
                ("window_prologue", le.prologue_kernel, pro),
                ("window_epilogue", le.epilogue_kernel, epi)):
            src, rest = call_args[0], call_args[1:]
            work = cs.clone_state(src)
            timed(f"{name} at {what}",
                  lambda x, f=kern, r=rest: f(x, *r),
                  lambda s=src, w=work: cs.restore(w, s), reps=5)


def k9k10_times(cs, dev, timed) -> None:
    """K10's, ``sharded_run``'s and K9's times (the ``k9k10`` group)."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support import contracts as C

    cc = S.compile_code(C.build_bench_contract(), device=dev)
    cap = C.BENCH_MAX_STEPS
    n = cs.CONCRETE_N
    timed(f"lane_run, {n} lanes (bench batch)",
          lambda x: S.run_kernel(cc, x, cap), lambda: C.bench_batch(n, dev))
    timed(f"lane_run, {n // 8}-lane shard",
          lambda x: S.run_kernel(cc, x, cap),
          lambda: C.bench_batch(n // 8, dev))
    mesh = M.Mesh([dev] * 8)
    timed(f"sharded_run, {n} lanes on 8 shards",
          lambda x: M.sharded_run(cc, M.shard_lanes(x, mesh), cap, mesh),
          lambda: C.bench_batch(n, dev))
    wcc = S.compile_code(C.build_lane_mix_contract(), device=dev)
    wide = cs.WIDE_CONCRETE_N
    timed(f"lane_run, {wide} lanes of default planes (lane mix)",
          lambda x: S.run_kernel(wcc, x, cs.WIDE_CONCRETE_STEPS),
          lambda: C.lane_mix_batch(wide, cs.SEED, device=dev), reps=2)
    torch.cuda.empty_cache()
    for lanes in (cs.MAIN_LANES, 64):
        st, pairs, _ = cs.main_path_state(dev, lanes)
        timed(f"merge_fingerprint, {lanes} lanes",
              lambda _=None, s=st, p=pairs: le.merge_fingerprint_kernel(s, p),
              lambda: None, reps=5)


GROUPS = {"window": window_times, "k9k10": k9k10_times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("group", nargs="?", choices=sorted(GROUPS),
                    default="window")
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("window_turns: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py, whichever tree the package is from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le

    if not os.path.abspath(le.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {le.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    _build.build_all()
    times = {}

    def timed(what, fn, setup, reps=3):
        times[what] = {"call_ms": cs.cuda_ms(fn, reps=reps, setup=setup),
                       "device_ms": cs.queued_ms(fn, setup, reps=reps)}
        torch.cuda.synchronize()

    GROUPS[args.group](cs, dev, timed)
    print(json.dumps({"tree": tree, "group": args.group, "card": cs.smi(),
                      "times": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
