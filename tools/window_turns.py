"""K2's and K4's call and device times of one tree of this repo, to
compare two commits in turns on one card.

    python3 tools/window_turns.py [--tree DIR]

Imports ``mythril_tpu_torch`` from ``DIR`` (default: this checkout; an
older commit unpacked with ``git archive`` works the same way, as long
as its ``prologue_kernel`` and ``epilogue_kernel`` take the arguments
they take here) and ``chip_smoke.py``'s inputs and timers from this
checkout. The inputs: the window of the device loop with the most seeds
(K2) and the most live records and parked lanes (K4) at 64 lanes (k=6),
512 lanes (k=9) and 4096 lanes (k=12), and ``check_window``'s (4096
lanes, 512 seeds). For each: the call on CUDA events (mean of 5, its
state reused as the engine's is, after a first call) and the device
time queued behind a spin kernel after an L2 flush (mean of 5). Prints
one JSON line with the card's name and power limit. Run e.g. parent,
change, change, parent, each in its own process.
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    from mythril_tpu_torch.ops import symstep

    if not os.path.abspath(le.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {le.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    _build.build_all()
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
    times = {}
    for what, (pro, epi) in inputs.items():
        for name, kern, call_args in (
                ("window_prologue", le.prologue_kernel, pro),
                ("window_epilogue", le.epilogue_kernel, epi)):
            src, rest = call_args[0], call_args[1:]
            work = cs.clone_state(src)

            def setup(s=src, w=work):
                return cs.restore(w, s)

            def call(x, f=kern, r=rest):
                return f(x, *r)

            times[f"{name} at {what}"] = {
                "call_ms": cs.cuda_ms(call, reps=5, setup=setup),
                "device_ms": cs.queued_ms(call, setup, reps=5)}
            torch.cuda.synchronize()
    print(json.dumps({"tree": tree, "card": cs.smi(), "times": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
