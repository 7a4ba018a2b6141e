"""Profile the PyTorch port on the card: where the time goes.

    python3 tools/prof_torch_port.py [--k 12] [--lanes 4096]
    python3 tools/prof_torch_port.py --screen [--systems 8192] [--off]
    python3 tools/prof_torch_port.py --analyze calls.sol.o
    python3 tools/prof_torch_port.py --packed [--k 11] [--lanes 4096]
    python3 tools/prof_torch_port.py --kernels
    python3 tools/prof_torch_port.py --dedup
    python3 tools/prof_torch_port.py --tables
    python3 tools/prof_torch_port.py --window

Without ``--screen`` or ``--analyze``: builds the kernels, runs the
device loop (``support/device_loop.DeviceLoop``) on
``build_symbolic_contract(k)`` once (the process's first run: the
allocator's first blocks), once timed on the host clock, then once
under ``torch.profiler``, and prints the card, the three wall times,
the device time summed over kernels, the device busy share of the
profiled wall, and the kernels by device time.

With ``--analyze``: ``myth analyze`` of one vendored fixture through the
port with the corpus flags (``support/lane_compare.analyze_argv``), once
to warm up and once timed, its wall broken into the lane engine's
window dispatch (launches to the window's outputs on the host), the
host drain of records and forks, materialize, the K9 fingerprint, the
device screens (every call of the interval and propagation screens,
timed to their verdicts), the solver's queries and the rest of the
host; then once under ``torch.profiler`` for the device busy share;
then once more with K6's and K7's calls timed one by one, on copies of
their inputs (a call on CUDA events and its device time behind a spin
kernel), grouped by (states, table rows, real entries), and K2's and
K4's the same way, grouped by (lanes, seeds, pairs), after the
compiler's register and spill lines of ``csrc/window.cu``.

With ``--window``: K2 (``window_prologue``) and K4 (``window_epilogue``)
as chip_smoke.py holds them (``check_window``, with K3's checks, and
``check_k2_k4``: the edge inputs in each launch mode, real windows at
64-131072 lanes, one CUDA launch a call, no host wait, the call and
device times at 64, 512 and 4096 lanes), after the compiler's
register and spill lines of ``csrc/window.cu``.

With ``--tables``: K5-K8 against their plain versions and timed as
``chip_smoke.py``'s screen phase does it (``check_screens``, then the
edge inputs ``check_screen_edges``), after the compiler's register and
spill lines of ``csrc/screen.cu``.

With ``--packed``: the four members of chip_smoke.py's packed explore
(``support/runs.pack_codes``) explored solo, one engine each, and
packed into one ``LaneEngine.explore_packed``, in turns (solo, packed,
packed, solo) on the host clock; then one packed explore under
``cProfile`` (the host functions by cumulative time) and one under
``torch.profiler`` (the device busy share).

With ``--kernels``: K1 and K14 at their shapes. K1 (``sym_run_kernel``)
over 64 steps of chip_smoke.py's K1 inputs at 4096 and 64 lanes and of
its packed arena (row 2p) at 4096 lanes, under ``torch.profiler``: the
device time a step split by kernel name, the launches a window
(``sync_every`` 1, 8 and 32), the call a step on CUDA events, and the
device time of a step in which no lane runs; and K1 on 131072 lanes of
the k=17 device loop (``chip_smoke.k1_wide_state``, two lanes a
thread). K14 (``lane_gather``) on
the mesh phase's 32768-lane batch and on 131072 lanes at the default
planes: the call on CUDA events beside ``index_select`` of the 17
planes (in turns), its device time alone, and a ``cProfile`` of 1000
calls (100 at 131072 lanes). First the compiler's register and spill
lines of ``csrc/symstep.cu`` and ``csrc/mesh.cu``.

With ``--dedup``: K3 (``window_dedup``) in each of its launch shapes.
First the compiler's lines of ``csrc/window.cu``, and K3 exact against
``dedup_plain`` on ``device_loop.k3_edge_cases`` in each launch mode.
Then on the device loop's dedup input with the most live records
(``chip_smoke.k3_input``) at 64 to 131072 lanes: its rounds and
records, and the device time (behind a spin kernel after an L2 flush)
of one block of up to 1024 threads and of cooperative grids of 1024-
and 256-thread blocks, each shape exact and timed in turns, which
places the crossover of ``window_dedup_shape``; the call on CUDA events,
the host's time of a call in each shape and the phases' SM cycles a
round; at 4096 lanes a cProfile of K3's and K4's ``fork_table``'s host
side, and ``fork_table``'s call against ``torch.stack`` in turns.

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


def _time_screen_kernels(records):
    """Wrap K6's and K7's wrappers for one analysis: each call is first
    timed on copies of its input, as a call on CUDA events (the host's
    launch included) and as device time (events around the call queued
    behind a spin kernel, the tables as the analysis leaves them in the
    L2), then run on its input; ``records`` gets (kernel, S, T, real
    entries, call ms, device ms) a call. Returns the undo."""
    from chip_smoke import SPIN_CYCLES
    from mythril_tpu_torch.ops import propagate

    def timed(name, kern):
        def call(entry, tabs, changed=None):
            out = []
            for spin in (False, True):
                x = tuple(t.clone() for t in tabs)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                if spin:
                    torch.cuda._sleep(SPIN_CYCLES)
                a.record()
                kern(entry, x)
                b.record()
                torch.cuda.synchronize()
                out.append(a.elapsed_time(b))
            kern(entry, tabs, changed)
            records.append((name, tabs[0].shape[0], tabs[0].shape[1],
                            entry["ent"].shape[0], *out))
        return call

    saved = (propagate.fwd_level_kernel, propagate.back_round_kernel)
    propagate.fwd_level_kernel = timed("prop_fwd_level", saved[0])
    propagate.back_round_kernel = timed("prop_back_round", saved[1])

    def undo():
        propagate.fwd_level_kernel, propagate.back_round_kernel = saved
    return undo


def _time_window_kernels(records):
    """Wrap K2's and K4's wrappers for one analysis, as
    ``_time_screen_kernels`` wraps K6's and K7's (on a copy of the state
    that a first untimed call has met, as the engine's state is met by
    every window after its first): ``records`` gets (kernel, lanes,
    seeds, pairs, call ms, device ms) a call. Returns the undo."""
    from chip_smoke import SPIN_CYCLES, clone_state, restore

    def timed(name, kern, key):
        def call(st, *rest, **kw):
            out = []
            x = clone_state(st)
            kern(x, *rest)  # its argument block built, as the engine's
            for spin in (False, True):
                restore(x, st)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                if spin:
                    torch.cuda._sleep(SPIN_CYCLES)
                a.record()
                kern(x, *rest)
                b.record()
                torch.cuda.synchronize()
                out.append(a.elapsed_time(b))
            got = kern(st, *rest, **kw)
            records.append((name, st.pc.shape[0], *key(rest), *out))
            return got
        return call

    saved = (le.prologue_kernel, le.epilogue_kernel)
    le.prologue_kernel = timed("window_prologue", saved[0],
                               lambda rest: (rest[2], rest[3]))
    le.epilogue_kernel = timed("window_epilogue", saved[1],
                               lambda rest: (0, 0))

    def undo():
        le.prologue_kernel, le.epilogue_kernel = saved
    return undo


def _print_window_shapes(records):
    """K2's and K4's calls of one analysis by (lanes, seeds, pairs): the
    count, the median call and device ms, the device ms summed."""
    import statistics

    groups = {}
    for name, n, k, pv, call_ms, dev_ms in records:
        groups.setdefault((name, n, k, pv), []).append((call_ms, dev_ms))
    print(f"  {'kernel':16s} {'lanes':>6s} {'seeds':>6s} {'pairs':>6s} "
          f"{'calls':>6s} {'call ms':>9s} {'device ms':>10s} "
          f"{'device sum':>11s}")
    for key, got in sorted(groups.items()):
        print(f"  {key[0]:16s} {key[1]:6d} {key[2]:6d} {key[3]:6d} "
              f"{len(got):6d} {statistics.median(c for c, _ in got):9.4f} "
              f"{statistics.median(d for _, d in got):10.4f} "
              f"{sum(d for _, d in got):11.4f}")


def _print_build_lines(src):
    """The compiler's register, stack and spill lines of one source."""
    from mythril_tpu_torch import _build

    for line in _build.build_log(src).splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"  {src}: {line.strip()}")


def _window(card):
    """K2 and K4 as chip_smoke.py holds them (``check_window``: the
    window at 512 lanes and its escalations, K3's checks, then
    ``check_k2_k4``), with the compiler's lines of ``csrc/window.cu``."""
    import chip_smoke as cs
    from mythril_tpu_torch import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    print(f"card: {card}")
    _print_build_lines("window.cu")
    report = {}
    cs.check_window(dev, report)
    for name in ("window_prologue", "window_epilogue"):
        print(f"{name}: {report[name]} on {card}")


def _print_screen_shapes(records):
    """K6's and K7's calls of one analysis by (S, T, real entries): the
    count, the median call and device ms, the device ms summed."""
    import statistics

    groups = {}
    for name, s, t, n, call_ms, dev_ms in records:
        groups.setdefault((name, s, t, n), []).append((call_ms, dev_ms))
    print(f"  {'kernel':16s} {'S':>6s} {'T':>6s} {'n':>6s} {'calls':>6s} "
          f"{'call ms':>9s} {'device ms':>10s} {'device sum':>11s}")
    for key, got in sorted(groups.items(), key=lambda kv: (kv[0][0],
                                                           -len(kv[1]))):
        print(f"  {key[0]:16s} {key[1]:6d} {key[2]:6d} {key[3]:6d} "
              f"{len(got):6d} {statistics.median(c for c, _ in got):9.4f} "
              f"{statistics.median(d for _, d in got):10.4f} "
              f"{sum(d for _, d in got):11.4f}")


def _tables(card):
    """K5-K8 as chip_smoke.py's screen phase holds them: against their
    plain versions on the all-opcode wave and the edge inputs, and timed
    at the 8192-system wave's shapes, with the compiler's lines of
    ``csrc/screen.cu``."""
    import chip_smoke as cs
    from mythril_tpu_torch import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    print(f"card: {card}")
    for line in _build.build_log("screen.cu").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"  screen.cu: {line.strip()}")
    report = {}
    cs.check_screens(dev, report, cs.screen_wave(dev))
    cs.check_screen_edges(dev)
    for name, r in report.items():
        print(f"{name}: call {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.1f} ms on {card}")


def _analyze_parts(name, shapes=None):
    """One timed ``myth analyze`` of fixture ``name``: (wall s, {part:
    s}, issues, engine stats); with ``shapes`` (two lists), K6's and
    K7's calls timed into the first (``_time_screen_kernels``), K2's and
    K4's into the second (``_time_window_kernels``)."""
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
    if shapes is not None:
        saved.append((None, None, _time_screen_kernels(shapes[0])))
        saved.append((None, None, _time_window_kernels(shapes[1])))
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
            if m is None:
                fn()
            else:
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


def _kernels(card):
    import cProfile
    import pstats

    import chip_smoke as cs
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support import contracts as C

    dev = torch.device("cuda", 0)
    _build.build_all()
    print(f"card: {card}")
    for src in ("symstep.cu", "mesh.cu"):
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                print(f"  {src}: {line.strip()}")
    steps = 64
    wcc, wide, _, _ = cs.k1_wide_state(dev)
    cases = [("4096 lanes", *cs.k1_state(dev)),
             ("64 lanes", *cs.k1_state(dev, 64)),
             ("packed 4096 lanes", *cs.packed_state(dev)[:2]),
             ("131072 lanes (k=17)", wide, wcc)]
    for what, st, cc in cases:
        probe = cs.clone_state(st)
        symstep.sym_run_kernel(cc, probe, steps)
        ran = int(probe.step_no) - int(st.step_no)
        for every in (1, symstep.SYNC_EVERY, 32):
            def run(e=every):
                symstep.sym_run_kernel(cc, cs.clone_state(st), steps,
                                       sync_every=e)
            before = dict(_build.LAUNCHES)
            run()
            launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                        if v != before[k]}
            split = cs.k1_profile(run, ran)
            call = cs.cuda_ms(
                lambda c, e=every: symstep.sym_run_kernel(
                    cc, c, steps, sync_every=e),
                reps=3, setup=lambda: cs.clone_state(st)) / ran
            print(f"K1 {what}, sync_every {every}: {ran} steps, call "
                  f"{call:.4f} ms a step, device "
                  f"{sum(v[1] for v in split.values()):.4f} ms a step; "
                  f"counters {launched}")
            for name, (count, ms) in split.items():
                print(f"    {name[:50]:50s} {count:6d} launches "
                      f"{ms:.5f} ms a step")
            if "k_sym_run" in "".join(split):
                print(f"    phases (share of block 0's cycles): "
                      f"{cs.k1_phases(cc, st, steps, every)}")
        # a run in which no lane runs: every lane parked
        idle = cs.clone_state(st)
        idle.status.fill_(S.Status.NEEDS_HOST)
        split = cs.k1_profile(
            lambda: symstep.sym_run_kernel(cc, cs.clone_state(idle), 1), 1)
        print(f"K1 {what}: a run with no lane running, device "
              f"{sum(v[1] for v in split.values()):.5f} ms "
              f"({ {k[:40]: round(v[1], 5) for k, v in split.items()} })")

    cc = S.compile_code(C.build_bench_contract(), device=dev)
    mid = S.run_kernel(cc, C.bench_batch(32768, dev), 400)
    wcc = S.compile_code(C.build_lane_mix_contract(), device=dev)
    wide = C.lane_mix_batch(131072, cs.SEED, device=dev)
    S.run_kernel(wcc, wide, 64)
    for st, calls in ((mid, 1000), (wide, 100)):
        n = st.pc.shape[0]
        order = M.lane_order(st.status, 8)
        rows = M.source_rows(order, n)
        planes = [getattr(st, f) for f in S.LANE_FIELDS]
        times = {}
        for name, fn in (("lane_gather", lambda: M.lane_gather(st, order)),
                         ("index_select", lambda: [
                             x.index_select(0, rows) for x in planes]),
                         ("index_select", lambda: [
                             x.index_select(0, rows) for x in planes]),
                         ("lane_gather", lambda: M.lane_gather(st, order))):
            times.setdefault(name, []).append(cs.cuda_ms(fn, reps=20))
        dev_ms = cs.queued_ms(lambda _: M.lane_gather(st, order),
                              lambda: None, reps=5)
        nbytes = 2 * n * S.lane_bytes(st)
        print(f"K14 {n} lanes ({S.lane_bytes(st)} bytes a lane): call "
              f"{times['lane_gather']} ms, index_select "
              f"{times['index_select']} ms (in turns), device {dev_ms:.4f} "
              f"ms, bound {nbytes / cs.PEAK_BYTES * 1e3:.6f} ms (bytes)")
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        t0 = time.perf_counter()
        for _ in range(calls):
            M.lane_gather(st, order)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.disable()
        print(f"K14 {n} lanes: {calls} calls under cProfile, "
              f"{wall / calls * 1e3:.4f} ms a call")
        pstats.Stats(prof).sort_stats("tottime").print_stats(14)


def _dedup(card):
    import chip_smoke as cs
    from mythril_tpu_torch import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    print(f"card: {card}")
    for line in _build.build_log("window.cu").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"  window.cu: {line.strip()}")
    for case in device_loop.k3_edge_cases():
        st = device_loop.k3_case_state(case, dev)
        cs.hold_k3(st, case.name, (None,) + cs.k3_shapes(case.lanes))
    print("K3 exact on k3_edge_cases in each launch mode")
    for n, k in ((64, 6), (1024, 10), (2048, 11), (4096, 12), (8192, 13),
                 (16384, 14), (32768, 15), (131072, 17)):
        st = cs.k3_input(dev, n, k)
        rounds, records = cs.k3_rounds(st)
        shapes = {"one block": (1, min(1024, -(-n // 32) * 32), 0),
                  "grid of 1024": (min(132, max(2, -(-n // 1024))), 1024,
                                   1),
                  "grid of 256": (min(264, max(2, -(-n // 256))), 256, 1),
                  "default": le.dedup_shape(n, dev)}
        if n > 8192:  # at most 8 lanes a thread
            del shapes["one block"]
        if shapes["default"] in list(shapes.values())[:-1]:
            del shapes["default"]
        for shape in shapes.values():
            cs.hold_k3(st, f"{n} lanes", (shape,))
        times = {}
        for name in list(shapes) + list(shapes)[::-1]:
            times.setdefault(name, []).append(round(cs.queued_ms(
                lambda x, sh=shapes[name]: le.dedup_kernel(x, shape=sh),
                lambda: cs.clone_state(st)), 4))
        call = cs.cuda_ms(lambda x: le.dedup_kernel(x), reps=5,
                          setup=lambda: cs.clone_state(st))
        # the phases of thread 0 of block 0 in the default shape, SM
        # cycles a round
        ph = torch.zeros(8, dtype=torch.int64, device=dev)
        le.dedup_kernel(cs.clone_state(st), phases=ph)
        ph = ph.tolist()
        per = {name: round(c / max(ph[7], 1), 1) for name, c in zip(
            ("A", "A barrier", "B winners", "B compare", "B cursors",
             "next step"), ph[1:7])}
        print(f"K3 {n} lanes phases: set-up {ph[0]} cycles, {ph[7]} rounds, "
              f"cycles a round {per}")
        # the host's time of a call in each shape, the card kept busy
        host = {}
        for name, sh in shapes.items():
            xs = [cs.clone_state(st) for _ in range(5)]
            torch.cuda.synchronize()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            t0 = time.perf_counter()
            for x in xs:
                le.dedup_kernel(x, shape=sh)
            host[name] = round((time.perf_counter() - t0) / len(xs) * 1e3, 4)
            torch.cuda.synchronize()
            del xs
        print(f"K3 {n} lanes: host ms a call by shape {host}")
        print(f"K3 {n} lanes (k={k}): {records} live records, {rounds} "
              f"rounds; default shape {le.dedup_shape(n, dev)}, call "
              f"{call:.4f} ms; device ms by shape (in turns): "
              + ", ".join(f"{name} {shapes[name]}: {t}"
                          for name, t in times.items()))
        if n == 4096:
            _host_profile("K3 (write_sids off)", lambda: le.dedup_kernel(
                st, write_sids=False), 500)
            _host_profile("K4's fork_table", lambda: le._gather_full_flog(st),
                          2000)
            fb = st.flog_parent.shape[0]
            cols = [getattr(st, f"flog_{c}")[:fb] for c in (
                "parent", "child", "step", "pc", "sid", "gmin", "gmax",
                "fentry", "dest")]
            turns = {}
            for name, fn in (("torch.stack", lambda: torch.stack(cols, 1)),
                             ("fork_table", lambda: le._gather_full_flog(st)),
                             ("fork_table", lambda: le._gather_full_flog(st)),
                             ("torch.stack", lambda: torch.stack(cols, 1))):
                turns.setdefault(name, []).append(round(cs.cuda_ms(
                    fn, reps=50), 4))
            print(f"K4's fork_table call against torch.stack in turns: "
                  f"{turns}")
        del st


def _host_profile(what, fn, calls):
    """``calls`` calls of fn under cProfile, the card kept busy: the
    host's milliseconds a call and its functions by own time."""
    import cProfile
    import pstats

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.SPIN_CYCLES * 4)
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    prof.disable()
    torch.cuda.synchronize()
    print(f"{what}: {calls} calls under cProfile, {wall / calls * 1e3:.4f} "
          f"ms a call on the host")
    pstats.Stats(prof).sort_stats("tottime").print_stats(12)


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
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--tables", action="store_true")
    ap.add_argument("--window", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.packed:
        _packed(args.k, args.lanes, card)
        return 0
    if args.kernels:
        _kernels(card)
        return 0
    if args.dedup:
        _dedup(card)
        return 0
    if args.tables:
        _tables(card)
        return 0
    if args.window:
        _window(card)
        return 0
    if args.analyze:
        _analyze_parts(args.analyze)  # warm: builds, allocator, caches
        wall, parts, n_issues, stats = _analyze_parts(args.analyze)
        print(f"card: {card}")
        _print_build_lines("window.cu")
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
        shapes = ([], [])
        _analyze_parts(args.analyze, shapes)
        print(f"K6 and K7 by call shape ({len(shapes[0])} calls; a fourth "
              f"run, each call timed on copies of its input) on {card}:")
        _print_screen_shapes(shapes[0])
        print(f"K2 and K4 by call shape ({len(shapes[1])} calls, the same "
              f"run) on {card}:")
        _print_window_shapes(shapes[1])
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
    from mythril_tpu_torch import _build

    _build.build_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    res, wall, rows = _profile(run)
    dev_us = sum(e.self_device_time_total for e in rows)
    print(f"card: {card}")
    print(f"{what}: {size(res)}, wall {plain_wall * 1e3:.3f} ms "
          f"({wall * 1e3:.3f} ms under the profiler; the process's first "
          f"run {first_wall * 1e3:.3f} ms)")
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
