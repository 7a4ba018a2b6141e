"""One kernel group's call and device times of one tree of this repo, to
compare two commits in turns on one card.

    python3 tools/window_turns.py
        [window|k9k10|k5k13|k12k6|k6fault|e2e|mesh|vis|bv256|k10plain]
        [--tree DIR]

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
  64. Means of 3 (K9's of 5), each K10 run on a fresh batch;
- ``k5k13``: K5 on the 8192-system screen wave's encoding: every level
  of it from the tables the driver seeds (where the tree has K5's
  layout, ``eval_levels_kernel`` from the init tables, the seeds
  scattered in the call; else ``eval_level_kernel`` level by level
  from ``seed_tables``' tables), and the driver whole
  (``_run_tables``: the tables, the seeds and every level), on one
  encoding (a layout, where the tree keeps one, built once) and on a
  fresh ``linearize`` of the wave each call (the linearize untimed, the
  layout's build and copy in the call: the screen path's case), and
  where the tree has it that build and copy alone, then the layout
  alone and its binding alone; the
  screen path with propagation off (``pruner._screen_interval`` over
  the wave, its call only); K13's ``lane_order`` on 131072 seeded
  statuses of every kind (those of ``device_loop.k13_edge_cases``
  ``mixed_131072``), and their first 32768, with 1 and 8 shards. Means
  of 5; and ``screen.cu``'s registers, stack and spills (``ptxas``),
  and K5's device time by kernel under torch.profiler;
- ``k12k6``: K12 on 32768 and 131072 seeded statuses of every kind
  (those of ``k13_edge_cases``' ``mixed_131072``) over 8 shards of the
  card: ``lane_live`` (a device tensor), the library's per-shard sum,
  ``live_lane_counts`` (the counts on the host) and the library's sum
  pulled to the host; where the tree has K12's one-launch form, the
  launch with its counts through the mapped host buffer it writes and
  through one async copy into a pinned buffer, in turns inside the
  group, its two block sizes forced (a block a shard; the grid of
  64-thread blocks), and an empty kernel (the launch floor). Then
  K6 on the 8192-system screen wave, level by level from its init
  tables (each level's call and device time on fresh copies of its
  input, summed over the levels), and K11 on the wave. Means of 20 (K6,
  K11: of 5);
- ``k6fault``: no times: K6 level by level, the K6-K8 driver and K11
  against their plain versions on ``k5_edge_cases``' ``reads_own_level``
  plan (``chip_smoke.prop_edge_diffs`` from the init, random and
  once-swept tables; on a tree whose edited encodings dropped their
  host arrays, those of a fresh ``linearize`` of the wave, which
  numbers its rows the same): every word that differs;
- ``mesh``: rows 2m, 6m and 2v. K1 over a mesh on the k=12 main path's
  first window at 4096 lanes, at its first forking step, over 8 shards
  of 512 lanes and over 4 of 1024 (the card's shards of ``chip_smoke.py``
  and a card's shard of ``--cards``): ``sym_decide`` launched alone
  (every shard, and shard 0 alone: the launch of a card that holds one
  shard), the step's whole decide (launch, wait, the counts read),
  every shard's ``sym_exec`` and the step's fork rows
  (``sym_fork_rows``: one call, in a tree with one launch a device,
  or the fork-log copies a shard and a stage and a land a pair of
  shards); in a tree with the launch a shard each of the first three
  is its 8 or 4 launches (a copy and an event a shard in the whole
  decide). K3's remap on the first window's input to it, its
  provisional sids restored before each call (``window_remap``: one call
  over the shards, a launch a device, or a launch a shard); K4's rows on
  the first window's end state (``window_rows``: one call over the
  shards, or a launch a shard) and the host's pull
  and assembly of that window's 12 outputs (``MeshOutputs``, a call
  time only). Then ``sym_vis_or`` ORing three bitmaps of the other
  cards (of card 0 on a one-card machine) into card 0's, and
  ``bitwise_or_`` after a copy of each (that part alone: ``vis``, for a
  machine of four cards). Means of 20 (exec, OR: of 10);
- ``e2e``: ``chip_smoke.py``'s end-to-end phases that run neither K5
  nor K13, with the tree's own ``chip_smoke.py``: the symbolic path
  (k=12 contract at 4096 lanes through ``support/runs.explore``) and
  its host-only run, the device loop alone (k=12 at 4096 lanes, k=17
  at 131072), the corpus mode (its four ranks, the tree's
  ``corpus_mode``), each once, after a warm-up explore at 64 lanes;
  walls in seconds;
- ``bv256``: row 1 and the kernels that inline ``csrc/bv256.cuh``: each
  of the 27 ops' test launch (``bv256_apply``) on ``check_bv256``'s
  4096 seeded words (means of 10), K1's run of 64 steps on
  ``check_k1``'s 4096-lane state (5) and of 32 steps on
  ``check_k1_wide``'s 131072 lanes (3), K10's run of ``bench_device``'s
  32768 lanes (3), and every kernel's registers, stack frame and spill
  bytes in ``bv256.cu``, ``symstep.cu``, ``stepper.cu`` and
  ``screen.cu`` (``ptxas``, from the tree's ``-Xptxas -v`` logs);
- ``k10plain``: the plain K10 on ``chip_smoke.py``'s concrete path
  input (1024 lanes through a whole run), its call after a warm-up.

For each kernel time: the call on CUDA events and, unless the group
says otherwise, the device time queued behind a spin kernel after an L2
flush. Prints one JSON line with the card's name and power limit. Run
e.g. parent, change, change, parent, each in its own process.
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


def kernel_ms(fn, setup, reps=5) -> dict:
    """{kernel: device ms a call} of fn(setup()) under torch.profiler,
    the setups made before it starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = [setup() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args:
            fn(a)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total}


def k5k13_times(cs, dev, timed) -> dict:
    """K5's, the screen path's and K13's times (the ``k5k13`` group).
    Returns the registers, stack and spills of ``screen.cu``'s kernels
    and K5's device time by kernel (an op class a kernel)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.models import pruner
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support.screen_waves import prefilter_wave

    systems = prefilter_wave(cs.SCREEN_N)[0]
    enc = I.linearize(systems)
    shape = (enc.seed_idx.shape[0],) + enc.init_lo.shape
    if hasattr(I, "eval_levels_kernel"):
        lay = I.encoding_layout(enc, dev)

        def fresh():
            return (lay["init_lo"].expand(shape).clone(),
                    lay["init_hi"].expand(shape).clone())

        timed("interval_level, screen wave, every level",
              lambda x: I.eval_levels_kernel(lay, *x), fresh, reps=5)
        by_kernel = kernel_ms(lambda x: I.eval_levels_kernel(lay, *x),
                              fresh, reps=5)
    else:
        by_kernel = {}
        levels = [I.level_to_device(lv, dev) for lv in enc.levels]
        parts = [I.words_to_device(enc.init_lo, dev),
                 I.words_to_device(enc.init_hi, dev),
                 I.ints_to_device(enc.seed_idx, dev),
                 I.words_to_device(enc.seed_lo, dev),
                 I.words_to_device(enc.seed_hi, dev)]

        def every_level(x):
            for lv in levels:
                I.eval_level_kernel(lv, *x)

        timed("interval_level, screen wave, every level",
              every_level, lambda: I.seed_tables(*parts), reps=5)
    timed("intervals._run_tables, screen wave (the driver), one encoding",
          lambda _=None: I._run_tables(enc, dev), lambda: None, reps=5)
    timed("intervals._run_tables, screen wave (the driver), a fresh "
          "linearize each call",
          lambda e: I._run_tables(e, dev), lambda: I.linearize(systems),
          reps=5, device=False)
    if hasattr(I, "encoding_layout"):
        timed("K5's layout built and copied (encoding_layout), a fresh "
              "linearize each call",
              lambda e: I.encoding_layout(e, dev),
              lambda: I.linearize(systems), reps=5, device=False)

        def layout(e):
            return I.interval_layout(e.levels, e.init_lo.shape[0],
                                     I.fwd_classes(), (e.init_lo, e.init_hi),
                                     e.seed_idx)

        def bound(e):
            return layout(e), dict(
                init_lo=e.init_lo, init_hi=e.init_hi, seed_idx=e.seed_idx,
                seed_lo=e.seed_lo, seed_hi=e.seed_hi, assert_idx=e.assert_idx,
                assert_mask=e.assert_mask)

        timed("K5's layout alone (interval_layout), a fresh linearize each "
              "call", layout, lambda: I.linearize(systems), reps=5,
              device=False)
        timed("K5's layout bound alone (bind_layout: packed, pinned, "
              "copied), a fresh linearize and layout each call",
              lambda x: I.bind_layout(x[0], dev, **x[1]),
              lambda: bound(I.linearize(systems)), reps=5, device=False)

    P.FORCE = False
    try:
        timed("screen path, propagation off (pruner._screen_interval)",
              lambda _=None: pruner._screen_interval(systems, lambda x: x),
              lambda: None, reps=5, device=False)
    finally:
        P.FORCE = None
    torch.cuda.empty_cache()
    # every status, seeded (device_loop.k13_edge_cases' mixed_131072)
    mixed = np.random.default_rng(13).choice(7, 131072).astype(np.int32)
    for n in (32768, 131072):
        status = torch.from_numpy(mixed[:n]).to(dev)
        for n_dev in (1, 8):
            timed(f"lane_order, {n} lanes, {n_dev} shards",
                  lambda _=None, s=status, d=n_dev: M.lane_order(s, d),
                  lambda: None, reps=5)
    return {"ptxas": ptxas_table(["screen.cu"]),
            "interval_level by kernel": by_kernel}


def k12k6_times(cs, dev, timed) -> None:
    """K12's, K6's and K11's times (the ``k12k6`` group)."""
    import dataclasses

    import numpy as np
    import torch

    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.parallel import mesh as M

    mixed = np.random.default_rng(13).choice(7, 131072).astype(np.int32)
    mesh = M.Mesh([dev] * 8)
    for n in (32768, 131072):
        status = torch.from_numpy(mixed[:n]).to(dev)
        batch = S.init_lanes(n, stack_depth=1, memory_bytes=4,
                             storage_slots=1, calldata_bytes=4, device=dev)
        sh = M.shard_lanes(dataclasses.replace(batch, status=status), mesh)
        timed(f"lane_live, {n} lanes, 8 shards",
              lambda _=None, s=status: M.lane_live(s, 8), lambda: None,
              reps=20)
        timed(f"library sum, {n} lanes, 8 shards",
              lambda _=None, s=status: (s.view(8, -1) == 0).sum(1),
              lambda: None, reps=20)
        timed(f"live_lane_counts, {n} lanes, 8 shards",
              lambda _=None, x=sh: M.live_lane_counts(x, mesh),
              lambda: None, reps=20, device=False)
        timed(f"library sum pulled to the host, {n} lanes, 8 shards",
              lambda _=None, s=status: (s.view(8, -1) == 0).sum(1).cpu(),
              lambda: None, reps=20, device=False)
        if hasattr(M, "_live_launch"):
            out = torch.empty(8, dtype=torch.int32, device=dev)
            pinned = torch.empty(8, dtype=torch.int32, pin_memory=True)
            view, addr = M._live_host(8)

            def copied(_=None, s=status, o=out, h=pinned):
                M._live_launch((s,), 8, out=o)
                h.copy_(o, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
                return h.numpy().copy()

            def mapped(_=None, s=status):
                M._live_launch((s,), 8, host=addr, sync=True)
                return view[:8].copy()

            want = M.live_lane_counts(sh, mesh)[0].tolist()
            if copied().tolist() != want or mapped().tolist() != want:
                raise AssertionError("K12: the host counts differ")
            for what, fn in (("one async copy into a pinned buffer", copied),
                             ("the mapped host buffer", mapped),
                             ("the mapped host buffer", mapped),
                             ("one async copy into a pinned buffer", copied)):
                timed(f"K12 and {what}, {n} lanes, 8 shards", fn,
                      lambda: None, reps=20, device=False)
        if hasattr(M, "lane_live_threads"):
            # K12's two block sizes on the same statuses: a block a
            # shard, and the grid of 64-thread blocks with the shards'
            # sums meeting in atomics
            rule = M.lane_live_threads
            try:
                for what, threads in (("a block a shard", n // 8 // 16),
                                      ("64-thread blocks", 64)):
                    M.lane_live_threads = lambda per, t=threads: t
                    M._LIVE_PLANS.clear()
                    timed(f"lane_live, {n} lanes, 8 shards, {what}",
                          lambda _=None, s=status: M.lane_live(s, 8),
                          lambda: None, reps=20)
            finally:
                M.lane_live_threads = rule
                M._LIVE_PLANS.clear()
    if hasattr(M, "empty_launch"):
        timed("an empty kernel (the launch floor)",
              lambda _=None: M.empty_launch(dev), lambda: None, reps=20)
    torch.cuda.empty_cache()
    _, _, _, plan, core = cs.screen_wave(dev)
    lay = P.kernel_layout(core)
    tabs = P.init_tables_kernel(core)
    k6 = {"call_ms": 0.0, "device_ms": 0.0}
    for level in lay["levels"]:
        k6["call_ms"] += cs.cuda_ms(
            lambda x, lv=level: P.fwd_level_kernel(lv, x), reps=5,
            setup=lambda t=tabs: cs.clone_all(t))
        k6["device_ms"] += cs.queued_ms(
            lambda x, lv=level: P.fwd_level_kernel(lv, x),
            lambda t=tabs: cs.clone_all(t), reps=5)
        tabs = cs.clone_all(tabs)
        P.fwd_level_kernel(level, tabs)
    cap = plan.statics[0]
    timed("prop_fixpoint, screen wave",
          lambda _=None: P.fixpoint_kernel(core, cap), lambda: None, reps=5)
    return {"prop_fwd_level, screen wave, every level (summed)": k6}


def k6fault_diffs(cs, dev, timed) -> dict:
    """The ``k6fault`` group's differences (``timed`` unused)."""
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import (k5_edge_cases,
                                                        layered_sets)

    enc = k5_edge_cases()["reads_own_level"]
    if not enc.host:
        enc.host = I.linearize(layered_sets()).host
    core = P.plan_to_device(P.build_plan(enc), dev)
    diffs = cs.prop_edge_diffs(dev, core, cs.prop_starts(core))
    return {"reads_own_level": [list(d) for d in diffs]}


class MeshK1:
    """K1's meshed phases in either form a tree has: a launch a shard
    (``shard_phases``, ``_CudaShard``) or a launch a device
    (``shard_groups``, ``_CudaGroup``)."""

    def __init__(self, S, codes, ex, ta, dev):
        self.S, self.codes, self.ex, self.ta, self.dev = S, codes, ex, ta, dev
        self.grouped = hasattr(S, "shard_groups")

    def make(self, ss, first=False):
        """Phase objects over ``ss``'s shards (``first``: shard 0's alone,
        one card's launch where each card holds one shard)."""
        S = self.S
        if self.grouped:
            if first:
                return [S._CudaGroup(ss, [0], 0, self.codes[self.dev],
                                     self.ex, self.ta, None)]
            return S.shard_groups(self.codes, ss, self.ex, self.ta)
        out = S.shard_phases(self.codes, ss, self.ex, self.ta)
        return out[:1] if first else out

    def launch(self, objs):
        """The decide kernels alone: no copy, no wait, no read."""
        import torch

        from mythril_tpu_torch import _build as b

        stream = b.stream(self.dev)
        with torch.cuda.device(self.dev):
            for o in objs:
                if self.grouped:
                    o.launch_decide(stream)
                    continue
                rc = o.lib.sym_decide(
                    o.planes, o.dims, b.ptr(o.code.packed), o.code.size,
                    b.ptr(o.optab), b.ptr(o.dec), b.ptr(o.counts), None, 0,
                    stream)
                b.LAUNCHES["sym_decide"] += 1
                b.check(o.lib, rc, "sym_decide")

    def decide(self, objs):
        """The step's whole decide: (requests, running) a shard."""
        if self.grouped:
            return self.S.decide_groups(objs, sum(len(g.idx) for g in objs))
        c = [r() for r in [o.decide() for o in objs]]
        return [x[0] for x in c], [x[1] for x in c]

    def execute(self, objs, counts, scalars):
        """Every shard's exec at the step's fork ranks and budget, from
        the batch's (free count, fork-log count, step, fork-log rows,
        lanes) read beforehand."""
        S = self.S
        free_count, flog_count, step_no, F, n = scalars
        if self.grouped:
            navail, off, forks, nf = S.fork_budget(counts[0], free_count,
                                                   flog_count, F, n)
            return S.execute_groups(objs, len(counts[0]), off, forks,
                                    navail, free_count, flog_count,
                                    step_no, nf)
        navail = min(free_count, min(S.MAX_FORKS_PER_STEP, n),
                     F - flog_count)
        off = 0
        for o, req in zip(objs, counts[0]):
            o.execute(off, navail, free_count, flog_count, step_no,
                      max(0, min(int(req), navail - off)))
            off += int(req)
        return off

    def fork_step(self, ss, groups, stashes, counts, scalars):
        """The step's fork rows after its exec as one call, in the
        tree's form: one ``_CudaForks.run`` (its plan, built once a run,
        made here), or the fork-log words copied a shard and the rows
        staged and landed a pair of shards (``fork_rows``). Grouped
        trees only."""
        import numpy as np

        S = self.S
        free_count, flog_count, _, F, n = scalars
        nf = S.fork_budget(counts[0], free_count, flog_count, F, n)[3]
        if hasattr(S, "_CudaForks"):
            forker = S._CudaForks(ss, groups)
            return lambda: forker.run(stashes, nf, free_count, flog_count)
        shards = [None] * len(counts[0])
        for g in groups:
            for i, sh in zip(g.idx, g.shards):
                shards[i] = sh
        child = ss.home.free_slots.cpu().numpy()[
            np.clip(free_count - 1 - np.arange(nf), 0, n - 1)]
        flog = [getattr(ss.home, f) for f in (
            "flog_parent", "flog_pc", "flog_fentry", "flog_sid",
            "flog_gmin", "flog_gmax", "flog_dest")]

        def call():
            for stash, o, k in stashes:
                if k:
                    for plane, c in zip(flog, [0, 3, 2, 4, 5, 6, 7]):
                        plane[flog_count + o:flog_count + o + k].copy_(
                            stash[c, :k])
            S.fork_rows(shards, stashes, child, ss.per)

        return call


def mesh_times(cs, dev, timed) -> None:
    """Rows 2m's K1 phases and 2v's ``sym_vis_or`` (the ``mesh`` group)."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep as S
    from mythril_tpu_torch.parallel.mesh import Mesh
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_symbolic_contract
    from mythril_tpu_torch.support.support_args import args

    code, paths = build_symbolic_contract(cs.MAIN_K)
    lanes = args.tpu_lanes
    for shards in (8, 4):
        le._STATE_POOL.clear()
        le.PATH_HISTORY[code] = paths
        with cs.mesh_engine(Mesh([dev] * shards)), \
                cs.MeshSpy(keep=True) as spy:
            runs.explore(code, cs.MAIN_LANES)
        args.tpu_lanes = lanes
        codes, k1_in = spy.k1[0], spy.k1[1]
        steps, ex, ta = spy.k1[2][:3]
        k1 = MeshK1(S, codes, ex, ta, dev)
        for _ in range(steps):  # the first step at which lanes fork
            if any(k1.decide(k1.make(k1_in))[0]):
                break
            S.sym_run_mesh(codes, k1_in, 1, ex, ta)
        else:
            raise AssertionError("the first window forks at no step")
        ss = cs.mesh_clone(k1_in)
        per = ss.per
        what = f"{shards} shards of {per} lanes"
        objs = k1.make(ss)
        first = k1.make(ss, first=True)
        timed(f"sym_decide launched alone, {what}",
              lambda _=None, o=objs: k1.launch(o), lambda: None, reps=20)
        timed(f"sym_decide launched alone, shard 0 ({per} lanes: a "
              f"card's launch where a card holds one shard), {what}",
              lambda _=None, o=first: k1.launch(o), lambda: None, reps=20)
        timed(f"sym_decide, the step's whole call (launch, wait, read), "
              f"{what}", lambda _=None, o=objs: k1.decide(o), lambda: None,
              reps=20, device=False)

        def ready(s=ss):
            cs.mesh_restore(s, k1_in)
            o = k1.make(s)
            h = s.home
            return o, k1.decide(o), (
                int(h.free_count), int(h.flog_count), int(h.step_no),
                h.flog_parent.shape[0], s.n)

        timed(f"sym_exec, every shard, {what}",
              lambda x: k1.execute(*x), ready, reps=10)
        if k1.grouped:
            def forks_ready(s=ss):
                o, counts, sc = ready(s)
                return k1.fork_step(s, o, k1.execute(o, counts, sc),
                                    counts, sc)

            timed(f"sym_fork_rows, the forking step's fork rows, {what}",
                  lambda call: call(), forks_ready, reps=10)
        # K3's remap on the first window's input to it, its provisional
        # sids restored before each call: one call over the shards (a
        # launch a device), or a launch a shard
        src, canon = spy.remap_in
        rin = cs.mesh_clone(src)
        if hasattr(le, "mesh_remap_kernel"):
            def remap(x):
                le.mesh_remap_kernel(x, canon)
        else:
            def remap(x):
                for st in x.shards:
                    le.remap_shard_kernel(st, canon)

        def remap_ready(s=src, r=rin):
            for a, b in zip(r.shards, s.shards):
                for f in ("ssid", "sval_sid", "skey_sid", "mlog_sid"):
                    getattr(a, f).copy_(getattr(b, f))
            return r

        timed(f"window_remap, the first window's remap, {what}", remap,
              remap_ready, reps=20)
        # K4's rows on the first window's end state: one call over the
        # shards (a launch a device), or a launch a shard
        out = spy.first[5]
        ridx, hidx = out[2].home[4], out[2].home[8]
        end = cs.mesh_clone(out[0])
        snap = cs.mesh_clone(end)
        if hasattr(le, "mesh_rows_kernel"):
            def rows(x):
                le.mesh_rows_kernel(x, ridx, hidx)
        else:
            def rows(x):
                for i, st in enumerate(x.shards):
                    le.shard_rows_kernel(st, i * x.per, ridx, hidx)
        timed(f"window_rows, the first window's rows, {what}", rows,
              lambda: cs.mesh_restore(end, snap), reps=10)
        timed(f"the first window's 12 outputs pulled and assembled, "
              f"{what}", lambda _=None: out[2].start_pull()(), lambda: None,
              reps=10, device=False)
        torch.cuda.empty_cache()
    vis_times(cs, dev, timed)


def vis_times(cs, dev, timed) -> None:
    """Row 2v (the ``vis`` group, the end of ``mesh``): the visited
    bitmaps of three other cards (three of card 0 where it is the only
    one) ORed into card 0's, as long as the k=12 contract's."""
    import torch

    from mythril_tpu_torch.ops import symstep as S
    from mythril_tpu_torch.ops.stepper import compile_code
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    cards = torch.cuda.device_count()
    srcs = [torch.device("cuda", i % cards) for i in range(1, 4)]
    length = compile_code(build_symbolic_contract(cs.MAIN_K)[0],
                          device=dev).packed.shape[0]
    g = torch.Generator().manual_seed(15)
    maps = [torch.rand(length, generator=g) < 0.3 for _ in range(4)]

    def pair():
        out = (maps[0].to(dev), [x.to(d) for x, d in zip(maps[1:], srcs)])
        for d in set(srcs) | {dev}:
            torch.cuda.synchronize(d)
        return out

    if hasattr(S, "vis_route"):
        def vis(x):
            S.vis_or(x[0], x[1])
    else:
        def vis(x):
            for src in x[1]:
                S.vis_or(x[0], src)
    where = "cards 1-3" if cards > 1 else "card 0"
    timed(f"sym_vis_or, three bitmaps of {where} into card 0's", vis, pair,
          reps=10)
    timed(f"bitwise_or_ after a copy of each, three bitmaps of {where}",
          lambda x: [x[0].bitwise_or_(s.to(dev)) for s in x[1]], pair,
          reps=10)


def e2e_walls(cs, dev, timed) -> dict:
    """The ``e2e`` group's walls (s), with the tree's ``chip_smoke.py``
    (``cs``; ``timed`` unused)."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    card = cs.smi()
    cs.explore(dev, 64, 6)  # warm: allocator, libraries
    code, paths = build_symbolic_contract(cs.MAIN_K)
    le.PATH_HISTORY[code] = paths
    torch.cuda.synchronize()
    n_open, _, wall = runs.explore(code, cs.MAIN_LANES)
    out = {f"symbolic path k={cs.MAIN_K}, {cs.MAIN_LANES} lanes": wall,
           "symbolic path paths/s": paths / wall}
    host_open, _, out["symbolic path host-only"] = runs.explore(code, 0)
    if host_open != n_open:
        raise AssertionError(f"{n_open} open states, host-only {host_open}")
    for n, k in ((cs.MAIN_LANES, cs.MAIN_K), (cs.WIDE_LANES, cs.WIDE_K)):
        res, want, wall, _ = cs.explore(dev, n, k)
        if res["paths"] != want:
            raise AssertionError(f"device loop k={k}: {res['paths']} paths")
        out[f"device loop k={k}, {n} lanes"] = wall
    out["corpus mode makespan"] = cs.corpus_mode(card)
    return out


def ptxas_table(sources) -> dict:
    """{kernel: [registers, stack frame, spill stores, spill loads]} of
    the tree's current builds of ``sources``, from their ``-Xptxas -v``
    logs (mangled names, the anonymous namespace's per-build hash cut
    out so that two trees' names match)."""
    import re

    from mythril_tpu_torch import _build

    anon = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+")
    out = {}
    for src in sources:
        name = None
        for line in _build.build_log(src).splitlines():
            line = anon.sub("anon", line)
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = f"{src}:{m.group(1)}"
                out[name] = [None, None, None, None]
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and name:
                out[name][1:] = [int(x) for x in m.groups()]
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = f"{src}:{m.group(1)}"
                out.setdefault(name, [None, None, None, None])
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name][0] = int(m.group(1))
    return out


def bv256_times(cs, dev, timed) -> dict:
    """Row 1 (the ``bv256`` group): every op's test launch on
    ``check_bv256``'s 4096 words, K1's step (``check_k1``'s 4096-lane
    state, 64 steps a run; ``check_k1_wide``'s 131072 lanes, 32 steps)
    and K10's run (``bench_device``'s 32768 lanes, to the end); means of
    10 (K1: 5 and 3, K10: 3). Returns the registers, stack and spills of
    the word arithmetic's kernels."""
    from mythril_tpu_torch.ops import bv256
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.support import contracts as C

    words = cs.bv256_words(dev)
    for op, (arity, _) in bv256.OPS.items():
        args = words[:arity]
        timed(f"bv256 {op}, 4096 words",
              lambda _=None, o=op, x=args: bv256.bv256_apply(o, *x),
              lambda: None, reps=10)
    st, cc = cs.k1_state(dev)
    probe, _ = symstep.sym_run_kernel(cc, cs.clone_state(st), 64)
    ran = int(probe.step_no) - int(st.step_no)
    timed(f"sym_run, 4096 lanes, a run of {ran} steps",
          lambda x: symstep.sym_run_kernel(cc, x, 64),
          lambda: cs.clone_state(st), reps=5)
    wcc, wide, running, _ = cs.k1_wide_state(dev)
    timed(f"sym_run, {wide.pc.shape[0]} lanes ({running} running), "
          f"a run of 32 steps", lambda x: symstep.sym_run_kernel(wcc, x, 32),
          lambda: cs.clone_state(wide), reps=3)
    del wcc, wide
    bcc = S.compile_code(C.build_bench_contract(), device=dev)
    timed(f"lane_run, {cs.CONCRETE_N} lanes (bench batch)",
          lambda x: S.run_kernel(bcc, x, C.BENCH_MAX_STEPS),
          lambda: C.bench_batch(cs.CONCRETE_N, dev))
    return {"ptxas": ptxas_table(["bv256.cu", "symstep.cu", "stepper.cu",
                                  "screen.cu"])}


def k10plain_times(cs, dev, timed) -> None:
    """The plain K10 (``run_plain``, PyTorch ops launched from the host)
    on ``chip_smoke.py``'s concrete path input: ``bench_batch`` of
    ``CONCRETE_PLAIN_N`` lanes through a whole run, after one warm-up
    run; its call only."""
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.support import contracts as C

    cc = S.compile_code(C.build_bench_contract(), device=dev)
    small = C.bench_batch(cs.CONCRETE_PLAIN_N, dev)
    timed(f"lane_run plain, {cs.CONCRETE_PLAIN_N} lanes, a whole run",
          lambda: S.run_plain(cc, small, C.BENCH_MAX_STEPS), None, reps=2,
          device=False)


#: each group times through ``timed``, or returns its numbers
GROUPS = {"window": window_times, "k9k10": k9k10_times, "k5k13": k5k13_times,
          "k12k6": k12k6_times, "k6fault": k6fault_diffs, "e2e": e2e_walls,
          "mesh": mesh_times, "vis": vis_times, "bv256": bv256_times,
          "k10plain": k10plain_times}


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
    # (e2e: the tree's own, whose corpus mode starts the tree's ranks)
    smoke = tree if args.group == "e2e" else ROOT
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(smoke, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le

    if not os.path.abspath(le.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {le.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    _build.build_all()
    times = {}

    def timed(what, fn, setup, reps=3, device=True):
        """Time fn; a thing timed again (turns inside a group) keeps the
        mean of its timings."""
        got = {"call_ms": cs.cuda_ms(fn, reps=reps, setup=setup)}
        if device:
            got["device_ms"] = cs.queued_ms(fn, setup, reps=reps)
        torch.cuda.synchronize()
        if what in times:
            got = {k: (v + times[what][k]) / 2 for k, v in got.items()}
        times[what] = got

    times.update(GROUPS[args.group](cs, dev, timed) or {})
    print(json.dumps({"tree": tree, "group": args.group, "card": cs.smi(),
                      "times": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
