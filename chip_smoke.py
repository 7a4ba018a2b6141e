#!/usr/bin/env python3
"""Build the port's CUDA kernels, hold each against its plain PyTorch
version on the card, and drive the port's paths: ``myth analyze`` end
to end, the symbolic path at full width, the window merge, the device
loop alone, the concrete lane path and the solver's screens (with the
host-sequenced and the fused fixpoint).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --analyze FIXTURE STATS`` is the per-fixture
process the corpus phase starts.)

Phases (any failure exits non-zero and prints no result):

1. build every ``mythril_tpu_torch/csrc/*.cu`` (in parallel) and the
   native solver library (``make``), print the card's name and power
   limit and the compiler's register/spill lines;
2. kernel checks, bit for bit against the plain versions on the card:
   ``bv256_apply`` for every op on seeded random and edge words; K0 over
   a 4096-lane batch whose planes hold junk; K1 over 64 steps of a seeded
   4096-lane state (and the cost of the host's running-count read); K2-K4
   through one ``window_exec`` and its three escalations; K9 on the k=12
   main path's state after its first window with that window's
   resolution pairs, and on two seeded random 4096-lane states;
3. the symbolic path: every path of the k=12 contract through the
   port's ``SymExecWrapper`` at 4096 lanes (the main path of K0-K4:
   launch counts reset before it and read after); its open states must
   equal the host-only run's;
4. the corpus: ``python -m mythril_tpu_torch analyze`` of the 18 vendored
   fixtures (each its own process, four at a time, with the flags of
   ``tests/compare_lane_host.py``); every canonical issue list must
   equal the JAX package's (``tests/torch_data/lane_issues.json``:
   40 issues), no analysis may raise, on each fixture the engine must
   run the JAX engine's windows, forks and device steps (the
   reference's run stats), or a window where the JAX engine's sweep
   failed and went on on the host, the screens must screen on the
   device, with no device failure;
5. the SHA3 resume (a 33-byte hash resumed in place) and the spill
   regime (64 paths through 8 lanes), each equal to the host-only run;
   the merge path: ``bench.py``'s window-merge rig (the diamond
   contract, 64 lanes, 32-step windows) with the merge on and off:
   lanes merge and subsume, K9 launches (its main path), the issues
   are identical;
6. the device loop alone (``support/device_loop.DeviceLoop``, raw
   seeds): k=12 at 4096 lanes with the kernels and with the plain
   versions, every window's outputs equal; the wide run, k=17 at 131072 lanes;
7. the screens' kernels K5-K8, bit for bit against the plain versions:
   on the all-opcode wave (``screen_waves.layered_sets`` replicated to
   8192 states: every opcode and backward rule, checked present) from
   its init tables and from two seeded random tables, with its whole
   screen; then at the shapes of the 8192-system wave of the JAX
   package's ``bench_prefilter`` with call, device and plain times and
   byte bounds; and one sweep's changed flag against the plain
   comparison on each;
8. the screen path: ``models/pruner._screen_interval`` over that wave
   with propagation on (K6-K8) and off (K5): 2731 kept each time,
   ``device_screened`` up by 8192, no device failure, keep masks, sweep
   counts and harvested facts equal to the plain versions', and each
   run's kernels launched; one more profiled screen each way gives the
   device's busy share and the kernels' device time on the path;
9. the propagation mix (8192 sets): propagation refutes the bit
   conflicts and unit chains the interval pass keeps;
10. the concrete path (before the screens): ``bench.py``'s
    ``bench_device`` workload, the bench contract over 32768 lanes
    through the port's ``ops/stepper.run`` (K10, its main path: one
    launch a run, counts reset before the warm run and three timed
    runs), every lane's status, steps and slot 0 equal to a closed form
    in Python ints; K10 bit for bit against ``run_plain`` at 1024 lanes
    through a whole run and over single steps at full width; paths/s,
    lane instructions/s, the busy share (where the profiler records no
    device event, the stream-interval share, an upper bound); K10's
    bound from a traced run of the timed inputs, whose single steps
    must end where one run does; then 131072 lanes at
    ``init_lanes``' default planes (~11.2 KB a lane) on
    ``__graft_entry__._build_fixture``'s loop contract and on the lane
    mix contract (loop, memory and storage arms), 512 sampled lanes of
    each equal to ``run_plain``;
11. the fused screen: K11 on the 8192-system wave, equal to
    ``_fixpoint_plain`` and to the host-sequenced K6-K8 driver (tables,
    ok, contra, keep, sweeps); the pruner's screen with
    ``MTPU_PROPAGATE_FUSE`` on (one K11 launch a wave) and off, in
    turns, systems/s and launches each way;
12. the report: a ``kernels`` JSON line (launches on each kernel's path,
    error, times, bounds), the card's name and power limit, and the
    result line.

``ms`` is a wrapper call on CUDA events, the host's argument packing
and launch gaps included; ``device_ms`` is the device time of the same
call: for K0-K4, K9, K10 and bv256 its kernels and copies in
torch.profiler, for K5-K8 and K11 CUDA events around the call queued
behind a spin kernel (``queued_ms``), on the inputs its bound is
counted from. The run fails where a device time is below its bound.

It imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA's datasheet): HBM bytes/s,
#: and the float32 non-tensor rate, which 32-bit integer ALU work is
#: counted against
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
MAIN_LANES = 4096
MAIN_K = 12
WIDE_LANES, WIDE_K = 131072, 17
SEED = 20260417


def log(*args):
    print(*args, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1, setup=None):
    """Mean milliseconds of one call of fn on the card over reps calls,
    after one warm-up call. With setup, each call is fn(setup()), the
    setup untimed."""
    import torch

    def once():
        arg = setup() if setup else None
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg) if setup else fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    once()
    return sum(once() for _ in range(reps)) / reps


def device_ms(fn, reps=3, setup=None, tries=3):
    """Mean device time (ms) of the kernels and copies one call of fn
    runs, from torch.profiler (the host's time between launches is not
    in it). A profiler session now and then records no device events;
    such a session is run again, up to ``tries`` sessions in all, and
    None is returned when none saw any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(setup()) if setup else fn()
    for _ in range(tries):
        args = [setup() if setup else None for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(a) if setup else fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return us / 1e3 / reps
    return None


def bound_ms(nbytes, nops=0):
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = nops / PEAK_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(a, b):
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def same_state(s1, s2, what):
    """The largest difference over every plane; raises if any."""
    from mythril_tpu_torch.ops.symstep import FIELDS

    err = 0
    for f in FIELDS:
        e = max_err(getattr(s1, f), getattr(s2, f))
        if e:
            raise AssertionError(f"{what}: plane {f} differs (max {e})")
        err = max(err, e)
    return err


def same_outputs(o1, o2, what):
    """The largest difference over the outputs; raises if any."""
    if len(o1) != len(o2):
        raise AssertionError(f"{what}: {len(o1)} outputs != {len(o2)}")
    err = 0
    for i, (x, y) in enumerate(zip(o1, o2)):
        e = max_err(x, y)
        if e:
            raise AssertionError(f"{what}: output {i} differs (max {e})")
        err = max(err, e)
    return err


# ---------------------------------------------------------------------------
# phase 2: kernel checks
# ---------------------------------------------------------------------------

#: rough 32-bit integer operations per word of each bv256 op (restoring
#: division: 256 or 512 rounds of ~40 limb ops; exp: up to 512 products)
_BV_OPS = {"div": 10240, "mod": 10240, "sdiv": 10400, "smod": 10400,
           "addmod": 20480, "mulmod": 20600, "exp": 512 * 200,
           "mul": 200, "mul_hi": 200}


def check_bv256(dev, report):
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import bv256

    rng = np.random.default_rng(SEED)
    n = MAIN_LANES
    edge = [0, 1, 2, 31, 32, 255, 256, (1 << 255), (1 << 255) - 1,
            (1 << 256) - 1, (1 << 256) - 2, (1 << 128), 0xFFFFFFFF]

    def words():
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        w[rng.random(n) < 0.3, 1:] = 0
        for i in range(0, n, 7):
            w[i] = bv256.int_to_limbs(edge[(i // 7) % len(edge)])
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    a, b, c = words(), words(), words()
    total_k = total_p = total_d = nbytes = nops = 0.0
    err = 0
    per_op = {}
    for op, (arity, _) in bv256.OPS.items():
        args = (a, b, c)[:arity]
        got = bv256.bv256_apply(op, *args)
        want = bv256.bv256_plain(op, *args)
        torch.cuda.synchronize()
        e = max_err(got, want)
        if e:
            raise AssertionError(f"bv256 {op}: kernel differs from plain")
        err = max(err, e)
        k_ms = cuda_ms(lambda: bv256.bv256_apply(op, *args), reps=5)
        p_ms = cuda_ms(lambda: bv256.bv256_plain(op, *args), reps=1)
        d_ms = device_ms(lambda: bv256.bv256_apply(op, *args))
        per_op[op] = [round(k_ms, 4), round(p_ms, 3), d_ms]
        total_d = None if d_ms is None or total_d is None else total_d + d_ms
        total_k += k_ms
        total_p += p_ms
        nbytes += n * 32 * (arity + 1)
        nops += n * _BV_OPS.get(op, 24)
    bms, by = bound_ms(nbytes, nops)
    log("bv256 per op [kernel ms, plain ms, device ms] at 4096 words:",
        json.dumps(per_op))
    report["bv256"] = dict(max_abs_err=err, ms=total_k, plain_ms=total_p,
                           device_ms=total_d, bound_ms=bms, bound_by=by)
    log(f"bv256: {len(per_op)} ops equal; kernel {total_k:.3f} ms, "
        f"plain {total_p:.1f} ms for all ops")


def check_init(dev, report):
    import torch

    from mythril_tpu_torch.ops import symstep

    n = MAIN_LANES
    want = symstep.init_sym_lanes(n, device=dev, plain=True)
    err = same_state(symstep.init_sym_lanes(n, device=dev), want,
                     "K0 sym_init")
    # in place over planes that hold junk: K0 must write every byte
    junk = symstep.init_sym_lanes(n, device=dev, plain=True)
    for f in symstep.FIELDS:
        getattr(junk, f).fill_(0x5A)
    symstep.init_kernel(junk)
    err = max(err, same_state(junk, want, "K0 sym_init over junk"))
    nbytes = sum(getattr(want, f).numel() * getattr(want, f).element_size()
                 for f in symstep.FIELDS)
    k_ms = cuda_ms(lambda: symstep.init_kernel(junk), reps=5)
    d_ms = device_ms(lambda: symstep.init_kernel(junk))
    p_ms = cuda_ms(
        lambda: symstep.init_sym_lanes(n, device=dev, plain=True), reps=3)
    torch.cuda.synchronize()
    bms, by = bound_ms(nbytes)
    report["sym_init"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              device_ms=d_ms, bound_ms=bms, bound_by=by)
    log(f"K0 sym_init: {n} lanes ({nbytes} bytes) equal, also over junk; "
        f"{k_ms:.4f} ms kernel ({d_ms} ms on the device), {p_ms:.3f} ms "
        f"plain")


def seeded_state(dev, n_seeds):
    """A 4096-lane state with n_seeds fresh entries of the coverage
    contract: odd seeds have symbolic calldata, even ones concrete
    calldata that picks each arm in turn. Returns (state, code, free)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.ops.stepper import compile_code
    from mythril_tpu_torch.support import device_loop
    from mythril_tpu_torch.support.contracts import build_coverage_contract

    rng = np.random.default_rng(SEED)
    n = MAIN_LANES
    st = symstep.init_sym_lanes(n, device=dev)
    objs = le.ObjectTable()
    seeds = []
    for i in range(n_seeds):
        s = device_loop.tx_entry_seed(objs, i + 1, st.calldata.shape[1])
        if i % 2 == 0:
            s["cd_sym"], s["cd_size_sid"], s["cd_size"] = 0, 0, 64
            s["calldata"][31] = (i // 2) % 10
            s["calldata"][32:64] = rng.integers(0, 256, 32, dtype=np.uint8)
        seeds.append(s)
    free = list(range(n - 1, -1, -1))
    entries = [(free.pop(), s) for s in seeds]
    i32b, u8b, k, pv = le.pack_window(n, symstep.N_ENV, {}, entries, free,
                                      [], {}, st.calldata.shape[1],
                                      big=True)
    i32b, u8b = torch.from_numpy(i32b).to(dev), torch.from_numpy(u8b).to(dev)
    cc = compile_code(build_coverage_contract(), device=dev)
    return st, cc, (i32b, u8b, k, pv)


def clone_state(st):
    from mythril_tpu_torch.ops.symstep import FIELDS

    return st.replace(**{f: getattr(st, f).clone() for f in FIELDS})


def check_k1(dev, report):
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep

    st, cc, (i32b, u8b, k, pv) = seeded_state(dev, MAIN_LANES // 8)
    st = le.prologue_plain(st, i32b, u8b, k, pv)
    steps = 64
    vis0 = torch.zeros(cc.packed.shape[0], dtype=torch.bool, device=dev)
    s_k, v_k = symstep.sym_run_kernel(cc, clone_state(st), steps, None,
                                      None, vis0.clone())
    s_p, v_p = symstep.sym_run_plain(cc, clone_state(st), steps, None,
                                     None, vis0.clone())
    torch.cuda.synchronize()
    err = same_state(s_k, s_p, "K1 sym_run")
    if max_err(v_k, v_p):
        raise AssertionError("K1 sym_run: visited differs")
    ran = int(s_k.step_no) - int(st.step_no)
    executed = int((s_k.steps.long() - st.steps.long()).sum())
    forks = int(s_k.flog_count)
    lane_bytes = symstep.lane_bytes()
    k_ms = cuda_ms(lambda c: symstep.sym_run_kernel(cc, c, steps),
                   reps=2, setup=lambda: clone_state(st)) / ran
    p_ms = cuda_ms(lambda c: symstep.sym_run_plain(cc, c, steps),
                   reps=1, setup=lambda: clone_state(st)) / ran
    d_ms = device_ms(lambda c: symstep.sym_run_kernel(cc, c, steps),
                     reps=2, setup=lambda: clone_state(st))
    d_ms = None if d_ms is None else d_ms / ran
    # the host's read of the running count between K1 launches
    sync = {every: cuda_ms(
        lambda c, e=every: symstep.sym_run_kernel(cc, c, steps,
                                                  sync_every=e),
        reps=2, setup=lambda: clone_state(st)) / ran for every in (1, 32)}
    sync[symstep.SYNC_EVERY] = k_ms
    # per executed instruction ~320 bytes (lane scalars, the opcode row,
    # three stack words and sids, the written word); a fork reads and
    # writes a whole row
    bms, by = bound_ms((executed * 320 + forks * 2 * lane_bytes) / ran)
    report["sym_step"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              device_ms=d_ms, bound_ms=bms, bound_by=by)
    log(f"K1 sym_step: {ran} steps of 4096 lanes equal ({executed} "
        f"instructions, {forks} forks); {k_ms:.4f} ms/step kernel ({d_ms} "
        f"on the device), {p_ms:.1f} ms/step plain")
    log("K1 ms/step by steps between running-count reads: " + ", ".join(
        f"{e}: {ms:.4f}" for e, ms in sorted(sync.items())))


def check_window(dev, report):
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep

    st0, cc, (i32b, u8b, k, pv) = seeded_state(dev, MAIN_LANES // 8)
    ex, ta = symstep.SYM_EXECUTABLE, None
    vis0 = torch.zeros(cc.packed.shape[0], dtype=torch.bool, device=dev)
    args = (i32b, u8b, ex, ta, le.DEFAULT_WINDOW, k, le.DEFAULT_STEP_BUDGET,
            pv)
    s_k, v_k, o_k = le.window_exec_kernel(
        clone_state(st0), cc, *args[:2], *args[2:], vis0.clone(), 1)
    s_p, v_p, o_p = le.window_exec_plain(
        clone_state(st0), cc, *args[:2], *args[2:], vis0.clone(), 1)
    torch.cuda.synchronize()
    err = max(same_state(s_k, s_p, "window_exec"),
              same_outputs(o_k, o_p, "window_exec"))
    if max_err(v_k, v_p):
        raise AssertionError("window_exec: visited differs")
    n = st0.pc.shape[0]
    # escalations on the post-window state
    parked = torch.nonzero(s_k.status == 5).reshape(-1)[:1024]
    ridx = torch.full((1024,), n, dtype=torch.int32, device=dev)
    ridx[:parked.numel()] = parked.to(torch.int32)
    r_k = le._retire_rows(clone_state(s_k), ridx, 64, 4096, 64, 64)
    r_p = le.retire_rows_plain(clone_state(s_k), ridx, 64, 4096, 64, 64)
    err = max(err, same_state(r_k[0], r_p[0], "_retire_rows"),
              same_outputs(r_k[1], r_p[1], "_retire_rows"))
    u_k = le._unique_table_big(s_k, 2048)
    u_p = le.unique_table_big_plain(s_k, 2048)
    err = max(err, same_outputs(u_k, u_p, "_unique_table_big"),
              same_outputs([le._gather_full_flog(s_k)],
                           [le.gather_full_flog_plain(s_k)],
                           "_gather_full_flog"))
    ucount, nf = int(o_k[1][2]), int(o_k[1][0])
    log(f"K2-K4 window_exec: state and 12 outputs equal ({nf} forks, "
        f"{ucount} unique records, {parked.numel()} parked); escalations "
        f"equal")

    # stage times at these shapes: K2 on the seeded state, K3 on the
    # state after the run, K4 on the state after the dedup
    ran = symstep.sym_run_plain(cc, le.prologue_plain(
        clone_state(st0), i32b, u8b, k, pv), le.DEFAULT_WINDOW)[0]
    deduped, canon = le.dedup_plain(clone_state(ran))
    stages = {
        "window_prologue": (
            lambda c: le.prologue_kernel(c, i32b, u8b, k, pv),
            lambda c: le.prologue_plain(c, i32b, u8b, k, pv), st0),
        "window_dedup": (
            lambda c: le.dedup_kernel(c), lambda c: le.dedup_plain(c), ran),
        "window_epilogue": (
            lambda c: le.epilogue_kernel(c, cc, canon, le.DEFAULT_STEP_BUDGET,
                                         1),
            lambda c: le.epilogue_plain(c, cc, canon, le.DEFAULT_STEP_BUDGET,
                                        1), deduped),
    }
    d, s_, mr, r = (st0.stack.shape[1], st0.skeys.shape[1],
                    st0.mlog_off.shape[1], st0.dlog_op.shape[1])
    sid_plane_bytes = 4 * n * (d + 2 * s_ + mr)
    live = int(ran.dlog_count.clamp(max=r).sum())
    nbytes = {
        "window_prologue": prologue_bytes(st0, i32b, k, pv),
        "window_dedup": live * 36 * 4 + 4 * n * r + 2 * sid_plane_bytes
        + 8 * n,
        "window_epilogue": n * 32 + n * 28 + 4 * n * r + n * 4
        + le.RCAP * 4 * 2000 + le.URB * 132 + le.FB * 36,
    }
    for name, (kern, plain, src) in stages.items():
        k_ms = cuda_ms(kern, reps=3, setup=lambda s=src: clone_state(s))
        p_ms = cuda_ms(plain, reps=1, setup=lambda s=src: clone_state(s))
        d_ms = device_ms(kern, setup=lambda s=src: clone_state(s))
        bms, by = bound_ms(nbytes[name])
        report[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                            device_ms=d_ms, bound_ms=bms, bound_by=by)
        log(f"{name}: {k_ms:.3f} ms kernel ({d_ms} ms on the device), "
            f"{p_ms:.1f} ms plain")

    # the escalations (K4's and K3's entries outside the window) on the
    # post-window state: retire the parked lanes' rows, the unique
    # records past URB, the whole fork table
    ws, wm, wl, wk = le._retire_widths(s_k, 64, 4096, 64, 64)
    row = 4 * (10 + 3 * wl + ws + 5 * wk) + 32 * (ws + 2 * wk) + 2 * wm
    uniq = min(int(u_k[1]), 2048)
    escalations = {
        "retire_rows": (
            lambda c: le._retire_rows(c, ridx, 64, 4096, 64, 64),
            lambda c: le.retire_rows_plain(c, ridx, 64, 4096, 64, 64),
            4 * ridx.numel() + parked.numel() * (2 * row + 4)),
        "unique_table_big": (
            lambda c: le._unique_table_big(c, 2048),
            lambda c: le.unique_table_big_plain(c, 2048),
            int(s_k.dlog_count.clamp(max=r).sum()) * 36 * 4 + 4 * n * r
            + uniq * 132 * 2),
        "gather_full_flog": (le._gather_full_flog, le.gather_full_flog_plain,
                             int(s_k.flog_count) * 9 * 4 * 2),
    }
    for name, (kern, plain, nb) in escalations.items():
        k_ms = cuda_ms(kern, reps=3, setup=lambda: clone_state(s_k))
        p_ms = cuda_ms(plain, reps=1, setup=lambda: clone_state(s_k))
        if name == "gather_full_flog":
            # a few microseconds a launch: three profiled calls record no
            # device event, so profile 50 calls of it (it reads the state
            # and writes a table of its own, so no copy is needed)
            d_ms = device_ms(lambda: kern(s_k), reps=50)
        else:
            d_ms = device_ms(kern, setup=lambda: clone_state(s_k))
        bms, by = bound_ms(nb)
        log(f"{name}: {k_ms:.4f} ms kernel ({d_ms} ms on the device), "
            f"{p_ms:.2f} ms plain, bound {bms} ms ({by})")


def prologue_bytes(st, i32b, k, pv):
    """Bytes K2 must move on this input: the four sid planes read and
    written (plus a table read per provisional sid), the packed sections
    it reads whole, and only the real (non-padding) seed, kill and
    resume rows, each with just the planes it writes."""
    from mythril_tpu_torch.laser import lane_engine as le

    n, d = st.stack.shape[:2]
    m, mr, s_, c, e = (st.memory.shape[1], st.mlog_off.shape[1],
                       st.skeys.shape[1], st.calldata.shape[1],
                       st.env.shape[1])
    sd, mc, ccw = le._seed_widths(st)
    sec = le._unpack_i32_sections(i32b.cpu().numpy(),
                                  le._seed_sections(n, k, e, sd, pv))

    def real(idx):
        return int(((idx >= 0) & (idx < n)).sum())

    seeds, kills, resumes = real(sec["idx"]), real(sec["kill"]), \
        real(sec["r_idx"])
    neg = sum(int((p < 0).sum()) for p in (st.ssid, st.sval_sid,
                                            st.skey_sid, st.mlog_sid))
    # a seed reads its i32, u32, stack and u8 rows; writes 20 lane
    # scalars, its stack, memory, kinds, calldata, env and storage rows
    seed_in = 4 * (8 + e) + 4 * (1 + 8 * e) + 36 * sd + ccw + 2 * mc
    seed_out = 80 + 36 * d + 2 * m + c + 36 * e + 84 * s_
    # a resume reads 6 ints and a word; writes 7 ints and the word
    resume_io = (24 + 32) + (28 + 32)
    return (2 * 4 * n * (d + 2 * s_ + mr) + 4 * neg + 8 * pv
            + 4 * (2 * k + 2 * n + 1)      # idx, r_idx, kill, fs, fcount
            + 4 * kills + 4 * (2 * n + 2)  # status; dlog_count, free
            + seeds * (seed_in + seed_out) + resumes * resume_io)


# ---------------------------------------------------------------------------
# the device loop alone: kernels against the plain versions, the wide run
# ---------------------------------------------------------------------------

def explore(dev, n_lanes, k, plain=False):
    import torch

    from mythril_tpu_torch.support import device_loop
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    code, paths = build_symbolic_contract(k)
    eng = device_loop.DeviceLoop(n_lanes=n_lanes, device=dev, plain=plain)
    seed = device_loop.tx_entry_seed(eng.objects, 1, 512)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.explore(code, [seed])
    torch.cuda.synchronize()
    return res, paths, time.perf_counter() - t0, eng.stats


def compare_runs(r1, r2):
    import numpy as np

    if len(r1["windows"]) != len(r2["windows"]):
        raise AssertionError("main path: window counts differ")
    for i, (w1, w2) in enumerate(zip(r1["windows"], r2["windows"])):
        if len(w1["outs"]) != len(w2["outs"]):
            raise AssertionError(f"main path window {i}: output counts")
        for j, (a, b) in enumerate(zip(w1["outs"], w2["outs"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"main path window {i}: output {j} "
                                     f"differs")
        for key in ("records", "forks"):
            if not np.array_equal(w1[key], w2[key]):
                raise AssertionError(f"main path window {i}: {key} differ")
        if len(w1["retired"]) != len(w2["retired"]):
            raise AssertionError(f"main path window {i}: retire chunks")
        for c1, c2 in zip(w1["retired"], w2["retired"]):
            if c1[0] != c2[0] or c1[1] != c2[1] or len(c1[2]) != len(
                    c2[2]) or not all(
                    np.array_equal(x, y) for x, y in zip(c1[2], c2[2])):
                raise AssertionError(f"main path window {i}: retired rows")
    if not np.array_equal(r1["visited"], r2["visited"]):
        raise AssertionError("main path: visited differs")


# ---------------------------------------------------------------------------
# phases 5-7: the feasibility screens (K5-K8)
# ---------------------------------------------------------------------------

#: the screen path's wave: bench_prefilter's 8192 fork-sibling systems,
#: of which the i % 3 == 0 ones (2731) are feasible
SCREEN_N, SCREEN_KEEP = 8192, 2731


def screen_wave(dev):
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import prefilter_wave

    systems, keep = prefilter_wave(SCREEN_N)
    enc = I.linearize(systems)
    plan = P.build_plan(enc)
    return systems, keep, enc, plan, P.plan_to_device(plan, dev)


def layered_wave(dev):
    """The all-opcode wave (``screen_waves.layered_sets``) replicated to
    8192 states; fails unless its levels hold every opcode and its
    backward rounds every rule of ``propagate._BACK_ROLES``."""
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import layered_sets

    sets = layered_sets() * (SCREEN_N // 8)
    enc = I.linearize(sets)
    core = P.plan_to_device(P.build_plan(enc), dev)
    n_t = core["init_lo"].shape[0]
    ops = set()
    for lvl in core["levels"]:
        ops |= set(lvl["op"].tolist())
    rules = {(o, r) for rs in core["back"] for rnd in rs
             for t, o, r in zip(rnd["tgt"].tolist(), rnd["op"].tolist(),
                                rnd["role"].tolist()) if t < n_t}
    want = {(o, r) for o, roles in P._BACK_ROLES.items() for r in roles}
    if ops != set(range(26)) or not want <= rules:
        raise AssertionError(f"all-opcode wave: opcodes {sorted(ops)}, "
                             f"rules missing {sorted(want - rules)}")
    return sets, enc, core


def random_tables(core, seed):
    """Product tables of the plan's shape filled from a seed: each
    numeric row that is not a constant holds a random value x within
    the row's width, as an interval around x (a third of the states
    each: bits of x cleared and set at random, the point x, an aligned
    range of up to 2^30 around x) and a random part of x's bits as
    known; each bool row is may-be-both, only-true or only-false. Every
    abstraction holds x, so the rows are consistent."""
    import torch

    dev = core["init_lo"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    n_s, n_t = core["seed_idx"].shape[0], core["init_lo"].shape[0]

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape or (n_s, n_t, 8),
                             dtype=torch.int32, device=dev, generator=g)

    ilo, ihi, ik0, ik1 = (core[k] for k in ("init_lo", "init_hi", "init_k0",
                                            "init_k1"))
    width = ~ik0
    x = rnd() & width
    low = torch.zeros_like(x)
    low[..., 0] = (1 << torch.randint(0, 31, (n_s, n_t), device=dev,
                                      generator=g, dtype=torch.int32)) - 1
    mode = torch.randint(0, 3, (n_s, 1, 1), device=dev, generator=g)
    lo = torch.where(mode == 0, x & rnd(),
                     torch.where(mode == 1, x, x & ~low))
    hi = torch.where(mode == 0, x | (rnd() & width),
                     torch.where(mode == 1, x, (x | low) & width))
    k1 = torch.where(mode == 1, x, x & rnd())
    k0 = torch.where(mode == 1, ~x, (~x & width & rnd()) | ik0)
    point = torch.all(ilo == ihi, dim=-1)
    vary = ((core["numeric"] != 0) & ~point)[None, :, None]
    tabs = [torch.where(vary, new, init.expand_as(new)).contiguous()
            for new, init in ((lo, ilo), (hi, ihi), (k0, ik0), (k1, ik1))]
    v = torch.randint(0, 4, (n_s, n_t), device=dev, generator=g)
    isbool = (core["isbool"] != 0)[None, :]
    tabs[0][..., 0] = torch.where(isbool, (v != 2).int(), tabs[0][..., 0])
    tabs[1][..., 0] = torch.where(isbool, (v != 3).int(), tabs[1][..., 0])
    return tuple(tabs)


def _reads(op):
    """Argument slots a level node of opcode ``op`` reads."""
    from mythril_tpu_torch.ops import intervals as I

    if op in (I.BNOT, I.NEG, I.COPY, I.SEXT, I.EXTRACT, I.BNOT1):
        return 1
    return 3 if op in (I.ITE, I.BITE) else 2


def _level_rows(level):
    """(argument rows read, node rows) of a level's real nodes: the
    kernels skip NOP and pad rows; EXTRACT's second and third slots are
    immediates."""
    from mythril_tpu_torch.ops import intervals as I

    ops, args = level["op"].tolist(), level["args"].tolist()
    node = level["node"].tolist()
    nodes = [j for j, o in enumerate(ops) if o]
    read = {args[j][k] for j in nodes for k in range(_reads(ops[j]))
            if not (ops[j] == I.EXTRACT and k)}
    return read, {node[j] for j in nodes}


def _round_rows(rnd, n_rows):
    """Rows a backward round's real entries read: each parent and target,
    the condition of an ITE parent, both arguments of a binary one."""
    from mythril_tpu_torch.ops import intervals as I

    unary = (I.BNOT, I.COPY, I.EXTRACT, I.BNOT1)
    cols = [rnd[k].tolist() for k in ("parent", "a", "b", "tgt", "op")]
    rows = set()
    for p, a, b, t, o in zip(*cols):
        if t < n_rows:
            rows |= {p, t} | ({a} if o == I.ITE else set()) \
                | (set() if o in unary or o == I.ITE else {a, b})
    return rows


def clone_all(tabs):
    return tuple(t.clone() for t in tabs)


#: cycles of the spin kernel that holds the card while the host enqueues
#: a timed call (about 10 ms on an H100)
SPIN_CYCLES = 20_000_000


def queued_ms(fn, setup, reps=3):
    """Device milliseconds of one call fn(setup()), the mean over reps
    calls each on a fresh input: before each, a 256 MiB write evicts the
    L2 and a spin kernel keeps the card busy while the host enqueues
    [event, call, event], so the host's launch time is not in the
    events' interval."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn(setup())
    out = []
    for _ in range(reps):
        x = setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn(x)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sum(out) / reps


def changed_bytes(before, after):
    """Bytes of the 32-bit limbs that differ between two tuples of
    tables: what an in-place pass must store."""
    return 4 * sum(int((x != y).sum()) for x, y in zip(before, after))


def check_tables(name, core, start, interval_start, accs=None):
    """K5-K8 on one plan, chained from ``start`` (product tables) and
    ``interval_start`` (interval tables): every kernel call bit for bit
    against its plain version on the same input. K5 and K6 run each
    forward level, K8's exchange follows, K7 runs each backward round
    from the last level down, K8's verdicts close; K8's init and one
    sweep's changed flag against the plain comparison come first.

    With ``accs`` (name -> dict), every call is also timed: ``ms`` (a
    call on CUDA events, the host's launch included), ``device_ms``
    (``queued_ms``) and ``plain_ms``, all on fresh copies of the checked
    call's input; and the bytes the function must move on that input
    are counted: the rows it reads, once each (numeric rows 32 bytes per
    table, bool rows the 4-byte limb 0 of lo and hi), and the limbs that
    its call changed; K8's init writes the four tables whole, and its
    verdicts read each state's rows up to the first row in conflict (all
    of them in a state without one), then the assertion slots of a state
    that has none."""
    import torch

    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P

    n_s, n_t = core["seed_idx"].shape[0], core["init_lo"].shape[0]
    numeric = core["numeric"] != 0
    isbool = core["isbool"] != 0
    row_iv = torch.where(isbool, 8, 64).tolist()
    row_pr = torch.where(isbool, 8, 128).tolist()
    flag = torch.zeros(1, dtype=torch.int32, device=start[0].device)
    err = dict.fromkeys(("interval_level", "prop_fwd_level",
                         "prop_back_round", "prop_tables"), 0)

    def call(key, what, kern, plain, x, nbytes=None):
        """Run kern and plain on copies of x, require equal outputs,
        time the pair when accs is given; returns the kernel's
        output."""
        a, b = clone_all(x), clone_all(x)
        out_k, out_p = kern(a), plain(b)
        out_k, out_p = (a, b) if out_k is None else (out_k, out_p)
        torch.cuda.synchronize()
        err[key] = max(err[key], same_outputs(out_k, out_p, f"{name}: {what}"))
        if accs is not None:
            acc = accs[key]
            acc["ms"] += cuda_ms(kern, reps=3, setup=lambda: clone_all(x))
            acc["device_ms"] += queued_ms(kern, lambda: clone_all(x))
            acc["plain_ms"] += cuda_ms(plain, reps=1,
                                       setup=lambda: clone_all(x))
            acc["bytes"] += nbytes(x, out_k)
        return out_k

    # K8 init; the changed flag of one kernel sweep
    call("prop_tables", "K8 prop_init", lambda _: P.init_tables_kernel(core),
         lambda _: P.init_tables_plain(core), (),
         lambda _x, _o: 4 * n_s * n_t * 32 + 4 * n_t * 32
         + 4 * core["seed_idx"].numel()
         + 64 * int(((core["seed_idx"] >= 0)
                     & (core["seed_idx"] < n_t)).sum())
         + 5 * core["assert_idx"].numel())
    a, b = clone_all(start), clone_all(start)
    flag.zero_()
    P.sweep(core, a, flag)
    P.sweep(core, b, plain=True)
    torch.cuda.synchronize()
    same_outputs(a, b, f"{name}: one sweep")
    if bool(flag.item()) != P.changed_plain(start, b):
        raise AssertionError(f"{name}: the changed flag differs from the "
                             f"tables")
    del a, b

    iv, tabs = interval_start, start
    for li, lvl in enumerate(core["levels"]):
        reads, nodes = _level_rows(lvl)
        iv = call("interval_level", f"K5 interval_level {li}",
                  lambda x, lv=lvl: I.eval_level_kernel(lv, *x),
                  lambda x, lv=lvl: I.eval_level_plain(lv, *x), iv,
                  lambda x, o, r=reads: n_s * sum(row_iv[i] for i in r)
                  + changed_bytes(x, o))
        tabs = call("prop_fwd_level", f"K6 prop_fwd_level {li}",
                    lambda x, lv=lvl: P.fwd_level_kernel(lv, x, flag),
                    lambda x, lv=lvl: P.fwd_level_plain(lv, x), tabs,
                    lambda x, o, r=reads | nodes: n_s * sum(
                        row_pr[i] for i in r) + changed_bytes(x, o))
    tabs = call("prop_tables", "K8 prop_exchange",
                lambda x: P.exchange_kernel(x, core["numeric"], flag),
                lambda x: P.exchange_plain(x, core["numeric"]), tabs,
                lambda x, o: n_s * int(numeric.sum()) * 128
                + changed_bytes(x, o))
    for li in range(len(core["back"]) - 1, -1, -1):
        for ri, rnd in enumerate(core["back"][li]):
            rows = _round_rows(rnd, n_t)
            tabs = call("prop_back_round", f"K7 prop_back_round {li}.{ri}",
                        lambda x, r=rnd: P.back_round_kernel(r, x, flag),
                        lambda x, r=rnd: P.back_round_plain(r, x), tabs,
                        lambda x, o, rows=rows: n_s * sum(
                            row_pr[i] for i in rows) + changed_bytes(x, o))

    def verdict_bytes(x, out):
        cost = torch.where(numeric, 128, torch.where(isbool, 8, 0))
        upto = torch.cumsum(cost, 0)
        first = torch.cat([
            torch.where(c.any(1), c.int().argmax(1), n_t - 1)
            for c in (P.conflict_rows(core, x, s)
                      for s in I.state_chunks(n_s, n_t))])
        clean = out[1] == 0
        slots = core["assert_idx"].shape[1]
        live = int((core["assert_mask"] != 0)[clean].sum())
        return (int(upto[first].sum()) + int(clean.sum()) * slots * 5
                + 4 * live + 2 * n_s + 2 * n_t)

    call("prop_tables", "K8 prop_verdicts",
         lambda x: P.verdicts_kernel(core, x),
         lambda x: P.verdicts_plain(core, x), tabs, verdict_bytes)
    return err


def check_screens(dev, report, wave):
    """K5-K8 against their plain versions on the card: on the all-opcode
    wave (every opcode and backward rule) from its init tables and from
    seeded random tables, then at the 8192-system wave's shapes from its
    init tables, timed and with byte bounds; on both waves the whole
    screen (keep masks, sweeps, facts) with the kernels equals the
    plain versions'."""
    import torch

    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P

    sets, l_enc, l_core = layered_wave(dev)
    init = P.init_tables_kernel(l_core)
    errs = [check_tables("all-opcode wave", l_core, init, init[:2])]
    for seed in (SEED, SEED + 1):
        rnd = random_tables(l_core, seed)
        errs.append(check_tables(f"all-opcode wave, random tables {seed}",
                                 l_core, rnd, rnd[:2]))
    got, want = P.screen(sets, dev), P.screen(sets, dev, plain=True)
    iv, iv_plain = (I.eval_feasible(l_enc, dev),
                    I.eval_feasible(l_enc, dev, plain=True))
    if (list(got.keep) != list(want.keep) or got.sweeps != want.sweeps
            or _facts_key(got.facts) != _facts_key(want.facts)
            or list(iv) != list(iv_plain)):
        raise AssertionError("all-opcode wave: the screen differs from "
                             "the plain versions")
    log(f"all-opcode wave: {len(sets)} states x {l_core['init_lo'].shape[0]}"
        f" rows, 26 opcodes, every backward rule; K5-K8 equal to the plain "
        f"versions from its init tables and from random tables (seeds "
        f"{SEED}, {SEED + 1}); screen keeps {int(got.keep.sum())} "
        f"(interval pass {int(iv.sum())}), {got.sweeps} sweeps, as plain")

    systems, keep, enc, plan, core = wave
    n_t = core["init_lo"].shape[0]
    log(f"screen wave: {SCREEN_N} systems, {enc.n_nodes} nodes in {n_t} "
        f"rows, levels {[lv['op'].shape[0] for lv in core['levels']]}, "
        f"rounds {[[r['op'].shape[0] for r in rs] for rs in core['back']]}")
    accs = {k: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes=0)
            for k in errs[0]}
    start = P.init_tables_kernel(core)
    seeded = I.seed_tables(core["init_lo"], core["init_hi"],
                           core["seed_idx"], core["seed_lo"],
                           core["seed_hi"])
    errs.append(check_tables("screen wave", core, start, seeded, accs))
    del start, seeded
    torch.cuda.empty_cache()
    for name, acc in accs.items():
        bms, by = bound_ms(acc["bytes"])
        report[name] = dict(max_abs_err=max(e[name] for e in errs),
                            ms=acc["ms"], plain_ms=acc["plain_ms"],
                            device_ms=acc["device_ms"], bound_ms=bms,
                            bound_by=by)
        log(f"{name}: {acc['ms']:.4f} ms calls, {acc['device_ms']:.4f} ms "
            f"device, {acc['plain_ms']:.1f} ms plain, bound {bms:.6f} ms "
            f"({by}, {acc['bytes']} bytes)")


def _facts_key(facts):
    return {s: (sorted(map(repr, f)),
                sorted((repr(v), lo, hi) for v, lo, hi in b.values()))
            for s, (f, b) in facts.items()}


#: the screens' kernels by their symbols in a profile
SCREEN_SYMBOLS = ("level_kernel<false>", "level_kernel<true>", "back_kernel",
                  "init_kernel", "exchange_kernel", "verdicts_kernel")


def screen_path(dev, wave, card):
    """The pruner's screen over the 8192-system wave, with propagation
    on (K6-K8) and off (K5). Returns the launches of each run; one more
    profiled screen each way gives the device's busy share and each
    screen kernel's device time on the path (logged for the breakdown
    of where the path's time goes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.models import pruner
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.smt.solver.solver_statistics import (
        SolverStatistics,
    )

    systems, keep, enc, plan, core = wave
    if sum(keep) != SCREEN_KEEP:
        raise AssertionError("the wave's expected keep count")

    def ident(s):
        return s

    launches, sym_ms = {}, {}
    for prop in (True, False):
        P.FORCE = None if prop else False
        tag = "propagation on" if prop else "propagation off"
        pruner._screen_interval(systems, ident)  # warm: allocator, libs
        stats0 = dict(pruner.STATS)
        ss0 = SolverStatistics().batch_counters()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = pruner._screen_interval(systems, ident)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[prop] = dict(_build.LAUNCHES)
        ss1 = SolverStatistics().batch_counters()
        delta = {k: pruner.STATS[k] - stats0[k] for k in stats0}
        if len(kept) != SCREEN_KEEP:
            raise AssertionError(f"screen path ({tag}): kept {len(kept)}")
        if delta["device_screened"] != SCREEN_N or pruner.STATS[
                "device_failures"]:
            raise AssertionError(f"screen path ({tag}): {delta}, "
                                 f"{pruner.STATS['device_failures']} "
                                 f"device failures")
        kept_ids = {id(s) for s in kept}
        mask = [id(s) in kept_ids for s in systems]
        if prop:
            want = P.screen(systems, dev, plain=True)
            got = P.screen(systems, dev)
            sweeps = ss1["propagate_sweeps"] - ss0["propagate_sweeps"]
            facts = ss1["facts_harvested"] - ss0["facts_harvested"]
            n_facts = sum(len(f) for f, _ in want.facts.values())
            if (mask != list(want.keep) or sweeps != want.sweeps
                    or facts != n_facts or list(got.keep) != mask
                    or got.sweeps != want.sweeps
                    or _facts_key(got.facts) != _facts_key(want.facts)):
                raise AssertionError("screen path (propagation on) differs "
                                     "from the plain versions")
            detail = f"{sweeps} sweeps, {facts} facts harvested"
            need = ("prop_fwd_level", "prop_back_round", "prop_tables")
        else:
            want = I.eval_feasible(I.linearize(systems), dev, plain=True)
            if mask != list(want):
                raise AssertionError("screen path (propagation off) differs "
                                     "from the plain version")
            detail = "forward interval pass"
            need = ("interval_level",)
        missing = [k for k in need if launches[prop][k] <= 0]
        if missing:
            raise AssertionError(f"screen path ({tag}) never launched "
                                 f"{missing}")
        # the device's busy share of one more call, and its kernels'
        # device time (a session that misses them is run again, up to 3)
        syms = SCREEN_SYMBOLS[1:] if prop else SCREEN_SYMBOLS[:1]
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                pruner._screen_interval(systems, ident)
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t1
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            got = {sym: sum(e.self_device_time_total for e in rows
                            if sym in e.key) / 1e3 for sym in syms}
            if all(got.values()):
                sym_ms.update(got)
                break
        dev_s = sum(e.self_device_time_total for e in rows) / 1e6
        log(f"screen path ({tag}): kept {len(kept)} of {SCREEN_N}, "
            f"device_screened +{delta['device_screened']}, 0 device "
            f"failures, {detail}; {wall:.3f} s, {SCREEN_N / wall:.1f} "
            f"systems/s; device busy {dev_s:.4f} of {pwall:.3f} s under the "
            f"profiler (share {dev_s / pwall:.4f}); launches "
            f"{ {k: v for k, v in launches[prop].items() if v} } on {card}")
    P.FORCE = None
    missing = set(SCREEN_SYMBOLS) - set(sym_ms)
    log("screen kernels' device ms in the profiled screens: " + (", ".join(
        f"{k} {v:.4f}" for k, v in sym_ms.items()) or "none recorded")
        + f" ({sweeps} sweeps)"
        + (f"; no device time recorded for {sorted(missing)}"
           if missing else ""))
    return launches


def screen_mix(dev):
    """The propagation mix (8192 sets): propagation refutes the bit
    conflicts and unit chains that the interval pass keeps; kernels and
    plain versions agree."""
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import propagation_mix

    sets, keep = propagation_mix(SCREEN_N)
    t0 = time.perf_counter()
    got = P.screen(sets, dev)
    wall = time.perf_counter() - t0
    want = P.screen(sets, dev, plain=True)
    iv = I.prefilter_feasible(sets, dev)
    iv_plain = I.eval_feasible(I.linearize(sets), dev, plain=True)
    if (list(got.keep) != list(want.keep) or got.sweeps != want.sweeps
            or _facts_key(got.facts) != _facts_key(want.facts)
            or list(iv) != list(iv_plain)):
        raise AssertionError("propagation mix: kernels differ from plain")
    if list(got.keep) != keep or not iv.all():
        raise AssertionError("propagation mix: kept "
                             f"{int(got.keep.sum())}, interval pass kept "
                             f"{int(iv.sum())}")
    log(f"propagation mix: {SCREEN_N} sets, interval pass keeps "
        f"{int(iv.sum())}, propagation keeps {int(got.keep.sum())} "
        f"({int(iv.sum() - got.keep.sum())} refuted only by propagation), "
        f"{got.sweeps} sweeps, "
        f"{sum(len(f) for f, _ in got.facts.values())} facts; {wall:.3f} s")


# ---------------------------------------------------------------------------
# the concrete lane path: K10
# ---------------------------------------------------------------------------

#: bench.py's bench_device batch and the plain comparison's width
CONCRETE_N, CONCRETE_PLAIN_N = 32768, 1024
#: the wide runs: init_lanes' default planes, their step cap, and the
#: lanes held against the plain version
WIDE_CONCRETE_N, WIDE_CONCRETE_STEPS, WIDE_SAMPLE = 131072, 4096, 512


def same_lanes(a, b, what):
    """The largest difference over every plane of two LaneStates;
    raises if any."""
    from mythril_tpu_torch.ops.stepper import LANE_FIELDS

    err = 0
    for f in LANE_FIELDS:
        e = max_err(getattr(a, f), getattr(b, f))
        if e:
            raise AssertionError(f"{what}: plane {f} differs (max {e})")
        err = max(err, e)
    return err


def lane_footprint(code, st, max_steps):
    """What one run of ``st`` reads beyond its scalars, traced on a copy
    with single steps (K10 at ``max_steps`` 1, which ends where one run
    does: lanes never interact): each lane's env rows and calldata bytes
    read, whether it touches memory, storage or calldata, the code rows
    and opcodes the batch executes, and (``final``) the traced state."""
    import torch

    from mythril_tpu_torch.ops import stepper as S

    x = S.clone_lanes(st)
    n, c = x.calldata.shape
    dev = x.device
    lanes = torch.arange(n, device=dev)
    cols = torch.arange(c, device=dev)
    env_slot = torch.as_tensor(S.ENV_TABLE, device=dev).long()
    op_ = {k: S._OP[k] for k in ("MLOAD", "MSTORE", "MSTORE8", "MSIZE",
                                 "SLOAD", "SSTORE", "CALLDATALOAD",
                                 "CALLDATASIZE")}
    fams = dict(memory=("MLOAD", "MSTORE", "MSTORE8", "MSIZE"),
                storage=("SLOAD", "SSTORE"),
                calldata=("CALLDATALOAD", "CALLDATASIZE"))
    fp = {k: torch.zeros(n, dtype=torch.bool, device=dev) for k in fams}
    fp.update(env=torch.zeros((n, S.N_ENV), dtype=torch.bool, device=dev),
              cd_bytes=torch.zeros((n, c), dtype=torch.bool, device=dev),
              rows=torch.zeros(code.size + 1, dtype=torch.bool, device=dev),
              ops=torch.zeros(256, dtype=torch.bool, device=dev))
    for _ in range(max_steps):
        live = x.status == S.Status.RUNNING
        if not bool(live.any()):
            break
        pc = x.pc.long().clamp(0, code.size)
        op = code.opcode[pc].long()
        fp["rows"][pc[live]] = True
        fp["ops"][op[live]] = True
        slot = env_slot[op]
        hit = live & (slot >= 0)
        fp["env"][lanes[hit], slot[hit]] = True
        for fam, names in fams.items():
            for name in names:
                fp[fam] |= live & (op == op_[name])
        # CALLDATALOAD reads [top, top + 32) below cd_size
        top = x.stack[lanes, (x.sp.long() - 1).clamp(0, x.stack.shape[1]
                                                     - 1)]
        off = top[:, 0].long() & 0xFFFFFFFF
        small = ~(top[:, 1:] != 0).any(dim=1) & (off < 1 << 30)
        cdl = live & (op == op_["CALLDATALOAD"]) & (x.sp > 0) & small
        fp["cd_bytes"] |= (cdl[:, None] & (cols >= off[:, None])
                           & (cols < off[:, None] + 32)
                           & (cols < x.cd_size.long()[:, None]))
        x = S.step(code, x)
    fp["final"] = x
    return fp


def lane_run_bound(before, after, code, fp):
    """(bound ms, "bytes" or "operations", bytes, operations) of one K10
    run from ``before`` to ``after``, counting what this run's data
    needs (``fp``, from ``lane_footprint``): every lane reads pc, sp,
    status, gas_used, gas_limit and steps, and msize, scount, cd_size
    where its instructions touch memory, storage, calldata; the stack
    slots live at its start; the memory below its starting msize and the
    storage keys of its starting log where it touches them; the calldata
    bytes and env rows it reads; the batch reads the code rows and
    op-table rows it executes; every element the run changed is written
    once. Against 8 integer operations (one a limb of the word moved)
    per instruction retired."""
    from mythril_tpu_torch.ops import stepper as S

    nbytes = 24 * before.pc.numel()
    for fam in ("memory", "storage", "calldata"):
        nbytes += 4 * int(fp[fam].sum())
    nbytes += 32 * int(before.sp.long().sum())
    nbytes += int((before.msize.long() * fp["memory"]).sum())
    nbytes += 32 * int((before.scount.long() * fp["storage"]).sum())
    nbytes += int(fp["cd_bytes"].sum()) + 32 * int(fp["env"].sum())
    nbytes += (code.packed.shape[1] * 4 * int(fp["rows"].sum())
               + S.LANE_OP_TABLE.shape[1] * 4 * int(fp["ops"].sum()))
    for f in S.LANE_FIELDS:
        x, y = getattr(before, f), getattr(after, f)
        nbytes += x.element_size() * int((x != y).sum())
    nops = 8 * int((after.steps.long() - before.steps.long()).sum())
    bms, by = bound_ms(nbytes, nops)
    return bms, by, nbytes, nops


def concrete_path(dev, card, report):
    """The concrete path of bench.py's headline (bench_device): the
    bench contract over 32768 lanes through the port's ``run`` (K10),
    one warm run and three timed, every lane's status, steps and slot 0
    held against the closed form; K10 held bit for bit against
    ``run_plain`` at 1024 lanes through a whole run and over single
    steps at full width; the device's busy share under torch.profiler
    (or the stream-interval share between CUDA events, an upper bound);
    K10's bound from what the timed inputs need (``lane_footprint``);
    then 131072 lanes at init_lanes' default planes on the dispatcher
    loop of ``__graft_entry__._build_fixture`` and on the lane mix
    contract, a sample of lanes held against the plain version. Returns
    the launches of the main path."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.support import contracts as C

    code = C.build_bench_contract()
    cc = S.compile_code(code, device=dev)
    cap = C.BENCH_MAX_STEPS

    # K10 against the plain version: a whole run, then single steps
    small = C.bench_batch(CONCRETE_PLAIN_N, dev)
    got = S.run_kernel(cc, S.clone_lanes(small), cap)
    t0 = time.perf_counter()
    want = S.run_plain(cc, small, cap)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = same_lanes(got, want, f"K10 at {CONCRETE_PLAIN_N} lanes")
    st = C.bench_batch(CONCRETE_N, dev)
    for k in range(9):
        if k == 6:
            S.run_kernel(cc, st, 200)
        x = S.step(cc, S.clone_lanes(st))
        st = S.step_plain(cc, st)
        err = max(err, same_lanes(x, st, f"K10 single step {k}"))
    del small, got, want, st, x
    log(f"K10 lane_run: equal to run_plain on every plane at "
        f"{CONCRETE_PLAIN_N} lanes through a whole run (plain {plain_s:.3f}"
        f" s) and over 9 single steps at {CONCRETE_N} lanes")

    # the main path: counts reset, one warm run, three timed
    _build.reset_launches()
    st = C.bench_batch(CONCRETE_N, dev)
    S.run(cc, st, cap)
    walls = []
    for _ in range(3):
        st = C.bench_batch(CONCRETE_N, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.run(cc, st, cap)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    if launches["lane_run"] != 4:
        raise AssertionError(f"concrete path: {launches['lane_run']} K10 "
                             f"launches for 4 runs")
    words = [int.from_bytes(bytes(r), "big")
             for r in C.bench_calldata(CONCRETE_N)]
    steps, stored = zip(*C.bench_closed_form(words))
    svals = st.svals[:, 0].cpu().numpy().view("uint32")
    got_stored = [sum(int(w) << (32 * i) for i, w in enumerate(row))
                  for row in svals]
    if (st.status != S.Status.STOPPED).any() \
            or st.steps.tolist() != list(steps) \
            or (st.scount != 1).any() or (st.skeys[:, 0] != 0).any() \
            or got_stored != list(stored):
        raise AssertionError("concrete path: lanes differ from the closed "
                             "form")
    total = int(st.steps.sum())
    med = statistics.median(walls)

    # K10's times on the main path's inputs, the busy share
    fresh = lambda: C.bench_batch(CONCRETE_N, dev)  # noqa: E731
    call = cuda_ms(lambda x: S.run_kernel(cc, x, cap), reps=3, setup=fresh)
    dev_ms = device_ms(lambda x: S.run_kernel(cc, x, cap), setup=fresh)
    dev_src = "torch.profiler"
    if dev_ms is None:
        dev_ms = queued_ms(lambda x: S.run_kernel(cc, x, cap), fresh)
        dev_src = "CUDA events behind a spin kernel"
    # the busy share of one more run: its device time under the profiler
    # over its wall (a session that records no device event is run
    # again, up to 3; with none, the share of the wall between CUDA
    # events around the run, an upper bound: idle time between the
    # events counts as busy)
    busy, busy_src = 0.0, "torch.profiler"
    for _ in range(3):
        x = fresh()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            S.run(cc, x, cap)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        if busy:
            break
    if not busy:
        names = sorted({e.name[:40] for e in prof.events()})
        log(f"concrete path: the profiler recorded no device event in 3 "
            f"sessions (the last: {len(prof.events())} host events, "
            f"{names})")
        x = fresh()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        S.run(cc, x, cap)
        b.record()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        busy = a.elapsed_time(b) / 1e3
        busy_src = "stream-interval share (upper bound), CUDA events"
    # the bound, from what one run of the timed inputs needs
    before = fresh()
    fp = lane_footprint(cc, before, cap)
    after = S.run_kernel(cc, S.clone_lanes(before), cap)
    same_lanes(fp["final"], after, "K10 in single steps against one run")
    bms, by, nbytes, nops = lane_run_bound(before, after, cc, fp)
    if nops != 8 * total:
        raise AssertionError(f"K10 bound: {nops // 8} instructions, the "
                             f"timed run retired {total}")
    report["lane_run"] = dict(max_abs_err=err, ms=call, device_ms=dev_ms,
                              plain_ms=plain_s * 1e3, bound_ms=bms,
                              bound_by=by)
    log(f"concrete path ({CONCRETE_N} lanes, bench contract, max_steps "
        f"{cap}): {CONCRETE_N / med:.1f} paths/s, {total / med:.1f} lane "
        f"instructions/s; median {med * 1e3:.3f} ms (runs "
        f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms); every lane's "
        f"status, steps and slot 0 equal the closed form; {total} "
        f"instructions; K10 {call:.4f} ms a call, {dev_ms:.4f} ms device "
        f"({dev_src}), bound {bms:.6f} ms ({by}: {nbytes} bytes, {nops} "
        f"operations: {nbytes / CONCRETE_N:.1f} bytes and "
        f"{nops / CONCRETE_N:.1f} operations a lane); device busy "
        f"{busy:.6f} of {pwall:.6f} s ({busy_src}; share "
        f"{busy / pwall:.4f}); plain at {CONCRETE_PLAIN_N} lanes "
        f"{plain_s:.3f} s; on {card}")
    del st, x, before, after, fp

    # the wide runs at default planes: __graft_entry__._build_fixture's
    # loop contract, then the lane mix contract (its loop, memory and
    # storage arms), on one seeded batch (loop counts in word 0, the
    # arm in word 1)
    g = torch.Generator().manual_seed(SEED)
    idx = torch.randperm(WIDE_CONCRETE_N, generator=g)[:WIDE_SAMPLE]
    idx = idx.sort().values.to(dev)
    for name, wcode in (("dispatcher loop", C.build_dispatcher_loop()),
                        ("lane mix", C.build_lane_mix_contract())):
        wcc = S.compile_code(wcode, device=dev)
        st = C.lane_mix_batch(WIDE_CONCRETE_N, SEED, device=dev)
        sample = S.select_lanes(st, idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.run(wcc, st, WIDE_CONCRETE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (st.status == S.Status.RUNNING).any():
            raise AssertionError(f"wide run ({name}): lanes still running")
        same_lanes(S.select_lanes(st, idx),
                   S.run_plain(wcc, sample, WIDE_CONCRETE_STEPS),
                   f"wide run ({name}), {WIDE_SAMPLE} sampled lanes")
        counts = torch.bincount(st.status.long(), minlength=7).tolist()
        log(f"wide concrete run ({name}): {WIDE_CONCRETE_N} lanes of "
            f"{S.lane_bytes(st)} bytes ({S.lane_bytes(st) * WIDE_CONCRETE_N}"
            f" bytes of planes), {wall:.3f} s, "
            f"{WIDE_CONCRETE_N / wall:.1f} paths/s, "
            f"{int(st.steps.sum()) / wall:.1f} lane instructions/s; "
            f"statuses {dict(enumerate(counts))}; {WIDE_SAMPLE} sampled "
            f"lanes equal to run_plain on every plane; on {card}")
        want = ((S.Status.STOPPED,) if name == "dispatcher loop" else
                (S.Status.STOPPED, S.Status.RETURNED, S.Status.NEEDS_HOST))
        if not all(counts[k] for k in want):
            raise AssertionError(f"wide run ({name}): statuses {counts}")
        del st, sample
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the fused screen: K11
# ---------------------------------------------------------------------------

def fused_screen(dev, wave, card, report):
    """The 8192-system wave with the fused driver: K11 against
    ``_fixpoint_plain`` on the card and against the host-sequenced K6-K8
    driver (tables, ok, contra, sweeps, keep); then the pruner's screen
    with ``MTPU_PROPAGATE_FUSE`` on and off, in turns (off, on, on,
    off), systems/s and launches each way. Returns the launches of the
    fused screen path."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.models import pruner
    from mythril_tpu_torch.ops import propagate as P

    systems, keep, enc, plan, core = wave
    cap = plan.statics[0]
    got = P.fixpoint_kernel(core, cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = P._fixpoint_plain(core, cap)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    host = P._run_host(core, cap)
    err = same_outputs(got[0], want[0], "K11 tables against the plain")
    err = max(err, same_outputs(got[0], host[0],
                                "K11 tables against the host driver"))
    for i, what in ((1, "ok"), (2, "contra")):
        if not (torch.equal(got[i], want[i]) and torch.equal(got[i],
                                                             host[i])):
            raise AssertionError(f"K11 {what} differs")
    if not (got[3] == want[3] == host[3]) or not torch.equal(got[4],
                                                             want[4]):
        raise AssertionError(f"K11 sweeps {got[3]}, plain {want[3]}, host "
                             f"driver {host[3]}")
    n = enc.n_real
    dead = torch.as_tensor(enc.dead[:n], device=dev)
    keeps = [(x[1][:n] & ~dead).tolist() for x in (got, host)]
    if keeps[0] != keeps[1] or sum(keeps[0]) != SCREEN_KEEP:
        raise AssertionError("K11 keep mask differs")
    # bytes: the four tables written once (the outputs), and each sweep
    # of a system reads its rows once: a numeric row's four words, a bool
    # row's limb 0 of lo and hi (as K8's count); pad rows are not read
    per = got[4]
    n_t = core["init_lo"].shape[0]
    row = int(torch.where(core["isbool"] != 0, 8, torch.where(
        core["numeric"] != 0, 128, 0)).sum())
    nbytes = 4 * n_t * 32 * per.numel() + row * int(per.sum())
    bms, by = bound_ms(nbytes)
    call = cuda_ms(lambda: P.fixpoint_kernel(core, cap), reps=3)
    dev_ms = queued_ms(lambda _: P.fixpoint_kernel(core, cap), lambda: None)
    host_ms = cuda_ms(lambda: P._run_host(core, cap), reps=3)
    report["prop_fixpoint"] = dict(max_abs_err=err, ms=call,
                                   device_ms=dev_ms, plain_ms=plain_s * 1e3,
                                   bound_ms=bms, bound_by=by)
    log(f"K11 prop_fixpoint: {SCREEN_N} systems, equal to _fixpoint_plain "
        f"and to the host-sequenced K6-K8 driver (tables, ok, contra, "
        f"keep {SCREEN_KEEP}, {got[3]} sweeps; per-system sweeps "
        f"{torch.bincount(per.long()).tolist()}); {call:.4f} ms a call, "
        f"{dev_ms:.4f} ms device, bound {bms:.6f} ms ({by}, {nbytes} "
        f"bytes); the host-sequenced driver {host_ms:.4f} ms a call; plain "
        f"{plain_s:.3f} s; on {card}")
    del got, want, host

    def ident(s):
        return s

    launches, rates = {}, {False: [], True: []}
    for fuse in (False, True, True, False):
        P.FUSE = fuse
        pruner._screen_interval(systems, ident)  # warm
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = pruner._screen_interval(systems, ident)
        torch.cuda.synchronize()
        rates[fuse].append(SCREEN_N / (time.perf_counter() - t0))
        launches[fuse] = dict(_build.LAUNCHES)
        if len(kept) != SCREEN_KEEP or pruner.STATS["device_failures"]:
            raise AssertionError(f"fused screen (fuse {fuse}): kept "
                                 f"{len(kept)}")
    P.FUSE = False
    on, off = launches[True], launches[False]
    if on["prop_fixpoint"] != 1 or on["prop_fwd_level"] \
            or on["prop_back_round"] or off["prop_fixpoint"]:
        raise AssertionError(f"fused screen launches {on}, host-sequenced "
                             f"{off}")
    log(f"fused screen (MTPU_PROPAGATE_FUSE=1): {SCREEN_KEEP} kept, "
        f"{', '.join(f'{r:.1f}' for r in rates[True])} systems/s, launches "
        f"{ {k: v for k, v in on.items() if v} }; host-sequenced: "
        f"{', '.join(f'{r:.1f}' for r in rates[False])} systems/s, launches "
        f"{ {k: v for k, v in off.items() if v} }; on {card}")
    return on


# ---------------------------------------------------------------------------
# the host bridge: K9, the analyzer end to end
# ---------------------------------------------------------------------------

def main_path_state(dev):
    """The k=12 main path's 4096-lane state after its first window (one
    fresh transaction entry, window 256), and that window's resolution
    pairs: each canonical record gets the next object id, as the
    engine's drain assigns them."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.ops.stepper import compile_code
    from mythril_tpu_torch.support import device_loop
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    n = MAIN_LANES
    code, _ = build_symbolic_contract(MAIN_K)
    cc = compile_code(code, device=dev)
    st = symstep.init_sym_lanes(n, device=dev)
    objs = le.ObjectTable()
    seed = device_loop.tx_entry_seed(objs, 1, st.calldata.shape[1])
    free = list(range(n - 1, -1, -1))
    entries = [(free.pop(), seed)]
    i32b, u8b, k, pv = le.pack_window(n, symstep.N_ENV, {}, entries, free,
                                      [], {}, st.calldata.shape[1])
    vis = torch.zeros(cc.packed.shape[0], dtype=torch.bool, device=dev)
    st, _, out = le.window_exec(
        st, cc, torch.from_numpy(i32b).to(dev), torch.from_numpy(u8b).to(dev),
        symstep.SYM_EXECUTABLE, None, le.DEFAULT_WINDOW, k,
        le.DEFAULT_STEP_BUDGET, pv, vis, 1)
    ucount = int(out[1][2])
    utab = out[2] if ucount <= out[2].shape[0] else \
        le._unique_table_big(st, 1 << (ucount - 1).bit_length())[0]
    utab = utab[:ucount].cpu().numpy()
    d = st.dlog_op.shape[1]
    pairs = np.full((le.PROV_BUCKET, 2), n * d, np.int32)
    for j, row in enumerate(utab):
        pairs[j] = (int(row[0]) * d + int(row[1]), objs.add(j))
    return st, torch.from_numpy(pairs).to(dev), ucount


def random_merge_state(dev, seed):
    """A seeded random 4096-lane state at the engine's default plane
    sizes for K9: sid planes mixing concrete (0), object ids, provisional
    ids of resolved and unresolved slots and int32 min; full storage
    tables with write stamps drawn from four values (ties); random
    memory kinds, stack heights and record counts. Returns (state,
    resolution pairs: 3000 real, then padding, then out-of-range and
    negative slots)."""
    import torch

    from mythril_tpu_torch.ops import symstep

    g = torch.Generator(device=dev).manual_seed(seed)
    st = symstep.init_sym_lanes(MAIN_LANES, device=dev)
    n, d = MAIN_LANES, st.dlog_op.shape[1]

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)

    planes = {}
    for f in symstep.FIELDS:
        t = getattr(st, f)
        if t.dtype == torch.uint8:
            planes[f] = ints(0, 256, t.shape, torch.uint8)
        else:
            planes[f] = ints(-2 ** 31, 2 ** 31, t.shape)
    for f in ("ssid", "mlog_sid", "skey_sid", "sval_sid"):
        shape = planes[f].shape
        kind = ints(0, 5, shape)
        vals = torch.where(kind == 1, ints(1, 5000, shape), 0)
        vals = torch.where(kind == 2, -(ints(0, n * d, shape) + 1), vals)
        vals = torch.where(kind == 3, torch.full_like(vals, -(n * d + 5)),
                           vals)
        planes[f] = torch.where(kind == 4,
                                torch.full_like(vals, -2 ** 31), vals)
    s = st.skeys.shape[1]
    planes["mkind"] = ints(0, 4, planes["mkind"].shape, torch.uint8)
    planes["sp"] = ints(0, st.stack.shape[1] + 1, (n,))
    planes["mlog_count"] = ints(0, st.mlog_off.shape[1] + 1, (n,))
    full = torch.full((n,), s, dtype=torch.int32, device=dev)
    planes["scount"] = torch.where(ints(0, 2, (n,)) == 0, full,
                                   ints(0, s + 1, (n,)))
    planes["s_written"] = ints(0, 2, planes["s_written"].shape)
    planes["s_wstep"] = ints(0, 4, planes["s_wstep"].shape)
    pairs = torch.full((8192, 2), n * d, dtype=torch.int32, device=dev)
    slots = torch.randperm(n * d, generator=g, device=dev)[:3000]
    pairs[:3000, 0] = slots.to(torch.int32)
    pairs[:3000, 1] = ints(1, 1 << 20, (3000,))
    pairs[3000:3003, 0] = torch.tensor([-1, n * d + 7, -n * d],
                                       dtype=torch.int32, device=dev)
    return st.replace(**planes), pairs


def merge_bytes(st, pairs):
    """K9's byte bound on these inputs: the planes it must read (the
    lane scalars, sid and kind planes, overlay and storage tables; the
    stack limbs of live concrete slots, the memory bytes of concrete
    kinds, the key and value limbs of live concrete storage slots), the
    resolution pairs, and 16 bytes per lane written."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le

    n, d = st.stack.shape[:2]
    m, mr, s_ = st.memory.shape[1], st.mlog_off.shape[1], st.skeys.shape[1]
    r = st.dlog_op.shape[1]
    prov = le.prov_table(st, pairs)

    def resolved(plane):
        return le._lookup(prov, plane, r)

    live = torch.arange(d, device=st.device)[None, :] < st.sp[:, None]
    conc_slots = int((live & (resolved(st.ssid) == 0)).sum())
    conc_mem = int(((st.mkind != 0) & (st.mkind != 3)).sum())
    srow = torch.arange(s_, device=st.device)[None, :] < st.scount[:, None]
    conc_k = int((srow & (resolved(st.skey_sid) == 0)).sum())
    conc_v = int((srow & (resolved(st.sval_sid) == 0)).sum())
    per_lane = 4 * 16 + 4 * d + m + 4 * 3 * mr + 4 * 5 * s_
    return (n * per_lane + 32 * (conc_slots + conc_k + conc_v) + conc_mem
            + 8 * pairs.shape[0] + 16 * n)


def check_merge_fp(dev, report):
    """K9 against its plain version, bit for bit, on the main path's
    state after a window and on a seeded random state; times on the
    main path's state."""
    from mythril_tpu_torch.laser import lane_engine as le

    st, pairs, ucount = main_path_state(dev)
    err = max_err(le.merge_fingerprint_kernel(st, pairs),
                  le.merge_fingerprint_plain(st, pairs))
    if err:
        raise AssertionError(f"K9 merge_fingerprint: main path state "
                             f"differs (max {err})")
    for seed in (SEED, SEED + 1):
        rs, rp = random_merge_state(dev, seed)
        e = max_err(le.merge_fingerprint_kernel(rs, rp),
                    le.merge_fingerprint_plain(rs, rp))
        if e:
            raise AssertionError(f"K9 merge_fingerprint: random state "
                                 f"{seed} differs (max {e})")
    k_ms = cuda_ms(lambda: le.merge_fingerprint_kernel(st, pairs), reps=5)
    d_ms = device_ms(lambda: le.merge_fingerprint_kernel(st, pairs))
    p_ms = cuda_ms(lambda: le.merge_fingerprint_plain(st, pairs), reps=1)
    nbytes = merge_bytes(st, pairs)
    bms, by = bound_ms(nbytes)
    report["merge_fingerprint"] = dict(max_abs_err=err, ms=k_ms,
                                       plain_ms=p_ms, device_ms=d_ms,
                                       bound_ms=bms, bound_by=by)
    log(f"K9 merge_fingerprint: equal on the main path's state after a "
        f"window ({ucount} records resolved) and on 2 random states; "
        f"{k_ms:.4f} ms kernel ({d_ms} ms on the device), {p_ms:.1f} ms "
        f"plain, bound {bms:.6f} ms ({nbytes} bytes)")


def symbolic_path(dev, card):
    """The end-to-end symbolic path at full width: every path of the
    k=12 contract through the port's SymExecWrapper at 4096 lanes (fork,
    SSTORE, the SHA3 tail; every path parks at its STOP and is
    materialized for the host). The launch counts are
    reset just before it and read just after. Fails unless it finds the
    open states the host-only run (``host_open``) finds."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    code, paths = build_symbolic_contract(MAIN_K)
    # pin the width to the workload's fork scale, as bench_symbolic does
    le.PATH_HISTORY[code] = paths
    torch.cuda.synchronize()
    _build.reset_launches()
    n_open, stats, wall = runs.explore(code, MAIN_LANES)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    missing = [name for name, *_ in ROWS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"symbolic path never launched {missing}")
    if not stats.get("windows") or not stats.get("device_steps"):
        raise AssertionError(f"symbolic path: the engine ran no window "
                             f"({stats})")
    log(f"symbolic path k={MAIN_K} at {MAIN_LANES} lanes: {n_open} open "
        f"states, {stats['windows']} windows, {stats['forks']} forks, "
        f"{stats['parked']} lanes materialized, {stats['resumed']} SHA3 "
        f"resumes, {stats['device_steps']} device steps, {wall:.3f} s, "
        f"{paths / wall:.1f} paths/s on {card}")
    return n_open, launches


def resume_and_spill(card):
    """Two host-bridge paths the symbolic path does not take, each held
    to the host-only run: a lane parked at a 33-byte SHA3 is resumed in
    place (``build_sha3_resume_contract`` at 16 lanes), and the spill
    regime (the k=6 contract's 64 paths through an 8-lane engine, every
    detector: over-budget forks park to the host, their descendants
    re-enter the device mid-path)."""
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import (
        build_sha3_resume_contract, build_symbolic_contract,
    )

    code = build_sha3_resume_contract()
    lane, stats, _ = runs.explore(code, 16)
    host, _, _ = runs.explore(code, 0)
    if lane != host or not stats.get("resumed"):
        raise AssertionError(f"SHA3 resume: {lane} open states, host "
                             f"{host}; {stats.get('resumed')} resumed")
    code, _ = build_symbolic_contract(6)
    old = le.FORCE_WIDTH
    le.FORCE_WIDTH = 8
    try:
        report, sstats, wall = runs.analyze(code.hex(), tpu_lanes=8)
    finally:
        le.FORCE_WIDTH = old
    host_report, _, _ = runs.analyze(code.hex(), tpu_lanes=0)

    def issues(r):
        return sorted((i.swc_id, i.address, i.title)
                      for i in r.issues.values())

    if issues(report) != issues(host_report) or not sstats.get("reseeded"):
        raise AssertionError(f"spill regime: issues {issues(report)}, host "
                             f"{issues(host_report)}; {sstats}")
    log(f"SHA3 resume: {stats['resumed']} lanes resumed in place, {lane} "
        f"open states as on the host; spill regime: 64 paths through 8 "
        f"lanes, {sstats['reseeded']} mid-path re-seeds, "
        f"{sstats['windows']} windows, {len(issues(report))} issues as on "
        f"the host, {wall:.2f} s on {card}")


def merge_path(card):
    """The window merge on bench.py's rig (the diamond contract, 64
    lanes, 32-step windows, every detector) with the merge on and off.
    Fails unless lanes merge and subsume, K9 launched, and the issue
    sets are identical. Returns K9's launch count of the merge-on run."""
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_diamond_contract

    code = build_diamond_contract(k=6, dup_levels=2)
    _build.reset_launches()
    t0 = time.perf_counter()
    on = runs.merge_run(code, True)
    wall = time.perf_counter() - t0
    k9 = _build.LAUNCHES["merge_fingerprint"]
    off = runs.merge_run(code, False)
    c = on["counters"]
    if not (c["lanes_merged"] > 0 and c["lanes_subsumed"] > 0 and k9 > 0):
        raise AssertionError(f"merge path: {c}, K9 launched {k9} times")
    if on["issues"] != off["issues"]:
        raise AssertionError(f"merge path: issues {on['issues']} with the "
                             f"merge, {off['issues']} without")
    log(f"merge path: {c['lanes_merged']} lanes merged, "
        f"{c['lanes_subsumed']} subsumed in {c['merge_rounds']} rounds, "
        f"K9 launched {k9} times, {len(on['issues'])} issues as with the "
        f"merge off; {on['engine']['windows']} windows, {wall:.2f} s on "
        f"{card}")
    return k9


CORPUS_WORKERS = 4


def corpus_start():
    """Start ``myth analyze`` of the 18 fixtures through the port, each
    in its own process (``--analyze``), at most CORPUS_WORKERS at once;
    returns the pool's handle for ``corpus_finish``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from mythril_tpu_torch.support.lane_compare import INPUTS

    names = sorted(p.name for p in INPUTS.glob("*.sol.o"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")

    def one(name):
        stats = os.path.join(tmp, name + ".json")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--analyze", name, stats], capture_output=True, text=True,
            cwd=HERE, timeout=900)
        return name, run, stats, time.perf_counter() - t0

    pool = ThreadPoolExecutor(CORPUS_WORKERS)
    return pool, [pool.submit(one, n) for n in names], tmp


def corpus_finish(handle, card):
    """Wait for the corpus and hold it against the JAX package's
    reference lists (tests/torch_data/lane_issues.json), fixture by
    fixture. Fails on any difference, on a run that printed an error
    or whose analysis raised, on a fixture where the port's engine ran
    other windows, forks or device steps than the JAX engine's (the
    reference's run stats) or, where a JAX sweep failed and went on on
    the host, no window, unless the engine ran windows, forks and
    device steps and the device screens screened, or on a device
    failure."""
    from mythril_tpu_torch.support.lane_compare import canon

    pool, futs, tmp = handle
    with open(os.path.join(HERE, "tests", "torch_data",
                           "lane_issues.json")) as f:
        ref = json.load(f)
    tot = {"windows": 0, "forks": 0, "device_steps": 0, "merged": 0}
    screened = failures = n_got = n_want = 0
    launches = {}
    bad, unlike = [], []
    try:
        for fut in futs:
            name, run, stats_path, wall = fut.result()
            if run.returncode != 0 or not os.path.exists(stats_path):
                raise AssertionError(f"corpus {name}: exit "
                                     f"{run.returncode}\n"
                                     f"{run.stderr[-3000:]}")
            rep = json.loads(run.stdout)
            if rep.get("error") or not rep.get("success", True):
                raise AssertionError(f"corpus {name}: {rep.get('error')}")
            with open(stats_path) as f:
                st = json.load(f)
            if st["exceptions"]:
                raise AssertionError(f"corpus {name}: the analysis raised\n"
                                     f"{st['exceptions'][0][-3000:]}")
            got, want = canon(rep), ref[name]["issues"]
            n_got, n_want = n_got + len(got), n_want + len(want)
            rs = st["run_stats"]
            for key in ("windows", "forks", "device_steps"):
                tot[key] += rs.get(key, 0)
            tot["merged"] += rs.get("lanes_merged", 0) \
                + rs.get("lanes_subsumed", 0)
            screened += st["pruner"]["device_screened"]
            failures += st["pruner"]["device_failures"]
            for k, v in st["launches"].items():
                launches[k] = launches.get(k, 0) + v
            if got != want:
                bad.append(name)
            keys = ("windows", "forks", "device_steps")
            mine = [rs.get(k, 0) for k in keys]
            jax = [ref[name]["run_stats"].get(k, 0) for k in keys]
            if ref[name]["engine_failures"]:
                # the JAX sweep raised and its states ran on the host
                same = mine[0] > 0
                how = "JAX engine failed, the port's ran"
            else:
                same = mine == jax
                how = "as the JAX engine's" if same else "NOT as JAX's"
            if not same:
                unlike.append((name, mine, jax))
            log(f"  corpus {name:30s} {len(got)}/{len(want)} issues "
                f"{'equal' if got == want else 'DIFFER'}, {wall:.1f} s, "
                f"{mine[0]} windows, {mine[1]} forks, {mine[2]} device "
                f"steps ({how})")
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    if bad:
        raise AssertionError(f"corpus: issues differ on {bad}")
    if unlike:
        raise AssertionError(f"corpus: windows, forks, device steps "
                             f"differ from the JAX engine's (name, port, "
                             f"JAX): {unlike}")
    if not (tot["windows"] and tot["forks"] and tot["device_steps"]):
        raise AssertionError(f"corpus: the lane engine did not run ({tot})")
    if screened <= 0 or failures:
        raise AssertionError(f"corpus: device_screened {screened}, "
                             f"device_failures {failures}")
    log(f"corpus: {n_got} = {n_want} issues over {len(futs)} fixtures; "
        f"{tot['windows']} windows, {tot['forks']} forks, "
        f"{tot['device_steps']} device steps, {tot['merged']} lanes merged "
        f"or subsumed, {screened} systems screened on the device, 0 device "
        f"failures; launches {launches} on {card}")


def analyze_one(name, stats_path):
    """``--analyze``: ``python -m mythril_tpu_torch analyze`` of one
    fixture with the corpus flags, its report on stdout; the engine's
    run stats, the screens' counters, the kernel launches and the
    analysis' exceptions (which the JSON report leaves out) go to
    ``stats_path``."""
    sys.path.insert(0, HERE)
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.models import pruner
    from mythril_tpu_torch.orchestration.mythril_analyzer import (
        MythrilAnalyzer,
    )
    from mythril_tpu_torch.support.lane_compare import INPUTS, analyze_argv

    exceptions = []
    fire = MythrilAnalyzer.fire_lasers

    def fire_recorded(*a, **k):
        report = fire(*a, **k)
        exceptions.extend(report.exceptions)
        return report

    MythrilAnalyzer.fire_lasers = fire_recorded
    sys.argv = ["myth"] + analyze_argv(INPUTS / name, lanes=64)
    try:
        cli.main()
    except SystemExit as e:
        if e.code not in (None, 0, 1):
            raise
    finally:
        with open(stats_path, "w") as f:
            json.dump({"run_stats": le.RUN_STATS_TOTAL,
                       "pruner": pruner.STATS,
                       "launches": _build.LAUNCHES,
                       "exceptions": exceptions}, f)
    return 0


#: the kernels the main path launches: (name, source, TPU kernel)
ROWS = [
    ("sym_init", "mythril_tpu_torch/csrc/symstep.cu",
     "mythril_tpu/ops/symstep.py:250"),
    ("sym_step", "mythril_tpu_torch/csrc/symstep.cu",
     "mythril_tpu/ops/symstep.py:419"),
    ("window_prologue", "mythril_tpu_torch/csrc/window.cu",
     "mythril_tpu/laser/lane_engine.py:859"),
    ("window_dedup", "mythril_tpu_torch/csrc/window.cu",
     "mythril_tpu/laser/lane_engine.py:689"),
    ("window_epilogue", "mythril_tpu_torch/csrc/window.cu",
     "mythril_tpu/laser/lane_engine.py:1196"),
]

#: the kernels of the screen path, with the run (propagation on or off)
#: that launches them
SCREEN_ROWS = [
    ("interval_level", "mythril_tpu_torch/csrc/screen.cu",
     "mythril_tpu/ops/intervals.py:611", False),
    ("prop_fwd_level", "mythril_tpu_torch/csrc/screen.cu",
     "mythril_tpu/ops/propagate.py:340", True),
    ("prop_back_round", "mythril_tpu_torch/csrc/screen.cu",
     "mythril_tpu/ops/propagate.py:463", True),
    ("prop_tables", "mythril_tpu_torch/csrc/screen.cu",
     "mythril_tpu/ops/propagate.py:699", True),
]


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--analyze":
        return analyze_one(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mythril_tpu_torch import _build

    dev = torch.device("cuda", 0)
    card = smi()
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} sources in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(built))}) on {card}")
    for src in sorted(os.listdir(_build.CSRC)):
        if src.endswith(".cu"):
            for line in _build.build_log(src).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")

    from mythril_tpu_torch import native

    t0 = time.perf_counter()
    fresh = not os.path.exists(native._LIB_PATH)
    native.get_lib()  # raises with make's output on a failed build
    log(f"native solver library: {'built' if fresh else 'loaded'} in "
        f"{time.perf_counter() - t0:.1f} s ({native._LIB_PATH})")

    from mythril_tpu_torch.ops.symstep import lane_bytes
    from mythril_tpu_torch.support.devices import default_lanes

    log(f"lane default on this card: {default_lanes(lane_bytes(), dev)} "
        f"lanes of {lane_bytes()} bytes")
    report = {}
    check_bv256(dev, report)
    check_init(dev, report)
    check_k1(dev, report)
    check_window(dev, report)
    check_merge_fp(dev, report)

    # the symbolic path at full width: its launch counts are the main
    # path's for K0-K4
    n_open, launches = symbolic_path(dev, card)

    # the corpus, each fixture its own process, while this process runs
    # the symbolic path's host-only reference (no card work here, so the
    # timed phases below run alone)
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    corpus = corpus_start()
    t0 = time.perf_counter()
    host_open, _, host_wall = runs.explore(
        build_symbolic_contract(MAIN_K)[0], 0)
    if host_open != n_open:
        raise AssertionError(f"symbolic path: {n_open} open states, the "
                             f"host-only run {host_open}")
    log(f"symbolic path host-only: {host_open} open states (equal), "
        f"{host_wall:.3f} s")
    corpus_finish(corpus, card)
    resume_and_spill(card)
    k9_launches = merge_path(card)

    res, paths, wall, stats = explore(dev, MAIN_LANES, MAIN_K)
    if res["paths"] != paths or res["forks"] != paths - 1:
        raise AssertionError(f"device loop: {res['paths']} paths retired, "
                             f"{res['forks']} forks; want {paths}, "
                             f"{paths - 1}")
    log(f"device loop (kernels): {len(res['windows'])} windows, "
        f"{res['paths']} paths, {res['forks']} forks, {res['records']} "
        f"unique records, {wall:.3f} s, {res['paths'] / wall:.1f} paths/s "
        f"on {card}")
    res_p, _, wall_p, _ = explore(dev, MAIN_LANES, MAIN_K, plain=True)
    compare_runs(res, res_p)
    log(f"device loop (plain on the card): identical windows, "
        f"{wall_p:.3f} s")

    res_w, paths_w, wall_w, _ = explore(dev, WIDE_LANES, WIDE_K)
    if res_w["paths"] != paths_w or res_w["forks"] != paths_w - 1:
        raise AssertionError(f"wide run: {res_w['paths']} paths, "
                             f"{res_w['forks']} forks; want {paths_w}")
    log(f"wide run k={WIDE_K} at {WIDE_LANES} lanes: "
        f"{len(res_w['windows'])} windows, {res_w['paths']} paths, "
        f"{wall_w:.3f} s, {res_w['paths'] / wall_w:.1f} paths/s on {card}")

    concrete_launches = concrete_path(dev, card, report)

    wave = screen_wave(dev)
    check_screens(dev, report, wave)
    screen_launches = screen_path(dev, wave, card)
    screen_mix(dev)
    fused_launches = fused_screen(dev, wave, card, report)

    def entry(name, source, replaces, counts=None):
        r = report[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (counts or launches)[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "device_ms": r["device_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    # bv256 has no launch of its own on the main path: its word ops run
    # inside K1's launches, so it is listed apart with its test launch's
    # times and its own (zero) main-path count
    inlined = dict(entry("bv256", "mythril_tpu_torch/csrc/bv256.cuh",
                         "mythril_tpu/ops/bv256.py:93"),
                   inlined_in="sym_step, interval_level, prop_fwd_level, "
                   "prop_back_round, lane_run, prop_fixpoint")
    rows = [entry(*row) for row in ROWS] + [
        entry(name, src, rep, screen_launches[prop])
        for name, src, rep, prop in SCREEN_ROWS] + [
        entry("merge_fingerprint", "mythril_tpu_torch/csrc/merge.cu",
              "mythril_tpu/laser/lane_engine.py:906",
              {"merge_fingerprint": k9_launches}),
        entry("lane_run", "mythril_tpu_torch/csrc/stepper.cu",
              "mythril_tpu/ops/stepper.py:902", concrete_launches),
        entry("prop_fixpoint", "mythril_tpu_torch/csrc/screen.cu",
              "mythril_tpu/ops/propagate.py:798", fused_launches)]
    fast = [r["name"] for r in rows + [inlined]
            if r["device_ms"] is not None and r["device_ms"] < r["bound_ms"]]
    if fast:
        raise AssertionError(f"device time below the bound for {fast}: "
                             f"the byte or operation count is wrong")
    log(json.dumps({"kernels": rows, "inlined": [inlined]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
