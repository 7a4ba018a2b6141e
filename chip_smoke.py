#!/usr/bin/env python3
"""Build the port's CUDA kernels, hold each against its plain PyTorch
version on the card, and drive the port's paths: ``myth analyze`` end
to end, the resident daemon (``myth serve``) with cross-tenant wave
packing, the symbolic path at full width, the window merge, the device
loop alone, the concrete lane path and the solver's screens (with the
host-sequenced and the fused fixpoint).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --analyze FIXTURE STATS`` is the per-fixture
process the corpus phase starts, ``--analyze-held FIXTURE STATS`` the
same with K6 and K7 held against their plain versions, ``--serve DIR
STATS`` the daemon process of the daemon phase, ``--corpus-rank STATS
ARGS`` a rank of the corpus-mode phase. ``--cards``, on a machine with
two or more cards, is ``check_cards`` alone; ``--sigterm`` is
``check_sigterm`` alone: the daemon's SIGTERM drain and resume, mid-
request and mid-pack, with ``myth serve`` on the card.)

Phases (any failure exits non-zero and prints no result):

1. build every ``mythril_tpu_torch/csrc/*.cu`` (in parallel) and the
   native solver library (``make``), print the card's name and power
   limit and the compiler's register/spill lines;
2. kernel checks, bit for bit against the plain versions on the card:
   ``bv256_apply`` for every op on ``bv256.DIV_EDGES`` (every path of
   the division core) and on seeded random and edge words; K0 over
   a 4096-lane batch whose planes hold junk (and its library
   counterpart, a fill a plane); K1 over 64 steps of a seeded 4096-lane
   state with 1, 8 and 32 steps a read window, one launch a window, and
   over ``device_loop.k1_edge_cases`` (lanes no multiple of a block, fork
   requests past the step's budget over many blocks, the last lane
   stopping inside a window, 64 lanes, a packed arena), its times at
   4096 and 64 lanes, its device time by kernel and by phase, the cost
   of the host's running-count read and of a run with no lane running;
   K1's packed branch (row 2p) over 64 steps of a seeded 4096-lane state on a
   four-member arena (the k=12 contract, bench.py's diamond, calls.sol.o
   and kinds_of_calls.sol.o, each with ``contracts.with_probe``'s probe:
   in every member lanes fork, read PC and CODESIZE and jump inside and
   out of their member), with the unpacked K1 on the same state; K2-K4
   through one ``window_exec`` and its three escalations (row 9's call
   against ``torch.stack`` in turns); K3 (rows 5, 8) and K4's fork table
   (row 9) on ``device_loop.k3_edge_cases`` in each launch mode (one
   block, a cooperative grid), write_sids on and off, then K3 on real windows
   at 64, 4096 and 131072 lanes (``k3_input``): exact, at most two CUDA
   launches a call, its rounds and device time, and a call that returns
   while a spin kernel queued ahead of it still runs; K9 on the k=12
   main path's state after its first window with that window's
   resolution pairs at 4096 lanes and at the corpus's 64, on two seeded
   random 4096-lane states (past its shared hash) and on
   ``device_loop.k9_edge_cases``, each call with its plan's CUDA
   launches, its times at 4096 and 64 lanes;
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
   device, with no device failure; then, apart from the timed corpus,
   the fixture that launches K6 and K7 the most is analysed again with
   every K6 and K7 call held against its plain version on a copy of
   its input (``--analyze-held``, ``hold_screen_kernels``), and the
   calls are logged by shape;
   beside it, the daemon: ``myth
   serve`` in its own process (``--serve``, ``MTPU_PACK`` on) serves
   the 18 fixtures submitted at once with the corpus flags: every
   canonical issue list equal to the JAX package's one-shot lists, no
   row with an error, at least one packed wave (waves packed, pack
   members, dispatches saved, lane windows and the makespan printed
   beside the corpus' one-shot windows); then tests/test_wave_pack.py's
   four-code queue on it and on a daemon with ``MTPU_PACK=0``: equal
   issues, a packed wave, strictly fewer lane windows packed; the
   daemon's own launch counts (from its start to its stop) must show
   K1's packed branch; then the packed explore at full width: the four
   members (the k=11 contract: k=12 alone fills 4096 lanes) through
   ``LaneEngine.explore_packed`` at 4096 lanes, each tenant's parked
   states equal to its solo explore, K1's packed branch launched;
5. the SHA3 resume (a 33-byte hash resumed in place) and the spill
   regime (64 paths through 8 lanes), each equal to the host-only run;
   the merge path: ``bench.py``'s window-merge rig (the diamond
   contract, 64 lanes, 32-step windows) with the merge on and off:
   lanes merge and subsume, K9 launches (its main path), the issues
   are identical; the corpus mode: four ranks of ``python -m
   mythril_tpu_torch.parallel.corpus`` on this card (``--corpus-rank``,
   a TCPStore on localhost, ``--tpu-lanes 64``, stealing on) over the
   18 fixtures: no rank fails, every fixture is analysed by one rank,
   and the merged report has, fixture by fixture, the JAX package's
   corpus-mode issues (``tests/torch_data/corpus_issues.json``); the
   meshed lane engine (``check_mesh_engine``) on MESH_SHARDS shards of
   this card: every window and escalation retire of the k=12 sweeps at
   256 and 64 lanes bit for bit against the same exchange over CPU
   copies (every phase's plain version), K9 a shard against its plain
   version and K9 over the gathered batch, then every path of the k=12
   contract through SymExecWrapper at 4096 lanes with the engine
   meshed (its launches, counted from a reset, are the meshed main
   path's: K1's phases, one ``sym_decide`` and one ``sym_exec`` launch
   a K1 step on the card, its fork rows, K2-K4, K3's remap a window and
   K4's rows, each a launch a device), its open states equal to the unsharded engine's and
   the host-only run's, both explores timed, and the new kernels'
   times; the concolic command: ``python3 -m mythril_tpu_torch
   concolic`` flips the branch of tests/test_concolic.py's contract
   and the solved input, replayed concretely, takes it;
6. the device loop alone (``support/device_loop.DeviceLoop``, raw
   seeds): k=12 at 4096 lanes with the kernels and with the plain
   versions, every window's outputs equal; the wide run, k=17 at 131072
   lanes; then K1 on that loop's first window (two lanes a thread) from
   the step where the most lanes run, 32 steps against the plain
   version;
7. the screens' kernels K5-K8, bit for bit against the plain versions:
   on the all-opcode wave (``screen_waves.layered_sets`` replicated to
   8192 states: every opcode and backward rule, checked present) from
   its init tables and from two seeded random tables, with its whole
   screen; then at the shapes of the 8192-system wave of the JAX
   package's ``bench_prefilter`` with call, device and plain times and
   byte bounds; and one sweep's changed flag against the plain
   comparison on each; K6 and K7 run on the plan's kernel layout, their
   plain versions on the plan; then the edge inputs of K6 and K7
   (``screen_waves.edge_sets``: a round whose targets are each other's
   siblings, an ITE whose condition another entry refines, a round of
   one entry, a round whose staging outgrows a block's shared memory, a
   level of UDIV, UREM and MUL beside ULE nodes, bool and numeric
   targets in one round) at 1, 33 and 8192 states and past K7's grid,
   and a level and a round of pads only; K5 over every level of each of
   those waves in one call (``check_k5``: its layout, the seeds in the
   call, bit for bit against the plain driver, its CUDA launches as
   planned; timed on the 8192-system wave with its own byte bound and
   the per-level count beside it), and on ``screen_waves.k5_edge_cases``
   (negative operand rows and nodes, a level that reads a row it
   writes, a level past a block, 8192 states, one state; also level by
   level); then K6 level by level, the K6-K8 driver and K11 over the
   whole fixpoint on the propagation plan of each of those cases
   (``screen_waves.k5_edge_plans``), from the init, seeded random and
   once-swept tables, against their plain versions, the level that
   reads a row it writes staged by both (one K6 launch);
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
    through a whole run, over single steps at full width and on
    ``device_loop.k10_edge_cases(full=True)`` (every result class and
    status cause, 1-131072 lanes, default planes read in place, a shard
    view at an offset); its times on the batch and on a 4096-lane shard
    of it; paths/s,
    lane instructions/s, the busy share (where the profiler records no
    device event, the stream-interval share, an upper bound); K10's
    bound from a traced run of the timed inputs, whose single steps
    must end where one run does; then 131072 lanes at
    ``init_lanes``' default planes (~11.2 KB a lane) on
    ``__graft_entry__._build_fixture``'s loop contract and on the lane
    mix contract (loop, memory and storage arms), 512 sampled lanes of
    each equal to ``run_plain``, K10's times on the lane mix; then the mesh (``parallel/mesh.py``):
    that batch on 8 shards of this card, K12 ``lane_live``, K13
    ``lane_order`` and K14 ``lane_gather`` bit for bit against their
    plain versions (K12 also on ``device_loop.k12_edge_cases``, through
    ``lane_live`` and ``live_lane_counts`` over views and over copies,
    as launched and on a grid of at most 3 blocks, one launch a call;
    K13 also on ``device_loop.k13_edge_cases`` as
    launched and on a grid of at most 3 blocks, one launch a call; K14
    also on
    an empty order, negative and
    out-of-range indices and more rows than lanes, its output disjoint
    aligned views of one allocation), ``sharded_run`` equal to one K10
    run (and its device time), the live
    counts, ``compact_lanes`` and ``steal_balance`` equal to the plain
    versions after 400 steps (the main path of K12-K14: counts reset
    before it and read after; K12 one launch a live_lane_counts call),
    the balanced shards within one running
    lane of each other, ``make_mesh()`` equal to K10 alone, and one
    ``steal_balance`` of 131072 lanes at the default planes; K12-K14's
    call, device, plain and library times (the per-shard sum,
    ``torch.argsort(stable=True)``, ``index_select``; call and library
    in turns) at both sizes, beside K12 ``live_lane_counts``' call (the
    counts on the host) and the launch floor (an empty kernel), and
    beside K14 a contiguous copy of as many bytes;
11. the fused screen: K11 on the 8192-system wave, equal to
    ``_fixpoint_plain`` and to the host-sequenced K6-K8 driver (tables,
    ok, contra, keep, sweeps); the pruner's screen with
    ``MTPU_PROPAGATE_FUSE`` on (one K11 launch a wave) and off, in
    turns, systems/s and launches each way;
12. the report: a ``kernels`` JSON line (launches on each kernel's path,
    error, times, bounds, library times where one PyTorch call computes
    the same function), the card's name and power limit, and the
    result line.

``ms`` is a wrapper call on CUDA events, the host's argument packing
and launch gaps included; ``device_ms`` is the device time of the same
call: for K0-K2, K4 and bv256 its kernels and copies in
torch.profiler, for K3, K5-K11 and K12-K14 CUDA events around the
call queued behind a spin kernel after an L2 flush (``queued_ms``), on
the inputs its bound is counted from. The run fails where a device
time is below its bound (each timed shape's ``*_device_ms`` against its
own ``*_bound_ms`` where it has one).

It imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
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
    after one warm-up call where reps > 1 (a plain version timed once
    follows its check's own run, which warmed it). With setup, each call
    is fn(setup()), the setup untimed."""
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

    if reps > 1:
        once()
    return sum(once() for _ in range(reps)) / reps


def timed_once(fn, *args):
    """(fn(*args), its milliseconds on CUDA events): one call, the card
    idle before it."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn(*args)
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


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

#: the least 32-bit integer operations a word of each bv256 op needs,
#: whatever implements it (``bv_ops``): one a limb for the limb-wise
#: ops (add, sub, neg, the compares, the bitwise ops; a shift or
#: signextend one funnel shift or select a result limb), 1 for byte;
#: a 32x32->64 digit product counts 2 (its low and high halves), so the
#: low-half product is 36 of them, the low half of a square 20 (the 16
#: cross products below 2^256 once, the 4 squares) and the full product 64
_BV_LIMBWISE = 8
_BV_MUL, _BV_SQR, _BV_MUL_FULL = 2 * 36, 2 * 20, 2 * 64


def _digits32(x):
    return (x.bit_length() + 31) // 32


def _reduce_ops(num, d):
    """Least work of num // d and num % d (num up to 512 bits): a compare
    where d is 0 or above num, a shift and a mask where d is 2^k, else
    schoolbook division's digit products, one a quotient digit and
    divisor digit (a Knuth-D step's estimate and its multiply and
    subtract), 2 operations each."""
    if d == 0 or num < d:
        return _BV_LIMBWISE
    if d & (d - 1) == 0:
        return 2 * _BV_LIMBWISE
    n = _digits32(d)
    return 2 * n * (_digits32(num) - n + 1)


def bv_ops(op, a, b, c):
    """The least integer operations of ``op`` on the words a, b, c
    (Python ints), as the header's comment counts them."""
    m = (1 << 256) - 1
    if op == "mul":
        return _BV_MUL
    if op == "mul_hi":
        return _BV_MUL_FULL
    if op in ("div", "mod"):
        return _reduce_ops(a, b)
    if op in ("sdiv", "smod"):
        sa, sb = a >> 255, b >> 255
        negs = sa + sb + (sa != sb if op == "sdiv" else sa)
        return _reduce_ops(-a & m if sa else a, -b & m if sb else b) + \
            _BV_LIMBWISE * negs
    if op == "addmod":
        return _BV_LIMBWISE + _reduce_ops(a + b, c)
    if op == "mulmod":
        return _BV_MUL_FULL + _reduce_ops(a * b, c)
    if op == "exp":
        # 1 for e = 0, a shift for a base 0, 1 or 2^k; else square and
        # multiply: bitlen(e) - 1 squarings, popcount(e) - 1 products
        if b == 0:
            return 1
        if a & (a - 1) == 0:
            return _BV_LIMBWISE
        return _BV_SQR * (b.bit_length() - 1) + \
            _BV_MUL * (bin(b).count("1") - 1)
    return 1 if op == "byte" else _BV_LIMBWISE


def bv256_words(dev):
    """check_bv256's timed operands: three seeded (4096, 8) int32 limb
    planes of random words, 30% of them one limb wide, every 7th an
    edge value."""
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

    return words(), words(), words()


def check_bv256(dev, report):
    """Every bv256 op's test launch bit for bit against the plain
    version on ``bv256.DIV_EDGES`` (untimed) and on ``bv256_words``;
    each op's kernel, plain and device times there beside its bound
    (``bv_ops`` of each word, or 4 words of bytes a word)."""
    import torch

    from mythril_tpu_torch.ops import bv256

    edges = bv256.div_edge_planes(dev)
    for op, (arity, _) in bv256.OPS.items():
        args = edges[:arity]
        if max_err(bv256.bv256_apply(op, *args),
                   bv256.bv256_plain(op, *args)):
            raise AssertionError(f"bv256 {op}: kernel differs from plain "
                                 f"on DIV_EDGES")
    a, b, c = bv256_words(dev)
    ints = [[bv256.limbs_to_int(w) for w in x.cpu().numpy().view("uint32")]
            for x in (a, b, c)]
    total_k = total_p = total_d = total_b = 0.0
    err = 0
    per_op, by_ops = {}, 0.0
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
        nops = sum(bv_ops(op, *w) for w in zip(*ints))
        b_ms, by = bound_ms(a.shape[0] * 32 * (arity + 1), nops)
        per_op[op] = [round(k_ms, 4), round(p_ms, 3), d_ms, b_ms]
        total_d = None if d_ms is None or total_d is None else total_d + d_ms
        total_k += k_ms
        total_p += p_ms
        total_b += b_ms
        by_ops += b_ms if by == "operations" else 0.0
    by = "operations" if by_ops >= total_b / 2 else "bytes"
    log("bv256 per op [kernel ms, plain ms, device ms, bound ms] at "
        f"{a.shape[0]} words:", json.dumps(per_op))
    report["bv256"] = dict(max_abs_err=err, ms=total_k, plain_ms=total_p,
                           device_ms=total_d, bound_ms=total_b, bound_by=by)
    log(f"bv256: {len(per_op)} ops equal on {len(bv256.DIV_EDGES)} "
        f"division edges and {a.shape[0]} words; kernel {total_k:.3f} ms, "
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
    # the library's way: one fill a plane, the free-slot stack an arange
    values = symstep._init_values(n, 8_000_000)

    def library():
        for f in symstep.FIELDS:
            x = getattr(junk, f)
            if f == "free_slots":
                torch.arange(n - 1, -1, -1, out=x)
            else:
                x.fill_(values.get(f, 0))

    library()
    err = max(err, same_state(junk, want, "K0's library counterpart"))
    l_ms = cuda_ms(library, reps=5)
    torch.cuda.synchronize()
    bms, by = bound_ms(nbytes)
    report["sym_init"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              device_ms=d_ms, bound_ms=bms, bound_by=by,
                              library_ms=l_ms)
    log(f"K0 sym_init: {n} lanes ({nbytes} bytes) equal, also over junk; "
        f"{k_ms:.4f} ms kernel ({d_ms} ms on the device), {p_ms:.3f} ms "
        f"plain")


def seeded_state(dev, n_seeds, n=MAIN_LANES):
    """An n-lane state with n_seeds fresh entries of the coverage
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


def k1_state(dev, n=MAIN_LANES):
    """K1's input: ``seeded_state`` with n // 8 seeds after the window
    prologue. Returns (state, code)."""
    from mythril_tpu_torch.laser import lane_engine as le

    st, cc, (i32b, u8b, k, pv) = seeded_state(dev, n // 8, n)
    return le.prologue_plain(st, i32b, u8b, k, pv), cc


def packed_state(dev, n=MAIN_LANES):
    """Row 2p's input: n // 8 probe seeds of the four-member arena
    (``check_k1_packed``) after the window prologue. Returns (state,
    arena code, member codes, bases, probes)."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.ops.stepper import compile_packed_code
    from mythril_tpu_torch.support import contracts, device_loop, runs

    codes, probes = zip(*(contracts.with_probe(c)
                          for c in runs.pack_codes(MAIN_K)))
    cc, bases = compile_packed_code(
        [(c, (p["jumpi"],)) for c, p in zip(codes, probes)], device=dev)
    st = symstep.init_sym_lanes(n, device=dev)
    seeds = device_loop.packed_probe_seeds(
        le.ObjectTable(), codes, bases, probes, st.calldata.shape[1], n // 8)
    free = list(range(n - 1, -1, -1))
    entries = [(free.pop(), s) for s in seeds]
    i32b, u8b, k, pv = le.pack_window(n, symstep.N_ENV, {}, entries, free,
                                      [], {}, st.calldata.shape[1],
                                      big=True)
    st = le.prologue_plain(st, torch.from_numpy(i32b).to(dev),
                           torch.from_numpy(u8b).to(dev), k, pv)
    return st, cc, codes, bases, probes


#: the read windows K1 is held to its plain version with (steps a launch)
K1_SYNC = (1, 8, 32)


def k1_profile(fn, ran):
    """{kernel: [launches, device ms a step]} of one call of fn under
    torch.profiler, copies left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: [e.count, e.self_device_time_total / 1e3 / ran]
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Memcpy" not in e.key and "Memset" not in e.key
            and "elementwise" not in e.key}


def k1_phases(cc, st, steps, sync_every):
    """K1's phases over one run from ``st``: the share of block 0's SM
    cycles in decide, exec and forks (each to its barrier's exit), and
    the steps run."""
    import torch

    from mythril_tpu_torch.ops import symstep

    ph = torch.zeros(4, dtype=torch.int64, device=st.pc.device)
    symstep.sym_run_kernel(cc, clone_state(st), steps,
                           sync_every=sync_every, phases=ph)
    c = ph.tolist()
    total = sum(c[:3]) or 1
    return {"decide": c[0] / total, "exec": c[1] / total,
            "forks": c[2] / total, "steps": c[3]}


def hold_k1(cc, st, steps, what, syncs=None):
    """K1 against sym_run_plain from ``st`` (both on the card, on clones),
    with each of ``syncs`` steps a read window (SYNC_EVERY by default):
    every plane and the visited bitmap equal, and one launch a read window
    (``LAUNCHES["sym_run"]``). Returns (plain's state, steps run, the
    plain run's milliseconds)."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import symstep

    vis0 = torch.zeros(cc.packed.shape[0], dtype=torch.bool,
                       device=st.pc.device)
    (s_p, v_p), plain_ms = timed_once(
        symstep.sym_run_plain, cc, clone_state(st), steps, None, None,
        vis0.clone())
    ran = int(s_p.step_no) - int(st.step_no)
    for every in syncs or (symstep.SYNC_EVERY,):
        before = _build.LAUNCHES["sym_run"]
        s_k, v_k = symstep.sym_run_kernel(cc, clone_state(st), steps, None,
                                          None, vis0.clone(),
                                          sync_every=every)
        launched = _build.LAUNCHES["sym_run"] - before
        torch.cuda.synchronize()
        same_state(s_k, s_p, f"K1 {what}, sync_every {every}")
        if max_err(v_k, v_p):
            raise AssertionError(f"K1 {what}: visited differs")
        want = max(1, -(-ran // every))
        if launched != want:
            raise AssertionError(f"K1 {what}: {launched} launches for {ran} "
                                 f"steps at {every} a window, want {want}")
        del s_k, v_k
    return s_p, ran, plain_ms


def check_k1(dev, report):
    """K1 bit for bit against its plain version: 64 steps of the seeded
    4096-lane state with 1, 8 and 32 steps a read window, and each of
    ``device_loop.k1_edge_cases`` (at 64 times the CPU tests' lane
    counts); then its call, device and plain times a step at 4096 and
    64 lanes, its device time by kernel and its phases, the cost of the
    host's read between windows, and of a run in which no lane runs."""
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.support import device_loop

    st, cc = k1_state(dev)
    steps = 64
    s_p, ran, plain_ms = hold_k1(cc, st, steps, "4096 lanes", K1_SYNC)
    err = 0
    for case in device_loop.k1_edge_cases(st.calldata.shape[1], scale=64):
        cst, ccc = device_loop.k1_case_state(case, dev)
        out, cran, _ = hold_k1(ccc, cst, case.steps, case.name)
        note = ""
        if case.name == "mid_window_stop":
            if cran >= case.steps or cran % symstep.SYNC_EVERY == 0 \
                    or int((out.status == 0).sum()):
                raise AssertionError(f"K1 mid_window_stop: ran {cran} "
                                     f"steps, the last lane did not stop "
                                     f"inside a window")
            note = f", the last lane stops at step {cran}"
        if case.name == "fork_budget" and int(out.flog_count) != 2100:
            raise AssertionError(f"K1 fork_budget: {int(out.flog_count)} "
                                 f"forks, want 2048 + 52")
        log(f"K1 {case.name}: {case.lanes} lanes, {len(case.seeds)} seeds, "
            f"{cran} steps equal to the plain version ("
            f"{int(out.flog_count)} forks{note})")
    executed = int((s_p.steps.long() - st.steps.long()).sum())
    forks = int(s_p.flog_count)
    lane_bytes = symstep.lane_bytes()

    def per_step(timer, code, state, n_ran, reps=2, **kw):
        ms = timer(lambda c: symstep.sym_run_kernel(code, c, steps, **kw),
                   reps=reps, setup=lambda: clone_state(state))
        return None if ms is None else ms / n_ran

    narrow, ncc = k1_state(dev, 64)
    _, nran, _ = hold_k1(ncc, narrow, steps, "64 lanes")
    k_ms = per_step(cuda_ms, cc, st, ran)
    d_ms = per_step(device_ms, cc, st, ran)
    n_ms = per_step(cuda_ms, ncc, narrow, nran)
    n_dms = per_step(device_ms, ncc, narrow, nran)
    p_ms = plain_ms / ran  # the check's own plain run
    # the host's read of the running count between K1 launches
    sync = {e: per_step(cuda_ms, cc, st, ran, sync_every=e)
            for e in (1, 32)}
    sync[symstep.SYNC_EVERY] = k_ms
    split = k1_profile(lambda: symstep.sym_run_kernel(
        cc, clone_state(st), steps), ran)
    phases = {every: k1_phases(cc, st, steps, every) for every in K1_SYNC}
    idle = clone_state(st)
    idle.status.fill_(5)
    idle_ms = device_ms(lambda c: symstep.sym_run_kernel(cc, c, steps),
                        reps=5, setup=lambda: clone_state(idle))
    # per executed instruction ~320 bytes (lane scalars, the opcode row,
    # three stack words and sids, the written word); a fork reads and
    # writes a whole row
    bms, by = bound_ms((executed * 320 + forks * 2 * lane_bytes) / ran)
    shape = symstep.run_shape(st.pc.shape[0], dev)
    report["sym_step"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              device_ms=d_ms, bound_ms=bms, bound_by=by,
                              narrow_ms=n_ms, narrow_device_ms=n_dms)
    log(f"K1 sym_step: {ran} steps of 4096 lanes equal with "
        f"{', '.join(map(str, K1_SYNC))} steps a read window, one launch "
        f"a window ({executed} instructions, {forks} forks); launch "
        f"shape {shape[1]} blocks of {shape[0]} threads holding "
        f"{shape[4]} lanes each, {shape[2]} lane(s) a thread; {k_ms:.4f} "
        f"ms/step kernel ({d_ms} on the "
        f"device), {p_ms:.1f} ms/step plain; 64 lanes {n_ms:.4f} ms/step "
        f"({n_dms} on the device)")
    log("K1 ms/step by steps a read window: " + ", ".join(
        f"{e}: {ms:.4f}" for e, ms in sorted(sync.items())))
    log("K1 device split at 4096 lanes [launches, ms a step]: "
        + json.dumps({k[:40]: [v[0], round(v[1], 6)]
                      for k, v in split.items()}))
    log("K1 phases (share of block 0's cycles) by steps a window: "
        + json.dumps({e: {k: round(v, 4) for k, v in p.items()}
                      for e, p in phases.items()}))
    log(f"K1 with no lane running: {idle_ms} ms on the device a run "
        f"(one launch, ended at its first step)")
    if any("k_decide" in k or "k_exec" in k or "k_fork" in k
           or "k_scan" in k for k in split):
        raise AssertionError(f"K1: the four-launch step ran ({split})")


def k1_wide_state(dev, n_lanes=WIDE_LANES, k=WIDE_K):
    """A real K1 input at 131072 lanes, where a thread holds several
    lanes: the k=17 device loop's first window input, stepped by K1 (its
    forks fill the batch inside the window) to the step where the most
    lanes run. Returns (code, state, lanes running, steps taken)."""
    from mythril_tpu_torch.ops import symstep

    taken = {}
    real = symstep.sym_run_kernel

    def catch(cc, st, *a, **kw):
        if not taken:
            taken.update(cc=cc, st=clone_state(st))
        return real(cc, st, *a, **kw)

    symstep.sym_run_kernel = catch
    try:
        explore(dev, n_lanes, k)
    finally:
        symstep.sym_run_kernel = real
    cc, st = taken["cc"], taken["st"]
    peak, at, advanced = None, 0, 0
    running = int((st.status == 0).sum())
    while running and advanced < 1024:
        symstep.sym_run_kernel(cc, st, symstep.SYNC_EVERY)
        advanced += symstep.SYNC_EVERY
        running = int((st.status == 0).sum())
        if peak is None or running > at:
            peak, at = clone_state(st), running
    return cc, peak, at, advanced


def check_k1_wide(dev, n_lanes, k, steps=32):
    """K1 on ``k1_wide_state``, ``steps`` steps against the plain
    version."""
    from mythril_tpu_torch.ops import symstep

    cc, peak, at, advanced = k1_wide_state(dev, n_lanes, k)
    threads, blocks, per, _, lanes = symstep.run_shape(n_lanes, dev)
    later = int((peak.status[lanes * blocks:] == 0).sum())
    if per < 2 or not later:
        raise AssertionError(f"wide run: {per} lanes a thread, {later} "
                             f"lanes running past the first round")
    out, ran, _ = hold_k1(cc, peak, steps, f"{n_lanes} lanes")
    log(f"K1 at {n_lanes} lanes (the k={k} device loop's first window "
        f"after {advanced} steps, at its most lanes running: {at}, {later} "
        f"of them past the first {lanes * blocks}): {ran} steps equal to "
        f"the plain version, {int(out.flog_count)} forks in the log; "
        f"{blocks} blocks of {threads} threads, {per} lanes a thread")


def check_k1_packed(dev, report):
    """Row 2p: K1's packed branch against the plain version over 64
    steps of a seeded 4096-lane state on a four-member arena (each
    member with ``contracts.with_probe``'s probe): in every member lanes
    fork at symbolic JUMPIs, read PC and CODESIZE, and jump inside and
    out of their member (``device_loop.packed_probe_seeds``). Every
    plane and ``visited`` must agree bit for bit; the seeded cases must
    show (a fork and a park at the probe in every member). The unpacked
    K1 over the same arena and state is timed beside it."""
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.ops.stepper import CompiledCode

    n = MAIN_LANES
    st, cc, codes, bases, probes = packed_state(dev, n)
    steps = 64
    s_p, ran, plain_ms = hold_k1(cc, st, steps, "packed", K1_SYNC)
    err = 0
    forks = int(s_p.flog_count)
    fork_seg = cc.seg_of[s_p.flog_pc[:forks].long()].tolist()
    pc, status = s_p.pc.tolist(), s_p.status.tolist()
    for m, (base, probe) in enumerate(zip(bases, probes)):
        at_jump = sum(1 for p, s in zip(pc, status)
                      if s == 5 and p == base + probe["jump"] + 4)
        if m not in fork_seg or at_jump < 4:
            raise AssertionError(f"K1 packed: member {m} forked "
                                 f"{fork_seg.count(m)} times, {at_jump} "
                                 f"lanes parked at its probe's JUMP")
    executed = int((s_p.steps.long() - st.steps.long()).sum())
    lane_bytes = symstep.lane_bytes()
    flat = CompiledCode(packed=cc.packed, size=cc.size)

    def per_step(timer, code, reps=2):
        ms = timer(lambda c: symstep.sym_run_kernel(code, c, steps),
                   reps=reps, setup=lambda: clone_state(st))
        return None if ms is None else ms / ran

    # the unpacked K1 over the same arena and state, in turns with the
    # packed branch (unpacked, packed, packed, unpacked)
    timed = {}
    for name, code in (("u", flat), ("k", cc), ("k", cc), ("u", flat)):
        timed.setdefault(name, []).append(
            (per_step(cuda_ms, code), per_step(device_ms, code)))

    def mean(name, i):
        vals = [t[i] for t in timed[name]]
        return None if None in vals else sum(vals) / len(vals)

    k_ms, d_ms, u_ms, u_dms = mean("k", 0), mean("k", 1), mean("u", 0), \
        mean("u", 1)
    p_ms = plain_ms / ran  # the check's own plain run
    # as K1 (check_k1), with the two segment-table reads (4 + 8 bytes)
    # of each executed instruction
    bms, by = bound_ms((executed * (320 + 12) + forks * 2 * lane_bytes)
                       / ran)
    report["sym_step_packed"] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, device_ms=d_ms,
        bound_ms=bms, bound_by=by, unpacked_ms=u_ms,
        unpacked_device_ms=u_dms)
    log(f"K1 packed (row 2p): {ran} steps of {n} lanes over "
        f"{len(codes)} members ({cc.size} arena bytes) equal ({executed} "
        f"instructions, {forks} forks, some in every member; PC, CODESIZE "
        f"and out-of-member jumps at every probe); {k_ms:.4f} ms/step "
        f"kernel ({d_ms} on the device), unpacked K1 on the same arena "
        f"and state {u_ms:.4f} ms/step ({u_dms} on the device), in turns; "
        f"{p_ms:.1f} ms/step plain; equal with "
        f"{', '.join(map(str, K1_SYNC))} steps a read window")
    split = k1_profile(lambda: symstep.sym_run_kernel(
        cc, clone_state(st), steps), ran)
    log("K1 packed device split [launches, ms a step]: "
        + json.dumps({k[:40]: [v[0], round(v[1], 6)]
                      for k, v in split.items()}))


#: the symbolic member of the packed explore: k=12 fills 4096 lanes by
#: itself, so beside three more members its last forks would find no
#: free lane and park early (right, but not the solo result)
PACK_EXPLORE_K = 11


def packed_explore(dev, card):
    """The packed explore at full width: the four members' entry states
    (``runs.entry_states``) through ``LaneEngine.explore_packed`` at
    4096 lanes; each tenant's parked states must equal that member's
    solo ``explore`` at 4096 lanes, and K1's packed branch must have
    launched. Returns its ``sym_step_packed`` launches."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import runs

    def sig(gs):
        return (gs.mstate.pc, len(gs.mstate.stack),
                len(gs.world_state.constraints),
                int(gs.mstate.memory._msize))

    codes = runs.pack_codes(PACK_EXPLORE_K)
    entries = []
    for code in codes:
        le.PATH_HISTORY[code] = MAIN_LANES
        entries.append(runs.entry_states(code.hex(), tpu_lanes=MAIN_LANES))
    t0 = time.perf_counter()
    solo = [sorted(sig(g) for g in le.LaneEngine(n_lanes=MAIN_LANES).explore(
        code, list(states))) for code, states in zip(codes, entries)]
    solo_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng = le.LaneEngine(n_lanes=MAIN_LANES)
    out = eng.explore_packed([(code, list(states), i) for i, (code, states)
                              in enumerate(zip(codes, entries))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    stats = eng.last_run_stats
    differ = [i for i in range(len(codes))
              if sorted(sig(g) for g in out[i]) != solo[i]]
    if differ or launches["sym_step_packed"] <= 0 or launches["sym_step"]:
        raise AssertionError(f"packed explore: members {differ} differ "
                             f"from their solo explores; launches "
                             f"{launches}")
    log(f"packed explore at {MAIN_LANES} lanes: {[len(x) for x in solo]} "
        f"parked states per member, equal to the solo explores; "
        f"{stats['windows']} windows, {stats['forks']} forks, "
        f"{launches['sym_step_packed']} packed K1 steps, {wall:.3f} s "
        f"(four solo explores {solo_wall:.3f} s) on {card}")
    return launches["sym_step_packed"]


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
        "window_epilogue": epilogue_bytes(ran),
    }
    for name, (kern, plain, src) in stages.items():
        k_ms = cuda_ms(kern, reps=3, setup=lambda s=src: clone_state(s))
        p_ms = cuda_ms(plain, reps=1, setup=lambda s=src: clone_state(s))
        # one launch each, cooperative past one block, which a profiler
        # session can miss: timed on CUDA events behind a spin kernel
        # after an L2 flush, which see every launch
        d_ms = queued_ms(kern, lambda s=src: clone_state(s))
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
    # one PyTorch call a plane for the retire (index_select of each
    # gathered plane's clipped columns, index_fill_ of the status), one
    # torch.stack for the fork table
    rc = ridx.clamp(0, n - 1).long()
    real = ridx[ridx < n].long()
    clipped = [(x.narrow(1, 0, w) if w is not None else x) for x, w in (
        (s_k.pc, None), (s_k.sp, None), (s_k.depth, None),
        (s_k.fentry, None), (s_k.last_jump, None), (s_k.msize, None),
        (s_k.mlog_count, None), (s_k.scount, None), (s_k.min_gas, None),
        (s_k.max_gas, None), (s_k.mlog_off, wl), (s_k.mlog_len, wl),
        (s_k.mlog_sid, wl), (s_k.ssid, ws), (s_k.sval_sid, wk),
        (s_k.s_written, wk), (s_k.s_read, wk), (s_k.skey_sid, wk),
        (s_k.s_wstep, wk), (s_k.stack, ws), (s_k.skeys, wk),
        (s_k.svals, wk), (s_k.memory, wm), (s_k.mkind, wm))]
    fb = s_k.flog_parent.shape[0]
    flog = [getattr(s_k, f"flog_{c}")[:fb] for c in (
        "parent", "child", "step", "pc", "sid", "gmin", "gmax", "fentry",
        "dest")]
    library = {
        "retire_rows": lambda c: [x.index_select(0, rc) for x in clipped]
        + [c.status.index_fill_(0, real, 5)],
        "gather_full_flog": lambda c: torch.stack(flog, 1).view(
            torch.int32),
    }
    for name, (kern, plain, nb) in escalations.items():
        k_ms = cuda_ms(kern, reps=3, setup=lambda: clone_state(s_k))
        p_ms = cuda_ms(plain, reps=1, setup=lambda: clone_state(s_k))
        l_ms = cuda_ms(library[name], reps=3,
                       setup=lambda: clone_state(s_k)) \
            if name in library else None
        if name == "gather_full_flog":
            # the call against torch.stack in turns (stack, call, call,
            # stack), 50 calls each
            turns = {}
            for what, fn in (("torch.stack", library[name]),
                             ("fork_table", kern), ("fork_table", kern),
                             ("torch.stack", library[name])):
                turns.setdefault(what, []).append(
                    cuda_ms(lambda f=fn: f(s_k), reps=50))
            k_ms = sum(turns["fork_table"]) / 2
            l_ms = sum(turns["torch.stack"]) / 2
            log(f"gather_full_flog in turns: call {turns['fork_table']} "
                f"ms, torch.stack {turns['torch.stack']} ms")
            # a few microseconds a launch: three profiled calls record no
            # device event, so profile 50 calls of it (it reads the state
            # and writes a table of its own, so no copy is needed)
            d_ms = device_ms(lambda: kern(s_k), reps=50)
        else:  # one launch (retire_rows), or K3's inside: queued
            d_ms = queued_ms(kern, lambda: clone_state(s_k))
        bms, by = bound_ms(nb)
        log(f"{name}: {k_ms:.4f} ms kernel ({d_ms} ms on the device), "
            f"{p_ms:.2f} ms plain, library {l_ms} ms, bound {bms} ms "
            f"({by})")
    check_k3(dev, report, ran)
    check_k2_k4(dev, report, (st0, i32b, u8b, k, pv),
                (deduped, cc, canon, le.DEFAULT_STEP_BUDGET, 1))


def epilogue_bytes(st):
    """Bytes K4 must move (``check_window``'s count, unchanged): the
    lanes' planes it reads and its counts written, the canon read whole,
    the retire and the unique and fork tables' rows written."""
    from mythril_tpu_torch.laser import lane_engine as le

    n, r = st.pc.shape[0], st.dlog_op.shape[1]
    return n * 32 + n * 28 + 4 * n * r + n * 4 + le.RCAP * 4 * 2000 \
        + le.URB * 132 + le.FB * 36


def to_cpu(st):
    from mythril_tpu_torch.ops.symstep import FIELDS

    return st.replace(**{f: getattr(st, f).cpu() for f in FIELDS})


def window_shapes(kernel, n, dev):
    """K2's (kernel "prologue") or K4's ("epilogue") launch shapes over n
    lanes in each mode that holds them: one block up to 2048 lanes (the
    shape the card gives such a batch), and a cooperative grid (the
    shape it gives a batch past one block)."""
    from mythril_tpu_torch.laser import lane_engine as le

    return ((le.window_shape(kernel, n, dev),) if n <= 2048 else ()) + (
        le.window_shape(kernel, max(n, 2049), dev),)


def restore(dst, src):
    """dst's planes (the same tensors) set to src's: a timed call then
    finds its state's argument block built, as the engine's calls do."""
    from mythril_tpu_torch.ops.symstep import FIELDS

    for f in FIELDS:
        getattr(dst, f).copy_(getattr(src, f))
    return dst


def hold_window(kernel, args, what, shapes=(None,), want=None):
    """K2 (kernel "prologue": args (state, i32buf, u8buf, k, pv)) or K4
    ("epilogue": (state, code, canon, budget, resume_on)) on copies of
    the state against its plain version, in each launch shape (None:
    ``window_shape``'s): the state and K4's 12 outputs equal, bit for
    bit, and one CUDA launch a call. ``want``: the plain version's
    (state, outputs), on the CPU for the edge cases (whose duplicate
    entries a CUDA scatter would write in any order); else the plain
    version runs on the card."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le

    st, rest = args[0], args[1:]
    kern = le.prologue_kernel if kernel == "prologue" else le.epilogue_kernel
    plain = le.prologue_plain if kernel == "prologue" else le.epilogue_plain
    if want is None:
        out = plain(clone_state(st), *rest)
        want = (out, ()) if kernel == "prologue" else out
    key = f"window_{kernel}"
    for shape in shapes:
        x = clone_state(st)
        before = _build.LAUNCHES[key]
        got = kern(x, *rest, shape=shape)
        launches = _build.LAUNCHES[key] - before
        torch.cuda.synchronize()
        tag = f"{key} {what}, shape {shape or 'default'}"
        if launches != 1:
            raise AssertionError(f"{tag}: {launches} CUDA launches a call")
        cpu = want[0].pc.device.type == "cpu"
        same_state(to_cpu(x) if cpu else x, want[0], tag)
        if kernel == "epilogue":
            same_outputs([o.cpu() for o in got] if cpu else got, want[1],
                         tag)


def returns_early(fn, setup, what):
    """fn(setup()) queued behind a spin kernel returns while the spin
    still runs (the call never waits on the card). Returns the call's
    host milliseconds."""
    import torch

    fn(setup())
    x = setup()
    torch.cuda.synchronize()
    mark = torch.cuda.Event()
    torch.cuda._sleep(SPIN_CYCLES)
    mark.record()
    t0 = time.perf_counter()
    fn(x)
    host_ms = (time.perf_counter() - t0) * 1e3
    spinning = not mark.query()
    torch.cuda.synchronize()
    if not spinning:
        raise AssertionError(f"{what} returned only after the spin kernel "
                             f"ended: the call waits on the card")
    return host_ms


def window_inputs(dev, n_lanes, k):
    """K2's and K4's inputs in the k-contract's device loop at n_lanes:
    K2's call with the most seed and pair entries (its state, buffers, k,
    pv) and K4's call on the batch with the most live records and parked
    lanes (its state, code, canon, budget, resume flag), each copied
    before the call."""
    import torch

    from mythril_tpu_torch.laser import lane_engine as le

    best = {}
    pro, epi = le.prologue_kernel, le.epilogue_kernel

    def keep(key, score, args):
        if score > best.get(key, (-1,))[0]:
            best[key] = (score, (clone_state(args[0]),) + tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args[1:]))

    def catch_pro(st, i32b, u8b, k, pv, **kw):
        keep("prologue", k * 1_000_000 + pv, (st, i32b, u8b, k, pv))
        return pro(st, i32b, u8b, k, pv, **kw)

    def catch_epi(st, cc, canon, budget, resume_on, **kw):
        live = int(st.dlog_count.clamp(0, st.dlog_op.shape[1]).sum()) \
            + int((st.status == 5).sum())
        keep("epilogue", live, (st, cc, canon, budget, resume_on))
        return epi(st, cc, canon, budget, resume_on, **kw)

    le.prologue_kernel, le.epilogue_kernel = catch_pro, catch_epi
    try:
        explore(dev, n_lanes, k)
    finally:
        le.prologue_kernel, le.epilogue_kernel = pro, epi
    return best["prologue"][1], best["epilogue"][1]


def check_k2_k4(dev, report, pro512, epi512):
    """K2 and K4 (rows 4, 6) on ``device_loop.k2_edge_cases`` and
    ``k4_edge_cases`` in one block and on a cooperative grid (the plain
    versions on the CPU), then on real windows at 64, 512, 4096 and
    131072 lanes and on ``check_window``'s (4096 lanes, 512 seeds:
    ``pro512``, ``epi512``; the plain versions on the card), exact, one
    CUDA launch a call, a call that returns behind a running spin
    kernel, and their call and device times at 64, 512 and 4096
    lanes."""
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import device_loop as dl

    for case in dl.k2_edge_cases():
        want = le.prologue_plain(*dl.k2_case_state(case, "cpu"))
        hold_window("prologue", dl.k2_case_state(case, dev), case.name,
                    (None,) + window_shapes("prologue", case.lanes, dev),
                    (want, ()))
    for case in dl.k4_edge_cases():
        want = le.epilogue_plain(*dl.k4_case_inputs(case, "cpu"))
        hold_window("epilogue", dl.k4_case_inputs(case, dev), case.name,
                    (None,) + window_shapes("epilogue", case.lanes, dev),
                    want)
    log("K2 and K4 on k2_edge_cases and k4_edge_cases (one block and a "
        "cooperative grid): equal to the plain versions, one CUDA launch "
        "a call")
    sizes = [("narrow", "64 lanes, k=6 loop") + window_inputs(dev, 64, 6),
             ("mid", "512 lanes, k=9 loop") + window_inputs(dev, 512, 9),
             ("main", "4096 lanes, 512 seeds (check_window)", pro512,
              epi512),
             ("loop", "4096 lanes, k=12 loop")
             + window_inputs(dev, MAIN_LANES, MAIN_K),
             ("wide", f"{WIDE_LANES} lanes, k={WIDE_K} loop")
             + window_inputs(dev, WIDE_LANES, WIDE_K)]
    for key, what, pro, epi in sizes:
        n = pro[0].pc.shape[0]
        hold_window("prologue", pro, what,
                    (None,) + window_shapes("prologue", n, dev))
        hold_window("epilogue", epi, what,
                    (None,) + window_shapes("epilogue", n, dev))
        if key == "wide":
            log(f"K2 and K4 at {what}: exact in "
                f"{window_shapes('prologue', n, dev)} and "
                f"{window_shapes('epilogue', n, dev)}")
            continue
        for name, args, kern, plain, nbytes in (
                ("window_prologue", pro, le.prologue_kernel,
                 le.prologue_plain, prologue_bytes(*pro[:2], *pro[3:])),
                ("window_epilogue", epi, le.epilogue_kernel,
                 le.epilogue_plain, epilogue_bytes(epi[0]))):
            st, rest = args[0], args[1:]
            work = clone_state(st)

            def setup(s=st, w=work):
                return restore(w, s)

            def fresh(s=st):
                return clone_state(s)

            host_ms = returns_early(lambda x, f=kern: f(x, *rest), setup,
                                    f"{name} at {what}")
            k_ms = cuda_ms(lambda x, f=kern: f(x, *rest), reps=5,
                           setup=setup)
            cold_ms = cuda_ms(lambda x, f=kern: f(x, *rest), reps=3,
                              setup=fresh)
            d_ms = queued_ms(lambda x, f=kern: f(x, *rest), setup, reps=5)
            p_ms = cuda_ms(lambda x, f=plain: f(x, *rest), reps=1,
                           setup=fresh)
            bms, by = bound_ms(nbytes)
            r = report[name]
            if key == "main":
                r.update(ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         bound_ms=bms, bound_by=by, cold_ms=cold_ms)
            else:
                r.update({f"{key}_ms": k_ms, f"{key}_device_ms": d_ms,
                          f"{key}_plain_ms": p_ms, f"{key}_bound_ms": bms,
                          f"{key}_cold_ms": cold_ms})
            log(f"{name} at {what}: call {k_ms:.4f} ms (on a new state, "
                f"its argument block built: {cold_ms:.4f} ms), device "
                f"{d_ms:.4f} ms (queued behind a spin after an L2 flush), "
                f"plain {p_ms:.3f} ms, bound {bms:.6f} ms ({by}); one CUDA "
                f"launch a call, exact in {window_shapes(name[7:], n, dev)}; "
                f"the call returned in {host_ms:.4f} ms behind a running "
                f"spin")


def k3_input(dev, n_lanes, k):
    """K3's input with the most live records of the k-contract's device
    loop at n_lanes: the state after K1 of that window (or of its
    escalation)."""
    from mythril_tpu_torch.laser import lane_engine as le

    best = {}
    real = le.dedup_kernel

    def catch(st, *a, **kw):
        live = int(st.dlog_count.clamp(max=st.dlog_op.shape[1]).sum())
        if live > best.get("live", -1):
            best.update(live=live, st=clone_state(st))
        return real(st, *a, **kw)

    le.dedup_kernel = catch
    try:
        explore(dev, n_lanes, k)
    finally:
        le.dedup_kernel = real
    return best["st"]


def k3_rounds(st):
    """(rounds, live records) of K3 on st: the distinct steps of the
    live records, and their count."""
    import torch

    r = st.dlog_op.shape[1]
    live = torch.arange(r, device=st.device)[None, :] \
        < st.dlog_count[:, None]
    return int(torch.unique(st.dlog_step[live]).numel()), int(live.sum())


def k3_shapes(n):
    """K3's launch shapes over n lanes in each mode that holds them (at
    most 8 lanes a thread): (blocks, threads, mode) for one block and for
    a cooperative grid."""
    t = min(1024, -(-n // 32) * 32)
    out = [(1, t, 0)] if n <= 8 * 1024 else []
    out.append((min(132, max(2, -(-n // 1024))), min(1024, max(32, t)), 1))
    return tuple(out)


def hold_k3(st, what, shapes=(None,)):
    """K3 on st against ``dedup_plain`` with write_sids on and off, in
    each launch shape (None: ``dedup_shape``'s): the canon and every
    plane equal, bit for bit. Returns K3's CUDA launches a call
    ({write_sids: launches})."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le

    want_st, want = le.dedup_plain(clone_state(st))
    per_call = {}
    for shape in shapes:
        for write in (True, False):
            x = clone_state(st)
            before = _build.LAUNCHES["window_dedup"]
            got = le.dedup_kernel(x, write_sids=write, shape=shape)
            per_call[write] = _build.LAUNCHES["window_dedup"] - before
            torch.cuda.synchronize()
            tag = f"K3 {what}, shape {shape or 'default'}, write {write}"
            if max_err(got, want):
                raise AssertionError(f"{tag}: canon differs")
            same_state(x, want_st if write else st, tag)
    if per_call[True] > 2 or per_call[False] > 1:
        raise AssertionError(f"K3 {what}: {per_call} launches a call")
    return per_call


def k3_returns_early(st):
    """A K3 call queued behind a spin kernel returns while the spin
    still runs (the call never waits on the card). Returns the call's
    host milliseconds."""
    from mythril_tpu_torch.laser import lane_engine as le

    return returns_early(le.dedup_kernel, lambda: clone_state(st), "K3")


def check_k3(dev, report, ran):
    """K3 (rows 5, 8) and K4's fork table (row 9) on
    ``device_loop.k3_edge_cases`` in one block and on a cooperative
    grid, then on real windows at 64, 4096 and 131072 lanes: exact
    against the plain versions, its CUDA launches a call, its device
    time, and a call that returns behind a running spin kernel."""
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import device_loop

    for case in device_loop.k3_edge_cases():
        st = device_loop.k3_case_state(case, dev)
        hold_k3(st, case.name, (None,) + k3_shapes(case.lanes))
        same_outputs(le._unique_table_big(clone_state(st), case.urb),
                     le.unique_table_big_plain(clone_state(st), case.urb),
                     f"_unique_table_big on {case.name}")
        same_outputs([le._gather_full_flog(st)],
                     [le.gather_full_flog_plain(st)],
                     f"_gather_full_flog on {case.name}")
    log("K3 on k3_edge_cases (one block and a cooperative grid, write_sids "
        "on and off), _unique_table_big and _gather_full_flog: equal to the "
        "plain versions")
    host_ms = k3_returns_early(ran)
    log(f"K3 call queued behind a spin kernel returned after {host_ms:.4f} "
        f"ms on the host, the spin still running: no host wait")
    sizes = (("narrow", "64 lanes, k=6 loop", k3_input(dev, 64, 6)),
             ("main", "4096 lanes, check_window", ran),
             ("loop", "4096 lanes, k=12 loop", k3_input(dev, MAIN_LANES,
                                                        MAIN_K)),
             ("wide", f"{WIDE_LANES} lanes, k={WIDE_K} loop",
              k3_input(dev, WIDE_LANES, WIDE_K)))
    for key, what, st in sizes:
        n = st.pc.shape[0]
        per_call = hold_k3(st, what, (None,) + k3_shapes(n))
        rounds, records = k3_rounds(st)
        shape = le.dedup_shape(n, dev)
        d_ms = queued_ms(lambda x: le.dedup_kernel(x),
                         lambda s=st: clone_state(s))
        d_nw = queued_ms(lambda x: le.dedup_kernel(x, write_sids=False),
                         lambda s=st: clone_state(s))
        report["window_dedup"][f"{key}_device_ms"] = d_ms
        report["window_dedup"][f"{key}_rounds"] = rounds
        log(f"K3 at {what}: {records} live records in {rounds} rounds, "
            f"{shape[0]} block(s) of {shape[1]} threads in mode {shape[2]} "
            f"(0 one block, 1 a grid), {per_call} CUDA "
            f"launches a call (write_sids: launches); device {d_ms:.4f} ms "
            f"(without the remap {d_nw:.4f} ms; queued behind a spin after "
            f"an L2 flush), exact in that shape and in {k3_shapes(n)}")
        del st


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


#: the parts of a row a rule reads: lo, hi, k0, k1 (32 B each of a
#: numeric row; of a bool row 4 B of lo and hi, nothing of k0 and k1)
#: and limb 0 of lo or hi (4 B, where the whole is not read)
LO, HI, K0, K1, LO0, HI0 = range(6)


def parts_bytes(reads, n_s, n_t, isbool):
    """Bytes of the (rows, part, mask) reads over n_s states: each part
    of a row that some read's mask (a bool of len(rows) columns and
    n_s rows or one, or None for every state) needs, once a state."""
    import torch

    dev = isbool.device
    need = torch.zeros((6, n_s, n_t), dtype=torch.int32, device=dev)
    for rows, part, mask in reads:
        if rows.numel() == 0:
            continue
        m = torch.ones((n_s, rows.numel()), dtype=torch.int32, device=dev) \
            if mask is None else mask.expand(n_s, -1).int()
        need[part].index_add_(1, rows.long(), m)
    need = need > 0
    need[LO0] &= ~need[LO]
    need[HI0] &= ~need[HI]
    whole = torch.where(isbool, 4, 32).long()
    knum = torch.where(isbool, 0, 32).long()
    cost = torch.stack([whole, whole, knum, knum,
                        torch.full_like(whole, 4), torch.full_like(whole, 4)])
    return int((need.sum(1) * cost).sum())


def level_parts(level, n_t):
    """The (rows, part, None) reads of a forward level's real nodes, by
    op, as K6 loads them (``fwd_op``): its arguments' lo and hi (limb 0
    of a bool argument of a bool op or an ITE condition), the known
    bits its known-bits transfer reads, and its own row's lo and hi
    (limb 0 of a bool node) and, where it has a known-bits transfer,
    k0 and k1."""
    import torch

    from mythril_tpu_torch.ops import intervals as I

    op, node = level["op"].long(), level["node"].long()
    real = (op != I.NOP) & (node >= 0) & (node < n_t)
    op, node = op[real], node[real]
    args = level["args"][real].long().clamp(0, n_t - 1)
    nb, nn = level["lvl_bool"][real] != 0, level["lvl_num"][real] != 0
    dev = op.device

    def isin(*ops):
        return torch.isin(op, torch.tensor(ops, device=dev))

    unary = isin(I.BNOT, I.NEG, I.COPY, I.SEXT, I.EXTRACT, I.BNOT1)
    a0 = isin(I.BAND2, I.BOR2, I.BNOT1, I.BXOR2, I.BITE, I.ITE)
    b0 = isin(I.BAND2, I.BOR2, I.BXOR2, I.BITE)
    kb = isin(I.BAND, I.BOR, I.BXOR, I.BNOT, I.COPY, I.SHL, I.LSHR,
              I.EXTRACT, I.CONCAT2, I.ADD, I.SUB, I.ITE)
    ka = (kb & (op != I.ITE)) | (op == I.EQ)
    kbb = isin(I.BAND, I.BOR, I.BXOR, I.CONCAT2, I.ADD, I.SUB, I.EQ, I.ITE)
    a, b, c = args[:, 0], args[:, 1], args[:, 2]
    sel = [(a, ~a0, (LO, HI)), (a, a0, (LO0, HI0)),
           (b, ~unary & ~b0, (LO, HI)), (b, ~unary & b0, (LO0, HI0)),
           (c, op == I.ITE, (LO, HI, K0, K1)), (c, op == I.BITE, (LO0, HI0)),
           (a, ka, (K0, K1)), (b, kbb, (K0, K1)),
           (node, nb, (LO0, HI0)), (node, nn & ~nb, (LO, HI)),
           (node, nn & ~nb & kb, (K0, K1))]
    return [(rows[m], part, None) for rows, m, parts in sel
            for part in parts]


def round_parts(rnd, x, n_t):
    """The (rows, part, mask) reads of a backward round's real entries on
    the pre-round tables x, as K7 loads them (``back_rule``): the
    parent's bool gate, then under it what the rule reads (the rows of
    a gate that does not pass are not read; ADD's overflow, SUB's order
    and the known-bits rules' zero tests are not applied: their reads
    are counted whole)."""
    import torch

    from mythril_tpu_torch.ops import intervals as I

    tgt = rnd["tgt"].long()
    real = (tgt >= 0) & (tgt < n_t)
    op, role = rnd["op"][real].long(), rnd["role"][real].long()
    p, a, b = (rnd[k][real].long().clamp(0, n_t - 1)
               for k in ("parent", "a", "b"))
    t = tgt[real]
    tb = rnd["tbool"][real] != 0
    tn = (rnd["tnum"][real] != 0) & ~tb
    r0, r1, r2 = role == 0, role == 1, role == 2
    sib = torch.where(r0, b, a)
    lo, hi = x[0], x[1]
    lo0z, hi0z = lo[..., 0] == 0, hi[..., 0] == 0
    mt, mf = lo0z[:, p], hi0z[:, p]
    out = []

    def add(rows, part, mask):
        out.append((rows, part, mask))

    def rows4(rows, m):
        """all four parts of rows where m (limb 0 of lo and hi where
        the target is bool)"""
        for part in (LO, HI, K0, K1):
            add(rows, part, m & tn[None, :])
        add(rows, LO0, m & tb[None, :])
        add(rows, HI0, m & tb[None, :])

    def is_(o):
        return (op == o)[None, :]

    live = (tb | tn)[None, :]
    # EQ: the parent's lo; under mtrue the target's and the sibling's rows
    m = is_(I.EQ) & live
    add(p, LO0, m)
    rows4(t, m & mt)
    rows4(sib, m & mt)
    # ULT, ULE: the parent's gate, the bound it refines from, the
    # target's side that moves
    m = (is_(I.ULT) | is_(I.ULE)) & live
    add(p, LO0, m)
    add(p, HI0, m)
    nz = (hi != 0).any(-1)
    top = (lo == -1).all(-1)
    ult, ule = is_(I.ULT) & live, is_(I.ULE) & live
    r0_, r1_ = r0[None, :], r1[None, :]
    g_bhi = (ult | ule) & r0_ & mt
    g_blo = (ult | ule) & r0_ & mf
    g_alo = (ult | ule) & r1_ & mt
    g_ahi = (ult | ule) & r1_ & mf
    add(b, HI, g_bhi)
    add(b, LO, g_blo)
    add(a, LO, g_alo)
    add(a, HI, g_ahi)
    setlo = (ult & g_blo) | (ule & g_blo & ~top[:, b]) \
        | (ult & g_alo & ~top[:, a]) | (ule & g_alo)
    sethi = (ult & g_bhi & nz[:, b]) | (ule & g_bhi) | (ult & g_ahi) \
        | (ule & g_ahi & nz[:, a])
    add(t, LO, setlo & tn[None, :])
    add(t, HI, sethi & tn[None, :])
    add(t, LO0, setlo & tb[None, :])
    add(t, HI0, sethi & tb[None, :])
    # ADD, SUB: their arguments' bounds, the parent's, the target's lo
    # and hi
    m = is_(I.ADD) & live
    for rows, part in ((a, HI), (b, HI), (p, LO), (p, HI), (sib, LO)):
        add(rows, part, m)
    msub = is_(I.SUB) & live
    for rows, part in ((a, LO), (b, HI), (p, LO), (p, HI)):
        add(rows, part, msub)
    add(b, LO, msub & r0_)
    add(a, HI, msub & r1_)
    m = m | (msub & (r0_ | r1_))
    for part, kind in ((LO, tn), (HI, tn), (LO0, tb), (HI0, tb)):
        add(t, part, m & kind[None, :])
    # COPY: the parent's and the target's rows
    m = is_(I.COPY) & live
    rows4(t, m)
    rows4(p, m)
    # ITE: the condition's limb 0; where it selects the entry's branch,
    # the parent's and the target's rows
    m = is_(I.ITE) & live
    add(a, LO0, m)
    add(a, HI0, m)
    sel = m & ((lo0z[:, a] & r1_) | (hi0z[:, a] & r2[None, :]))
    rows4(t, sel)
    rows4(p, sel)
    # the bool rules: limb 0 of the parent, the sibling's under the
    # gate, the target's under its rule
    band, bor, bnot = (is_(o) & live for o in (I.BAND2, I.BOR2, I.BNOT1))
    m = band | bor | bnot
    add(p, LO0, m)
    add(p, HI0, m)
    add(sib, LO0, band & mf)
    add(sib, HI0, bor & mt)
    clo = (band & mt) | (bor & mt & hi0z[:, sib]) | (bnot & mf)
    chi = (band & mf & lo0z[:, sib]) | (bor & mf) | (bnot & mt)
    add(t, LO0, clo & tb[None, :])
    add(t, HI0, chi)
    # the known-bits rules (a numeric target): the parent's known bits,
    # the sibling's a rule reads, a shift's amount, the target's known
    # bits (a shift's only where its amount is one value)
    kn = tn[None, :]
    kbr = [is_(o) & kn for o in (I.BAND, I.BOR, I.BXOR, I.BNOT, I.SHL,
                                  I.LSHR, I.EXTRACT, I.CONCAT2)]
    m = kbr[0] | kbr[1] | kbr[2] | kbr[3] | kbr[4] | kbr[5] | kbr[6] \
        | kbr[7]
    add(p, K0, m)
    add(p, K1, m)
    add(sib, K1, kbr[0] | kbr[2])
    add(sib, K0, kbr[1] | kbr[2])
    shift = kbr[4] | kbr[5]
    add(b, LO, shift)
    add(b, HI, shift)
    eq = (lo == hi).all(-1)[:, b]
    tk = (m & ~shift) | (shift & eq)
    add(t, K0, tk)
    add(t, K1, tk)
    return out


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
    against its plain version on the same input. K5 (a one-level
    layout that assumes nothing of the tables) and K6 run each forward
    level, K8's exchange follows, K7 runs each backward round
    from the last level down, K8's verdicts close; K8's init and one
    sweep's changed flag against the plain comparison come first. K6
    and K7 take the plan's kernel layout, their plain versions the plan
    as the JAX package builds it; ``start`` must keep a bool row zero
    above limb 0 (the kernels' invariant, ``csrc/screen.cu``).

    With ``accs`` (name -> dict), every call is also timed: ``ms`` (a
    call on CUDA events, the host's launch included), ``device_ms``
    (``queued_ms``) and ``plain_ms``, all on fresh copies of the checked
    call's input; and the bytes the function must move on that input
    are counted (``bytes``): what it reads, once each (K6 and K7 the
    parts of rows each op or rule reads on that input, ``level_parts``,
    ``round_parts``; K8 the rows: numeric rows 32 bytes per table, bool
    rows the 4-byte limb 0 of lo and hi), and the limbs that its call
    changed; K5 a level at a time is not timed (``check_k5`` times its
    one call over every level), its rows so counted are summed level by
    level (``levels_bytes``, the per-level count of PRs 2-11); ``rows_bytes`` is K6's and K7's earlier count,
    each row they touch whole, so the rows stay comparable; K8's init writes the four tables whole, and its
    verdicts read each state's rows up to the first row in conflict (all
    of them in a state without one), then the assertion slots of a state
    that has none."""
    import torch

    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P

    n_s, n_t = core["seed_idx"].shape[0], core["init_lo"].shape[0]
    numeric = core["numeric"] != 0
    isbool = core["isbool"] != 0
    if any(bool(t[:, isbool, 1:].any()) for t in start[:2]):
        raise AssertionError(f"{name}: a bool row is not zero above limb 0")
    lay = P.kernel_layout(core)
    row_iv = torch.where(isbool, 8, 64).tolist()
    row_pr = torch.where(isbool, 8, 128).tolist()
    flag = torch.zeros(1, dtype=torch.int32, device=start[0].device)
    err = dict.fromkeys(("interval_level", "prop_fwd_level",
                         "prop_back_round", "prop_tables"), 0)

    def call(key, what, kern, plain, x, nbytes=None, rows_nbytes=None,
             timed=True):
        """Run kern and plain on copies of x, require equal outputs,
        time the pair when accs is given, with the bytes it must move
        (``nbytes``; ``rows_nbytes``, where given, the rows' count of
        PRs 4-8); untimed, only its bytes are summed (``levels_bytes``);
        returns the kernel's output."""
        a, b = clone_all(x), clone_all(x)
        out_k = kern(a)
        out_p, plain_ms = timed_once(plain, b)
        out_k, out_p = (a, b) if out_k is None else (out_k, out_p)
        err[key] = max(err[key], same_outputs(out_k, out_p, f"{name}: {what}"))
        if accs is not None and not timed:
            accs[key]["levels_bytes"] += nbytes(x, out_k)
        elif accs is not None:
            acc = accs[key]
            acc["ms"] += cuda_ms(kern, reps=3, setup=lambda: clone_all(x))
            acc["device_ms"] += queued_ms(kern, lambda: clone_all(x))
            acc["plain_ms"] += plain_ms  # the check's own run
            acc["bytes"] += nbytes(x, out_k)
            acc["rows_bytes"] += (rows_nbytes or nbytes)(x, out_k)
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
    for li, (lvl, klv) in enumerate(zip(core["levels"], lay["levels"])):
        reads, nodes = _level_rows(lvl)
        iv = call("interval_level", f"K5 interval_level {li}",
                  lambda x, lv=lvl: I.eval_level_kernel(lv, *x),
                  lambda x, lv=lvl: I.eval_level_plain(lv, *x), iv,
                  lambda x, o, r=reads: n_s * sum(row_iv[i] for i in r)
                  + changed_bytes(x, o), timed=False)
        tabs = call("prop_fwd_level", f"K6 prop_fwd_level {li}",
                    lambda x, lv=klv: P.fwd_level_kernel(lv, x, flag),
                    lambda x, lv=lvl: P.fwd_level_plain(lv, x), tabs,
                    lambda x, o, lv=lvl: parts_bytes(
                        level_parts(lv, n_t), n_s, n_t, isbool)
                    + changed_bytes(x, o),
                    lambda x, o, r=reads | nodes: n_s * sum(
                        row_pr[i] for i in r) + changed_bytes(x, o))
    tabs = call("prop_tables", "K8 prop_exchange",
                lambda x: P.exchange_kernel(x, core["numeric"], flag),
                lambda x: P.exchange_plain(x, core["numeric"]), tabs,
                lambda x, o: n_s * int(numeric.sum()) * 128
                + changed_bytes(x, o))
    for li in range(len(core["back"]) - 1, -1, -1):
        for ri, (rnd, krnd) in enumerate(zip(core["back"][li],
                                             lay["back"][li])):
            rows = _round_rows(rnd, n_t)
            tabs = call("prop_back_round", f"K7 prop_back_round {li}.{ri}",
                        lambda x, r=krnd: P.back_round_kernel(r, x, flag),
                        lambda x, r=rnd: P.back_round_plain(r, x), tabs,
                        lambda x, o, r=rnd: parts_bytes(
                            round_parts(r, x, n_t), n_s, n_t, isbool)
                        + changed_bytes(x, o),
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


def k5_call_bytes(lay, out_lo):
    """Bytes one K5 call over a bound layout must move: the layout once
    (every entry's two int4, the mask of the ops that read it, the aux of
    those that read it, 4 bytes of CONCAT's); the seed slots, each kept
    slot's seed rows read once and written once; each operand row that
    no earlier level of the call wrote, once for all states (the init
    tables': a state's row there is the init row or a seed, counted
    above), limb 0 of lo and hi (8 bytes) where every read of it takes
    limb 0, else both rows (64); each row a level writes, once a state,
    64 bytes (a bool row's limb 0 alone is 8 bytes of data, but a write of
    less than a 32-byte sector makes the card read the sector back).
    What each op reads is the kernel's own table (``I.iv_reads``, from
    csrc/screen.cu), whose operand counts must be the layout's
    (``I.operand_reads``)."""
    import numpy as np

    from mythril_tpu_torch.ops import intervals as I

    reads = np.asarray(I.iv_reads())
    known = np.nonzero(reads)[0]
    if (reads[known] & 3 != I.operand_reads(known)).any():
        raise AssertionError(f"K5: the kernel's operand counts "
                             f"{(reads[known] & 3).tolist()} are not the "
                             f"layout's {I.operand_reads(known).tolist()} "
                             f"for ops {known.tolist()}")
    ent = lay["ent"].cpu().numpy()
    op, n_rows = ent[:, 1], lay["n_rows"]
    n_s = out_lo.shape[0]
    r = reads[op]
    if not r.all():
        raise AssertionError(f"K5: the layout holds ops with no transfer: "
                             f"{sorted(set(op[r == 0].tolist()))}")
    nbytes = 32 * len(op) + 32 * int((r & I.IV_R_MASK != 0).sum()) \
        + 32 * int((r & I.IV_R_AUX != 0).sum()) \
        + 4 * int((r & I.IV_R_AUX0 != 0).sum()) + 16 * lay["lv"].shape[0]
    if "seed_idx" in lay:
        idx = lay["seed_idx"].cpu().long()
        rows, ok = I.scatter_index(idx, n_rows)
        ss, vv = np.nonzero(ok.numpy())
        kept = set(zip(ss.tolist(), rows.numpy()[ss, vv].tolist()))
        nbytes += 4 * idx.numel() + 64 * len(ss) + 64 * len(kept)
    need = {}  # row -> 8 (limb 0) or 64 (whole)
    written = set()
    limb0 = (I.IV_R_A0, I.IV_R_B0, I.IV_R_C0)
    for a, b, _, _ in lay["lv"]:
        for j in range(a, b):
            for k in range(r[j] & 3):
                row = int(ent[j, 2 + k])
                if row in written:
                    continue
                part = 8 if r[j] & limb0[k] else 64
                need[row] = max(need.get(row, 0), part)
        for j in range(a, b):
            written.add(int(ent[j, 0]))
    return nbytes + sum(need.values()) + 64 * n_s * len(written)


def check_k5(name, enc, dev, acc=None):
    """K5 over every level of an encoding (its bound layout, from the
    init tables: the seeds scattered in the same call) against the plain
    driver (``seed_tables``, then ``eval_level_plain`` level by level),
    bit for bit, its CUDA launches (as ``interval_levels`` in
    csrc/screen.cu counts them) those ``iv_launch_shape`` plans; and
    ``eval_feasible`` with the kernel against the plain version. With
    ``acc``, the call is timed (call, device, plain ms), its launches
    kept and its bytes counted (``k5_call_bytes``). Returns the largest
    difference."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import intervals as I

    lay = I.encoding_layout(enc, dev)
    shape = (enc.seed_idx.shape[0],) + enc.init_lo.shape

    def fresh():
        return (lay["init_lo"].expand(shape).clone(),
                lay["init_hi"].expand(shape).clone())

    def kern(x):
        I.eval_levels_kernel(lay, *x)
        return x

    def plain(_=None):
        return I._run_tables(enc, dev, plain=True)[:2]

    n_s = shape[0]
    plan, _ = I.iv_launch_shape(lay, n_s, 1)
    want_launches = len(plan) + int("seed_idx" in lay and enc.seed_idx.shape[1]
                                    > 0) + int(lay["lv"][:, 2].sum())
    before = _build.LAUNCHES["interval_level"]
    got = kern(fresh())
    torch.cuda.synchronize()
    launched = _build.LAUNCHES["interval_level"] - before
    if launched != want_launches:
        raise AssertionError(f"{name}: K5 counted {launched} launches a "
                             f"call, planned {want_launches}")
    want = plain()
    err = same_outputs(got, want, f"{name}: K5 over every level")
    if list(I.eval_feasible(enc, dev)) != list(I.eval_feasible(enc, dev,
                                                                plain=True)):
        raise AssertionError(f"{name}: eval_feasible differs from the plain "
                             f"version")
    if acc is not None:
        acc["ms"] = cuda_ms(kern, reps=5, setup=fresh)
        acc["device_ms"] = queued_ms(kern, fresh, reps=5)
        acc["plain_ms"] = cuda_ms(plain, reps=1)
        acc["bytes"] = k5_call_bytes(lay, got[0])
        acc["launches_a_call"] = launched
    return err


def check_k5_edges(dev):
    """K5 on ``screen_waves.k5_edge_cases`` (``check_k5``), and level by
    level (``eval_level_kernel``) from the seeded tables against the
    plain version after every level; the cases must take the paths they
    are for: a level wider than a block, a level that reads a row it
    writes (the staged launch), more states than the staged grid's
    resident blocks, one state."""
    import torch

    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.support.screen_waves import k5_edge_cases

    t0 = time.perf_counter()
    seen = []
    _, lib = I.screen_lib()
    resident = lib.interval_levels_blocks(I.IV_THREADS)
    for name, enc in k5_edge_cases().items():
        check_k5(f"K5 edge {name}", enc, dev)
        lay = I.encoding_layout(enc, dev)
        n_s = enc.seed_idx.shape[0]
        launches, (threads, blocks) = I.iv_launch_shape(lay, n_s, resident)
        seen.append(f"{name} ({n_s} states, levels "
                    f"{[int(b - a) for a, b, _, _ in lay['lv']]}, "
                    f"{len(launches)} level launches"
                    + (f", staged: {threads} threads, {blocks} blocks"
                       if lay["stage_words"] else "") + ")")
        widest = max((b - a for a, b, _, _ in lay["lv"]), default=0)
        if name == "wide_level" and widest <= I.IV_LEVEL_THREADS:
            raise AssertionError("K5 edge wide_level: not past one block")
        if (name == "reads_own_level") != bool(lay["stage_words"]):
            raise AssertionError(f"K5 edge {name}: staging "
                                 f"{lay['stage_words']} words")
        if name == "many_states" and n_s <= resident:
            raise AssertionError("K5 edge many_states: within one grid")
        a = I.seed_tables(*(I.words_to_device(x, dev)
                            for x in (enc.init_lo, enc.init_hi)),
                          I.ints_to_device(enc.seed_idx, dev),
                          *(I.words_to_device(x, dev)
                            for x in (enc.seed_lo, enc.seed_hi)))
        b = clone_all(a)
        for li, level in enumerate(enc.levels):
            lv = I.level_to_device(level, dev)
            I.eval_level_kernel(lv, *a)
            I.eval_level_plain(lv, *b)
            torch.cuda.synchronize()
            same_outputs(a, b, f"K5 edge {name}: level {li} alone")
        del a, b
    torch.cuda.empty_cache()
    log(f"K5 edges: equal to the plain versions over every level in one "
        f"call and level by level: {'; '.join(seen)}; "
        f"{time.perf_counter() - t0:.1f} s")


def prop_starts(core):
    """The tables K6 starts from on an edge plan, by name: the plan's
    init tables, seeded random tables (``random_tables``) and the init
    tables after one plain sweep (refined rows, where a level that reads
    a row it writes shows), all made by the plain versions."""
    from mythril_tpu_torch.ops import propagate as P

    init = P.init_tables(core, plain=True)
    swept = clone_all(init)
    P.sweep(core, swept, plain=True)
    return [("init", init), ("random", random_tables(core, SEED)),
            ("one sweep", swept)]


def prop_edge_diffs(dev, core, starts):
    """K6 level by level (from each of ``starts``, (name, tables); each
    level's plain output the next level's input), the host-sequenced
    driver (K6-K8, ``_run_host``) and K11 (``fixpoint_kernel``, the
    whole fixpoint) on one plan on the card against their plain
    versions (``_fixpoint_plain`` for K11): every difference, as (pass,
    table or output, the first (state, row) pairs that differ, how many
    differ); none where the kernels are exact."""
    import torch

    from mythril_tpu_torch.ops import propagate as P

    lay = P.kernel_layout(core)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    out = []

    def diff(what, names, got, want):
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            g, w = torch.as_tensor(g), torch.as_tensor(w)
            bad = (g != w).flatten(2).any(-1) if g.dim() == 3 else g != w
            if bool(bad.any()):
                out.append((what, name, bad.nonzero().tolist()[:8],
                            int(bad.sum())))

    for name, start in starts:
        tabs = start
        for li, (lvl, klv) in enumerate(zip(core["levels"], lay["levels"])):
            a, b = clone_all(tabs), clone_all(tabs)
            P.fwd_level_kernel(klv, a, flag)
            P.fwd_level_plain(lvl, b)
            diff(f"K6 level {li} from {name}", ("lo", "hi", "k0", "k1"), a, b)
            tabs = b
    cap = P.SWEEP_CAP
    for what, kern, plain in (
            ("K6-K8 driver", P._run_host(core, cap),
             P._run_host(core, cap, plain=True)),
            ("K11", P.fixpoint_kernel(core, cap)[:4],
             P._fixpoint_plain(core, cap)[:4])):
        diff(what, ("lo", "hi", "k0", "k1"), kern[0], plain[0])
        diff(what, ("ok", "contra", "sweeps"),
             (kern[1], kern[2], torch.tensor(kern[3])),
             (plain[1], plain[2], torch.tensor(plain[3])))
    return out


#: the edge plans with a level that reads a row it writes: (that level,
#: where K6 stages it)
STAGED_EDGES = {"reads_own_level": (1, "shared"),
                "staged_wide": (0, "global")}


def check_prop_edges(dev):
    """K6 level by level and K11 over the whole fixpoint (with the
    host-sequenced driver beside it) on the propagation plan of every
    ``screen_waves.k5_edge_cases`` encoding and on a level of 2048
    comparisons that reads a row it writes (``k5_edge_plans``), against
    their plain versions from the init tables, seeded random tables and
    the tables after one sweep (``prop_edge_diffs``): no difference.
    The staged path is taken on ``reads_own_level`` and ``staged_wide``
    alone (``STAGED_EDGES``): K6's layout and K11's fused plan flag that
    level and no other (K11 runs its staging instance on those plans
    alone), and K6 runs it in one launch, staging in shared memory and
    in its global buffer."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import k5_edge_plans

    t0 = time.perf_counter()
    seen = []
    for name, plan in k5_edge_plans().items():
        core = P.plan_to_device(plan, dev)
        lay = P.kernel_layout(core)
        flags = [lv["hazard"] for lv in lay["levels"]]
        if flags != [li == STAGED_EDGES.get(name, (None,))[0]
                     for li in range(len(flags))]:
            raise AssertionError(f"K6 edge {name}: levels flagged {flags}")
        fp = P._fused_plan(core)
        lhaz = fp["lhaz"].tolist()[:len(flags)]
        if lhaz != [int(f) for f in flags] or fp["haz"] != any(flags):
            raise AssertionError(f"K11 edge {name}: levels flagged {lhaz}, "
                                 f"the staging instance {fp['haz']}")
        for li, lv in enumerate(lay["levels"]):
            if not lv["hazard"]:
                continue
            before = _build.LAUNCHES["prop_fwd_level"]
            P.fwd_level_kernel(lv, P.init_tables(core, plain=True))
            torch.cuda.synchronize()
            where = "global" if lv["launch"][7] else "shared"
            if _build.LAUNCHES["prop_fwd_level"] - before != 1 \
                    or where != STAGED_EDGES[name][1]:
                raise AssertionError(f"K6 edge {name}: level {li} not one "
                                     f"staged launch in "
                                     f"{STAGED_EDGES[name][1]} memory")
            seen.append(f"{name} level {li} staged ({lv['ent'].shape[0]} "
                        f"nodes, {lv['stage_words']} words, {where} "
                        f"memory, {lv['launch'][6]} blocks)")
        diffs = prop_edge_diffs(dev, core, prop_starts(core))
        if diffs:
            raise AssertionError(f"K6/K11 edge {name}: {diffs}")
        del core, lay
        torch.cuda.empty_cache()
    log(f"K6 and K11 edges: on every k5_edge_cases plan, K6 level by level "
        f"(from the init, random and once-swept tables), the K6-K8 driver "
        f"and K11 equal to their plain versions; {'; '.join(seen)}; "
        f"{time.perf_counter() - t0:.1f} s")


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
    k5_err = check_k5("all-opcode wave", l_enc, dev)
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
    accs = {k: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes=0,
                    rows_bytes=0, levels_bytes=0) for k in errs[0]}
    start = P.init_tables_kernel(core)
    seeded = I.seed_tables(core["init_lo"], core["init_hi"],
                           core["seed_idx"], core["seed_lo"],
                           core["seed_hi"])
    errs.append(check_tables("screen wave", core, start, seeded, accs))
    del start, seeded
    torch.cuda.empty_cache()
    k5_err = max(k5_err, check_k5("screen wave", enc, dev,
                                  accs["interval_level"]))
    torch.cuda.empty_cache()
    for name, acc in accs.items():
        bms, by = bound_ms(acc["bytes"])
        report[name] = dict(max_abs_err=max(e[name] for e in errs),
                            ms=acc["ms"], plain_ms=acc["plain_ms"],
                            device_ms=acc["device_ms"], bound_ms=bms,
                            bound_by=by)
        rows = ""
        if name == "interval_level":
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              k5_err)
            report[name]["levels_bound_ms"] = bound_ms(
                acc["levels_bytes"])[0]
            rows = (f"; one call over every level, "
                    f"{acc['launches_a_call']} CUDA launches (the per-level "
                    f"count {report[name]['levels_bound_ms']:.6f} ms, "
                    f"{acc['levels_bytes']} bytes)")
        elif acc["rows_bytes"] != acc["bytes"]:
            report[name]["bound_rows_ms"] = bound_ms(acc["rows_bytes"])[0]
            rows = (f"; rows whole {report[name]['bound_rows_ms']:.6f} ms "
                    f"({acc['rows_bytes']} bytes)")
        log(f"{name}: {acc['ms']:.4f} ms calls, {acc['device_ms']:.4f} ms "
            f"device, {acc['plain_ms']:.1f} ms plain, bound {bms:.6f} ms "
            f"({by}, {acc['bytes']} bytes){rows}")


#: the edge inputs' state counts, the last past the resident grid of
#: K7's widest round (``staging``: twice that grid and one, its 1000
#: assertion pairs a state making 8192 states slow to encode and check)
EDGE_STATES = (1, 33, 8192)


def edge_wave(dev, sets, n):
    """``sets`` repeated to n states: (the states' sets, their encoding,
    their plan on the card)."""
    from mythril_tpu_torch.ops import intervals as I
    from mythril_tpu_torch.ops import propagate as P

    wave = (sets * -(-n // len(sets)))[:n]
    enc = I.linearize(wave)
    return wave, enc, P.plan_to_device(P.build_plan(enc), dev)


def check_screen_edges(dev):
    """K6 and K7 (with K5 and K8 around them, ``check_tables``) on the
    edge inputs ``screen_waves.edge_sets`` at 1, 33 and 8192 states
    (``staging``: a count past its resident grid), from the init tables
    and from seeded random tables, and each wave's whole screen, against
    the plain versions; then a level and a round of pads only, which
    launch nothing and change nothing."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import propagate as P
    from mythril_tpu_torch.support.screen_waves import edge_sets

    def widest_grid(core):
        rounds = [r for rs in P.kernel_layout(core)["back"] for r in rs]
        return max(rounds, key=lambda r: r["launch"][3])["grid"]

    t0 = time.perf_counter()
    for name, sets in edge_sets().items():
        counts = EDGE_STATES
        if name == "staging":
            counts = (1, 33, 2 * widest_grid(edge_wave(dev, sets, 1)[2]) + 1)
        for n in counts:
            wave, enc, core = edge_wave(dev, sets, n)
            check_k5(f"edge {name}, {n} states", enc, dev)
            lay = P.kernel_layout(core)
            grid = widest_grid(core)
            glob = sum(r["launch"][7] is not None for rs in lay["back"]
                       for r in rs)
            if n == counts[-1] and n <= grid:
                raise AssertionError(f"edge {name}: {n} states within the "
                                     f"grid of {grid} blocks")
            if (name == "staging") != bool(glob):
                raise AssertionError(f"edge {name}: {glob} rounds stage in "
                                     f"global memory")
            init = P.init_tables_kernel(core)
            check_tables(f"edge {name}, {n} states", core, init, init[:2])
            rnd = random_tables(core, SEED + n)
            check_tables(f"edge {name}, {n} states, random tables", core,
                         rnd, rnd[:2])
            got, want = P.screen(wave, dev), P.screen(wave, dev, plain=True)
            if (list(got.keep) != list(want.keep) or got.sweeps != want.sweeps
                    or _facts_key(got.facts) != _facts_key(want.facts)):
                raise AssertionError(f"edge {name}, {n} states: the screen "
                                     f"differs from the plain versions")
            del init, rnd, core, enc
            torch.cuda.empty_cache()
        log(f"edge {name}: K5-K8 and the screen equal to the plain versions "
            f"at {list(counts)} states (the grid of K7's widest round {grid} "
            f"blocks; {glob} rounds staged in global memory)")

    _, _, core = layered_wave(dev)
    n_t = core["init_lo"].shape[0]
    level = dict(core["levels"][0], op=torch.zeros_like(
        core["levels"][0]["op"]))
    rnd = dict(core["back"][0][0], tgt=torch.full_like(
        core["back"][0][0]["tgt"], n_t))
    pads = {k: v for k, v in core.items() if k != "layout"}
    pads["levels"], pads["back"] = [level], [[rnd]]
    init = P.init_tables_kernel(pads)
    _build.reset_launches()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    tabs = clone_all(init)
    lay = P.kernel_layout(pads)
    P.fwd_level_kernel(lay["levels"][0], tabs, flag)
    P.back_round_kernel(lay["back"][0][0], tabs, flag)
    torch.cuda.synchronize()
    if (_build.LAUNCHES["prop_fwd_level"] or _build.LAUNCHES["prop_back_round"]
            or flag.item()):
        raise AssertionError(f"pads only: {dict(_build.LAUNCHES)} launches, "
                             f"flag {flag.item()}")
    same_outputs(tabs, init, "pads only")
    check_tables("pads only", pads, init, init[:2])
    log(f"pads only: a level and a round of pads launch nothing and change "
        f"nothing, as the plain versions; the edge inputs took "
        f"{time.perf_counter() - t0:.1f} s")


def _facts_key(facts):
    return {s: (sorted(map(repr, f)),
                sorted((repr(v), lo, hi) for v, lo, hi in b.values()))
            for s, (f, b) in facts.items()}


#: the screens' kernels by their symbols in a profile
SCREEN_SYMBOLS = ("iv_level_kernel", "fwd_kernel", "back_kernel",
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
        busy = (f"device busy {dev_s:.4f} of {pwall:.3f} s under the "
                f"profiler (share {dev_s / pwall:.4f})" if dev_s else
                "device busy not measured (the profiler recorded no CUDA "
                "event)")
        log(f"screen path ({tag}): kept {len(kept)} of {SCREEN_N}, "
            f"device_screened +{delta['device_screened']}, 0 device "
            f"failures, {detail}; {wall:.3f} s, {SCREEN_N / wall:.1f} "
            f"systems/s; {busy}; launches "
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
    fams = dict(memory=("MLOAD", "MSTORE", "MSTORE8", "MSIZE"),
                storage=("SLOAD", "SSTORE"),
                calldata=("CALLDATALOAD", "CALLDATASIZE"))
    # each opcode's families (a column each) in one table: a lookup a
    # step instead of a compare an opcode name
    fam_of = torch.zeros((256, len(fams)), dtype=torch.bool)
    for j, names in enumerate(fams.values()):
        for name in names:
            fam_of[S._OP[name], j] = True
    fam_of = fam_of.to(dev)
    cdload = S._OP["CALLDATALOAD"]
    fam = torch.zeros((n, len(fams)), dtype=torch.bool, device=dev)
    fp = dict(env=torch.zeros((n, S.N_ENV), dtype=torch.bool, device=dev),
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
        fam |= live[:, None] & fam_of[op]
        # CALLDATALOAD reads [top, top + 32) below cd_size
        top = x.stack[lanes, (x.sp.long() - 1).clamp(0, x.stack.shape[1]
                                                     - 1)]
        off = top[:, 0].long() & 0xFFFFFFFF
        small = ~(top[:, 1:] != 0).any(dim=1) & (off < 1 << 30)
        cdl = live & (op == cdload) & (x.sp > 0) & small
        fp["cd_bytes"] |= (cdl[:, None] & (cols >= off[:, None])
                           & (cols < off[:, None] + 32)
                           & (cols < x.cd_size.long()[:, None]))
        x = S.step(code, x)
    fp.update({k: fam[:, j] for j, k in enumerate(fams)})
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


#: a K10 edge case of at most this many lanes runs its plain reference
#: on the CPU (the same inputs, made from the case's numpy planes): its
#: steps are tiny ops, which the card runs one launch (and each gate one
#: wait) at a time
PLAIN_CPU_LANES = 64


def check_k10_edges(dev):
    """K10 on ``device_loop.k10_edge_cases(full=True)`` against
    ``run_plain``, bit for bit on every plane: the whole batch, or the
    case's shard view of it (the lanes around the view unchanged); the
    plain run on the CPU up to PLAIN_CPU_LANES lanes. The cases must
    take each of the kernel's four branches (the code's rows in shared
    memory or in place, the lanes' rows on chip or in place)."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.support import device_loop as dl

    names, branches = [], set()
    for case in dl.k10_edge_cases(full=True):
        cc, st = dl.k10_case_inputs(case, dev)
        v = dl.view_of(st, case.view)
        plan = S.lane_run_plan(v.pc.shape[0], v.stack.shape[1],
                               v.memory.shape[1], v.skeys.shape[1], cc.size,
                               *_build.device_limits(st.device))
        branches.add((plan["code_shared"], plan["local"]))
        del v
        on_cpu = st.pc.shape[0] <= PLAIN_CPU_LANES
        pcc, want = dl.k10_case_inputs(case, "cpu") if on_cpu \
            else (cc, S.clone_lanes(st))
        x = dl.view_of(want, case.view)
        ran = S.run_plain(pcc, S.clone_lanes(x), case.max_steps)
        for f in S.LANE_FIELDS:
            getattr(x, f).copy_(getattr(ran, f))
        S.run_kernel(cc, dl.view_of(st, case.view), case.max_steps)
        torch.cuda.synchronize()
        got = S.LaneState(**{f: getattr(st, f).to(want.pc.device)
                             for f in S.LANE_FIELDS})
        same_lanes(got, want, f"K10 edge case {case.name}")
        names.append(f"{case.name} ({st.pc.shape[0]} lanes, code "
                     f"{'shared' if plan['code_shared'] else 'in place'}, "
                     f"rows {'on chip' if plan['local'] else 'in place'})")
        del st, want, x, ran, got
    torch.cuda.empty_cache()
    if branches != {(0, 0), (0, 1), (1, 0), (1, 1)}:
        raise AssertionError(f"K10 edge cases took the branches {branches} "
                             f"of four")
    log(f"K10 lane_run: equal to run_plain on k10_edge_cases: "
        f"{', '.join(names)}")


def concrete_path(dev, card, report):
    """The concrete path of bench.py's headline (bench_device): the
    bench contract over 32768 lanes through the port's ``run`` (K10),
    one warm run and three timed, every lane's status, steps and slot 0
    held against the closed form; K10 held bit for bit against
    ``run_plain`` at 1024 lanes through a whole run and over single
    steps at full width (its edge cases: ``check_k10_edges``, run
    beside the corpus mode); the device's busy share under torch.profiler
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
    dev_ms = queued_ms(lambda x: S.run_kernel(cc, x, cap), fresh)
    dev_src = "CUDA events behind a spin kernel after an L2 flush"
    # a 4096-lane shard of the batch (sharded_run's launch on 8 shards)
    shard = lambda: C.bench_batch(CONCRETE_N // 8, dev)  # noqa: E731
    shard_ms = cuda_ms(lambda x: S.run_kernel(cc, x, cap), reps=3,
                       setup=shard)
    shard_dms = queued_ms(lambda x: S.run_kernel(cc, x, cap), shard)
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
                              bound_by=by, shard_ms=shard_ms,
                              shard_device_ms=shard_dms)
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
        f"{plain_s:.3f} s; a {CONCRETE_N // 8}-lane shard {shard_ms:.4f} "
        f"ms a call, {shard_dms:.4f} ms device; on {card}")
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
        if name == "lane mix":
            wide = lambda: C.lane_mix_batch(  # noqa: E731
                WIDE_CONCRETE_N, SEED, device=dev)
            run = lambda x: S.run_kernel(  # noqa: E731
                wcc, x, WIDE_CONCRETE_STEPS)
            w_ms = cuda_ms(run, reps=2, setup=wide)
            w_dms = queued_ms(run, wide, reps=2)
            report["lane_run"].update(wide_ms=w_ms, wide_device_ms=w_dms)
            log(f"  K10 at {WIDE_CONCRETE_N} lanes of default planes (lane "
                f"mix): {w_ms:.4f} ms a call, {w_dms:.4f} ms device; on "
                f"{card}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the mesh: sharded runs, the live count, compaction, the deal (K12-K14)
# ---------------------------------------------------------------------------

#: the mesh phase: bench_device's batch on MESH_SHARDS shards of one
#: card, MESH_STEPS steps before the count, compaction and the deal;
#: then one deal at init_lanes' default planes
MESH_LANES, MESH_SHARDS, MESH_STEPS = 32768, 8, 400
WIDE_MESH_N, WIDE_MESH_STEPS = 131072, 64


def mesh_kernel_times(dev, st, n_dev, reps):
    """Call, device (``queued_ms``: inside this script, after the earlier
    phases, torch.profiler records only part of these short launches),
    plain and library ms and the bounds of K12, K13 (with the deal over
    n_dev shards) and K14 on ``st``'s statuses and planes:
    {kernel: {...}}. The library calls: the per-shard sum of
    ``status == RUNNING``, ``torch.argsort(stable=True)`` of the
    not-running key (the order of compact_lanes) and ``index_select``
    of every plane. K12 also: ``live_lane_counts``' call over n_dev
    shards that are views of ``st`` (``counts_ms``; the counts on the
    host) against the library's sum pulled to the host
    (``counts_library_ms``), in turns, and the launch floor, an empty
    kernel under the same timer (``floor_device_ms``)."""
    import torch

    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.parallel import mesh as M

    n = st.pc.shape[0]
    status = st.status
    order = M.lane_order(status, n_dev)
    rows = M.source_rows(order, n)
    planes = [getattr(st, f) for f in S.LANE_FIELDS]

    def copy_ms(nbytes):
        """device ms of one contiguous copy of as many bytes: the rate a
        plain copy reaches on this card"""
        a = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        b = torch.empty_like(a)
        return queued_ms(lambda _: b.copy_(a), lambda: None, reps=reps)

    def timed(kern, plain, library, nbytes):
        bms, by = bound_ms(nbytes)
        # the kernel's call and the library's in turns
        turns = [cuda_ms(f, reps=reps) for f in (kern, library, library,
                                                   kern)]
        return dict(ms=(turns[0] + turns[3]) / 2,
                    device_ms=queued_ms(lambda _: kern(), lambda: None,
                                        reps=reps),
                    plain_ms=cuda_ms(plain, reps=reps),
                    library_ms=(turns[1] + turns[2]) / 2, bound_ms=bms,
                    bound_by=by)

    mesh = M.Mesh([dev] * n_dev)
    sh = M.shard_lanes(st, mesh)
    live = timed(lambda: M.lane_live(status, n_dev),
                 lambda: M.lane_live_plain(status, n_dev),
                 lambda: (status.view(n_dev, -1) == S.Status.RUNNING).sum(1),
                 4 * n + 4 * n_dev)
    # the counts on the host: live_lane_counts (K12 into the mapped host
    # buffer, one wait) against the library's sum and a pageable pull,
    # in turns; and the launch floor: an empty kernel, queued as K12 is
    counts = [cuda_ms(f, reps=reps) for f in (
        lambda: M.live_lane_counts(sh, mesh),
        lambda: (status.view(n_dev, -1) == S.Status.RUNNING).sum(1).cpu(),
        lambda: (status.view(n_dev, -1) == S.Status.RUNNING).sum(1).cpu(),
        lambda: M.live_lane_counts(sh, mesh))]
    live.update(counts_ms=(counts[0] + counts[3]) / 2,
                counts_library_ms=(counts[1] + counts[2]) / 2,
                floor_device_ms=queued_ms(lambda _: M.empty_launch(dev),
                                          lambda: None, reps=reps))
    return {
        "lane_live": live,
        "lane_order": timed(
            lambda: M.lane_order(status, n_dev),
            lambda: M.lane_order_plain(status, n_dev),
            lambda: torch.argsort((status != S.Status.RUNNING).int(),
                                  stable=True),
            8 * n),
        "lane_gather": dict(timed(
            lambda: M.lane_gather(st, order),
            lambda: M.lane_gather_plain(st, order),
            lambda: [x.index_select(0, rows) for x in planes],
            2 * n * S.lane_bytes(st)),
            copy_device_ms=copy_ms(n * S.lane_bytes(st))),
    }


def check_k12_edges(dev):
    """K12 on ``device_loop.k12_edge_cases`` with each case's shard
    counts, against ``lane_live_plain``: ``lane_live`` on the case's
    status view, ``live_lane_counts`` over the shards as views of one
    batch and as copies (an array a shard), each as launched and on a
    grid of at most 3 blocks (several tiles a thread, through
    ``mesh._LIVE_RESIDENT``, the launch plans made anew): equal, one
    CUDA launch a call (one device)."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support.device_loop import (k12_edge_cases,
                                                       k12_status)

    t0 = time.perf_counter()
    calls = 0
    saved = dict(M._LIVE_RESIDENT)

    def one_launch(what, fn):
        before = _build.LAUNCHES["lane_live"]
        got = fn()
        torch.cuda.synchronize()
        if _build.LAUNCHES["lane_live"] - before != 1:
            raise AssertionError(f"K12 edge {what}: not one launch")
        return got

    try:
        for case in k12_edge_cases():
            name, _, devs, _ = case
            st = k12_status(case, dev)
            batch = S.init_lanes(st.shape[0], stack_depth=1, memory_bytes=4,
                                 storage_slots=1, calldata_bytes=4,
                                 device=dev).replace(status=st)
            for n_dev in devs:
                want = M.lane_live_plain(st, n_dev)
                mesh = M.Mesh([dev] * n_dev)
                views = M.shard_lanes(batch, mesh)
                copies = M.ShardedLanes(mesh, tuple(
                    x.replace(status=x.status.clone())
                    for x in views.shards))
                for form in ("as launched", "at most 3 blocks"):
                    M._LIVE_PLANS.clear()  # each form's own grid
                    M._LIVE_RESIDENT.clear()
                    M._LIVE_RESIDENT.update(saved)
                    if form != "as launched":
                        M._LIVE_RESIDENT.update(
                            {(dev.index, t): 3 for t in range(32, 1025, 32)})
                    what = f"{name}, {n_dev} shards, {form}"
                    got = one_launch(what, lambda: M.lane_live(st, n_dev))
                    if max_err(got, want):
                        raise AssertionError(f"K12 edge {what}: differs "
                                             f"from the plain version")
                    for kind, sh in (("views", views), ("copies", copies)):
                        per, total = one_launch(
                            f"{what}, {kind}",
                            lambda: M.live_lane_counts(sh, mesh))
                        if per.tolist() != want.tolist() \
                                or total != int(want.sum()):
                            raise AssertionError(
                                f"K12 edge {what}, {kind}: live_lane_counts "
                                f"{per.tolist()}, plain {want.tolist()}")
                    calls += 3
    finally:
        M._LIVE_PLANS.clear()
        M._LIVE_RESIDENT.clear()
        M._LIVE_RESIDENT.update(saved)
    log(f"K12 edges: {calls} calls (every case of k12_edge_cases with its "
        f"shard counts: lane_live, live_lane_counts over views of one batch "
        f"and over shard copies, as launched and on a grid of at most 3 "
        f"blocks) equal to the plain version, one launch each; "
        f"{time.perf_counter() - t0:.1f} s")


def check_k13_edges(dev):
    """K13 on ``device_loop.k13_edge_cases`` with each case's shard
    counts, as ``lane_order`` launches it (a tile a block past 4096
    lanes) and on a grid of at most 3 blocks (several tiles a block),
    against ``lane_order_plain``: equal, one CUDA launch a call."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support.device_loop import k13_edge_cases

    t0 = time.perf_counter()
    calls = 0
    resident = M._ORDER_RESIDENT.get(dev.index)
    try:
        for name, status, devs in k13_edge_cases():
            st = torch.from_numpy(status).to(dev)
            for n_dev in devs:
                want = M.lane_order_plain(st, n_dev)
                for form in ("as launched", "at most 3 blocks"):
                    M._ORDER_RESIDENT.pop(dev.index, None)
                    if form != "as launched":
                        M._ORDER_RESIDENT[dev.index] = 3
                    before = _build.LAUNCHES["lane_order"]
                    got = M.lane_order(st, n_dev)
                    torch.cuda.synchronize()
                    if _build.LAUNCHES["lane_order"] - before != 1:
                        raise AssertionError(f"K13 edge {name}: not one "
                                             f"launch")
                    if max_err(got, want):
                        raise AssertionError(
                            f"K13 edge {name}, {n_dev} shards, {form}: "
                            f"differs from the plain version")
                    calls += 1
    finally:
        M._ORDER_RESIDENT.pop(dev.index, None)
        if resident is not None:
            M._ORDER_RESIDENT[dev.index] = resident
    log(f"K13 edges: {calls} calls (every case of k13_edge_cases with its "
        f"shard counts, as launched and on a grid of at most 3 blocks) "
        f"equal to the plain version, one launch each; "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the meshed lane engine (a window's phases a shard)
# ---------------------------------------------------------------------------

#: the meshed engine's shards on one card, and the (width, window) of
#: the sweeps whose every window is held against the sharded plain
#: versions
MESH_SHARDS = 8
MESH_HOLDS = ((256, None), (64, 32))


def mesh_to_cpu(ss):
    """A copy of a ``SymShards`` on a mesh of CPU shards: the same
    exchange then runs every phase's plain version."""
    from mythril_tpu_torch.parallel.mesh import Mesh, SymShards

    return SymShards(Mesh(["cpu"] * ss.mesh.size),
                     [to_cpu(s) for s in ss.shards], to_cpu(ss.home))


def mesh_clone(ss):
    from mythril_tpu_torch.ops.symstep import FIELDS
    from mythril_tpu_torch.parallel.mesh import SymShards

    def clone(st):
        return st.replace(**{f: getattr(st, f).clone() for f in FIELDS})

    return SymShards(ss.mesh, [clone(s) for s in ss.shards], clone(ss.home))


def mesh_restore(dst, src):
    for a, b in zip(dst.shards + [dst.home], src.shards + [src.home]):
        restore(a, b)
    return dst


def code_to_cpu(cc):
    from mythril_tpu_torch.ops.stepper import CompiledCode

    return CompiledCode(packed=cc.packed.cpu(), size=cc.size)


class MeshSpy:
    """While installed (``with``): the meshed engine's window dispatches
    and escalation retires; with ``hold`` each is held bit for bit (its
    outputs, the whole batch after it, the visited bitmap) against the
    same exchange over a CPU copy of its input, every phase there the
    plain version; with ``keep`` the first window's input and outputs,
    K1's first input and K3's remap's first input (the shards with their
    provisional sids, and the canon) are kept (device copies) for the
    timings."""

    def __init__(self, hold=False, keep=False):
        self.hold, self.keep = hold, keep
        self.windows = self.retires = self.err = 0
        self.k1_steps = self.k1_decides = self.k1_fork_steps = 0
        self.first = self.k1 = self.remap_in = self.canon = None

    def __enter__(self):
        from mythril_tpu_torch.laser import lane_engine as le
        from mythril_tpu_torch.ops import symstep
        from mythril_tpu_torch.parallel import mesh

        self.le, self.sym, self.mesh = le, symstep, mesh
        # K3's remap input is caught in every tree's form
        # (tools/window_turns.py imports older ones): the shards once
        # the window has copied its record sids back (mesh.scatter_home,
        # which the window imports at each call), and K3's canon
        self.orig = (le.window_exec_mesh, le.retire_rows_mesh,
                     symstep.sym_run_mesh, le.dedup_kernel,
                     mesh.scatter_home)
        le.window_exec_mesh, le.retire_rows_mesh = self.window, self.retire
        symstep.sym_run_mesh = self.run
        le.dedup_kernel, mesh.scatter_home = self.dedup, self.scatter
        return self

    def __exit__(self, *exc):
        (self.le.window_exec_mesh, self.le.retire_rows_mesh,
         self.sym.sym_run_mesh, self.le.dedup_kernel,
         self.mesh.scatter_home) = self.orig

    def dedup(self, *a, **kw):
        canon = self.orig[3](*a, **kw)
        if self.keep and self.remap_in is None:
            self.canon = canon.clone()
        return canon

    def scatter(self, ss, names):
        self.orig[4](ss, names)
        if self.keep and self.remap_in is None and "dlog_sid" in names:
            self.remap_in = (mesh_clone(ss), self.canon)

    def run(self, codes, ss, *a, **kw):
        if self.keep and self.k1 is None:
            self.k1 = (codes, mesh_clone(ss), a, kw)
        step0 = int(ss.home.step_no)
        flog0 = int(ss.home.flog_count)
        out = self.orig[2](codes, ss, *a, **kw)
        steps = int(ss.home.step_no) - step0
        # a decide a step, and one more where the run stopped early; the
        # forking steps are the distinct steps of the run's fork-log rows
        self.k1_steps += steps
        self.k1_decides += steps + (steps < a[0])
        flog = ss.home.flog_step[flog0:int(ss.home.flog_count)]
        self.k1_fork_steps += int(flog.unique().numel())
        return out

    def window(self, ss, codes, i32b, u8b, *rest):
        import torch

        cpu = mesh_to_cpu(ss) if self.hold else None
        vis = rest[6]
        first = self.keep and self.first is None
        if first:
            before = mesh_clone(ss)
        out = self.orig[0](ss, codes, i32b, u8b, *rest)
        if first:
            self.first = (before, codes, i32b, u8b, rest, out)
        if self.hold:
            codes_cpu = {torch.device("cpu"): code_to_cpu(codes[ss.device])}
            want = self.orig[0](cpu, codes_cpu, i32b, u8b, *rest[:6],
                                None if vis is None else vis.cpu(), rest[7])
            what = f"meshed window {self.windows}"
            self.err = max(self.err,
                           same_outputs(list(out[2]), list(want[2]), what),
                           same_state(to_cpu(out[0].lanes()),
                                      want[0].lanes(), what))
            if vis is not None and not torch.equal(out[1].cpu(), want[1]):
                raise AssertionError(f"{what}: visited differs")
        self.windows += 1
        return out

    def retire(self, ss, ridx, *floors):
        cpu = mesh_to_cpu(ss) if self.hold else None
        out = self.orig[1](ss, ridx, *floors)
        if self.hold:
            want = self.orig[1](cpu, ridx.cpu(), *floors)
            what = f"meshed retire {self.retires}"
            self.err = max(self.err,
                           same_outputs(list(out[1]), list(want[1]), what),
                           same_state(to_cpu(out[0].lanes()),
                                      want[0].lanes(), what))
        self.retires += 1
        return out


class RemapHold:
    """While installed (``with``): every meshed window's K3 remap
    (``lane_engine.mesh_remap``) held bit for bit against its plain
    version on CPU copies of its input (each shard's four sid planes and
    the canon, copied before the call); counts the calls and the
    provisional sids they met."""

    def __enter__(self):
        from mythril_tpu_torch.laser import lane_engine as le

        self.le, self.orig = le, le.mesh_remap
        self.calls = self.prov = 0
        le.mesh_remap = self.remap
        return self

    def __exit__(self, *exc):
        self.le.mesh_remap = self.orig

    def remap(self, ss, canon):
        import torch

        le = self.le
        before = [{f: getattr(st, f).cpu() for f in le.REMAP_PLANES}
                  for st in ss.shards]
        table = canon.cpu()
        out = self.orig(ss, canon)
        for i, (st, planes) in enumerate(zip(ss.shards, before)):
            d_recs = st.dlog_op.shape[1]
            for f, x in planes.items():
                self.prov += int((x < 0).sum())
                if not torch.equal(getattr(st, f).cpu(),
                                   le._lookup(table, x, d_recs)):
                    raise AssertionError(f"K3's remap, window "
                                         f"{self.calls}: shard {i} ({st.device}) "
                                         f"{f} differs from the plain version")
        self.calls += 1
        return out


def mesh_engine(mesh):
    """``pick_mesh`` answering ``mesh`` (None: the policy's answer):
    the card has one device, so the meshed engine's sweeps are asked
    for over shards of it."""
    from mythril_tpu_torch.laser import lane_engine as le

    orig = le.pick_mesh

    class Use:
        def __enter__(self):
            if mesh is not None:
                le.pick_mesh = lambda width: mesh
            return self

        def __exit__(self, *exc):
            le.pick_mesh = orig

    return Use()


def mesh_phase_times(spy, report, launches):
    """Each new kernel of the meshed window (K1's phases and its fork
    rows a device, K3's remap and K4's rows a device) on the main
    path's first window (K1's phases at its first forking step), each
    timed as one whole call over all shards: wrapper call (CUDA events),
    device (queued behind a spin kernel), plain version (the same
    exchange on a CPU copy) and a byte bound; exact against the plain
    version, the fork rows also through the stage and the land of the
    route a pair without peer access takes (forced on this card, which
    has no copy between cards: ``mesh_cards`` forces that route on
    every pair of cards). ``sym_decide`` is timed as the
    step's whole call (the launch, the one wait and the read of the
    counts: ``ms``) and as its launch alone (``launch_ms``; its device
    time is the kernel's alone). The host's pull and assembly of the
    window's 12 outputs is timed too (``pull_ms``). Fails where the
    window has no step that forks, or a kernel is not launched in its
    timed calls."""
    import statistics

    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep as S

    codes, k1_in = spy.k1[0], spy.k1[1]
    ex, ta = spy.k1[2][1:3]
    dev = k1_in.device
    cpu_codes = {torch.device("cpu"): code_to_cpu(codes[dev])}
    d = k1_in.mesh.size

    def groups(state):
        return S.shard_groups(codes if state.device.type == "cuda"
                              else cpu_codes, state, ex, ta)

    # from K1's first input, the first step at which lanes fork
    for _ in range(spy.k1[2][0]):
        if any(S.decide_groups(groups(k1_in), d)[0]):
            break
        S.sym_run_mesh(codes, k1_in, 1, ex, ta)
    else:
        raise AssertionError("meshed window: no step requests a fork")
    ss = mesh_clone(k1_in)
    n, m = ss.n, ss.per
    home = ss.home
    free_count, flog_count = int(home.free_count), int(home.flog_count)
    step_no = int(home.step_no)
    F = home.flog_parent.shape[0]

    def exec_all(gs, counts):
        navail, off, forks, nf = S.fork_budget(counts[0], free_count,
                                               flog_count, F, n)
        return S.execute_groups(gs, d, off, forks, navail, free_count,
                                flog_count, step_no, nf), nf

    def ready():
        """the input restored, its groups made and decided"""
        mesh_restore(ss, k1_in)
        gs = groups(ss)
        return gs, S.decide_groups(gs, d)

    gs, counts = ready()
    running = sum(counts[1])
    dec_bytes = S._k1_mesh()[2]
    cpu = mesh_to_cpu(k1_in)
    t0 = time.perf_counter()
    cgs = groups(cpu)
    ccounts = S.decide_groups(cgs, d)
    plain_decide = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cstash, cnf = exec_all(cgs, ccounts)
    plain_exec = (time.perf_counter() - t0) * 1e3
    if counts != ccounts:
        raise AssertionError(f"sym_decide: counts {counts} != {ccounts}")
    stashes, nf = exec_all(gs, counts)
    if not nf or nf != cnf:
        raise AssertionError(f"meshed window: the forking step forks "
                             f"{nf} (plain {cnf}; requests {counts[0]})")
    t0 = time.perf_counter()
    S._PlainForks(cpu, cgs).run(cstash, cnf, free_count, flog_count)
    plain_forks = (time.perf_counter() - t0) * 1e3
    forker = S._CudaForks(ss, gs)
    forker.run(stashes, nf, free_count, flog_count)
    torch.cuda.synchronize()
    err = same_state(to_cpu(ss.lanes()), cpu.lanes(), "K1 a device, a step")
    for (a, _, k), (b, _, _) in zip(stashes, cstash):
        err = max(err, max_err(a[:, :k].cpu(), b[:, :k]))
    # the stage and land of the route a pair without peer access takes,
    # forced on this card: the same planes
    gs2, counts2 = ready()
    stashes2, _ = exec_all(gs2, counts2)
    staged = S._CudaForks(ss, gs2, route=lambda dst, src: "copy")
    staged.run(stashes2, nf, free_count, flog_count)
    torch.cuda.synchronize()
    err = max(err, same_state(to_cpu(ss.lanes()), cpu.lanes(),
                              "the fork rows staged (no peer access)"))
    st0 = ss.shards[0]
    row_bytes = sum(getattr(st0, f)[0].nbytes for f in S.FORK_PLANES)
    # each fork: its parent's row read and its child's written, the
    # child's pc, fentry and record count, 8 stash words read, 7 fork-log
    # words written, a free slot read
    fork_bytes = nf * (2 * row_bytes + 12 + 32 + 28 + 4)
    child = S.child_slots(k1_in.home.free_slots.cpu(), free_count, nf, n)
    log(f"  sym_fork_rows at the first forking step: {nf} forks of "
        f"{row_bytes} bytes a row, children in shards "
        f"{sorted(set((child // m).tolist()))}; equal to the plain "
        f"version, also staged")

    def timed_exec(x):
        exec_all(*x)

    def timed_forks(x):
        x[0].run(x[1], nf, free_count, flog_count)

    def forks_setup():
        g, c = ready()
        return S._CudaForks(ss, g), exec_all(g, c)[0]

    mesh_restore(ss, k1_in)
    decided = groups(ss)
    stream = _build.stream(dev)

    def launch_decide(_=None):
        with torch.cuda.device(dev):
            for g in decided:
                g.launch_decide(stream)

    # the launch alone, on CUDA events and queued (the kernel's time)
    before = _build.LAUNCHES["sym_decide"]
    launch = cuda_ms(launch_decide, reps=5)
    kernel = queued_ms(launch_decide, lambda: None, reps=5)
    if _build.LAUNCHES["sym_decide"] <= before:
        raise AssertionError("sym_decide: not launched in its timed calls")
    rows = {
        "sym_decide": (lambda: S.decide_groups(decided, d), None,
                       plain_decide, n * (4 + dec_bytes), kernel, None),
        "sym_exec": (timed_exec, ready, plain_exec,
                     n * (dec_bytes + 96) + running * 16, None, None),
        "sym_fork_rows": (timed_forks, forks_setup, plain_forks,
                          fork_bytes, None, None),
    }
    # K3's remap (a launch a device) on the main path's first window's
    # input to it, whose sid planes still hold this window's provisional
    # sids; K4's rows on that window's end state
    before, wcodes, i32b, u8b, rest, out = spy.first
    ss_end = out[0]
    ridx, hidx = out[2].home[4], out[2].home[8]
    end = mesh_clone(ss_end)
    remap_src, canon = spy.remap_in
    sids = [getattr(st, f) for st in remap_src.shards
            for f in le.REMAP_PLANES]
    prov = torch.cat([x[x < 0] for x in sids])
    if not prov.numel():
        raise AssertionError("K3's remap: the first window's input holds "
                             "no provisional sid")
    remap_in = mesh_clone(remap_src)
    cpu_in = mesh_to_cpu(remap_in)
    t0 = time.perf_counter()
    le.mesh_remap_plain(cpu_in, canon.cpu())
    plain_remap = (time.perf_counter() - t0) * 1e3
    before_remap = _build.LAUNCHES["window_remap"]
    le.mesh_remap_kernel(remap_in, canon)
    if _build.LAUNCHES["window_remap"] - before_remap != 1:
        raise AssertionError("K3's remap over one card's shards: not one "
                             "launch")
    err = max(err, same_state(to_cpu(remap_in.lanes()), cpu_in.lanes(),
                              "K3's remap, a launch a device"))
    log(f"  window_remap on the first window's input: {prov.numel()} "
        f"provisional sids ({prov.unique().numel()} distinct) in "
        f"{sum(x.numel() for x in sids)} words, one launch, equal to the "
        f"plain version")
    plain_in = mesh_to_cpu(end)
    t0 = time.perf_counter()
    plain_end, prow = le.mesh_rows_plain(plain_in, ridx.cpu(), hidx.cpu())
    prow = prow.start_pull()()
    plain_rows = (time.perf_counter() - t0) * 1e3
    rows_in = mesh_clone(end)
    _, krow = le.mesh_rows_kernel(end, ridx, hidx)
    err = max(err, same_outputs([torch.from_numpy(x) for x in
                                 krow.start_pull()()],
                                [torch.from_numpy(x) for x in prow],
                                "K4's rows, a launch a device"),
              same_state(to_cpu(end.lanes()), plain_end.lanes(),
                         "K4's rows, a launch a device"))
    # the host's pull and assembly of the window's 12 outputs
    pulls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[2].start_pull()()
        pulls.append((time.perf_counter() - t0) * 1e3)
    pull_ms = statistics.median(pulls)
    log(f"  a meshed window's 12 outputs pulled and assembled on the host "
        f"(MeshOutputs.start_pull()()): median {pull_ms:.4f} ms of 5")
    st0 = end.shards[0]
    # the four sid planes read once, each provisional sid written, the
    # canon's entry of each distinct one read
    remap_bytes = 4 * (sum(x.numel() for x in sids) + prov.numel()
                       + prov.unique().numel())
    row_out = sum(x.nbytes for x in prow)

    def remap_all(x):
        le.mesh_remap_kernel(x, canon)

    def remap_setup():
        """the input restored: the provisional sids back in place"""
        for a, b in zip(remap_in.shards, remap_src.shards):
            for f in le.REMAP_PLANES:
                getattr(a, f).copy_(getattr(b, f))
        return remap_in

    def rows_all(x):
        le.mesh_rows_kernel(x, ridx, hidx)

    def rows_setup():
        return mesh_restore(end, rows_in)

    # the library's K4 rows a shard, as row 7 times them: index_select of
    # each plane's columns a row reads (the retired rows' clipped ones,
    # the resumed rows' whole stack and ssid rows), index_fill_ of the
    # shard's retired lanes' status; the indices made beforehand
    ws, wm, wl, wk = le._retire_widths(st0, *le.RETIRE_FLOORS)
    hl = min(le.RESUME_MLOG, st0.mlog_off.shape[1])
    hm = min(le.RESUME_MEM, st0.memory.shape[1])
    lib_idx = []
    for i in range(d):
        rl = ridx.long() - i * m
        lib_idx.append((rl.clamp(0, m - 1), rl[(rl >= 0) & (rl < m)],
                        (hidx.long() - i * m).clamp(0, m - 1)))

    def rows_library(_=None):
        for st, (rc, real, hc) in zip(end.shards, lib_idx):
            for x, w in ((st.pc, 0), (st.sp, 0), (st.depth, 0),
                         (st.fentry, 0), (st.last_jump, 0), (st.msize, 0),
                         (st.mlog_count, 0), (st.scount, 0),
                         (st.min_gas, 0), (st.max_gas, 0),
                         (st.mlog_off, wl), (st.mlog_len, wl),
                         (st.mlog_sid, wl), (st.ssid, ws),
                         (st.sval_sid, wk), (st.s_written, wk),
                         (st.s_read, wk), (st.skey_sid, wk),
                         (st.s_wstep, wk), (st.stack, ws), (st.skeys, wk),
                         (st.svals, wk), (st.memory, wm), (st.mkind, wm)):
                (x.narrow(1, 0, w) if w else x).index_select(0, rc)
            for x, w in ((st.msize, 0), (st.min_gas, 0), (st.max_gas, 0),
                         (st.gas_limit, 0), (st.mlog_count, 0),
                         (st.ssid, 0), (st.stack, 0), (st.mlog_off, hl),
                         (st.mlog_len, hl), (st.mlog_sid, hl),
                         (st.memory, hm), (st.mkind, hm)):
                (x.narrow(1, 0, w) if w else x).index_select(0, hc)
            st.status.index_fill_(0, real, S.DEAD)

    rows.update({
        "window_remap": (remap_all, remap_setup, plain_remap, remap_bytes,
                         None, None),
        "window_rows": (rows_all, rows_setup, plain_rows, 2 * row_out,
                        None, rows_library),
    })
    for name, (fn, setup, plain, nbytes, dms, lib) in rows.items():
        before = _build.LAUNCHES[name]
        ms = cuda_ms(fn, reps=3, setup=setup)
        if dms is None:
            dms = queued_ms(fn if setup else (lambda _: fn()),
                            setup or (lambda: None))
        if _build.LAUNCHES[name] <= before:
            raise AssertionError(f"{name}: not launched in its timed calls")
        b, by = bound_ms(nbytes)
        lib_ms = None if lib is None else round(cuda_ms(lib, reps=3), 4)
        report[name] = dict(max_abs_err=err, ms=round(ms, 4),
                            plain_ms=round(plain, 2),
                            device_ms=round(dms, 4), bound_ms=round(b, 6),
                            bound_by=by, library_ms=lib_ms)
        log(f"  {name} (all {len(ss.shards)} shards, main path's first "
            f"window): call {ms:.4f} ms, device {dms:.4f} ms, plain "
            f"{plain:.2f} ms, bound {b:.6f} ms ({by}), library {lib_ms} "
            f"ms, {launches[name]} launches on the main path")
    report["window_rows"]["pull_ms"] = round(pull_ms, 4)
    report["sym_decide"]["launch_ms"] = round(launch, 4)
    log(f"  sym_decide's launch alone (no wait, no read): call "
        f"{launch:.4f} ms; its call above is the step's whole decide")
    return err


def check_mesh_engine(dev, card, report, host_open=None):
    """The meshed lane engine on one card: first every window and
    escalation retire of the k=12 contract's sweeps at MESH_HOLDS's
    widths over MESH_SHARDS shards of this card held bit for bit against
    the same exchange over CPU copies (each phase's plain version), and
    K9 a shard on its end state against its plain version and against
    K9 over the gathered batch; then the main path: every path of the
    k=12 contract through the port's SymExecWrapper at MAIN_LANES lanes
    with the engine over MESH_SHARDS shards (counts reset before, read
    after: K1's phases, a launch each a K1 step, its fork rows a launch
    a forking step, K2, K3, its remap a launch a window, K4, its rows a
    launch a window or escalation retire, each launched), its open states
    equal to the unsharded engine's (run just before it, timed) and to
    the host-only run's; then the new kernels' times on its first
    window. Returns the main path's launches."""
    from copy import deepcopy

    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.parallel.mesh import Mesh
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    mesh = Mesh([dev] * MESH_SHARDS)
    code, paths = build_symbolic_contract(MAIN_K)
    if le.pick_mesh(MAIN_LANES) is not None:
        raise AssertionError("pick_mesh: a mesh on a one-card machine")
    # the holds: a sweep through the engine at each of MESH_HOLDS
    from mythril_tpu_torch.laser.lane_engine import LaneEngine
    from mythril_tpu_torch.support.runs import entry_states

    def sig(gs):
        return (gs.mstate.pc, tuple(map(repr, gs.mstate.stack)),
                tuple(map(repr, gs.world_state.constraints)),
                gs.mstate.min_gas_used, gs.mstate.max_gas_used)

    entries = entry_states(code.hex())
    for lanes, window in MESH_HOLDS:
        le._STATE_POOL.clear()
        with MeshSpy(hold=True) as spy:
            eng = LaneEngine(n_lanes=lanes, window=window, mesh=mesh)
            parked = eng.explore(code, deepcopy(entries))
        one = LaneEngine(n_lanes=lanes, window=window)
        want = one.explore(code, deepcopy(entries))
        if list(map(sig, parked)) != list(map(sig, want)) \
                or eng.stats["windows"] != one.stats["windows"] \
                or eng.stats["forks"] != one.stats["forks"]:
            raise AssertionError(f"meshed sweep at {lanes} lanes: "
                                 f"{len(parked)} states, {eng.stats} "
                                 f"against the unsharded engine's "
                                 f"{len(want)}, {one.stats}")
        log(f"meshed engine held: {spy.windows} windows and "
            f"{spy.retires} escalation retires of the k={MAIN_K} sweep "
            f"at {lanes} lanes (window {eng.window}) over {MESH_SHARDS} "
            f"shards of this card equal to the sharded plain versions "
            f"(outputs, batch, visited); {len(parked)} states, "
            f"{eng.stats['windows']} windows, {eng.stats['forks']} "
            f"forks, as the unsharded engine")
    # K9 a shard on a held end state: a mesh window's end state of the
    # main path is taken below; here the engine's pooled batch
    ss = le._STATE_POOL[eng._shape_key()][-1]
    pairs = [le._prov_pairs(eng._prov, eng.n_lanes,
                            eng.lane_kwargs.get("dlog_records", 64), s.device)
             for s in ss.shards]
    fp = torch.cat([le.merge_fingerprint(s, p, ss.n)
                    for s, p in zip(ss.shards, pairs)]).cpu()
    cpu = mesh_to_cpu(ss)
    fp_plain = torch.cat([le.merge_fingerprint(s, p.cpu(), ss.n)
                          for s, p in zip(cpu.shards, pairs)])
    fp_whole = le.merge_fingerprint(ss.lanes(), pairs[0]).cpu()
    err = max(max_err(fp, fp_plain), max_err(fp, fp_whole))
    if err:
        raise AssertionError("K9 a shard differs")
    log(f"K9 a shard ({MESH_SHARDS} launches) equal to its plain version "
        f"and to K9 over the gathered batch")

    # the main path: unsharded, then meshed, each timed (runs.explore
    # leaves the lane width at 0: the later phases get theirs back)
    from mythril_tpu_torch.support.support_args import args

    lanes = args.tpu_lanes
    le.PATH_HISTORY[code] = paths
    torch.cuda.synchronize()
    n_one, _, wall_one = runs.explore(code, MAIN_LANES)
    le._STATE_POOL.clear()
    torch.cuda.synchronize()
    _build.reset_launches()
    with mesh_engine(mesh), MeshSpy(keep=True) as spy:
        n_mesh, stats, wall = runs.explore(code, MAIN_LANES)
        torch.cuda.synchronize()
    args.tpu_lanes = lanes
    launches = dict(_build.LAUNCHES)
    new = ("sym_decide", "sym_exec", "sym_fork_rows", "window_remap",
           "window_rows", "window_prologue", "window_dedup",
           "window_epilogue", "sym_init")
    missing = [k for k in new if launches[k] <= 0]
    # one launch a device a step (the card is one device): a decide a
    # step and at the step that finds no lane running, an exec a step
    if launches["sym_decide"] != spy.k1_decides \
            or launches["sym_exec"] != spy.k1_steps:
        raise AssertionError(f"meshed main path: {launches['sym_decide']} "
                             f"sym_decide and {launches['sym_exec']} "
                             f"sym_exec launches for {spy.k1_steps} K1 "
                             f"steps ({spy.k1_decides} decides)")
    # and one fork-rows launch a forking K1 step, one remap launch a
    # window, one rows launch a window or escalation retire
    if launches["sym_fork_rows"] != spy.k1_fork_steps \
            or launches["window_remap"] != spy.windows \
            or launches["window_rows"] != spy.windows + spy.retires:
        raise AssertionError(f"meshed main path: {launches['sym_fork_rows']}"
                             f" sym_fork_rows launches for "
                             f"{spy.k1_fork_steps} forking K1 steps, "
                             f"{launches['window_remap']} window_remap and "
                             f"{launches['window_rows']} window_rows for "
                             f"{spy.windows} windows and {spy.retires} "
                             f"escalation retires")
    if missing or launches["sym_run"]:
        raise AssertionError(f"meshed main path: launches {launches} "
                             f"(none of {missing}; the unsharded K1 "
                             f"{launches['sym_run']})")
    if n_mesh != n_one or (host_open is not None and n_mesh != host_open) \
            or n_mesh != paths:
        raise AssertionError(f"meshed main path: {n_mesh} open states, "
                             f"unsharded {n_one}, host-only {host_open}")
    log(f"meshed main path k={MAIN_K} at {MAIN_LANES} lanes over "
        f"{MESH_SHARDS} shards of this card: {n_mesh} open states (the "
        f"unsharded engine's {n_one}, host-only {host_open}), "
        f"{stats['windows']} windows, {stats['forks']} forks, "
        f"{stats['device_steps']} device steps, {spy.k1_steps} K1 steps "
        f"(one sym_decide and one sym_exec launch a step), "
        f"{spy.k1_fork_steps} forking (one sym_fork_rows launch each), "
        f"{spy.windows} windows (one window_remap launch each) and "
        f"{spy.retires} escalation retires (one window_rows launch each "
        f"and a window's); explore "
        f"{wall:.3f} s "
        f"({paths / wall:.1f} paths/s), unsharded {wall_one:.3f} s "
        f"({paths / wall_one:.1f} paths/s) on {card}; launches "
        f"{ {k: launches[k] for k in new} }")
    report["mesh_explore_s"] = round(wall, 3)
    report["one_explore_s"] = round(wall_one, 3)
    mesh_phase_times(spy, report, launches)
    return launches


# ---------------------------------------------------------------------------
# the concolic command
# ---------------------------------------------------------------------------

def branchy_code():
    """if calldata[0:32] == 42: storage[1] = 1 else storage[1] = 2 (the
    contract of tests/test_concolic.py): (runtime hex, the JUMPI's
    address, the then-branch's JUMPDEST)."""
    from mythril_tpu_torch.support.opcodes import ADDRESS, OPCODES

    op = {name: d[ADDRESS] for name, d in OPCODES.items()}

    def push(v):
        return bytes([op["PUSH1"], v])

    c = bytearray(push(0) + bytes([op["CALLDATALOAD"]]))
    c += push(42) + bytes([op["EQ"]])
    at = len(c) + 1
    c += push(0) + bytes([op["JUMPI"]])
    jumpi = len(c) - 1
    c += push(2) + push(1) + bytes([op["SSTORE"], op["STOP"]])
    then = len(c)
    c += bytes([op["JUMPDEST"]]) + push(1) + push(1)
    c += bytes([op["SSTORE"], op["STOP"]])
    c[at] = then
    return c.hex(), jumpi, then


def concrete_data(code_hex, tx_input="00" * 32):
    contract = "0x" + "aa" * 20
    return {"initialState": {"accounts": {contract: {
        "balance": "0x0", "code": code_hex, "nonce": 0, "storage": {}}}},
        "steps": [{"address": contract, "origin": "0x" + "bb" * 20,
                   "input": tx_input, "gasLimit": "0x7ffffff"}]}


def concolic_path(card):
    """``python3 -m mythril_tpu_torch concolic FILE --branches JUMPI`` on
    this card (the lane engine at its default width): it prints the one
    flipped transaction sequence, whose solved input is 42, and that
    input, replayed concretely (``concolic.find_trace``), takes the
    branch the original input did not."""
    import tempfile

    from mythril_tpu_torch.concolic.find_trace import concrete_execution

    code_hex, jumpi, then = branchy_code()
    _, trace0 = concrete_execution(concrete_data(code_hex))
    if then in trace0[0] or jumpi not in trace0[0]:
        raise AssertionError(f"concolic: the original trace {trace0[0]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "concrete.json")
        with open(path, "w") as f:
            json.dump(concrete_data(code_hex), f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mythril_tpu_torch", "concolic", path,
             "--branches", str(jumpi)], cwd=HERE, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"concolic exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout)
    new_input = out[0]["steps"][-1]["input"] if len(out) == 1 else ""
    if len(out) != 1 or int(new_input[2:66] or "0", 16) != 42:
        raise AssertionError(f"concolic: the branch was not flipped: {out}")
    _, trace1 = concrete_execution(concrete_data(code_hex, new_input[2:]))
    if then not in trace1[0]:
        raise AssertionError(f"concolic: the solved input {new_input} "
                             f"replays {trace1[0]}")
    log(f"concolic: python3 -m mythril_tpu_torch concolic flipped the "
        f"JUMPI at {jumpi} in {wall:.1f} s; the solved input (42), "
        f"replayed, takes the branch at {then} on {card}")


def mesh_path(dev, card, report):
    """The scale-out path (``parallel/mesh.py``) at full width:
    ``bench_device``'s batch (32768 lanes of 1324 bytes) on a mesh of 8
    shards of this card. First K12-K14 against their plain versions on
    the batch after MESH_STEPS steps (mixed statuses: the live counts,
    the order with no deal and with the deal over 8 shards, the gather
    through both orders and through a seeded order with negative and
    out-of-range entries). Then the main path, counts reset:
    ``sharded_run`` to the end, equal on every plane to one unsharded
    K10 run; a fresh batch through MESH_STEPS sharded steps (equal to
    the unsharded K10 run of as many), ``live_lane_counts``,
    ``compact_lanes`` and ``steal_balance`` equal to their plain
    versions, the balanced shards' RUNNING counts within 1 of each
    other, and the balanced shards run to the end equal to the
    unsharded run in the dealt order; ``make_mesh()`` (the card's
    devices) equal to K10 alone; then one ``steal_balance`` of 131072
    lanes at ``init_lanes``' default planes (11212 bytes a lane) after
    WIDE_MESH_STEPS steps of the lane mix contract, equal to the plain
    version. Times: K12-K14 on the 32768-lane batch (report) and on
    the 131072-lane one (``wide_*`` keys). Returns the main path's
    launches."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support import contracts as C

    cc = S.compile_code(C.build_bench_contract(), device=dev)
    cap = C.BENCH_MAX_STEPS
    mesh = M.Mesh([dev] * MESH_SHARDS)
    ref = S.run_kernel(cc, C.bench_batch(MESH_LANES, dev), cap)
    mid = S.run_kernel(cc, C.bench_batch(MESH_LANES, dev), MESH_STEPS)
    n_run = int((mid.status == S.Status.RUNNING).sum())
    if not 0 < n_run < MESH_LANES:
        raise AssertionError(f"mesh: {n_run} lanes running after "
                             f"{MESH_STEPS} steps")

    # K12-K14 against the plain versions on the mixed batch
    g = torch.Generator().manual_seed(SEED)
    wild = torch.randint(-2 * MESH_LANES, 2 * MESH_LANES, (MESH_LANES // 2,),
                         generator=g, dtype=torch.int32).to(dev)
    err = {"lane_live": 0, "lane_order": 0, "lane_gather": 0}
    for n_dev in (1, MESH_SHARDS):
        err["lane_live"] = max(err["lane_live"], max_err(
            M.lane_live(mid.status, n_dev),
            M.lane_live_plain(mid.status, n_dev)))
        order = M.lane_order(mid.status, n_dev)
        err["lane_order"] = max(err["lane_order"], max_err(
            order, M.lane_order_plain(mid.status, n_dev)))
        if err["lane_live"] or err["lane_order"]:
            raise AssertionError(f"mesh: K12/K13 differ from the plain "
                                 f"versions ({err})")
        for o in (order, wild):
            err["lane_gather"] = max(err["lane_gather"], same_lanes(
                M.lane_gather(mid, o), M.lane_gather_plain(mid, o),
                f"K14 ({len(o)} rows, {n_dev} shards)"))
    # K14's edges: an empty order, more rows than lanes (negative and
    # out-of-range entries), and the one allocation of its output
    longer = torch.randint(-MESH_LANES - 9, MESH_LANES + 9,
                           (MESH_LANES * 3 // 2,), generator=g,
                           dtype=torch.int32).to(dev)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    for o in (empty, longer):
        same_lanes(M.lane_gather(mid, o), M.lane_gather_plain(mid, o),
                   f"K14 ({len(o)} rows of {MESH_LANES})")
    got = M.lane_gather(mid, wild)
    spans = sorted((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size())
                   for x in (getattr(got, f) for f in S.LANE_FIELDS))
    stores = {getattr(got, f).untyped_storage().data_ptr()
              for f in S.LANE_FIELDS}
    if len(stores) != 1 or any(a % 16 for a, _ in spans) or any(
            spans[i][1] > spans[i + 1][0] for i in range(len(spans) - 1)):
        raise AssertionError(f"K14: output planes are not disjoint 16-byte "
                             f"aligned views of one allocation ({spans})")
    log(f"mesh kernels: K12 lane_live, K13 lane_order (with and without "
        f"the deal over {MESH_SHARDS} shards) and K14 lane_gather (both "
        f"orders, {len(wild)} seeded rows with negative and out-of-range "
        f"entries, an empty order and {len(longer)} rows of "
        f"{MESH_LANES}) equal to their plain versions on {MESH_LANES} "
        f"lanes ({n_run} running); K14's planes are disjoint 16-byte "
        f"aligned views of one allocation")

    check_k12_edges(dev)
    check_k13_edges(dev)

    # the main path
    _build.reset_launches()
    whole = M.sharded_run(cc, M.shard_lanes(C.bench_batch(MESH_LANES, dev),
                                            mesh), cap, mesh)
    same_lanes(whole.lanes(), ref, "sharded_run against one K10 run")
    sh = M.shard_lanes(C.bench_batch(MESH_LANES, dev), mesh)
    M.sharded_run(M.replicate_code(cc, mesh), sh, MESH_STEPS, mesh)
    same_lanes(sh.lanes(), mid, f"sharded_run of {MESH_STEPS} steps")
    per, total = M.live_lane_counts(sh, mesh)
    want = M.lane_live_plain(mid.status, MESH_SHARDS).cpu().numpy()
    if per.tolist() != want.tolist() or total != n_run:
        raise AssertionError(f"live_lane_counts {per} {total}, plain {want}")
    packed = M.compact_lanes(sh)
    same_lanes(packed, M.lane_gather_plain(
        mid, M.lane_order_plain(mid.status, 1)), "compact_lanes")
    dealt = M.lane_order_plain(mid.status, MESH_SHARDS)
    bal = M.steal_balance(sh, mesh)
    same_lanes(bal.lanes(), M.lane_gather_plain(mid, dealt),
               "steal_balance")
    per_b, total_b = M.live_lane_counts(bal, mesh)
    if total_b != n_run or int(per_b.max()) - int(per_b.min()) > 1:
        raise AssertionError(f"steal_balance: running per shard {per_b}")
    M.sharded_run(cc, bal, cap, mesh)
    same_lanes(bal.lanes(), M.lane_gather_plain(ref, dealt),
               "the balanced shards run to the end")
    # the card's own devices (one here; several cards are a mesh of
    # distinct devices, whose shards are copies, not views)
    real = M.make_mesh()
    alone = M.sharded_run(cc, M.shard_lanes(C.bench_batch(MESH_LANES, dev),
                                            real), cap, real)
    same_lanes(alone.lanes(), ref, "make_mesh() against K10 alone")
    alone = M.sharded_run(cc, M.shard_lanes(C.bench_batch(MESH_LANES, dev),
                                            real), MESH_STEPS, real)
    same_lanes(alone.lanes(), mid, "make_mesh(): the partial run")
    per_r, _ = M.live_lane_counts(alone, real)
    if per_r.tolist() != M.lane_live_plain(mid.status, real.size).tolist():
        raise AssertionError(f"make_mesh(): live counts {per_r}")
    same_lanes(M.compact_lanes(alone), packed, "make_mesh(): compact_lanes")
    same_lanes(M.steal_balance(alone, real).lanes(), M.lane_gather_plain(
        mid, M.lane_order_plain(mid.status, real.size)),
        "make_mesh(): steal_balance")
    del whole, sh, packed, bal, alone

    wcc = S.compile_code(C.build_lane_mix_contract(), device=dev)
    wide = C.lane_mix_batch(WIDE_MESH_N, SEED, device=dev)
    S.run_kernel(wcc, wide, WIDE_MESH_STEPS)
    w_run = int((wide.status == S.Status.RUNNING).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wbal = M.steal_balance(M.shard_lanes(wide, mesh), mesh)
    torch.cuda.synchronize()
    w_wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    same_lanes(wbal.lanes(), M.lane_gather_plain(
        wide, M.lane_order_plain(wide.status, MESH_SHARDS)),
        f"steal_balance at {WIDE_MESH_N} lanes")
    w_per, _ = M.live_lane_counts(wbal, mesh)
    if int(w_per.max()) - int(w_per.min()) > 1 or not 0 < w_run < WIDE_MESH_N:
        raise AssertionError(f"wide steal_balance: {w_run} running, per "
                             f"shard {w_per}")
    del wbal
    for name in ("lane_live", "lane_order", "lane_gather"):
        if launches[name] <= 0:
            raise AssertionError(f"mesh path: {name} never launched "
                                 f"({launches})")
    # three live_lane_counts calls, each over shards on one device
    if launches["lane_live"] != 3:
        raise AssertionError(f"mesh path: {launches['lane_live']} K12 "
                             f"launches for 3 calls on one device")
    log(f"mesh path ({MESH_LANES} lanes, {MESH_SHARDS} shards on {dev}): "
        f"sharded_run equal to one K10 run on every plane; after "
        f"{MESH_STEPS} steps {total} running, per shard {per.tolist()}, "
        f"after steal_balance {per_b.tolist()}; compact_lanes and "
        f"steal_balance equal to the plain versions; the balanced shards "
        f"finish as the unsharded run; make_mesh() ({real.size} device) "
        f"equal to K10 alone; steal_balance of {WIDE_MESH_N} lanes of "
        f"{S.lane_bytes(wide)} bytes ({S.lane_bytes(wide) * WIDE_MESH_N} "
        f"bytes of planes, {w_run} running) in {w_wall * 1e3:.3f} ms of "
        f"host wall (its output's first allocation included), per "
        f"shard {w_per.tolist()}; launches "
        f"{ {k: launches[k] for k in err} } on {card}")

    fresh = lambda: C.bench_batch(MESH_LANES, dev)  # noqa: E731
    one_ms = cuda_ms(lambda x: S.run_kernel(cc, x, cap), reps=3, setup=fresh)
    sharded = lambda x: M.sharded_run(  # noqa: E731
        cc, M.shard_lanes(x, mesh), cap, mesh)
    sharded_ms = cuda_ms(sharded, reps=3, setup=fresh)
    sharded_dms = queued_ms(sharded, fresh, reps=3)
    one_dms = queued_ms(lambda x: S.run_kernel(cc, x, cap), fresh, reps=3)
    log(f"  sharded_run of the {MESH_LANES}-lane batch to the end: "
        f"{sharded_ms:.4f} ms on {MESH_SHARDS} shards ({MESH_SHARDS} K10 "
        f"launches in turn on one stream; {sharded_dms:.4f} ms on the "
        f"device) against {one_ms:.4f} ms for one K10 run ({one_dms:.4f} "
        f"ms on the device); on {card}")
    times = mesh_kernel_times(dev, mid, MESH_SHARDS, reps=20)
    wide_times = mesh_kernel_times(dev, wide, MESH_SHARDS, reps=3)
    for name, t in times.items():
        w = wide_times[name]
        report[name] = dict(t, max_abs_err=err[name],
                            **{f"wide_{k}": w[k] for k in
                               ("ms", "device_ms", "plain_ms", "library_ms",
                                "bound_ms", "copy_device_ms", "counts_ms",
                                "counts_library_ms", "floor_device_ms")
                               if k in w})
        log(f"  {name}: {MESH_LANES} lanes {t['ms']:.4f} ms a call, "
            f"{t['device_ms']:.4f} ms device, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms; {WIDE_MESH_N} lanes {w['ms']:.4f} "
            f"ms a call, {w['device_ms']:.4f} ms device, bound "
            f"{w['bound_ms']:.6f} ms, plain {w['plain_ms']:.4f} ms, library "
            f"{w['library_ms']:.4f} ms; on {card}"
            + (f"; a contiguous copy of as many bytes {t['copy_device_ms']:.4f}"
               f" and {w['copy_device_ms']:.4f} ms device"
               if "copy_device_ms" in t else "")
            + (f"; live_lane_counts {t['counts_ms']:.4f} and "
               f"{w['counts_ms']:.4f} ms a call (the library's sum and a "
               f"pageable pull {t['counts_library_ms']:.4f} and "
               f"{w['counts_library_ms']:.4f}); an empty kernel queued "
               f"{t['floor_device_ms']:.4f} and {w['floor_device_ms']:.4f} "
               f"ms device" if "counts_ms" in t else ""))
    del wide, mid, ref
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

def main_path_state(dev, n=MAIN_LANES):
    """The k=12 main path's n-lane state (4096: the symbolic path's; 64:
    the corpus's) after its first window (one fresh transaction entry,
    window 256), and that window's resolution pairs: each canonical
    record gets the next object id, as the engine's drain assigns them,
    padded to ``PROV_BUCKET`` rows."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep
    from mythril_tpu_torch.ops.stepper import compile_code
    from mythril_tpu_torch.support import device_loop
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

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


def hold_k9(st, pairs, what):
    """K9 on (st, pairs) against its plain version, bit for bit; its
    CUDA launches must be its plan's (one where the pairs fit its
    shared hash). Returns the launches."""
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le

    before = _build.LAUNCHES["merge_fingerprint"]
    got = le.merge_fingerprint_kernel(st, pairs)
    launches = _build.LAUNCHES["merge_fingerprint"] - before
    err = max_err(got, le.merge_fingerprint_plain(st, pairs))
    if err:
        raise AssertionError(f"K9 merge_fingerprint: {what} differs "
                             f"(max {err})")
    plan = le.merge_fp_plan(st.pc.shape[0], pairs.shape[0],
                            st.stack.shape[1], st.skeys.shape[1],
                            _build.device_limits(st.device)[1])
    if launches != plan["launches"]:
        raise AssertionError(f"K9 {what}: {launches} CUDA launches, its "
                             f"plan {plan}")
    return launches


def k9_times(st, pairs, reps=5):
    """(call ms on CUDA events, device ms queued behind a spin kernel
    after an L2 flush) of K9 on (st, pairs)."""
    from mythril_tpu_torch.laser import lane_engine as le

    call = lambda _=None: le.merge_fingerprint_kernel(st, pairs)  # noqa
    return (cuda_ms(call, reps=reps),
            queued_ms(call, lambda: None, reps=reps))


def check_merge_fp(dev, report):
    """K9 against its plain version, bit for bit, with its plan's CUDA
    launches: on the main path's state after a window at 4096 lanes and
    at the corpus's 64, on two seeded random states (past its shared
    hash: the dense table) and on ``device_loop.k9_edge_cases``; times
    at 4096 and 64 lanes."""
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.support import device_loop

    st, pairs, ucount = main_path_state(dev)
    hold_k9(st, pairs, "main path state")
    small, spairs, _ = main_path_state(dev, 64)
    k64 = hold_k9(small, spairs, "the corpus's 64-lane state")
    for seed in (SEED, SEED + 1):
        rs, rp = random_merge_state(dev, seed)
        hold_k9(rs, rp, f"random state {seed}")
    edges = []
    for case in device_loop.k9_edge_cases():
        cst, cpairs = device_loop.k9_case_inputs(case, dev)
        edges.append(f"{case.name}: {hold_k9(cst, cpairs, case.name)}")
    k_ms, d_ms = k9_times(st, pairs)
    k64_ms, d64_ms = k9_times(small, spairs)
    p_ms = cuda_ms(lambda: le.merge_fingerprint_plain(st, pairs), reps=1)
    nbytes = merge_bytes(st, pairs)
    bms, by = bound_ms(nbytes)
    b64, _ = bound_ms(merge_bytes(small, spairs))
    report["merge_fingerprint"] = dict(
        max_abs_err=0, ms=k_ms, plain_ms=p_ms, device_ms=d_ms,
        bound_ms=bms, bound_by=by, lanes64_ms=k64_ms,
        lanes64_device_ms=d64_ms, lanes64_bound_ms=b64)
    log(f"K9 merge_fingerprint: equal on the main path's state after a "
        f"window ({ucount} records resolved), at 64 lanes, on 2 random "
        f"states and on k9_edge_cases (CUDA launches a call: "
        f"{', '.join(edges)}; at the corpus's 64 lanes with "
        f"{spairs.shape[0]} pairs: {k64}); 4096 lanes {k_ms:.4f} ms a call, "
        f"{d_ms:.4f} ms device, bound {bms:.6f} ms ({nbytes} bytes); 64 "
        f"lanes {k64_ms:.4f} ms a call, {d64_ms:.4f} ms device, bound "
        f"{b64:.6f} ms; plain {p_ms:.1f} ms")


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
    missing = [name for name, *_ in ROWS + [("sym_run",)]
               if launches[name] <= 0]
    if missing:
        raise AssertionError(f"symbolic path never launched {missing}")
    if not stats.get("windows") or not stats.get("device_steps"):
        raise AssertionError(f"symbolic path: the engine ran no window "
                             f"({stats})")
    log(f"symbolic path k={MAIN_K} at {MAIN_LANES} lanes: {n_open} open "
        f"states, {stats['windows']} windows, {stats['forks']} forks, "
        f"{stats['parked']} lanes materialized, {stats['resumed']} SHA3 "
        f"resumes, {stats['device_steps']} device steps, {wall:.3f} s, "
        f"{paths / wall:.1f} paths/s on {card}; K1 {launches['sym_run']} "
        f"launches for {launches['sym_step']} steps")
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
        return (name, *analyze_process(name, stats), stats)

    pool = ThreadPoolExecutor(CORPUS_WORKERS)
    return pool, [pool.submit(one, n) for n in names], tmp


def analyze_process(name, stats, held=False):
    """(the finished process, its wall in s) of ``--analyze`` (with
    ``held``, ``--analyze-held``) of one fixture."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--analyze-held" if held else "--analyze", name, stats],
        capture_output=True, text=True, cwd=HERE, timeout=900)
    return run, time.perf_counter() - t0


def host_explore_start():
    """Start the symbolic path's host-only reference (``runs.explore``
    of the k=12 contract with no lanes) in a process of its own
    (``--host-explore``); ``host_explore_finish`` reads its result."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--host-explore"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    DAEMONS.append(proc)  # stopped at exit if it still runs
    return proc


def host_explore_finish(proc):
    """(open states, wall in s) of ``host_explore_start``'s process."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"symbolic path host-only: exit "
                             f"{proc.returncode}\n{err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    return got["open"], got["wall"]


def host_explore() -> int:
    """``--host-explore``: the host-only run, its result as JSON."""
    from mythril_tpu_torch.support import runs
    from mythril_tpu_torch.support.contracts import build_symbolic_contract

    n_open, _, wall = runs.explore(build_symbolic_contract(MAIN_K)[0], 0)
    print(json.dumps({"open": n_open, "wall": wall}))
    return 0


def analysis_result(name, run, stats_path):
    """(report, stats) of a finished ``--analyze`` process; fails on a
    run that exited with an error or printed one, or whose analysis
    raised."""
    if run.returncode != 0 or not os.path.exists(stats_path):
        raise AssertionError(f"corpus {name}: exit {run.returncode}\n"
                             f"{run.stderr[-3000:]}")
    rep = json.loads(run.stdout)
    if rep.get("error") or not rep.get("success", True):
        raise AssertionError(f"corpus {name}: {rep.get('error')}")
    with open(stats_path) as f:
        st = json.load(f)
    if st["exceptions"]:
        raise AssertionError(f"corpus {name}: the analysis raised\n"
                             f"{st['exceptions'][0][-3000:]}")
    return rep, st


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
    launches, per_fixture, walls = {}, {}, {}
    bad, unlike = [], []
    try:
        for fut in futs:
            name, run, wall, stats_path = fut.result()
            rep, st = analysis_result(name, run, stats_path)
            walls[name] = wall
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
            per_fixture[name] = (st["launches"]["prop_fwd_level"]
                                 + st["launches"]["prop_back_round"])
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
    top = sorted(per_fixture.items(), key=lambda kv: -kv[1])[:3]
    log(f"corpus: K6 and K7 launches by fixture, the most: {top}")
    hold_corpus_screens(top[0][0], walls[top[0][0]], ref)
    return tot["windows"]


def hold_corpus_screens(name, wall, ref):
    """A second analysis of the corpus fixture ``name`` (the one that
    launches K6 and K7 the most), apart from the timed corpus, with
    every K6 and K7 call held against its plain version on a copy of
    its input (``--analyze-held``): its issues must again equal the
    JAX package's, and the calls are logged by shape, beside its wall
    with and without the check."""
    import tempfile

    from mythril_tpu_torch.support.lane_compare import canon

    tmp = tempfile.mkdtemp(prefix="chip_smoke_held_")
    try:
        stats = os.path.join(tmp, "held.json")
        run, held_wall = analyze_process(name, stats, held=True)
        rep, st = analysis_result(name, run, stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if canon(rep) != ref[name]["issues"]:
        raise AssertionError(f"corpus {name}, held: issues differ")
    shapes = st["screen_shapes"]
    if not shapes:
        raise AssertionError(f"corpus {name}, held: no K6 or K7 call")
    for kern in ("prop_fwd_level", "prop_back_round"):
        mine = sorted(((v, k) for k, v in shapes.items()
                       if k.startswith(kern + " ")), reverse=True)
        log(f"corpus {name} {kern}: {sum(v for v, _ in mine)} calls, each "
            f"equal to the plain version; by (S, T, entries): "
            + ", ".join(f"{k.split(' ', 1)[1]} x{v}" for v, k in mine[:8]))
    log(f"corpus {name}: {wall:.1f} s in the timed corpus, {held_wall:.1f} "
        f"s analysed again with K6 and K7 held against the plain versions")


def analyze_one(name, stats_path, held=False):
    """``--analyze``: ``python -m mythril_tpu_torch analyze`` of one
    fixture with the corpus flags, its report on stdout; the engine's
    run stats, the screens' counters, the kernel launches and the
    analysis' exceptions (which the JSON report leaves out) go to
    ``stats_path``, and with ``held`` (``--analyze-held``) the K6 and
    K7 calls, each held against its plain version, by shape."""
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
    shapes = hold_screen_kernels() if held else {}
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
                       "screen_shapes": shapes,
                       "exceptions": exceptions}, f)
    return 0


def hold_screen_kernels():
    """Wrap K6's and K7's wrappers for the rest of the process: every
    call also runs the plain version on a copy of its input and fails on
    a difference, so the corpus holds both kernels at its own shapes.
    Returns the calls counted by "kernel S T entries" (states, table
    rows, the layout's real nodes or entries)."""
    from mythril_tpu_torch.ops import propagate as P

    shapes = {}

    def held(name, kern, plain):
        def call(entry, tabs, changed=None):
            want = clone_all(tabs)
            kern(entry, tabs, changed)
            plain(entry, want)
            same_outputs(tabs, want, f"{name} in the corpus")
            key = (f"{name} {tabs[0].shape[0]} {tabs[0].shape[1]} "
                   f"{entry['ent'].shape[0]}")
            shapes[key] = shapes.get(key, 0) + 1
        return call

    P.fwd_level_kernel = held("prop_fwd_level", P.fwd_level_kernel,
                              P.fwd_level_plain)
    P.back_round_kernel = held("prop_back_round", P.back_round_kernel,
                               P.back_round_plain)
    return shapes


# ---------------------------------------------------------------------------
# the resident daemon with wave packing
# ---------------------------------------------------------------------------

#: the corpus phase's flags (support/lane_compare.analyze_argv) as daemon
#: request fields: the one-shot CLI's execution timeout and the rest
CORPUS_REQUEST = dict(timeout=86400, tpu_lanes=64, transaction_count=2,
                      solver_timeout=15000, no_onchain_data=True)
#: the daemon's counters of the packed queue (the ping's)
PACK_COUNTERS = ("waves_packed", "pack_members", "dispatches_saved",
                 "lane_windows")


def serve_one(out_dir, stats_path):
    """``--serve``: ``python -m mythril_tpu_torch serve --out-dir
    out_dir`` (the CLI's main, as ``--analyze`` runs it for a fixture);
    when the daemon stops, the kernel launches of its process (counted
    from 0 at its start) go to ``stats_path``."""
    sys.path.insert(0, HERE)
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.interfaces import cli

    sys.argv = ["myth", "serve", "--out-dir", out_dir]
    try:
        cli.main()
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    finally:
        with open(stats_path, "w") as f:
            json.dump(_build.LAUNCHES, f)
    return 0


#: the daemon processes started (and the host-only explore's), each
#: stopped or killed before exit
DAEMONS = []


def daemon_start(pack: bool):
    """Start a daemon process (``--serve``) with ``MTPU_PACK`` on or
    off; its output goes to a log file in its directory."""
    import tempfile

    from mythril_tpu_torch.daemon import SOCKET_NAME

    tmp = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    serve = os.path.join(tmp, "serve")
    stats = os.path.join(tmp, "launches.json")
    logf = open(os.path.join(tmp, "daemon.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--serve",
         serve, stats], cwd=HERE, stdout=logf, stderr=subprocess.STDOUT,
        env=dict(os.environ, MTPU_PACK="1" if pack else "0"))
    DAEMONS.append(proc)
    return {"proc": proc, "tmp": tmp, "stats": stats, "log": logf,
            "sock": os.path.join(serve, SOCKET_NAME)}


def daemon_log(d) -> str:
    d["log"].flush()
    with open(os.path.join(d["tmp"], "daemon.log"),
              errors="replace") as f:
        return f.read()[-3000:]


def daemon_ready(d, timeout=300):
    from mythril_tpu_torch.daemon.client import wait_ready

    if not wait_ready(d["sock"], timeout):
        raise AssertionError(f"daemon never became ready (exit "
                             f"{d['proc'].poll()}):\n{daemon_log(d)}")


def daemon_stop(d):
    """Shut the daemon down (draining its queue), wait for its process
    and return its kernel launches."""
    from mythril_tpu_torch.daemon.client import DaemonClient

    try:
        DaemonClient(d["sock"]).shutdown()
        rc = d["proc"].wait(timeout=300)
    finally:
        if d["proc"].poll() is None:
            d["proc"].kill()
            d["proc"].wait()
        d["log"].close()
    if rc != 0 or not os.path.exists(d["stats"]):
        raise AssertionError(f"daemon exit {rc}:\n{daemon_log(d)}")
    with open(d["stats"]) as f:
        launches = json.load(f)
    shutil.rmtree(d["tmp"], ignore_errors=True)
    return launches


def counters(sock):
    from mythril_tpu_torch.daemon.client import DaemonClient

    return DaemonClient(sock).ping()["counters"]


def daemon_corpus_start(d):
    """Submit the 18 fixtures to the daemon at once, once it answers,
    from a thread of their own (the daemon co-schedules them into
    packed waves while the corpus phase runs); returns the handle for
    ``daemon_corpus_finish``."""
    import threading

    from mythril_tpu_torch.daemon.client import DaemonClient
    from mythril_tpu_torch.support.lane_compare import (
        CREATION_FIXTURES, INPUTS,
    )

    h = {"rows": {}, "errors": {}, "done": {}}

    def one(path):
        try:
            h["rows"][path.name] = DaemonClient(d["sock"]).analyze(
                path.read_text().strip(), name=path.name,
                bin_runtime=path.name not in CREATION_FIXTURES,
                **CORPUS_REQUEST)
        except Exception as e:  # reported by daemon_corpus_finish
            h["errors"][path.name] = f"{type(e).__name__}: {e}"
        h["done"][path.name] = time.perf_counter()

    def run():
        try:
            daemon_ready(d)
            h["c0"] = counters(d["sock"])
            h["t0"] = time.perf_counter()
            subs = [threading.Thread(target=one, args=(p,))
                    for p in sorted(INPUTS.glob("*.sol.o"))]
            for t in subs:
                t.start()
            for t in subs:
                t.join()
            h["c1"] = counters(d["sock"])
        except Exception as e:  # reported by daemon_corpus_finish
            h["errors"]["daemon"] = f"{type(e).__name__}: {e}"

    h["thread"] = threading.Thread(target=run)
    h["thread"].start()
    return h


def daemon_corpus_finish(h, d, oneshot_windows, card):
    """Wait for the daemon's 18 reports and hold each canonical issue
    list to the JAX package's (tests/torch_data/lane_issues.json); no
    row may carry an error and at least one wave must have packed."""
    from mythril_tpu_torch.support.lane_compare import canon

    h["thread"].join(timeout=1100)
    if h["thread"].is_alive() or h["errors"]:
        raise AssertionError(f"daemon corpus: {h['errors'] or 'timed out'}"
                             f"\n{daemon_log(d)}")
    with open(os.path.join(HERE, "tests", "torch_data",
                           "lane_issues.json")) as f:
        ref = json.load(f)
    bad, n_got, n_want = [], 0, 0
    for name, row in sorted(h["rows"].items()):
        if row.get("exceptions"):
            raise AssertionError(f"daemon corpus {name}: the analysis "
                                 f"raised\n{row['exceptions'][0][-3000:]}")
        got, want = canon(json.loads(row["output"])), ref[name]["issues"]
        n_got, n_want = n_got + len(got), n_want + len(want)
        if got != want:
            bad.append(name)
    if bad or len(h["rows"]) != len(ref):
        raise AssertionError(f"daemon corpus: issues differ on {bad} "
                             f"({len(h['rows'])} reports)")
    delta = {k: h["c1"][k] - h["c0"][k] for k in PACK_COUNTERS}
    if delta["waves_packed"] < 1:
        raise AssertionError(f"daemon corpus: no wave packed ({delta})")
    makespan = max(h["done"].values()) - h["t0"]
    packed = sum(1 for r in h["rows"].values() if r.get("packed"))
    log(f"daemon corpus (MTPU_PACK on): {n_got} = {n_want} issues over "
        f"{len(h['rows'])} requests, none failed, {packed} served in "
        f"packs; waves_packed {delta['waves_packed']}, pack_members "
        f"{delta['pack_members']}, dispatches_saved "
        f"{delta['dispatches_saved']}, lane_windows "
        f"{delta['lane_windows']} (one-shot corpus: {oneshot_windows} "
        f"windows); makespan {makespan:.1f} s (edge checks beside) on "
        f"{card}")
    return delta, makespan


def daemon_queue(d):
    """tests/test_wave_pack.py's four-code queue: a head request keeps
    the worker busy while three more queue (and pack, with MTPU_PACK
    on). Returns ({id: canonical issues}, counter deltas)."""
    import threading

    from mythril_tpu_torch.daemon.client import DaemonClient
    from mythril_tpu_torch.support.contracts import (
        build_diamond_contract, build_fork_tree_contract,
    )
    from mythril_tpu_torch.support.lane_compare import canon

    codes = {"warm": build_fork_tree_contract(3, 1).hex(),
             "ra": build_fork_tree_contract(4, 1).hex(),
             "rb": build_diamond_contract(5, dup_levels=0).hex(),
             "rc": build_diamond_contract(3, dup_levels=0).hex()}
    params = dict(tpu_lanes=64, timeout=120, transaction_count=1)
    c0 = counters(d["sock"])
    rows, started = {}, threading.Event()

    def submit(rid):
        for ev in DaemonClient(d["sock"]).submit(codes[rid], id=rid,
                                                 **params):
            if ev.get("event") == "started":
                started.set()
            rows[rid] = ev

    threads = [threading.Thread(target=submit, args=("warm",))]
    threads[0].start()
    started.wait(timeout=300)
    threads += [threading.Thread(target=submit, args=(rid,))
                for rid in ("ra", "rb", "rc")]
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=600)
    c1 = counters(d["sock"])
    out = {}
    for rid in codes:
        row = rows.get(rid, {})
        if row.get("event") != "report" or row.get("exceptions"):
            raise AssertionError(f"four-code queue {rid}: {row}\n"
                                 f"{daemon_log(d)}")
        out[rid] = canon(json.loads(row["output"]))
    return out, {k: c1[k] - c0[k] for k in PACK_COUNTERS}


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

#: the kernels the meshed engine adds to its main path (the window's
#: phases a shard): (name, source, TPU kernel)
MESH_ROWS = [
    ("sym_decide", "symstep.cu", "mythril_tpu/ops/symstep.py:419"),
    ("sym_exec", "symstep.cu", "mythril_tpu/ops/symstep.py:419"),
    ("sym_fork_rows", "symstep.cu", "mythril_tpu/ops/symstep.py:1264"),
    ("window_remap", "window.cu", "mythril_tpu/laser/lane_engine.py:771"),
    ("window_rows", "window.cu", "mythril_tpu/laser/lane_engine.py:1196"),
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


# ---------------------------------------------------------------------------
# the multi-rank corpus mode
# ---------------------------------------------------------------------------

#: the corpus mode's ranks on this card and their flags (those of the
#: reference, tools/make_torch_reference.py --corpus, with stealing on)
CORPUS_RANKS = 4
CORPUS_MODE_FLAGS = ["--tpu-lanes", "64", "--timeout", "600"]


def corpus_rank(stats_path, argv):
    """``--corpus-rank STATS ARGS``: one rank of ``python -m
    mythril_tpu_torch.parallel.corpus ARGS`` (the module run as ``-m``
    runs it); the kernel launches of the rank go to ``stats_path`` when
    it ends."""
    import runpy

    sys.path.insert(0, HERE)
    from mythril_tpu_torch import _build

    sys.argv = ["corpus"] + argv
    try:
        runpy.run_module("mythril_tpu_torch.parallel.corpus",
                         run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    finally:
        with open(stats_path, "w") as f:
            json.dump(_build.LAUNCHES, f)
    return 0


def corpus_mode(card, during):
    """CORPUS_RANKS ranks of the port's corpus mode on this card
    (``--corpus-rank``), meeting at a TCPStore on localhost, stealing
    on, over the 18 fixtures: every rank exits 0, the merged report has
    no error and, fixture by fixture, the JAX package's corpus-mode
    issues (``tests/torch_data/corpus_issues.json``), every fixture is
    analysed by exactly one rank, and the ranks' lane engines launched
    K1. ``during()`` (untimed work of this process) runs while the ranks
    do; the makespan is taken when the last rank ends. Returns the
    makespan in seconds."""
    import socket
    import tempfile

    from mythril_tpu_torch.support.lane_compare import INPUTS

    with open(os.path.join(HERE, "tests", "torch_data",
                           "corpus_issues.json")) as f:
        ref = json.load(f)
    files = sorted(str(p) for p in INPUTS.glob("*.sol.o"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    out = os.path.join(tmp, "out")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(CORPUS_RANKS):
            stats = os.path.join(tmp, f"launches_{rank}.json")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--corpus-rank", stats, "--coordinator",
                 f"127.0.0.1:{port}", "--num-processes", str(CORPUS_RANKS),
                 "--process-id", str(rank), "--out-dir", out]
                + CORPUS_MODE_FLAGS + files, cwd=HERE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                stats))
        ended = {}

        def wait():
            ended["outs"] = [p.communicate(timeout=900) for p, _ in procs]
            ended["makespan"] = time.perf_counter() - t0

        waiter = threading.Thread(target=wait)
        waiter.start()
        try:
            during()
        finally:
            waiter.join()
        if "outs" not in ended:
            raise AssertionError("corpus mode: the ranks did not end")
        outs, makespan = ended["outs"], ended["makespan"]
        for rank, ((p, _), (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"corpus mode: rank {rank} exited "
                                     f"{p.returncode}\n{err[-3000:]}")
        with open(os.path.join(out, "corpus_report.json")) as f:
            merged = json.load(f)
        seen = {}
        walls = []
        for rank in range(CORPUS_RANKS):
            with open(os.path.join(out, f"shard_{rank}.json")) as f:
                shard = json.load(f)
            walls.append(shard["wall_s"])
            for r in shard["results"]:
                seen.setdefault(r["contract"], []).append(rank)
        launches = {}
        for _, stats in procs:
            with open(stats) as f:
                for k, v in json.load(f).items():
                    launches[k] = launches.get(k, 0) + v
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    got = {c["contract"]: {"issues": c.get("issues"), "swc": c.get("swc")}
           for c in merged["contracts"]}
    if merged["errors"] or got != ref:
        bad = sorted(k for k in set(got) | set(ref)
                     if got.get(k) != ref.get(k))
        raise AssertionError(f"corpus mode: {merged['errors']} errors, "
                             f"issues differ on {bad}: "
                             f"{[(k, got.get(k), ref.get(k)) for k in bad]}")
    twice = {k: v for k, v in seen.items() if len(v) != 1}
    if twice or set(seen) != set(ref):
        raise AssertionError(f"corpus mode: fixtures not analysed exactly "
                             f"once: {twice or sorted(set(ref) - set(seen))}")
    if launches.get("sym_step", 0) <= 0:
        raise AssertionError(f"corpus mode: the lane engine never stepped "
                             f"({launches})")
    log(f"corpus mode ({CORPUS_RANKS} ranks on this card, TCPStore on "
        f"localhost, stealing on, {' '.join(CORPUS_MODE_FLAGS)}): "
        f"{merged['total_issues']} issues over {len(got)} fixtures, each "
        f"fixture's issues and SWC ids equal to the JAX package's corpus "
        f"mode, each analysed by one rank, {merged['stolen']} stolen; "
        f"makespan {makespan:.1f} s with the K10 edges beside (rank walls "
        f"{', '.join(f'{w:.1f}' for w in walls)} s); launches "
        f"{ {k: v for k, v in launches.items() if v} } on {card}")
    return makespan


def mesh_cards(devs):
    """The meshed engine over every card (a shard a card, the fork rows
    read in place over peer access, the home's gathers peer copies)
    against the engine on card 0:
    the k=12 contract's sweep at MAIN_LANES lanes, every window's
    outputs equal, the same states and visited bitmap, both explores
    timed, ``sym_vis_or`` launched once a K1 run; then ``sym_vis_or``
    (every other card's bitmap ORed into card 0's in one launch, read in
    place over peer access where the pair has it, the one kernel only
    distinct cards launch) on seeded bitmaps of the sweep's length
    against its plain version (the OR on the CPU, itself held to
    numpy's), with its row of the kernel table: call and device ms
    (every other card's bitmap, and card 1's alone: ``one_*``), the
    plain OR, the byte bound and ``bitwise_or_`` after a copy of each
    source; the route of each pair is logged, the fork rows' too; K3's
    remap launched once a card a window. The sweep runs twice more, each
    on a fresh batch (the pool emptied, so its windows compare with the
    one card's fresh ones bit for bit): with K3's remap held in every
    window against its plain version on CPU copies of its input
    (``RemapHold``; the canon read over peer access), and with the route
    of a pair without peer access (the fork rows staged, copied and
    landed; the canon copied once a card) forced on every pair, each
    window and retire held against the plain versions on a CPU copy of
    its input (``MeshSpy``), its states and bitmap against card 0's."""
    from copy import deepcopy

    import numpy as np
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.ops import symstep as S
    from mythril_tpu_torch.parallel.mesh import Mesh
    from mythril_tpu_torch.support.contracts import build_symbolic_contract
    from mythril_tpu_torch.support.runs import entry_states

    code, _ = build_symbolic_contract(MAIN_K)
    entries = entry_states(code.hex())
    outs = {"mesh": [], "one": []}
    orig = (le.window_exec_mesh, le.window_exec)
    vis_route = S.vis_route

    def spy(fn, key):
        def call(*a, **kw):
            r = fn(*a, **kw)
            outs[key].append([x.cpu() for x in list(r[2])])
            return r
        return call

    def sig(gs):
        return (gs.mstate.pc, tuple(map(repr, gs.mstate.stack)),
                tuple(map(repr, gs.world_state.constraints)))

    le.window_exec_mesh = spy(orig[0], "mesh")
    le.window_exec = spy(orig[1], "one")
    le._STATE_POOL.clear()
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        eng = le.LaneEngine(n_lanes=MAIN_LANES, mesh=Mesh(devs))
        got = eng.explore(code, deepcopy(entries))
        for d in devs:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        t0 = time.perf_counter()
        one = le.LaneEngine(n_lanes=MAIN_LANES, device=devs[0])
        want = one.explore(code, deepcopy(entries))
        torch.cuda.synchronize(devs[0])
        wall_one = time.perf_counter() - t0
    finally:
        le.window_exec_mesh, le.window_exec = orig
    if len(outs["mesh"]) != len(outs["one"]) or not outs["mesh"]:
        raise AssertionError(f"meshed engine over {len(devs)} cards: "
                             f"{len(outs['mesh'])} windows, one card "
                             f"{len(outs['one'])}")
    for w, (a, b) in enumerate(zip(outs["mesh"], outs["one"])):
        same_outputs(a, b, f"meshed window {w} over {len(devs)} cards")
    if list(map(sig, got)) != list(map(sig, want)):
        raise AssertionError("meshed engine over the cards: other states")
    remaps = launches.get("window_remap", 0)
    if remaps != len(devs) * len(outs["mesh"]):
        raise AssertionError(f"meshed engine over {len(devs)} cards: "
                             f"{remaps} window_remap launches for "
                             f"{len(outs['mesh'])} windows (one a card a "
                             f"window)")
    vis, vis_one = eng.visited_by_code[code], one.visited_by_code[code]
    if not vis.any() or not np.array_equal(vis, vis_one):
        raise AssertionError(f"meshed engine over the cards: visited "
                             f"{int(vis.sum())} pcs, one card "
                             f"{int(vis_one.sum())}, "
                             f"{int((vis != vis_one).sum())} differ")
    # the route each (destination, source) pair of cards took for the
    # fork rows (vis_route, by topology: a source read in place over
    # peer access, or staged and copied)
    fork_routes = {f"cuda:{dst}<-cuda:{src}": r
                   for (dst, src), r in sorted(S._VIS_ROUTES.items())}
    log(f"cards: fork rows over {len(devs)} cards: "
        f"{launches.get('sym_fork_rows', 0)} sym_fork_rows launches, the "
        f"route of each pair {fork_routes}; window_remap {remaps} "
        f"launches, one a card a window, the canon read by the same "
        f"routes")

    def fresh_sweep(key, hold):
        """The sweep again on a fresh batch (the pool emptied: a pooled
        batch carries the first sweep's steps in its step columns, as
        the JAX package's does), its windows recorded under ``key`` and
        held to the one card's, which ran on a fresh batch too; returns
        (engine, states, launches)."""
        le._STATE_POOL.clear()
        _build.reset_launches()
        with hold:
            inner = le.window_exec_mesh
            le.window_exec_mesh = spy(inner, key)
            try:
                e = le.LaneEngine(n_lanes=MAIN_LANES, mesh=Mesh(devs))
                states = e.explore(code, deepcopy(entries))
            finally:
                le.window_exec_mesh = inner
        if len(outs[key]) != len(outs["one"]):
            raise AssertionError(f"{key}: {len(outs[key])} windows, one "
                                 f"card {len(outs['one'])}")
        for w, (a, b) in enumerate(zip(outs[key], outs["one"])):
            same_outputs(a, b, f"{key} window {w} over {len(devs)} cards")
        got_launches = dict(_build.LAUNCHES)
        if got_launches["window_remap"] != len(devs) * len(outs[key]):
            raise AssertionError(f"{key}: {got_launches['window_remap']} "
                                 f"window_remap launches for "
                                 f"{len(outs[key])} windows")
        return e, states, got_launches

    # K3's remap in every window held against its plain version, the
    # canon read over peer access where the pair has it
    outs["held"] = []
    rh = RemapHold()
    _, got_h, _ = fresh_sweep("held", rh)
    if list(map(sig, got_h)) != list(map(sig, want)) or rh.calls != len(
            outs["held"]) or not rh.prov:
        raise AssertionError(f"remap held: {rh.calls} calls for "
                             f"{len(outs['held'])} windows, {rh.prov} "
                             f"provisional sids, or other states")
    log(f"cards: window_remap held in each of {rh.calls} windows "
        f"({rh.prov} provisional sids) against its plain version on CPU "
        f"copies, one launch a card a window, the windows the one card's")
    # the route of a pair with no peer access, forced on every pair of
    # distinct cards: each source card stages its forks' rows, each
    # destination card gets them in one copy a run of ranks (vis_or's
    # bitmaps copied too); every window and retire held bit for bit
    # against the plain versions on a CPU copy of its input (MeshSpy),
    # the states and the visited bitmap the one card's
    S.vis_route = lambda dst, src: "local" if dst == src else "copy"
    outs["staged"] = []
    held = MeshSpy(hold=True)
    try:
        eng_st, got_st, staged_launches = fresh_sweep("staged", held)
        staged = staged_launches["sym_fork_rows"]
    finally:
        S.vis_route = vis_route
    if list(map(sig, got_st)) != list(map(sig, want)) or not np.array_equal(
            eng_st.visited_by_code[code], vis_one):
        raise AssertionError("meshed engine, fork rows staged: other "
                             "states or visited bitmap than one card's")
    if staged <= launches.get("sym_fork_rows", 0):
        raise AssertionError(f"fork rows staged: {staged} launches, not "
                             f"above the peer route's "
                             f"{launches.get('sym_fork_rows')}: no stage")
    log(f"cards: fork rows staged and copied on every pair of distinct "
        f"cards: {held.windows} windows and {held.retires} retires equal "
        f"to the plain versions on CPU copies, the states and the visited "
        f"bitmap the engine's on {devs[0]}; {staged} sym_fork_rows "
        f"launches (stage and land)")
    if launches.get("sym_vis_or", 0) != len(outs["mesh"]):
        raise AssertionError(f"meshed engine over the cards: sym_vis_or "
                             f"launched {launches.get('sym_vis_or', 0)} "
                             f"times for {len(outs['mesh'])} K1 runs (one "
                             f"a run)")
    # sym_vis_or against its plain version: card 0's bitmap and every
    # other card's, seeded, as long as the sweep's (its code's packed
    # length, as explore allocates it), in one launch
    g = torch.Generator().manual_seed(15)
    length = eng._visited_dev[code].shape[0]
    maps = [torch.rand(length, generator=g) < 0.3 for _ in devs]
    routes = {str(d): S.vis_route(devs[0], d) for d in devs[1:]}
    before = _build.LAUNCHES["sym_vis_or"]
    got_or = S.vis_or(maps[0].to(devs[0]),
                      [x.to(d) for x, d in zip(maps[1:], devs[1:])]).cpu()
    want_or = S.vis_or(maps[0].clone(), maps[1:])
    err = int((got_or != want_or).sum())
    np_or = np.logical_or.reduce([x.numpy() for x in maps], axis=0)
    if err or not np.array_equal(want_or.numpy(), np_or) \
            or _build.LAUNCHES["sym_vis_or"] - before != 1:
        raise AssertionError(f"sym_vis_or: {err} bytes differ from the "
                             f"plain OR")

    def inputs(k):
        """card 0's bitmap and k other cards' (their writes done)"""
        def make():
            out = (maps[0].to(devs[0]), [x.to(d) for x, d in
                                         zip(maps[1:k + 1], devs[1:k + 1])])
            for d in devs[:k + 1]:
                torch.cuda.synchronize(d)
            return out
        return make

    def library(x):
        for src in x[1]:
            x[0].bitwise_or_(src.to(devs[0]))

    times = {}
    with torch.cuda.device(devs[0]):
        for k in (len(devs) - 1, 1):
            times[k] = (
                cuda_ms(lambda x: S.vis_or(*x), reps=5, setup=inputs(k)),
                queued_ms(lambda x: S.vis_or(*x), inputs(k)),
                cuda_ms(library, reps=5, setup=inputs(k)))
    t0 = time.perf_counter()
    for _ in range(5):
        S.vis_or(maps[0].clone(), maps[1:])
    plain = (time.perf_counter() - t0) / 5 * 1e3
    ms, dms, lib = times[len(devs) - 1]
    bnd, by = bound_ms((len(devs) + 1) * length)
    row = dict(name="sym_vis_or", route="cuda",
               source="mythril_tpu_torch/csrc/symstep.cu",
               replaces="mythril_tpu/laser/lane_engine.py:1807",
               launches=launches.get("sym_vis_or", 0), max_abs_err=err,
               ms=round(ms, 4), plain_ms=round(plain, 4),
               device_ms=round(dms, 4), bound_ms=round(bnd, 6),
               bound_by=by, library_ms=round(lib, 4),
               one_ms=round(times[1][0], 4),
               one_device_ms=round(times[1][1], 4),
               one_library_ms=round(times[1][2], 4), routes=routes)
    log(f"cards: the meshed engine over {len(devs)} cards (k={MAIN_K} "
        f"sweep, {MAIN_LANES} lanes): {len(outs['mesh'])} windows equal "
        f"to the engine on {devs[0]}, {len(got)} states, the visited "
        f"bitmap equal ({int(vis.sum())} pcs); explore {wall:.3f} s "
        f"against {wall_one:.3f} s on one card; launches {launches}; "
        f"sym_vis_or on {length}-byte bitmaps from "
        f"{', '.join(map(str, devs[1:]))} into {devs[0]} in one launch "
        f"(routes {routes}) equal to the plain OR (max_abs_err {err}), "
        f"{ms:.4f} ms against bitwise_or_ after the copies {lib:.4f} ms")
    log(f"cards: {json.dumps(row)}")


# ---------------------------------------------------------------------------
# --sigterm: the daemon's SIGTERM drain and resume on the card
# ---------------------------------------------------------------------------

def fork_tree_code(k=4):
    """tests/test_checkpoint_live.py's ``_fork_tree_code``: k
    sequential symbolic branches with SSTOREs and an assert-style
    INVALID tail (the exceptions module flags the INVALID)."""
    import random

    from mythril_tpu_torch.support.contracts import _OP as op, _push

    rng = random.Random(0)
    c = bytearray(_push(0))
    for i in range(k):
        c += _push(i) + bytes([op["CALLDATALOAD"]])
        c += _push(1) + bytes([op["AND"], op["ISZERO"]])
        j = len(c)
        c += _push(0, 2) + bytes([op["JUMPI"]])
        c += _push(rng.randrange(1, 200)) + bytes([op["ADD"], op["DUP1"]])
        c += _push(i) + bytes([op["SSTORE"]])
        c[j + 1:j + 3] = len(c).to_bytes(2, "big")
        c += bytes([op["JUMPDEST"]])
    c += bytes([op["POP"]])
    c += _push(31) + bytes([op["CALLDATALOAD"]])
    c += _push(0xDEADBEEF, 4) + bytes([op["EQ"]])
    j = len(c)
    c += _push(0, 2) + bytes([op["JUMPI"]])
    c += bytes([op["STOP"]])
    c[j + 1:j + 3] = len(c).to_bytes(2, "big")
    c += bytes([op["JUMPDEST"], 0xFE])
    return bytes(c)


def sigterm_resume(tmp, name, env, requests, settle_s):
    """A daemon drained by SIGTERM and restarted, as the slow CPU tests
    drive it, with ``myth serve`` on the card (``--serve``, a process
    each, their output into one log): ``requests`` ({id: request
    fields}) each submitted from a thread of its own, 0.2 s apart;
    ``settle_s`` after every one has started, SIGTERM, which must end
    the daemon with a non-zero exit (it re-raises the signal once its
    queue is persisted); then a second daemon on the same directory with
    ``MTPU_PATH_DELAY=0`` until every request has its report, its
    counters read, shut down. Returns (the persisted queue, the ids of
    the interrupted requests whose checkpoint (``resume.ckpt``) was on
    disk after the SIGTERM, {id: report row}, the restarted daemon's
    counters, the SIGTERM exit, seconds)."""
    import signal
    import threading

    from mythril_tpu_torch.daemon import SOCKET_NAME
    from mythril_tpu_torch.daemon.client import (
        DaemonClient, DaemonError, wait_ready,
    )

    out = os.path.join(tmp, name, "serve")
    os.makedirs(out)
    log_path = os.path.join(tmp, name, "daemon.log")
    sock = os.path.join(out, SOCKET_NAME)
    t0 = time.perf_counter()

    def served_log():
        with open(log_path, errors="replace") as f:
            return f.read()[-3000:]

    def serve(delay):
        with open(log_path, "a") as logf:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--serve", out, os.path.join(tmp, name, "launches.json")],
                cwd=HERE, stdout=logf, stderr=subprocess.STDOUT,
                env=dict(env, MTPU_PATH_DELAY=delay))
        DAEMONS.append(proc)
        if not wait_ready(sock, 300):
            raise AssertionError(f"{name}: daemon never ready:\n"
                                 f"{served_log()}")
        return proc

    proc = serve(env["MTPU_PATH_DELAY"])
    events = {rid: [] for rid in requests}

    def submit(rid):
        try:
            for ev in DaemonClient(sock).submit(id=rid, **requests[rid]):
                events[rid].append(ev)
        except (DaemonError, OSError) as e:
            events[rid].append({"event": "hangup", "error": str(e)})

    threads = [threading.Thread(target=submit, args=(rid,))
               for rid in requests]
    for t in threads:
        t.start()
        time.sleep(0.2)
    deadline = time.monotonic() + 180
    while not all(any(e.get("event") == "started" for e in evs)
                  for evs in events.values()):
        if time.monotonic() > deadline:
            raise AssertionError(f"{name}: requests never all started: "
                                 f"{events}")
        time.sleep(0.05)
    time.sleep(settle_s)
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    for t in threads:
        t.join(timeout=30)
    if rc == 0:
        raise AssertionError(f"{name}: daemon exited 0 on SIGTERM:\n"
                             f"{served_log()}")
    with open(os.path.join(out, "daemon_queue.json")) as f:
        queue = json.load(f)
    ckpts = [r["id"] for r in queue["interrupted"] if os.path.exists(
        os.path.join(out, "requests", r["id"], "resume.ckpt"))]
    proc2 = serve("0")
    client = DaemonClient(sock)
    rows, deadline = {}, time.monotonic() + 300
    while len(rows) < len(requests):
        for rid in requests:
            if rid not in rows:
                row = client.result(rid)
                if row.get("event") == "report":
                    rows[rid] = row
                elif row.get("event") not in ("pending", "unknown"):
                    raise AssertionError(f"{name}: request {rid}: {row}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{name}: no report for "
                                 f"{sorted(set(requests) - set(rows))}")
        time.sleep(0.25)
    counters = client.ping()["counters"]
    client.shutdown()
    if proc2.wait(timeout=120) != 0:
        raise AssertionError(f"{name}: restarted daemon exit "
                             f"{proc2.returncode}:\n{served_log()}")
    return queue, ckpts, rows, counters, rc, time.perf_counter() - t0


def sigterm_mid_request(tmp):
    """tests/test_torch_daemon.py's ``TestSigtermDrainResume`` on the
    card: SIGTERM 2.5 s after a request started (0.25 s a finished
    path); the persisted queue holds it interrupted with its checkpoint;
    the restarted daemon resumes it from the checkpoint, with the
    uninterrupted one-shot run's issues (in this process, on the card).
    Returns a summary."""
    from mythril_tpu_torch.orchestration.mythril_analyzer import (
        MythrilAnalyzer, reset_analysis_state,
    )
    from mythril_tpu_torch.orchestration.mythril_disassembler import (
        MythrilDisassembler,
    )
    from mythril_tpu_torch.support.analysis_args import make_cmd_args

    code_hex = fork_tree_code(k=4).hex()
    queue, ckpts, rows, counters, rc, wall = sigterm_resume(
        tmp, "request", dict(os.environ, MTPU_PATH_DELAY="0.25"),
        {"tree": dict(code=code_hex, bin_runtime=True, timeout=300)}, 2.5)
    if [r["id"] for r in queue["interrupted"]] != ["tree"] \
            or ckpts != ["tree"]:
        raise AssertionError(f"persisted queue {queue}, checkpoints "
                             f"{ckpts}")
    reset_analysis_state()
    dis = MythrilDisassembler(eth=None)
    address, _ = dis.load_from_bytecode(code_hex, bin_runtime=True)
    base = MythrilAnalyzer(
        disassembler=dis, cmd_args=make_cmd_args(execution_timeout=300),
        strategy="bfs", address=address).fire_lasers(
            modules=None, transaction_count=2)
    row = rows["tree"]
    got = sorted((i["swc-id"], i.get("address"), i.get("function"))
                 for i in row["issues"])
    want = sorted((i.swc_id, i.address, i.function)
                  for i in base.issues.values())
    resumed = counters.get("requests_resumed", 0)
    if row.get("resumed") is not True or resumed < 1 or got != want \
            or not want:
        raise AssertionError(f"resumed request: resumed "
                             f"{row.get('resumed')}, requests_resumed "
                             f"{resumed}, issues {got} against the one-shot "
                             f"run's {want}")
    return dict(sigterm_exit=rc, issues=len(got), requests_resumed=resumed,
                wall_s=round(wall, 1))


def sigterm_mid_pack(tmp):
    """tests/test_torch_wave_pack.py's ``TestSigtermMidPack`` on the
    card: three requests packed into one wave (``MTPU_PACK=1``, 64
    lanes, one transaction, 1 s a finished path), SIGTERM half a second
    after all three started; the restarted daemon resumes each
    interrupted member on its own, every member with its solo lane
    analysis' issues (in this process, on the card). Returns a
    summary."""
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader
    from mythril_tpu_torch.laser import lane_engine as le
    from mythril_tpu_torch.orchestration.mythril_analyzer import (
        MythrilAnalyzer,
    )
    from mythril_tpu_torch.orchestration.mythril_disassembler import (
        MythrilDisassembler,
    )
    from mythril_tpu_torch.support import contracts
    from mythril_tpu_torch.support.analysis_args import make_cmd_args

    codes = {"ra": contracts.build_fork_tree_contract(4, 1).hex(),
             "rb": contracts.build_diamond_contract(5, dup_levels=0).hex(),
             "rc": contracts.build_diamond_contract(3, dup_levels=0).hex()}
    queue, ckpts, rows, _, rc, wall = sigterm_resume(
        tmp, "pack", dict(os.environ, MTPU_PACK="1", MTPU_PATH_DELAY="1.0"),
        {rid: dict(code=c, bin_runtime=True, timeout=300, tpu_lanes=64,
                   transaction_count=1) for rid, c in codes.items()}, 0.5)
    interrupted = {r["id"] for r in queue["interrupted"]}
    if not interrupted or not interrupted <= set(codes):
        raise AssertionError(f"persisted queue: {queue}")
    issues = {}
    for rid, code_hex in codes.items():
        for m in ModuleLoader().get_detection_modules(None, None):
            m.reset_module()
            m.cache.clear()
        dis = MythrilDisassembler(eth=None)
        address, _ = dis.load_from_bytecode(code_hex, bin_runtime=True)
        analyzer = MythrilAnalyzer(
            disassembler=dis,
            cmd_args=make_cmd_args(execution_timeout=120, tpu_lanes=64),
            strategy="bfs", address=address)
        le.PATH_HISTORY[bytes.fromhex(code_hex)] = 64
        report = analyzer.fire_lasers(modules=None, transaction_count=1)
        want = sorted((i.swc_id, i.title, i.address)
                      for i in report.issues.values())
        got = sorted((i["swc-id"], i.get("title"), i.get("address"))
                     for i in rows[rid]["issues"])
        if got != want or (rid in interrupted
                           and rows[rid].get("resumed") is not True):
            raise AssertionError(f"request {rid}: issues {got} against "
                                 f"the solo analysis' {want}, resumed "
                                 f"{rows[rid].get('resumed')}")
        issues[rid] = len(got)
    return dict(interrupted=sorted(interrupted), checkpoints=ckpts,
                sigterm_exit=rc,
                packed_on_resume=sorted(r for r in rows
                                        if rows[r].get("packed")),
                issues=issues, wall_s=round(wall, 1))


def check_sigterm() -> int:
    """``--sigterm``: the daemon's two SIGTERM scenarios of the slow CPU
    tests with ``myth serve`` on the card (``sigterm_mid_request``,
    ``sigterm_mid_pack``), each daemon a process of its own."""
    import tempfile

    import torch

    from mythril_tpu_torch import _build, native

    card = smi()
    t0 = time.perf_counter()
    built = _build.build_all()
    native.get_lib()
    log(f"sigterm: {len(built)} sources and the native library built in "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sigterm_")
    try:
        t = time.perf_counter()
        one = sigterm_mid_request(tmp)
        log(f"sigterm: mid-request drain and resume on the card: {one} "
            f"({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        pack = sigterm_mid_pack(tmp)
        log(f"sigterm: mid-pack drain and per-member resume on the card: "
            f"{pack} ({time.perf_counter() - t:.1f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"sigterm": {"mid_request": one, "mid_pack": pack}}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_cards() -> int:
    """``--cards``: K10, K9 and the meshed engine on every card of a
    machine with two or more, each card's first launch past 48 KB of
    shared memory included (a kernel opts in to it once a device):
    ``sharded_run`` of
    CONCRETE_N lanes of the bench batch a card (57 KB blocks) on a mesh
    of every card, each shard a copy on its own card, equal on every
    plane to one K10 run on card 0; then on each card K9 on
    ``device_loop.k9_edge_cases`` (66 KB blocks at 600 and 4096 lanes)
    against its plain version, with its plan's launches; then
    ``mesh_cards``."""
    import torch

    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import stepper as S
    from mythril_tpu_torch.parallel import mesh as M
    from mythril_tpu_torch.support import contracts as C
    from mythril_tpu_torch.support import device_loop

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"chip_smoke --cards: {cards} card(s), two needed",
              file=sys.stderr)
        return 2
    _build.build_all()
    devs = [torch.device("cuda", i) for i in range(cards)]
    mesh = M.Mesh(devs)
    n = CONCRETE_N * cards
    cc = S.compile_code(C.build_bench_contract(), device=devs[0])
    cap = C.BENCH_MAX_STEPS
    ref = S.run_kernel(cc, C.bench_batch(n, devs[0]), cap)
    whole = M.sharded_run(cc, M.shard_lanes(C.bench_batch(n, devs[0]),
                                            mesh), cap, mesh)
    for d in devs:
        torch.cuda.synchronize(d)
    same_lanes(whole.lanes(), ref, f"sharded_run over {cards} cards")
    edges = []
    for d in devs:
        with torch.cuda.device(d):
            for case in device_loop.k9_edge_cases():
                st, pairs = device_loop.k9_case_inputs(case, d)
                hold_k9(st, pairs, f"{case.name} on {d}")
            edges.append(str(d))
    log(f"cards: sharded_run of {n} lanes over {cards} cards equal to one "
        f"K10 run on {devs[0]}; K9 equal to its plain version on "
        f"k9_edge_cases on {', '.join(edges)} ({smi()})")
    mesh_cards(devs)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}))
    return 0


def main() -> int:
    try:
        return run()
    finally:
        for proc in DAEMONS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] in ("--analyze",
                                              "--analyze-held"):
        return analyze_one(sys.argv[2], sys.argv[3],
                           held=sys.argv[1] == "--analyze-held")
    if len(sys.argv) == 4 and sys.argv[1] == "--serve":
        return serve_one(sys.argv[2], sys.argv[3])
    if sys.argv[1:] == ["--host-explore"]:
        return host_explore()
    if len(sys.argv) > 3 and sys.argv[1] == "--corpus-rank":
        return corpus_rank(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:] == ["--cards"]:
        return check_cards()
    if sys.argv[1:] == ["--sigterm"]:
        return check_sigterm()
    from mythril_tpu_torch import _build

    dev = torch.device("cuda", 0)
    card = smi()
    t_run = t0 = time.perf_counter()
    # the native solver library builds (make) beside the kernels (nvcc)
    from mythril_tpu_torch import native

    fresh = not os.path.exists(native._LIB_PATH)
    made = {}

    def make_native():
        t = time.perf_counter()
        try:
            native.get_lib()  # raises with make's output on a failed build
        except BaseException as e:  # re-raised below, in this thread
            made["error"] = e
        made["s"] = time.perf_counter() - t

    maker = threading.Thread(target=make_native)
    maker.start()
    built = _build.build_all()
    log(f"build: {len(built)} sources in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in sorted(built.items()))})"
        f" on {card}")
    for src in sorted(os.listdir(_build.CSRC)):
        if src.endswith(".cu"):
            for line in _build.build_log(src).splitlines():
                if "registers" in line or "spill" in line \
                        or "Function properties" in line:
                    log(f"  {src}: {line.strip()}")

    maker.join()
    if "error" in made:
        raise made["error"]
    log(f"native solver library: {'built' if fresh else 'loaded'} in "
        f"{made['s']:.1f} s beside the kernels' build ({native._LIB_PATH})")

    from mythril_tpu_torch.ops.symstep import lane_bytes
    from mythril_tpu_torch.support.devices import default_lanes

    log(f"lane default on this card: {default_lanes(lane_bytes(), dev)} "
        f"lanes of {lane_bytes()} bytes")
    report = {}
    laps, last = [], [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, on a line of its own and kept for
        the closing line."""
        now = time.perf_counter()
        laps.append(f"{name} {now - last[0]:.1f}")
        log(f"phase: {name} {now - last[0]:.1f} s")
        last[0] = now

    lap("build and set-up")
    for check in (check_bv256, check_init, check_k1, check_k1_packed,
                  check_window, check_merge_fp):
        check(dev, report)
        lap(check.__name__)

    # the symbolic path at full width: its launch counts are the main
    # path's for K0-K4
    n_open, launches = symbolic_path(dev, card)
    lap("symbolic path")

    # the corpus, each fixture its own process, beside the symbolic
    # path's host-only reference (a process too) and the daemons; this
    # process meanwhile runs the screens' edge checks, which time
    # nothing, while a thread waits on the others (the timed phases
    # below run alone)
    def beside(name, check):
        t0 = time.perf_counter()
        check(dev)
        log(f"phase: {name} {time.perf_counter() - t0:.1f} s (beside the "
            f"corpus processes)")

    # the daemon serves the 18 fixtures packed beside the corpus phase;
    # the unpacked one starts now to be ready for its queue
    daemon = daemon_start(pack=True)
    unpacked = daemon_start(pack=False)
    corpus = corpus_start()
    host = host_explore_start()
    daemon_corpus = daemon_corpus_start(daemon)
    tail = {}

    def corpus_tail():
        """The corpus's and the daemons' results, then the four-code
        queue packed and unpacked: waits on other processes, in a thread
        of its own while this one runs the edge checks."""
        try:
            windows = corpus_finish(corpus, card)
            daemon_corpus_finish(daemon_corpus, daemon, windows, card)
            tail["on"] = daemon_queue(daemon)
            tail["launches"] = daemon_stop(daemon)
            daemon_ready(unpacked)
            tail["off"] = daemon_queue(unpacked)
            daemon_stop(unpacked)
        except BaseException as e:  # re-raised below, in this thread
            tail["error"] = e

    waiter = threading.Thread(target=corpus_tail)
    waiter.start()
    try:
        beside("screen edges", check_screen_edges)
        beside("K5 edges", check_k5_edges)
        beside("K6 and K11 edges", check_prop_edges)
        host_open, host_wall = host_explore_finish(host)
    finally:
        waiter.join()
    if "error" in tail:
        raise tail["error"]
    if host_open != n_open:
        raise AssertionError(f"symbolic path: {n_open} open states, the "
                             f"host-only run {host_open}")
    log(f"symbolic path host-only: {host_open} open states (equal), "
        f"{host_wall:.3f} s (its own process, edge checks beside)")
    (queue_on, delta_on), daemon_launches = tail["on"], tail["launches"]
    queue_off, delta_off = tail["off"]
    if daemon_launches["sym_step_packed"] <= 0:
        raise AssertionError(f"daemon: K1's packed branch never launched "
                             f"({daemon_launches})")
    if queue_on != queue_off or delta_on["waves_packed"] < 1 \
            or delta_off["waves_packed"] != 0 \
            or delta_on["lane_windows"] >= delta_off["lane_windows"]:
        raise AssertionError(f"four-code queue: packed {delta_on}, "
                             f"unpacked {delta_off}, issues equal "
                             f"{queue_on == queue_off}")
    log(f"four-code queue: issues equal packed and unpacked "
        f"({sum(len(v) for v in queue_on.values())} issues); packed "
        f"{delta_on}, MTPU_PACK=0 {delta_off}; daemon launches "
        f"{daemon_launches}")
    lap("corpus, daemon, queues")
    packed_explore(dev, card)
    lap("packed explore")
    resume_and_spill(card)
    lap("resume and spill")
    k9_launches = merge_path(card)
    lap("merge rig")
    # K10's edge cases (untimed) while the corpus mode's ranks run
    corpus_mode(card, during=lambda: beside("K10 edges", check_k10_edges))
    lap("corpus mode")
    mesh_engine_launches = check_mesh_engine(dev, card, report, host_open)
    lap("meshed engine")
    concolic_path(card)
    lap("concolic")

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
    check_k1_wide(dev, WIDE_LANES, WIDE_K)
    lap("device loop")

    concrete_launches = concrete_path(dev, card, report)
    lap("concrete path")
    mesh_launches = mesh_path(dev, card, report)
    lap("mesh")

    wave = screen_wave(dev)
    check_screens(dev, report, wave)
    lap("screen kernels")
    screen_launches = screen_path(dev, wave, card)
    lap("screen path")
    screen_mix(dev)
    lap("propagation mix")
    fused_launches = fused_screen(dev, wave, card, report)
    lap("fused screen")

    def entry(name, source, replaces, counts=None):
        r = report[name]
        counts = counts or launches
        # K1 (and its packed branch) counts launches, one a read window,
        # apart from its steps
        runs = {"sym_step": "sym_run", "sym_step_packed": "sym_run_packed"}
        steps = {"steps": counts[name]} if name in runs else {}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": counts[runs.get(name, name)], **steps,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "device_ms": r["device_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"),
                **{k: r[k] for k in r if k.startswith(("unpacked_",
                                                       "shard_",
                                                       "lanes64_",
                                                       "wide_",
                                                       "narrow_",
                                                       "mid_",
                                                       "cold_",
                                                       "loop_",
                                                       "copy_",
                                                       "counts_",
                                                       "launch_",
                                                       "floor_",
                                                       "bound_rows_",
                                                       "levels_"))}}

    # bv256 has no launch of its own on the main path: its word ops run
    # inside K1's launches, so it is listed apart with its test launch's
    # times and its own (zero) main-path count
    inlined = dict(entry("bv256", "mythril_tpu_torch/csrc/bv256.cuh",
                         "mythril_tpu/ops/bv256.py:93"),
                   inlined_in="sym_step, interval_level, prop_fwd_level, "
                   "prop_back_round, lane_run, prop_fixpoint")
    rows = [entry(*row) for row in ROWS] + [
        entry("sym_step_packed", "mythril_tpu_torch/csrc/symstep.cu",
              "mythril_tpu/ops/symstep.py:453", daemon_launches)] + [
        entry(name, src, rep, screen_launches[prop])
        for name, src, rep, prop in SCREEN_ROWS] + [
        entry("merge_fingerprint", "mythril_tpu_torch/csrc/merge.cu",
              "mythril_tpu/laser/lane_engine.py:906",
              {"merge_fingerprint": k9_launches}),
        entry("lane_run", "mythril_tpu_torch/csrc/stepper.cu",
              "mythril_tpu/ops/stepper.py:902", concrete_launches),
        entry("prop_fixpoint", "mythril_tpu_torch/csrc/screen.cu",
              "mythril_tpu/ops/propagate.py:798", fused_launches)] + [
        entry(name, "mythril_tpu_torch/csrc/mesh.cu",
              f"mythril_tpu/parallel/mesh.py:{line}", mesh_launches)
        for name, line in (("lane_live", 110), ("lane_order", 138),
                           ("lane_gather", 139))] + [
        entry(name, f"mythril_tpu_torch/csrc/{src}", rep,
              mesh_engine_launches)
        for name, src, rep in MESH_ROWS]
    for r in rows:  # the same kernels' launches in the meshed main path
        if r["name"] in ("window_prologue", "window_dedup",
                         "window_epilogue", "sym_init"):
            r["mesh_launches"] = mesh_engine_launches[r["name"]]
    # every timed shape with its own bound: device_ms against bound_ms,
    # lanes64_device_ms against lanes64_bound_ms, ...
    fast = [f"{r['name']} {k}" for r in rows + [inlined] for k in r
            if k.endswith("device_ms") and r[k] is not None
            and r.get(k[:-9] + "bound_ms") is not None
            and r[k] < r[k[:-9] + "bound_ms"]]
    if fast:
        raise AssertionError(f"device time below the bound for {fast}: "
                             f"the byte or operation count is wrong")
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_run:.1f} s, the build included; by "
        f"phase (s): {', '.join(laps)}")
    log(json.dumps({"kernels": rows, "inlined": [inlined]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
