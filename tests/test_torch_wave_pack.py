"""Cross-tenant wave packing in the port, on the CPU (plain versions),
held bit for bit to the JAX package (docs/daemon.md §wave packing):

* ``ops/stepper.compile_packed_code`` against the JAX one: planes,
  ``seg_of``, ``seg_tab``, bases, the pow2 buckets, with and without
  loop-summary planes;
* the packed branch of the plain symbolic step (kernel row 2p's plain
  version) against the JAX ``sym_run_jit`` on the same packed arena and
  seeded states: every plane and ``visited``, with lanes that fork, read
  PC and CODESIZE and jump inside and out of their member;
* ``LaneEngine.explore_packed`` against each member's solo ``explore``
  and against the JAX ``explore_packed``; the merge within tenants only;
* ``retire_ring.TenantRouter`` order at K=1 and K=2 materialization
  workers, and the worker pool;
* ``wave_pack.PackGroup``: interleaved members against sequential runs,
  counters that never bleed across members, and a packed dispatch that
  raises ending every member's analysis with the error;
* the daemon's pack admission; the daemon-queue identity and the
  SIGTERM mid-pack resume are slow-marked, as their JAX originals'
  tiers are.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import stepper as JST
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.daemon.client import (
    DaemonClient, DaemonError, wait_ready,
)
from mythril_tpu_torch.daemon.server import AnalysisDaemon, Request
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.laser import retire_ring, wave_pack
from mythril_tpu_torch.laser.retire_ring import RetireRing, TenantRouter
from mythril_tpu_torch.ops import stepper as TST
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics
from mythril_tpu_torch.support import contracts, device_loop, runs
from mythril_tpu_torch.support.support_args import args as p_args

from .test_torch_symstep import KW, seeded_planes
from .test_wave_pack import _capture_entries as _jax_entries
from .torch_isolation import isolated_analysis

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def _random_code(rng, length):
    """Bytecode biased to PUSHes, jumps, PC and CODESIZE."""
    common = np.array([0x60, 0x61, 0x7F, 0x5B, 0x56, 0x57, 0x00, 0x58,
                       0x38, 0x01], np.uint8)
    code = rng.integers(0, 256, length).astype(np.uint8)
    pick = rng.random(length) < 0.6
    code[pick] = rng.choice(common, int(pick.sum()))
    return code.tobytes()


# ---------------------------------------------------------------------------
# the packed arena
# ---------------------------------------------------------------------------


class TestPackedCompile:
    A = bytes([0x60, 0x04, 0x56, 0x00, 0x5B, 0x00])   # PUSH1 4 JUMP
    B = bytes([0x60, 0x01, 0x60, 0x02, 0x01, 0x00])   # 1+2 STOP

    def test_arena_layout(self):
        cc, bases = TST.compile_packed_code(
            [(self.A, ()), (self.B, (2,))], device="cpu")
        assert bases == [0, len(self.A) + TST.SEG_GUARD]
        assert cc.size == bases[1] + len(self.B) + TST.SEG_GUARD
        packed = cc.packed.numpy()
        assert packed[0, 0] == 0x60 and packed[2, 0] == 0x56
        assert packed[bases[1], 0] == 0x60
        assert (packed[len(self.A):bases[1], 0] == 0x00).all()
        assert np.nonzero(packed[:, 2])[0].tolist() == [4]
        assert np.nonzero(packed[:, 3])[0].tolist() == [bases[1] + 2]
        # next_pc is in arena coordinates
        assert packed[bases[1], 1] == bases[1] + 2

    def test_seg_tables_pow2_bucketed(self):
        cc, bases = TST.compile_packed_code(
            [(self.A, ()), (self.B, ()), (self.A, ())], device="cpu")
        tab = cc.seg_tab.numpy()
        assert tab.shape == (4, 2)
        assert tab[0].tolist() == [0, len(self.A)]
        assert tab[2].tolist() == [bases[2], len(self.A)]
        seg = cc.seg_of.numpy()
        for i, base in enumerate(bases):
            assert seg[base] == i and seg[base + len(self.A) - 1] == i
        # the guard bytes after a member belong to it
        assert seg[bases[1] - 1] == 0
        plain = TST.compile_code(self.A, device="cpu")
        assert plain.seg_of is None and plain.seg_tab is None

    def test_arena_length_buckets_shared(self):
        cc1, _ = TST.compile_packed_code([(self.A, ()), (self.B, ())],
                                         device="cpu")
        cc2, _ = TST.compile_packed_code([(self.B, ()), (self.A * 3, ())],
                                         device="cpu")
        assert cc1.packed.shape == cc2.packed.shape
        assert cc1.seg_tab.shape == cc2.seg_tab.shape

    def test_an_empty_pack_raises(self):
        with pytest.raises(ValueError):
            TST.compile_packed_code([], device="cpu")

    @pytest.mark.parametrize("members,loopsum,long_member", [
        (1, False, False), (2, True, False), (3, False, False),
        (5, True, False), (3, True, True)])
    def test_matches_the_jax_package(self, members, loopsum, long_member):
        """Planes, tables, bases and size equal the JAX compile's, with
        and without per-member loop-summary planes; a member past the
        first code bucket moves the arena to the next one."""
        rng = np.random.default_rng(members * 10 + loopsum)
        spec = []
        for m in range(members):
            length = 5000 if long_member and m == 1 else \
                int(rng.integers(0, 700))
            code = _random_code(rng, length)
            fentries = tuple(sorted(set(
                rng.integers(0, length + 2, 3).tolist())))
            if loopsum and m % 2 == 0:
                spec.append((code, fentries,
                             rng.random(length + 1) < 0.1))
            else:
                spec.append((code, fentries))
        want, jbases = JST.compile_packed_code(spec)
        got, bases = TST.compile_packed_code(spec, device="cpu")
        assert bases == jbases and got.size == want.size
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed))
        np.testing.assert_array_equal(got.seg_of.numpy(),
                                      np.asarray(want.seg_of))
        np.testing.assert_array_equal(got.seg_tab.numpy(),
                                      np.asarray(want.seg_tab))
        assert got.packed.shape[0] - 1 == (16384 if long_member else 4096)


# ---------------------------------------------------------------------------
# the packed branch of the plain step (row 2p's plain version)
# ---------------------------------------------------------------------------

STEPS = 48
N = 64


def _probe_arena():
    codes, probes = zip(*(contracts.with_probe(c) for c in (
        contracts.build_symbolic_contract(4)[0],
        contracts.build_diamond_contract(k=3),
        contracts.build_coverage_contract())))
    members = [(c, (p["jumpi"], 0)) for c, p in zip(codes, probes)]
    return codes, probes, members


def _run_packed(members, planes, visited=True):
    """The same packed arena and planes through the JAX sym_run_jit and
    the port's plain sym_run; every plane and visited must be equal.
    Returns the port's planes and its CompiledCode."""
    jcc, jbases = JST.compile_packed_code(members)
    tcc, bases = TST.compile_packed_code(members, device="cpu")
    assert bases == jbases
    jst = JS.SymLaneState(**{k: jnp.asarray(v) for k, v in planes.items()})
    jvis = jnp.zeros(jcc.packed.shape[0], bool) if visited else None
    jout, jvis = JS.sym_run_jit(jcc, jst, STEPS,
                                jnp.asarray(TS.SYM_EXECUTABLE),
                                jnp.asarray(np.zeros(256, bool)), jvis)
    tvis = torch.zeros(tcc.packed.shape[0], dtype=torch.bool) \
        if visited else None
    tout, tvis = TS.sym_run(tcc, interop.state_from_numpy(planes, "cpu"),
                            STEPS, None, None, tvis)
    got = interop.state_to_numpy(tout)
    for name in TS.FIELDS:
        want = np.asarray(getattr(jout, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    if visited:
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    return got, tcc, bases


class TestPackedStep:
    @pytest.mark.parametrize("n_seeds", [40, 60])
    def test_probe_arena_matches_the_jax_package(self, n_seeds):
        """Entries at every member's base fork at its JUMPIs; probe
        lanes read PC and CODESIZE and jump to an in-member JUMPDEST,
        the member's size, the next member's JUMPDEST, a non-JUMPDEST,
        a word over 32 bits and a symbolic word; JUMPI lanes fork or
        branch. At 60 seeds in 64 lanes the fork pool runs dry."""
        codes, probes, members = _probe_arena()
        _, bases = TST.compile_packed_code(members, device="cpu")
        seeds = device_loop.packed_probe_seeds(
            TL.ObjectTable(), codes, bases, probes, KW["calldata_bytes"],
            n_seeds)
        got, cc, bases = _run_packed(members, seeded_planes(seeds, n=N))
        if n_seeds > 40:
            assert int(got["free_count"]) == 0
            return
        forks = int(got["flog_count"])
        fork_seg = cc.seg_of.numpy()[got["flog_pc"][:forks]]
        for m, (base, probe) in enumerate(zip(bases, probes)):
            assert (fork_seg == m).any(), m
            parked = (got["status"] == 5) \
                & (got["pc"] == base + probe["jump"] + 4)
            assert parked.sum() >= 4, m
        # fentry and the fork log keep member-local destinations
        assert got["flog_dest"][:forks].max() < max(len(c) for c in codes)

    def test_pc_codesize_and_jumps_resolve_against_the_member(self):
        """One probe lane per member jumping to its own JUMPDEST: PC
        pushed the member-local pc, CODESIZE the member's size, the
        jump landed at base + dest with fentry the member-local dest;
        a jump to the next member's JUMPDEST parked at the JUMP."""
        codes, probes, members = _probe_arena()
        _, bases = TST.compile_packed_code(members, device="cpu")
        objs = TL.ObjectTable()
        seeds = []
        for m in range(len(codes)):
            for dest in ("local", "cross"):
                s = device_loop.tx_entry_seed(objs, len(seeds) + 1,
                                              KW["calldata_bytes"])
                s["pc"] = bases[m] + probes[m]["jump"]
                nxt = (m + 1) % len(codes)
                d = probes[m]["jumpi"] if dest == "local" else (
                    bases[nxt] - bases[m] + probes[nxt]["jumpi"]) % (1 << 256)
                s["stack_v"][0] = TS.bv256.int_to_limbs(d)
                s["sp"] = 1
                seeds.append(s)
        planes = seeded_planes(seeds, n=16)
        lanes = [int(x) for x in np.argsort(planes["group"])
                 if planes["group"][x] > 0]
        got, _, _ = _run_packed(members, planes)
        for m in range(len(codes)):
            local, cross = lanes[2 * m], lanes[2 * m + 1]
            jump_pc = bases[m] + probes[m]["jump"] + 4
            stack = got["stack"][local].view(np.uint32)
            assert stack[0, 0] == len(codes[m])          # CODESIZE
            assert stack[1, 0] == probes[m]["jump"] + 1  # PC, member-local
            assert got["last_jump"][local] == jump_pc
            assert got["fentry"][local] == probes[m]["jumpi"]
            assert got["status"][cross] == 5 and got["pc"][cross] == jump_pc


# ---------------------------------------------------------------------------
# engine-level packed identity
# ---------------------------------------------------------------------------


def _sig(gs):
    return (gs.mstate.pc, len(gs.mstate.stack),
            len(gs.world_state.constraints), int(gs.mstate.memory._msize))


def _port_entries(code):
    TL.PATH_HISTORY[code] = 64
    return runs.entry_states(code.hex(), tpu_lanes=64)


@pytest.fixture(scope="module")
def codes():
    return {"A": contracts.build_fork_tree_contract(3, 1),
            "B": contracts.build_diamond_contract(3, dup_levels=0)}


class TestEnginePackedIdentity:
    def test_packed_equals_solo_and_the_jax_package(self, codes):
        A, B = codes["A"], codes["B"]
        with isolated_analysis():
            ja, jb = _jax_entries(A), _jax_entries(B)
        jout = JL.LaneEngine(n_lanes=64).explore_packed(
            [(A, list(ja), "req-a"), (B, list(jb), "req-b")])
        sa, sb = _port_entries(A), _port_entries(B)
        solo_a = sorted(_sig(g) for g in
                        TL.LaneEngine(n_lanes=64).explore(A, list(sa)))
        solo_b = sorted(_sig(g) for g in
                        TL.LaneEngine(n_lanes=64).explore(B, list(sb)))
        ss = SolverStatistics()
        saved0, packed0 = ss.dispatches_saved, ss.waves_packed
        eng = TL.LaneEngine(n_lanes=64)
        out = eng.explore_packed([(A, list(sa), "req-a"),
                                  (B, list(sb), "req-b")])
        assert sorted(_sig(g) for g in out["req-a"]) == solo_a
        assert sorted(_sig(g) for g in out["req-b"]) == solo_b
        assert sorted(_sig(g) for g in jout["req-a"]) == solo_a
        assert sorted(_sig(g) for g in jout["req-b"]) == solo_b
        assert ss.dispatches_saved > saved0
        assert ss.waves_packed == packed0 + 1
        # per-member coverage sliced out of the arena bitmap
        for code in (A, B):
            vis = eng.visited_by_code.get(code)
            assert vis is not None and vis.shape[0] == len(code)
            assert vis.any()

    def test_within_tenant_merge_only(self, codes):
        """Twin-heavy members in one packed wave with short windows:
        each tenant's merge fires (the owner guard in _collapse_twins
        never trips) and both tenants park what the solo run parks."""
        B = codes["B"]
        sb = _port_entries(B)
        solo = sorted(_sig(g) for g in TL.LaneEngine(
            n_lanes=64, window=12).explore(B, list(sb)))
        ss = SolverStatistics()
        merged0 = ss.lanes_merged
        out = TL.LaneEngine(n_lanes=64, window=12).explore_packed(
            [(B, list(sb), "t1"), (B, list(sb), "t2")])
        assert sorted(_sig(g) for g in out["t1"]) == solo
        assert sorted(_sig(g) for g in out["t2"]) == solo
        assert ss.lanes_merged > merged0

    def test_owner_tags_must_differ(self, codes):
        with pytest.raises(ValueError):
            TL.LaneEngine(n_lanes=8).explore_packed(
                [(codes["A"], [], "t"), (codes["B"], [], "t")])


# ---------------------------------------------------------------------------
# per-tenant retire routing + the persistent worker pool
# ---------------------------------------------------------------------------


class TestTenantRouting:
    @pytest.mark.parametrize("workers", [1, 2])
    def test_router_delivers_per_owner_in_submit_order(self, workers):
        router = TenantRouter(["t1", "t2"])
        ring = RetireRing(workers=workers, capacity=8, sink=router)
        rng = np.random.default_rng(7)
        expect = {"t1": [], "t2": []}
        for i in range(12):
            owner = "t1" if i % 2 else "t2"
            delay = float(rng.uniform(0, 0.01)) if workers > 1 else 0
            expect[owner].append(i)

            def pull(i=i, delay=delay):
                time.sleep(delay)
                return i

            def build(payload, owner=owner):
                return [(owner, payload)]

            ring.submit(pull, build)
        ring.flush()
        assert router.lists == expect

    def test_k1_spawns_zero_threads(self, monkeypatch):
        monkeypatch.delenv("MTPU_MAT_WORKERS", raising=False)
        before = list(retire_ring._POOL_THREADS)
        ring = RetireRing(workers=1, sink=[])
        ring.submit(lambda: 1, lambda p: [p])
        ring.flush()
        assert retire_ring._POOL_THREADS == before

    def test_pool_persists_across_rings(self):
        ss = SolverStatistics()
        RetireRing(workers=2, sink=[])
        reuses0 = ss.mat_pool_reuses
        threads0 = list(retire_ring._POOL_THREADS)
        sink = []
        ring = RetireRing(workers=2, sink=sink)
        ring.submit(lambda: 41, lambda p: [p + 1])
        ring.flush()
        assert sink == [42]
        assert ss.mat_pool_reuses > reuses0
        assert retire_ring._POOL_THREADS == threads0


# ---------------------------------------------------------------------------
# PackGroup interleaving
# ---------------------------------------------------------------------------


def _reset_modules():
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader

    for m in ModuleLoader().get_detection_modules(None, None):
        m.reset_module()
        m.cache.clear()


def _analysis(code, tx_count=1):
    """A lane analysis of ``code`` at 64 lanes (every detector); returns
    (issues, the report's exceptions)."""
    from mythril_tpu_torch.orchestration.mythril_analyzer import (
        MythrilAnalyzer,
    )
    from mythril_tpu_torch.orchestration.mythril_disassembler import (
        MythrilDisassembler,
    )
    from mythril_tpu_torch.support.analysis_args import make_cmd_args

    _reset_modules()
    dis = MythrilDisassembler(eth=None)
    address, _ = dis.load_from_bytecode(code.hex(), bin_runtime=True)
    analyzer = MythrilAnalyzer(
        disassembler=dis,
        cmd_args=make_cmd_args(execution_timeout=120, tpu_lanes=64),
        strategy="bfs", address=address)
    TL.PATH_HISTORY[code] = 64
    report = analyzer.fire_lasers(modules=None, transaction_count=tx_count)
    return (sorted((i.swc_id, i.title, i.address)
                   for i in report.issues.values()),
            list(report.exceptions))


class TestPackGroup:
    def test_interleaved_members_match_sequential(self, codes):
        A, B = codes["A"], codes["B"]
        seq = {"a": _analysis(A), "b": _analysis(B)}
        ss = SolverStatistics()
        packed0 = ss.waves_packed
        group = wave_pack.PackGroup()
        group.add_member("a", lambda: _analysis(A))
        group.add_member("b", lambda: _analysis(B))
        members = group.run()
        for key in ("a", "b"):
            assert members[key].error is None, members[key].error
            assert members[key].result == seq[key]
        assert ss.waves_packed > packed0
        # the fork tree finds nothing, the diamond's issue stays its own
        assert seq["a"] == ([], []) and len(seq["b"][0]) == 1

    def test_members_keep_their_own_keccak_hashes(self):
        """Two storage-mapping contracts (two transactions) packed: each
        member's SHA3 records resolve into its own analysis' keccak
        manager, whichever member dispatched the wave, so neither
        reports an arbitrary storage write its sequential run does not
        (the JAX package's packed daemon does, on these fixtures)."""
        from .fixture_paths import INPUTS

        codes = [bytes.fromhex((INPUTS / name).read_text().strip())
                 for name in ("metacoin.sol.o", "ether_send.sol.o")]
        seq = [_analysis(c, tx_count=2) for c in codes]
        group = wave_pack.PackGroup()
        for i, c in enumerate(codes):
            group.add_member(i, lambda c=c: _analysis(c, tx_count=2))
        members = group.run()
        for i in range(len(codes)):
            assert members[i].error is None, members[i].error
            assert members[i].result == seq[i], i
        assert all(swc != "124" for swc, _t, _a in seq[0][0] + seq[1][0])

    def test_counters_never_bleed_across_members(self, codes):
        group = wave_pack.PackGroup()

        def body(code):
            SolverStatistics().bump(daemon_requests=1)
            return _analysis(code)

        group.add_member("a", lambda: body(codes["A"]))
        group.add_member("b", lambda: body(codes["B"]))
        members = group.run()
        for key in ("a", "b"):
            assert members[key].counters.get("daemon_requests") == 1
        assert group.shared_counters.get("lane_windows", 0) >= 1
        assert sum(members[k].counters.get("lane_windows", 0)
                   for k in ("a", "b")) == 0

    def test_a_failed_packed_dispatch_ends_every_member(self, codes,
                                                        monkeypatch):
        """A packed dispatch that raises is delivered to every waiting
        member: each analysis ends with the error (recorded in its
        report), none goes on with its states on the host."""
        def broken(self, members):
            raise RuntimeError("packed dispatch failed")

        monkeypatch.setattr(TL.LaneEngine, "explore_packed", broken)
        group = wave_pack.PackGroup()
        group.add_member("a", lambda: _analysis(codes["A"]))
        group.add_member("b", lambda: _analysis(codes["B"]))
        members = group.run()
        for key in ("a", "b"):
            issues, exceptions = members[key].result
            assert issues == []
            assert any("packed dispatch failed" in e for e in exceptions)


# ---------------------------------------------------------------------------
# daemon admission
# ---------------------------------------------------------------------------


@pytest.fixture
def daemon_state():
    """Undo what a running daemon arms process-wide (the port's warm
    store, the solver-session keep-alive)."""
    from mythril_tpu_torch.smt.solver import core
    from mythril_tpu_torch.support import warm_store

    yield
    warm_store.reset()
    core.set_keep_sessions(False)
    core.reset_session(force=True)


class TestDaemonPacking:
    def test_pack_admission_requires_same_shape(self, tmp_path):
        d = AnalysisDaemon(tmp_path / "shape", workers=1)
        head = Request({"code": "6001", "tpu_lanes": 64})
        peer = Request({"code": "6002", "tpu_lanes": 64, "id": "p"})
        odd = Request({"code": "6003", "tpu_lanes": 64, "timeout": 99,
                       "id": "o"})
        host = Request({"code": "6004", "id": "h"})  # host mode
        d._pending = [peer, odd, host]
        assert [r.id for r in d._pop_pack_peers(head)] == ["p"]
        assert [r.id for r in d._pending] == ["o", "h"]

    def test_pack_gate_off_means_no_peers(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_PACK", "0")
        d = AnalysisDaemon(tmp_path / "off", workers=1)
        head = Request({"code": "6001", "tpu_lanes": 64})
        d._pending = [Request({"code": "6002", "tpu_lanes": 64})]
        assert d._pop_pack_peers(head) == []
        assert len(d._pending) == 1

    def test_pack_max_caps_the_members(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_PACK_MAX", "3")
        d = AnalysisDaemon(tmp_path / "cap", workers=1)
        head = Request({"code": "6001", "tpu_lanes": 64})
        d._pending = [Request({"code": f"60{i:02x}", "tpu_lanes": 64,
                               "id": f"r{i}"}) for i in range(2, 6)]
        assert [r.id for r in d._pop_pack_peers(head)] == ["r2", "r3"]
        assert len(d._pending) == 2

    def test_resumed_requests_stay_solo(self, tmp_path):
        d = AnalysisDaemon(tmp_path / "res", workers=1)
        head = Request({"code": "6001", "tpu_lanes": 64})
        d._pending = [Request({"code": "6002", "tpu_lanes": 64},
                              resumed=True)]
        assert d._pop_pack_peers(head) == []
        resumed = Request({"code": "6003", "tpu_lanes": 64}, resumed=True)
        d._pending = [Request({"code": "6004", "tpu_lanes": 64})]
        assert d._pop_pack_peers(resumed) == []


def _run_daemon_queue(tmp, queue, pack_on, monkeypatch):
    """Serve the queue in-process; returns ({rid: report row}, counter
    deltas)."""
    monkeypatch.setenv("MTPU_PACK", "1" if pack_on else "0")
    d = AnalysisDaemon(tmp, workers=1)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    assert wait_ready(d.socket_path, 120)
    ss = SolverStatistics()
    base = {k: getattr(ss, k) for k in
            ("waves_packed", "lane_windows", "dispatches_saved")}
    warm = threading.Thread(target=lambda: DaemonClient(
        d.socket_path).analyze(queue["warm"], tpu_lanes=64, timeout=120,
                               transaction_count=1, id="warm"))
    warm.start()
    time.sleep(0.6)
    rows = {}

    def submit(rid, code):
        rows[rid] = DaemonClient(d.socket_path).analyze(
            code, tpu_lanes=64, timeout=120, transaction_count=1, id=rid)

    threads = [threading.Thread(target=submit, args=(rid, code))
               for rid, code in queue.items() if rid != "warm"]
    for s in threads:
        s.start()
    for s in threads:
        s.join(timeout=300)
    warm.join(timeout=300)
    delta = {k: getattr(ss, k) - base[k] for k in base}
    DaemonClient(d.socket_path).shutdown()
    t.join(timeout=60)
    return rows, delta


def _canon_row(row):
    return sorted((i["swc-id"], i.get("address"), i.get("function"))
                  for i in row["issues"])


@pytest.mark.slow
class TestDaemonQueue:
    def test_packed_queue_identity_and_fewer_dispatches(
            self, tmp_path, monkeypatch, daemon_state):
        queue = {
            "warm": contracts.build_fork_tree_contract(3, 1).hex(),
            "ra": contracts.build_fork_tree_contract(4, 1).hex(),
            "rb": contracts.build_diamond_contract(5, dup_levels=0).hex(),
            "rc": contracts.build_diamond_contract(3, dup_levels=0).hex(),
        }
        rows_on, d_on = _run_daemon_queue(tmp_path / "on", queue, True,
                                          monkeypatch)
        rows_off, d_off = _run_daemon_queue(tmp_path / "off", queue, False,
                                            monkeypatch)
        assert d_on["waves_packed"] >= 1 and d_on["dispatches_saved"] >= 1
        assert d_on["lane_windows"] < d_off["lane_windows"]
        assert d_off["waves_packed"] == 0
        for rid in ("ra", "rb", "rc"):
            assert not rows_on[rid]["exceptions"]
            assert _canon_row(rows_on[rid]) == _canon_row(rows_off[rid])
            issues, _ = _analysis(bytes.fromhex(queue[rid]))
            assert sorted((i["swc-id"], i.get("title"), i.get("address"))
                          for i in rows_on[rid]["issues"]) == issues, rid
        packed_rows = [r for r in rows_on.values() if r.get("packed")]
        assert len(packed_rows) >= 2
        for row in packed_rows:
            assert row["counters"].get("daemon_requests") == 1


# ---------------------------------------------------------------------------
# SIGTERM mid-pack -> per-request resume (two daemon processes)
# ---------------------------------------------------------------------------

#: a daemon process on the CPU: ``myth serve`` with the plain versions
SERVE_ON_CPU = (
    "import sys\n"
    "from mythril_tpu_torch.support.support_args import args\n"
    "args.device = 'cpu'\n"
    "from mythril_tpu_torch.interfaces import cli\n"
    "sys.argv = ['myth', 'serve', '--out-dir', sys.argv[1]]\n"
    "cli.main()\n")


@pytest.mark.slow
class TestSigtermMidPack:
    def test_members_resume_independently(self, tmp_path):
        out = tmp_path / "serve"
        queue = {"ra": contracts.build_fork_tree_contract(4, 1).hex(),
                 "rb": contracts.build_diamond_contract(5,
                                                        dup_levels=0).hex(),
                 "rc": contracts.build_diamond_contract(3,
                                                        dup_levels=0).hex()}
        # a second a finished path: the plain versions run these small
        # contracts in well under the JAX package's compile time, so
        # the pack must still be in flight half a second after it
        # started
        env = dict(os.environ, MTPU_PACK="1", MTPU_PATH_DELAY="1.0")

        def start(e):
            return subprocess.Popen(
                [sys.executable, "-c", SERVE_ON_CPU, str(out)], env=e,
                cwd=str(REPO), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)

        proc = start(env)
        from mythril_tpu_torch.daemon import SOCKET_NAME

        sock = str(out / SOCKET_NAME)
        assert wait_ready(sock, 120)
        events = {rid: [] for rid in queue}

        def submit(rid):
            try:
                for ev in DaemonClient(sock).submit(
                        queue[rid], bin_runtime=True, timeout=300,
                        tpu_lanes=64, transaction_count=1, id=rid):
                    events[rid].append(ev)
            except (DaemonError, OSError) as e:
                events[rid].append({"event": "hangup", "error": str(e)})

        threads = [threading.Thread(target=submit, args=(rid,))
                   for rid in queue]
        for t in threads:
            t.start()
            time.sleep(0.2)
        deadline = time.monotonic() + 180
        while not all(any(e.get("event") == "started" for e in evs)
                      for evs in events.values()):
            assert time.monotonic() < deadline, events
            time.sleep(0.1)
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
        for t in threads:
            t.join(timeout=30)
        saved = json.loads((out / "daemon_queue.json").read_text())
        interrupted = {r["id"] for r in saved["interrupted"]}
        assert interrupted and interrupted <= set(queue)

        env["MTPU_PATH_DELAY"] = "0"
        proc2 = start(env)
        try:
            assert wait_ready(sock, 120)
            client = DaemonClient(sock)
            rows = {}
            deadline = time.monotonic() + 300
            while len(rows) < len(queue):
                for rid in queue:
                    if rid not in rows:
                        row = client.result(rid)
                        if row.get("event") == "report":
                            rows[rid] = row
                assert time.monotonic() < deadline, rows.keys()
                time.sleep(0.25)
            client.shutdown()
            proc2.communicate(timeout=60)
        finally:
            if proc2.poll() is None:
                proc2.kill()
        for rid in queue:
            issues, _ = _analysis(bytes.fromhex(queue[rid]))
            assert sorted((i["swc-id"], i.get("title"), i.get("address"))
                          for i in rows[rid]["issues"]) == issues, rid
            if rid in interrupted:
                assert rows[rid]["resumed"] is True
