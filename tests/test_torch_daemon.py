"""The resident analysis daemon in the port (mythril_tpu_torch/daemon/,
docs/daemon.md), on the CPU: the daemon runs in-process with
``args.device = "cpu"`` (the plain versions), as the JAX package's
``tests/test_daemon.py`` runs its own:

* protocol framing (roundtrip, caps, truncation, the socket probe);
* the cost-model scheduling (LPT, median inheritance, FIFO, resumed
  first, the splittable flag);
* start/submit/shutdown with report identity against the port's
  one-shot analyzer; a second request starting warm; the queue ordered
  end to end; an error request that leaves the worker serving;
* the code-plane half of the cross-request compile accounting;
* the ``MTPU_DAEMON`` gate off: the one-shot CLI touches no daemon;
* the solver-session keep-alive;
* SIGTERM mid-request, restart and resume (slow-marked: its JAX
  original is the reference's timing-dependent SIGTERM test).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from mythril_tpu_torch.daemon import SOCKET_NAME, configured_socket, protocol
from mythril_tpu_torch.daemon.client import (
    DaemonClient, DaemonError, wait_ready,
)
from mythril_tpu_torch.daemon.server import AnalysisDaemon, Request
from mythril_tpu_torch.orchestration.mythril_analyzer import (
    MythrilAnalyzer, reset_analysis_state,
)
from mythril_tpu_torch.orchestration.mythril_disassembler import (
    MythrilDisassembler,
)
from mythril_tpu_torch.smt.solver import core
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics
from mythril_tpu_torch.support.analysis_args import make_cmd_args
from mythril_tpu_torch.support.support_args import args as p_args

from .fixture_paths import INPUTS
from .test_checkpoint_live import _fork_tree_code
from .torch_isolation import isolated_analysis

REPO = Path(__file__).resolve().parent.parent
SUICIDE_HEX = (INPUTS / "suicide.sol.o").read_text().strip()


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    """The port's plain versions, and nothing a daemon arms
    process-wide (warm store, session keep-alive) left behind."""
    from mythril_tpu_torch.support import warm_store

    with isolated_analysis():
        p_args.device = "cpu"
        yield
    warm_store.reset()
    core.set_keep_sessions(False)
    core.reset_session(force=True)


def _canon(issues):
    return sorted((i["swc-id"], i.get("address"), i.get("function"))
                  for i in issues)


def _oneshot(code_hex, timeout=60, tx_count=2):
    """The in-process one-shot baseline with the daemon's request
    defaults (make_cmd_args)."""
    reset_analysis_state()
    dis = MythrilDisassembler(eth=None)
    address, _ = dis.load_from_bytecode(code_hex, bin_runtime=True)
    analyzer = MythrilAnalyzer(
        disassembler=dis,
        cmd_args=make_cmd_args(execution_timeout=timeout),
        strategy="bfs", address=address)
    return analyzer.fire_lasers(modules=None, transaction_count=tx_count)


@pytest.fixture
def daemon(tmp_path):
    """An in-process daemon on a worker thread; shuts down at exit."""
    d = AnalysisDaemon(tmp_path / "serve", workers=1)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    assert wait_ready(d.socket_path, 60), "daemon never became ready"
    client = DaemonClient(d.socket_path)
    yield d, client
    try:
        client.shutdown()
    except (DaemonError, OSError):
        pass
    t.join(timeout=30)


class TestProtocol:
    def test_frame_roundtrip(self):
        a, b = socket.socketpair()
        try:
            protocol.send_frame(a, {"op": "ping", "n": [1, 2, 3]})
            assert protocol.recv_frame(b) == {"op": "ping",
                                              "n": [1, 2, 3]}
        finally:
            a.close()
            b.close()

    def test_clean_eof_is_none(self):
        a, b = socket.socketpair()
        a.close()
        try:
            assert protocol.recv_frame(b) is None
        finally:
            b.close()

    def test_truncated_frame_raises(self):
        a, b = socket.socketpair()
        try:
            a.sendall(b"\x00\x00\x00\x10abc")  # 16 promised, 3 sent
            a.close()
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)
        finally:
            b.close()

    def test_oversized_length_rejected(self):
        a, b = socket.socketpair()
        try:
            a.sendall((protocol.MAX_FRAME + 1).to_bytes(4, "big"))
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)
        finally:
            a.close()
            b.close()

    def test_live_listener_refused(self, tmp_path):
        path = str(tmp_path / "x.sock")
        first = protocol.listen_unix(path)
        try:
            with pytest.raises(OSError):
                protocol.listen_unix(path)
        finally:
            first.close()

    def test_stale_socket_replaced(self, tmp_path):
        path = str(tmp_path / "x.sock")
        protocol.listen_unix(path).close()  # dead listener left behind
        protocol.listen_unix(path).close()


class TestScheduling:
    """Queue ordering straight off the daemon's scheduler (no
    analysis): LPT over stats.json walls, FIFO fallback, resumed
    first."""

    def _daemon(self, tmp_path):
        return AnalysisDaemon(tmp_path / "d", workers=1)

    def _req(self, name, code="60016001", resumed=False):
        return Request({"code": code + name.encode().hex(),
                        "name": name}, resumed=resumed)

    def test_lpt_orders_known_costs(self, tmp_path):
        d = self._daemon(tmp_path)
        d._stats = {"small": {"wall_s": 1.0}, "big": {"wall_s": 10.0},
                    "mid": {"wall_s": 5.0}}
        for name in ("small", "big", "mid"):
            d._pending.append(self._req(name))
        order = [d._pop_scheduled().cost_key for _ in range(3)]
        assert order == ["big", "mid", "small"]

    def test_unknown_hash_inherits_median_fifo_ties(self, tmp_path):
        d = self._daemon(tmp_path)
        d._stats = {"small": {"wall_s": 1.0}, "big": {"wall_s": 10.0},
                    "mid": {"wall_s": 5.0}}
        for name in ("unknownA", "small", "big", "mid"):
            d._pending.append(self._req(name))
        order = [d._pop_scheduled().cost_key for _ in range(4)]
        assert order == ["big", "unknownA", "mid", "small"]

    def test_fifo_fallback_with_no_history(self, tmp_path):
        d = self._daemon(tmp_path)
        d._stats = {}
        for name in ("c1", "c2", "c3"):
            d._pending.append(self._req(name))
        order = [d._pop_scheduled().cost_key for _ in range(3)]
        assert order == ["c1", "c2", "c3"]

    def test_resumed_request_goes_first(self, tmp_path):
        d = self._daemon(tmp_path)
        d._stats = {"big": {"wall_s": 10.0}}
        d._pending.append(self._req("big"))
        d._pending.append(self._req("interrupted", resumed=True))
        assert d._pop_scheduled().cost_key == "interrupted"

    def test_splittable_above_fair_share(self, tmp_path):
        d = self._daemon(tmp_path)
        d.workers = 2
        d._stats = {"big": {"wall_s": 30.0}, "small": {"wall_s": 1.0},
                    "tiny": {"wall_s": 0.5}}
        for name in ("big", "small", "tiny"):
            d._pending.append(self._req(name))
        d._annotate_costs()
        flags = {r.cost_key: r.splittable for r in d._pending}
        assert flags == {"big": True, "small": False, "tiny": False}
        d.workers = 1
        d._annotate_costs()
        assert not any(r.splittable for r in d._pending)


class TestLifecycle:
    def test_start_submit_shutdown_report_identity(self, daemon):
        d, client = daemon
        assert client.ping()["event"] == "pong"
        row = client.analyze(SUICIDE_HEX, bin_runtime=True, timeout=60,
                             name="suicide.sol.o")
        base = _oneshot(SUICIDE_HEX)
        assert row["issue_count"] == len(base.issues)
        assert row["exceptions"] == []
        assert _canon(row["issues"]) == sorted(
            (i.swc_id, i.address, i.function)
            for i in base.issues.values())
        assert json.loads(row["output"]) == json.loads(base.as_json())

    def test_lane_request_equals_the_one_shot_lane_run(self, daemon):
        """A lane request (64 lanes, the plain versions) reports what
        the port's one-shot lane analysis of the same code reports."""
        d, client = daemon
        row = client.analyze(SUICIDE_HEX, bin_runtime=True, timeout=60,
                             tpu_lanes=64)
        reset_analysis_state()
        dis = MythrilDisassembler(eth=None)
        address, _ = dis.load_from_bytecode(SUICIDE_HEX, bin_runtime=True)
        base = MythrilAnalyzer(
            disassembler=dis, strategy="bfs", address=address,
            cmd_args=make_cmd_args(execution_timeout=60, tpu_lanes=64),
        ).fire_lasers(modules=None, transaction_count=2)
        assert row["exceptions"] == []
        assert json.loads(row["output"]) == json.loads(base.as_json())

    def test_second_request_starts_warm(self, daemon):
        d, client = daemon
        r1 = client.analyze(SUICIDE_HEX, bin_runtime=True, timeout=60)
        r2 = client.analyze(SUICIDE_HEX, bin_runtime=True, timeout=60)
        assert r1["issues"] == r2["issues"]
        assert r2["counters"]["warm_hits"] >= 1
        assert r2["counters"]["verdicts_warmed"] > 0
        assert r2["counters"]["daemon_requests"] == 1
        got = client.result(r2["id"])
        assert got["event"] == "report"
        assert got["issues"] == r2["issues"]

    def test_queue_orders_by_cost_model_end_to_end(self, daemon):
        d, client = daemon
        started = []
        real_analyze = d._analyze

        def empty():
            return {"output": "{}", "outform": "json", "exceptions": [],
                    "issue_count": 0, "issues": []}

        def stub(req):
            started.append(req.params.get("name"))
            time.sleep(0.05)
            return empty()

        d._record_cost = lambda req, wall: None
        hold = threading.Event()
        try:
            d._stats = {"blocker": {"wall_s": 5.0},
                        "small": {"wall_s": 1.0},
                        "big": {"wall_s": 10.0}, "mid": {"wall_s": 5.0}}

            def blocker_stub(req):
                started.append(req.params.get("name"))
                hold.wait(timeout=30)
                return empty()

            d._analyze = blocker_stub
            results = []

            def submit(name, code):
                results.append(client.analyze(code, name=name))

            t0 = threading.Thread(target=submit,
                                  args=("blocker", "6001600155"))
            t0.start()
            while "blocker" not in started:
                time.sleep(0.01)
            d._analyze = stub
            threads = []
            for name, code in (("small", "6002600255"),
                               ("big", "6003600355"),
                               ("mid", "6004600455")):
                t = threading.Thread(target=submit, args=(name, code))
                t.start()
                threads.append(t)
                deadline = time.monotonic() + 10
                while True:
                    with d._lock:
                        if any(r.params.get("name") == name
                               for r in d._pending):
                            break
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
            with d._lock:
                assert len(d._pending) == 3
            hold.set()
            for t in [t0] + threads:
                t.join(timeout=30)
            assert started == ["blocker", "big", "mid", "small"]
        finally:
            d._analyze = real_analyze
            hold.set()

    def test_error_request_does_not_kill_worker(self, daemon):
        d, client = daemon
        with pytest.raises(DaemonError):
            client.analyze("")
        # a non-hex body reaches the analyzer, which records the
        # failure in the report: the row names it
        row = client.analyze("zz-not-hex")
        assert row["issue_count"] == 0
        assert row["exceptions"]
        row = client.analyze(SUICIDE_HEX, bin_runtime=True, timeout=60)
        assert row["issue_count"] >= 1 and row["exceptions"] == []


class TestCompileReuseAccounting:
    """The request-epoch seam (lane_engine.REQUEST_EPOCH) on its
    code-plane half: a code-plane cache hit whose compile belongs to an
    earlier request epoch books compile_reuse_hits; same-epoch hits (the
    one-shot world) book nothing. The JAX package's other half counts
    warmed XLA window variants; the kernels have no per-shape compile,
    so the port has no variants to count."""

    def test_code_plane_reuse_across_epochs(self, monkeypatch):
        from mythril_tpu_torch.laser import lane_engine

        monkeypatch.setattr(lane_engine, "_CC_CACHE", {})
        monkeypatch.setattr(lane_engine, "_CC_EPOCH", {})
        monkeypatch.setattr(lane_engine, "_PACK_CC_CACHE", {})
        monkeypatch.setattr(lane_engine, "_PACK_CC_EPOCH", {})
        monkeypatch.setattr(lane_engine, "REQUEST_EPOCH", [0])
        ss = SolverStatistics()
        base = ss.compile_reuse_hits
        code = bytes.fromhex(SUICIDE_HEX)
        first = lane_engine._compiled_code(code, (), "cpu")
        assert lane_engine._compiled_code(code, (), "cpu") is first
        assert ss.compile_reuse_hits == base
        lane_engine.REQUEST_EPOCH[0] += 1
        assert lane_engine._compiled_code(code, (), "cpu") is first
        assert ss.compile_reuse_hits == base + 1
        # the packed arena's cache books the same way
        keys = ((code, (), ()), (b"\x60\x00\x00", (), ()))
        arena = lane_engine._compiled_packed(keys, "cpu")
        assert lane_engine._compiled_packed(keys, "cpu") is arena
        assert ss.compile_reuse_hits == base + 1
        lane_engine.REQUEST_EPOCH[0] += 1
        assert lane_engine._compiled_packed(keys, "cpu") is arena
        assert ss.compile_reuse_hits == base + 2


class TestGateOff:
    """The MTPU_DAEMON master gate: unset/0 means the one-shot path
    runs with no socket, no daemon module, no daemon dirs."""

    def test_configured_socket_gate(self, monkeypatch):
        monkeypatch.delenv("MTPU_DAEMON", raising=False)
        assert configured_socket() is None
        assert configured_socket("/tmp/x.sock") == "/tmp/x.sock"
        monkeypatch.setenv("MTPU_DAEMON", "0")
        assert configured_socket() is None
        monkeypatch.setenv("MTPU_DAEMON", "/tmp/y.sock")
        assert configured_socket() == "/tmp/y.sock"

    def test_oneshot_cli_never_touches_daemon(self, tmp_path):
        """A plain analyze run of the port in a clean subprocess (host
        only) imports no socket-touching daemon submodule and leaves no
        socket or daemon artifact."""
        script = (
            "import sys, os\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "os.environ.pop('MTPU_DAEMON', None)\n"
            "sys.argv = ['myth', 'analyze', '-c', %r,\n"
            "            '--bin-runtime', '-o', 'json',\n"
            "            '--execution-timeout', '60', '--tpu-lanes', '0']\n"
            "from mythril_tpu_torch.interfaces import cli\n"
            "try:\n"
            "    cli.main()\n"
            "except SystemExit as e:\n"
            "    mods = [m for m in sys.modules\n"
            "            if m.startswith('mythril_tpu_torch.daemon.')]\n"
            "    print('DAEMON_MODULES', mods)\n"
            "    print('EXIT', e.code)\n"
        ) % SUICIDE_HEX
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            cwd=str(tmp_path))
        assert "DAEMON_MODULES []" in proc.stdout, proc.stdout[-2000:]
        assert "EXIT 1" in proc.stdout
        leftovers = [p.name for p in tmp_path.iterdir()]
        assert SOCKET_NAME not in leftovers
        assert "daemon_queue.json" not in leftovers


class TestSessionKeepAlive:
    """core.reset_session's retirement is opt-out under the daemon;
    sessions hold only universally valid clauses, so verdicts are
    identical warm-vs-retired (at K=1 and K=4)."""

    def setup_method(self):
        core.set_keep_sessions(False)
        core.reset_session(force=True)
        core.set_thread_session(None)

    teardown_method = setup_method

    def test_keep_mode_preserves_sessions(self):
        sess = core.ensure_thread_session()
        core.set_keep_sessions(True)
        core.reset_session()
        assert core.thread_session() is sess
        assert sess.gen == core._SESSION_GEN[0]
        core.reset_session(force=True)
        assert sess.gen != core._SESSION_GEN[0]

    def test_retire_mode_retires(self):
        sess = core.ensure_thread_session()
        core.reset_session()
        assert sess.gen != core._SESSION_GEN[0]

    @pytest.mark.parametrize("workers", [1, 4])
    def test_verdict_parity_warm_vs_retired(self, workers):
        from mythril_tpu_torch.laser.state.constraints import Constraints
        from mythril_tpu_torch.smt import ULE, ULT, symbol_factory
        from mythril_tpu_torch.smt.solver import verdicts as verdict_mod
        from mythril_tpu_torch.smt.solver.pool import configure_pool
        from mythril_tpu_torch.support.model import check_batch

        BV = lambda v: symbol_factory.BitVecVal(v, 256)  # noqa: E731
        x = symbol_factory.BitVecSym(f"tka_x{workers}", 256)
        y = symbol_factory.BitVecSym(f"tka_y{workers}", 256)
        prefix = [ULE(BV(16), x), ULE(x, BV(4096))]
        round1 = [Constraints(prefix + [ULE(y, x + BV(j))])
                  for j in range(8)]
        round1.append(Constraints([ULT(x, BV(4)), ULE(BV(9), x)]))
        round2 = [Constraints(prefix + [ULE(y, x + BV(j)), ULT(BV(j), y)])
                  for j in range(8)]
        round2.append(Constraints([ULT(x, BV(2)), ULE(BV(7), x),
                                   ULE(y, BV(5))]))

        def two_rounds():
            v1 = check_batch([Constraints(list(c)) for c in round1])
            core.reset_session()
            v2 = check_batch([Constraints(list(c)) for c in round2])
            return v1, v2

        configure_pool(workers=workers)
        verdict_mod.ENABLED = False
        try:
            core.set_keep_sessions(True)
            warm = two_rounds()
            core.set_keep_sessions(False)
            core.reset_session(force=True)
            retired = two_rounds()
        finally:
            verdict_mod.ENABLED = True
            core.set_keep_sessions(False)
            core.reset_session(force=True)
            configure_pool(workers=1)
        assert warm == retired


#: a daemon process on the CPU: ``myth serve`` with the plain versions
SERVE_ON_CPU = (
    "import sys\n"
    "from mythril_tpu_torch.support.support_args import args\n"
    "args.device = 'cpu'\n"
    "from mythril_tpu_torch.interfaces import cli\n"
    "sys.argv = ['myth', 'serve', '--out-dir', sys.argv[1]]\n"
    "cli.main()\n")


@pytest.mark.slow
class TestSigtermDrainResume:
    def test_sigterm_midrequest_restart_resume_identical(self, tmp_path):
        """SIGTERM mid-request: the queue persists with the in-flight
        request marked interrupted; a restarted daemon re-enqueues it
        first and its analysis resumes from the per-request checkpoint,
        with the uninterrupted one-shot run's issues."""
        out = tmp_path / "serve"
        code_hex = _fork_tree_code(k=4).hex()
        env = dict(os.environ, MTPU_PATH_DELAY="0.25")

        def start(e):
            return subprocess.Popen(
                [sys.executable, "-c", SERVE_ON_CPU, str(out)], env=e,
                cwd=str(REPO), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)

        proc = start(env)
        sock = str(out / SOCKET_NAME)
        assert wait_ready(sock, 120)
        client = DaemonClient(sock)
        events = []

        def submit():
            try:
                for ev in client.submit(code_hex, bin_runtime=True,
                                        timeout=300):
                    events.append(ev)
            except DaemonError as e:
                events.append({"event": "hangup", "error": str(e)})

        t = threading.Thread(target=submit)
        t.start()
        deadline = time.monotonic() + 60
        while not any(e.get("event") == "started" for e in events):
            assert time.monotonic() < deadline, events
            time.sleep(0.05)
        time.sleep(2.5)
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
        t.join(timeout=30)
        assert proc.returncode != 0
        queue = json.loads((out / "daemon_queue.json").read_text())
        assert len(queue["interrupted"]) == 1
        rid = queue["interrupted"][0]["id"]
        assert (out / "requests" / rid / "resume.ckpt").exists()

        env["MTPU_PATH_DELAY"] = "0"
        proc2 = start(env)
        try:
            assert wait_ready(sock, 120)
            deadline = time.monotonic() + 300
            while True:
                row = client.result(rid)
                if row.get("event") == "report":
                    break
                assert row.get("event") in ("pending", "unknown")
                assert time.monotonic() < deadline, row
                time.sleep(0.25)
            assert row["resumed"] is True
            assert client.ping()["counters"]["requests_resumed"] >= 1
            client.shutdown()
            proc2.communicate(timeout=60)
        finally:
            if proc2.poll() is None:
                proc2.kill()
        baseline = _oneshot(code_hex, timeout=300)
        assert _canon(row["issues"]) == sorted(
            (i.swc_id, i.address, i.function)
            for i in baseline.issues.values())
