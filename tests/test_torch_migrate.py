"""Path-batch migration (``parallel/migrate.py``, a verbatim copy) in the
port: the verdict-cache sidecar round trip, the dead-thief fallback
under multi-way offers, and the checkpoint's verdict sidecar, which the
port's analysis writes through ``MigrationBus._entries_for`` beside
every round snapshot, as the JAX package's does.

The multi-rank corpus tests of ``tests/test_migration.py`` have their
counterparts in ``tests/test_torch_migrate_ranks.py``."""

import importlib
import json
import os
import re
import time

import pytest

from mythril_tpu_torch.support.support_args import args as p_args

from .fixture_paths import INPUTS
from .torch_isolation import isolated_analysis


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with isolated_analysis():
        p_args.device = "cpu"
        yield


def _checkpoint_run(pkg, code, ckpt):
    """``MythrilAnalyzer`` of ``pkg`` on runtime bytecode, bfs, two
    transactions, no lanes, with ``checkpoint=ckpt``; returns the
    sorted issue keys."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    ma = mod("orchestration.mythril_analyzer")
    ma.reset_analysis_state()
    # symbol names carry transaction ids: start both runs from the same
    # id, whatever the worker analysed before
    mod("laser.transaction.transaction_models").tx_id_manager \
        .restart_counter()
    dis = mod("orchestration.mythril_disassembler").MythrilDisassembler(
        eth=None)
    address, _ = dis.load_from_bytecode(code, bin_runtime=True)
    analyzer = ma.MythrilAnalyzer(
        disassembler=dis, strategy="bfs", address=address,
        cmd_args=mod("support.analysis_args").make_cmd_args(
            checkpoint=str(ckpt), tpu_lanes=0))
    report = analyzer.fire_lasers(modules=None, transaction_count=2)
    return sorted((i["swc-id"], i["address"], i["title"])
                  for i in report.sorted_issues())


def _words(x):
    """The words of a term's text, sorted: the same for two terms that
    differ only in the order of commutative operands (which follows the
    term table's history in the process)."""
    return sorted(re.findall(r"\w+", str(x)))


def _sidecar(pkg, path):
    """The sidecar's entries, loaded by ``pkg``, in a form both packages
    share: each entry's terms, facts and bounds as ``_words`` and its
    verdict, in a sorted list."""
    load = importlib.import_module(
        f"{pkg}.support.checkpoint").load_verdict_sidecar
    out = []
    for entry in load(path):
        terms, verdict = entry[0], entry[1]
        rest = [sorted(_words(x) for x in part) for part in entry[3:]]
        out.append((sorted(_words(t) for t in terms), verdict, rest))
    return sorted(out)


@pytest.fixture
def _default_solver_pools():
    """Both packages' solver pools at their default width (up to four
    workers). An earlier test may leave the port's at one worker
    (``tests/test_torch_daemon.py``'s ``test_verdict_parity_warm_vs_
    retired`` ends with ``configure_pool(workers=1)``), and with one
    worker neither package writes the sidecar for this run
    (``MTPU_SOLVER_WORKERS=1`` shows it)."""
    from mythril_tpu.smt.solver.pool import configure_pool as jax_pool
    from mythril_tpu_torch.smt.solver.pool import configure_pool

    jax_pool()
    configure_pool()
    yield


@pytest.mark.skipif(not INPUTS.exists(), reason="fixtures not present")
@pytest.mark.usefixtures("_default_solver_pools")
def test_checkpoint_run_writes_the_verdict_sidecar(tmp_path):
    """A ``--checkpoint`` run of ``overflow.sol.o`` at two transactions
    leaves ``FILE`` and ``FILE.verdicts`` in the port as in the JAX
    package, with the same issues and the same sidecar entries."""
    code = (INPUTS / "overflow.sol.o").read_text().strip()
    runs = {}
    for pkg in ("mythril_tpu", "mythril_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        issues = _checkpoint_run(pkg, code, d / "run.ckpt")
        runs[pkg] = (issues, sorted(p.name for p in d.iterdir()),
                     _sidecar(pkg, d / "run.ckpt.verdicts"))
    want, got = runs["mythril_tpu"], runs["mythril_tpu_torch"]
    assert want[1] == ["run.ckpt", "run.ckpt.verdicts"]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert want[2] and got[2] == want[2]


def _touch_old(path, age_s):
    past = time.time() - age_s
    os.utime(path, (past, past))


def test_dead_thief_fallback_multiway(tmp_path, monkeypatch):
    """Every offer whose claim goes stale (or that nobody claims while
    no thief is asking) resumes locally through ``analyze_batch``; the
    answered one merges its remote result."""
    from mythril_tpu_torch.parallel import migrate

    monkeypatch.setattr(migrate, "CLAIMED_WAIT_S", 0.5)
    bus = migrate.MigrationBus(str(tmp_path), rank=0, num_ranks=3)
    resumed = []
    monkeypatch.setattr(
        migrate, "analyze_batch",
        lambda meta, batch, timeout, lanes, work_tag="local",
        verdicts_path=None: resumed.append(meta["id"]) or
        [f"issue_{meta['id']}"])

    for i, state in enumerate(("dead", "answered", "unclaimed")):
        offer_id = f"0_{i}"
        meta = {"id": i, "contract": "x", "code_id": "c",
                "tx_count": 2, "round": 1, "victim": 0}
        (bus.dir / f"offer_{offer_id}.batch").write_bytes(b"")
        (bus.dir / f"offer_{offer_id}.meta.json").write_text(
            json.dumps(meta))
        bus.outstanding[offer_id] = meta
        if state == "dead":
            claim = bus.dir / f"claim_{offer_id}"
            claim.touch()
            _touch_old(claim, 30)
            _touch_old(bus.dir / f"offer_{offer_id}.meta.json", 30)
        elif state == "answered":
            (bus.dir / f"claim_{offer_id}").touch()
            migrate._dump_issues(
                bus.dir / f"result_{offer_id}.pkl", ["remote_issue"])
    (bus.dir / "done_1").touch()
    (bus.dir / "done_2").touch()

    merged_issues = []
    report = type("R", (), {"append_issue":
                            lambda self, i: merged_issues.append(i)})()
    bus.current_contract = "x"
    remote = bus.finalize_contract(report)

    assert sorted(resumed) == [0, 2], resumed
    assert remote == 1
    assert set(merged_issues) == {"issue_0", "issue_2", "remote_issue"}
    assert not bus.outstanding


def test_verdict_sidecar_roundtrip(tmp_path):
    """Cached proofs, facts and bounds survive the export, sidecar and
    import round trip in the port and answer the same constraint sets
    without a solver call."""
    from mythril_tpu_torch.laser.state.constraints import Constraints
    from mythril_tpu_torch.smt import ULE, ULT, symbol_factory
    from mythril_tpu_torch.smt.solver import verdicts
    from mythril_tpu_torch.smt.solver.solver_statistics import (
        SolverStatistics,
    )
    from mythril_tpu_torch.support.checkpoint import (
        load_verdict_sidecar,
        save_verdict_sidecar,
    )
    from mythril_tpu_torch.support.model import check_batch

    verdicts.reset_cache()
    verdicts.ENABLED = True
    bv = lambda v: symbol_factory.BitVecVal(v, 256)  # noqa: E731
    x = symbol_factory.BitVecSym("sidecar_x", 256)
    y = symbol_factory.BitVecSym("sidecar_y", 256)
    sat_set = Constraints([ULE(bv(5), x), ULE(x, bv(100)),
                           ULE(y, x)])
    unsat_set = Constraints([ULT(x, bv(4)), ULE(bv(9), x)])
    check_batch([sat_set, unsat_set])

    vc = verdicts.cache()
    term_lists = [[c.raw for c in s.get_all_constraints()]
                  for s in (sat_set, unsat_set)]
    sat_tids = tuple(t.tid for t in term_lists[0])
    fact = ULE(x, bv(100)).raw
    vc.note_facts(sat_tids, (fact,))
    vc.absorb_bounds(sat_tids, {x.raw.tid: (x.raw, 5, 100)})
    entries = vc.export_entries(term_lists)
    assert entries, "nothing exported"
    assert any(len(e) > 3 and (e[3] or e[4]) for e in entries), \
        "no facts/bounds exported"
    side = tmp_path / "batch.verdicts"
    assert save_verdict_sidecar(side, entries)

    verdicts.reset_cache()
    loaded = load_verdict_sidecar(side)
    assert len(loaded) == len(entries)
    thief = verdicts.cache()
    ss = SolverStatistics()
    replayed0 = ss.verdicts_replayed
    saved0 = ss.batch_counters()["queries_saved"]
    assert thief.import_entries(loaded) == len(loaded)
    assert ss.verdicts_replayed - replayed0 == len(loaded)

    sat_verdict, model = thief.probe(
        [c.raw for c in sat_set.get_all_constraints()])
    unsat_verdict, _ = thief.probe(
        [c.raw for c in unsat_set.get_all_constraints()])
    assert sat_verdict == verdicts.SAT
    assert unsat_verdict == verdicts.UNSAT
    assert ss.batch_counters()["queries_saved"] > saved0
    assert model is not None
    thief_tids = tuple(t.tid for t in term_lists[0])
    assert fact in thief.facts_for(thief_tids)
    bounds = thief.bounds_for(term_lists[0], thief_tids)
    assert bounds[x.raw.tid][1] >= 5 and bounds[x.raw.tid][2] <= 100
    n = thief.import_entries([(list(term_lists[1]), verdicts.UNSAT,
                               None)])
    assert n == 1
    verdicts.reset_cache()
