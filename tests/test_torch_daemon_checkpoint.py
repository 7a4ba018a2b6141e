"""The daemon's round-boundary checkpoints under packed waves, on the
CPU (the port's plain versions).

A packed member's open states carry integer-overflow annotations whose
captured state is a ``lane_engine._LazyOState``: its ``_DrainSite``
holds the ``LaneEngine``, whose ``_stats_lock`` does not pickle. The
JAX package's daemon logs "checkpoint save failed (cannot pickle
'_thread.lock' object)" there and leaves no round snapshot; the port
pickles the lazy state as the state it stands for. Here every round
snapshot of a packed daemon run is written, and loads back (as a
restarted daemon's analysis loads it) with its round and open states."""

import shutil
import threading

import pytest

from mythril_tpu_torch.daemon.client import DaemonClient, wait_ready
from mythril_tpu_torch.daemon.server import AnalysisDaemon
from mythril_tpu_torch.smt.solver import core
from mythril_tpu_torch.support import checkpoint
from mythril_tpu_torch.support.support_args import args as p_args

from .fixture_paths import INPUTS
from .torch_isolation import isolated_analysis


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    from mythril_tpu_torch.support import warm_store

    with isolated_analysis():
        p_args.device = "cpu"
        yield
    warm_store.reset()
    core.set_keep_sessions(False)
    core.reset_session(force=True)


def test_packed_round_snapshots_save_and_load(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_PACK", "1")
    saved, warnings = [], []
    real_save = checkpoint.save_checkpoint

    def save(path, round_index, open_states, *a, **kw):
        open_states = list(open_states)
        ok = real_save(path, round_index, open_states, *a, **kw)
        if ok:  # kept aside: a finished request deletes its snapshot
            keep = tmp_path / f"round{len(saved)}.ckpt"
            shutil.copy(path, keep)
            saved.append((keep, round_index, len(open_states), a[1]))
        else:
            saved.append((None, round_index, len(open_states), a[1]))
        return ok

    monkeypatch.setattr(checkpoint, "save_checkpoint", save)
    monkeypatch.setattr(checkpoint.log, "warning",
                        lambda msg, *a: warnings.append(msg % a))
    d = AnalysisDaemon(tmp_path / "serve", workers=1)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    assert wait_ready(d.socket_path, 60), "daemon never became ready"
    rows = {}

    def submit(name):
        rows[name] = DaemonClient(d.socket_path).analyze(
            (INPUTS / name).read_text().strip(), bin_runtime=True,
            timeout=120, name=name, tpu_lanes=64)

    # the first request runs alone; the three behind it wait and pack
    names = ("suicide.sol.o", "metacoin.sol.o", "ether_send.sol.o",
             "kinds_of_calls.sol.o")
    threads = []
    for name in names:
        threads.append(threading.Thread(target=submit, args=(name,)))
        threads[-1].start()
    for th in threads:
        th.join(timeout=600)
    client = DaemonClient(d.socket_path)
    packed = client.ping()["counters"].get("waves_packed", 0)
    client.shutdown()
    t.join(timeout=30)
    assert all(rows[n]["exceptions"] == [] for n in names), rows
    assert packed >= 1
    assert not [w for w in warnings if "checkpoint save failed" in w]
    assert saved and all(keep is not None for keep, *_ in saved)
    assert any(n_open for _, _, n_open, _ in saved)
    for keep, round_index, n_open, code_id in saved:
        payload = checkpoint.load_checkpoint(str(keep), code_id)
        assert payload is not None
        assert payload["round"] == round_index
        assert len(payload["open_states"]) == n_open
