"""A pooled meshed batch against the JAX package's pooled batch.

An explore hands its batch back to the pool (``_STATE_POOL``) when it
ends, and the next explore of the same shape takes it as it is: the
batch keeps its step counter (``step_no``), so the next explore's
records, fork log and storage-write steps carry global steps that
start where the last explore stopped. Both packages pool so. Here each
package's pool is left as a first explore left it, and the second
explore's windows are held to each other, bit for bit: the JAX meshed
engine on the 8 virtual CPU devices ``tests/conftest.py`` forces, the
port's on 8 CPU shards. The pooled windows differ from fresh ones only
in those step columns, by one offset, in both packages alike, and the
host reads those columns only to order the events of one batch, so the
paths it hands back are a fresh batch's."""

from copy import deepcopy

import numpy as np
import pytest

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.parallel import mesh as JM
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.support import contracts

from . import test_lane_engine as JT
from .test_torch_lane_mesh import (  # noqa: F401  (the fixture)
    Windows, _on_the_cpu, cpu_mesh, fork_code, make_entry, mini_run,
    text_sig,
)

#: the window outputs that carry a global step, and its column there:
#: the unique-record table (step), the fork table (flog_step), the
#: first retire array (s_wstep, the last ``wk`` columns)
STEP_OUTPUTS = {2: "step", 3: "flog_step", 5: "s_wstep"}


def _explores(code, jentry, entry, n_lanes, window, rec):
    """Two explores in each package on a mesh of 8 (the first on a
    fresh batch, the second on the batch the first pooled), their
    windows recorded by ``rec``; returns the port's two engines and
    parked states and the JAX package's, and each package's number of
    windows in its first explore."""
    runs = {"jax": [], "mesh": []}
    first = {}
    for r in range(2):
        jeng = JL.LaneEngine(n_lanes=n_lanes, window=window,
                             mesh=JM.make_mesh(8))
        runs["jax"].append((jeng, jeng.explore(code, [deepcopy(jentry)])))
        eng = TL.LaneEngine(n_lanes=n_lanes, window=window,
                            mesh=cpu_mesh(8))
        runs["mesh"].append((eng, eng.explore(code, [deepcopy(entry)])))
        if r == 0:
            first = {k: len(rec.out[k]) for k in runs}
            assert JL._STATE_POOL[jeng._shape_key()]
            assert TL._STATE_POOL[eng._shape_key()]
    return runs, first


def _same_windows(a, b, what):
    assert len(a) == len(b) and a, (what, len(a), len(b))
    for w, (x, y) in enumerate(zip(a, b)):
        for i, (p, q) in enumerate(zip(x, y)):
            np.testing.assert_array_equal(
                q, p, err_msg=f"{what}: window {w} output {i}")


def _step_offset(fresh, pooled, wk):
    """The windows of a pooled explore against a fresh one's: equal but
    in the step columns, which differ by one offset over every window
    (the steps the batch ran before); ``wk``: the storage columns of a
    retire row, whose last block is ``s_wstep``. Returns the offset."""
    offsets = set()
    for x, y in zip(fresh, pooled):
        for i, (p, q) in enumerate(zip(x, y)):
            if i not in STEP_OUTPUTS:
                np.testing.assert_array_equal(q, p, err_msg=f"output {i}")
                continue
            assert p.shape == q.shape
            cols = np.nonzero((p != q).any(axis=0))[0]
            if i == 2:
                assert set(cols) <= {4}, cols
            elif i == 3:
                assert set(cols) <= {2}, cols
            else:
                assert set(cols) <= set(range(p.shape[1] - wk,
                                              p.shape[1])), cols
            for c in cols:
                diff = q[:, c].astype(np.int64) - p[:, c]
                offsets.update(diff[diff != 0].tolist())
    assert len(offsets) <= 1, offsets
    return offsets.pop() if offsets else 0


def test_a_pooled_meshed_batch_equals_the_jax_packages_pooled_batch(
        monkeypatch):
    """``test_sharded_engine_differential``'s contract (a fork, a
    mapping-slot SHA3 and symbolic-key stores) at 32 lanes, window 64:
    the second explore's windows, each on the batch the first pooled,
    equal the JAX package's bit for bit; against the first (fresh)
    explore they differ in the three step columns alone, by the steps
    the first ran, in both packages; and every explore hands back the
    paths the host interpreter finds."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")
    code = fork_code()
    rec = Windows(monkeypatch)
    jentry, entry = JT.make_entry(code), make_entry(code)
    runs, first = _explores(code, jentry, entry, 32, 64, rec)
    jax_w, port_w = rec.out["jax"], rec.out["mesh"]
    _same_windows(jax_w, port_w, "jax vs port, fresh then pooled")
    nj, nt = first["jax"], first["mesh"]
    assert nj == nt == len(jax_w) - nj
    eng = runs["mesh"][1][0]
    slots = TL._STATE_POOL[eng._shape_key()][-1].shards[0].skeys.shape[1]
    wk = min(TL.RETIRE_FLOORS[3], slots)
    off_j = _step_offset(jax_w[:nj], jax_w[nj:], wk)
    off_t = _step_offset(port_w[:nt], port_w[nt:], wk)
    assert off_j == off_t > 0
    host = sorted(map(lambda p: JT.state_sig(*p),
                      mini_run([deepcopy(entry)])), key=repr)
    for eng, parked in runs["mesh"]:
        assert sorted(map(lambda p: JT.state_sig(*p), mini_run(parked)),
                      key=repr) == host
    jsigs = [sorted(map(lambda p: text_sig(*p), JT.mini_run(parked)))
             for _, parked in runs["jax"]]
    tsigs = [sorted(map(lambda p: text_sig(*p), mini_run(parked)))
             for _, parked in runs["mesh"]]
    assert jsigs[0] == jsigs[1] == tsigs[0] == tsigs[1]


@pytest.mark.parametrize("n_lanes", [256, 4096])
def test_the_k12_contract_on_a_pooled_batch_equals_the_jax_package(
        monkeypatch, n_lanes):
    """The k=12 symbolic contract (the card's meshed main path: 4096
    paths) over 8 shards at 256 lanes (windows with escalation retires)
    and at the main path's own 4096 (about two minutes on the CPU), two
    explores in each package: every window of both, the second on the
    pooled batch, equal to the JAX package's bit for bit, the pooled
    windows a fresh one's but for the step columns, and the same states
    handed back."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")
    code, _ = contracts.build_symbolic_contract(12)
    rec = Windows(monkeypatch)
    jentry, entry = JT.make_entry(code), make_entry(code)
    runs, first = _explores(code, jentry, entry, n_lanes, None, rec)
    jax_w, port_w = rec.out["jax"], rec.out["mesh"]
    _same_windows(jax_w, port_w, "jax vs port, fresh then pooled")
    nt = first["mesh"]
    eng = runs["mesh"][1][0]
    slots = TL._STATE_POOL[eng._shape_key()][-1].shards[0].skeys.shape[1]
    off = _step_offset(port_w[:nt], port_w[nt:],
                       min(TL.RETIRE_FLOORS[3], slots))
    assert off > 0
    sigs = [[JT.state_sig("open", gs) for gs in parked]
            for _, parked in runs["mesh"]]
    assert len(sigs[0]) == n_lanes and sigs[0] == sigs[1]
