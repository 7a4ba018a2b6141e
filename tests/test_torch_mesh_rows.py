"""K4's rows over a mesh (``laser/lane_engine.mesh_rows``, the window's
form with retire and resume rows, and ``retire_rows_mesh``, an
escalation retire) on CPU shards, where the call runs its plain version.

Every case's batch is the k=3 contract's, every lane seeded and a few
steps run, placed over 8 CPU shards of 8 lanes. The rows and the status
plane after the call must agree bit for bit with the JAX package on the
gathered batch (``_retire_rows``: the gather clips, the status write
wraps a negative index once and drops one still out of range; the resume
gather clips) and with the shard-at-a-time form the port had before the
one-call form (``shard_at_a_time`` below: each shard gathers every row
at its clamped lane, the row kept from the shard that holds its lane).
That older form marked only the lanes each shard's local range holds,
so a negative index marked nothing: its status is compared only where
the index list holds no negative index."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS

from .test_torch_mesh_step import LANES, SHARDS, case_state, on_shards

PER = LANES // SHARDS
#: an escalation retire's floors (narrower than the window's)
ESCALATION = (6, 64, 4, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    """Every lane seeded, 6 steps run: (the port's state, its planes);
    lane n-1 is RUNNING."""
    st, cc, _ = case_state(LANES)
    st, _ = TS.sym_run_plain(cc, st, 6)
    assert int(st.status[LANES - 1]) == TS.Status.RUNNING
    return st, interop.state_to_numpy(st)


def jax_rows(planes, ridx, hidx, floors):
    """The JAX package on the gathered batch: ``_retire_rows`` of
    ``ridx`` under ``floors`` (its gather and its status write), then
    the resume gather of ``hidx`` at JAX's clip. Returns (the retire
    rows, the resume rows, the status plane), numpy."""
    jst = JS.SymLaneState(**{k: jnp.asarray(v) for k, v in planes.items()})
    jst, rows = JL._retire_rows(jst, jnp.asarray(ridx, jnp.int32), *floors)
    hrows = JL._resume_gather_core(
        jst, jnp.clip(jnp.asarray(hidx, jnp.int32), 0, LANES - 1))
    return ([np.asarray(x) for x in rows], [np.asarray(x) for x in hrows],
            np.asarray(jst.status))


def shard_at_a_time(st, ridx, hidx, floors):
    """The parent's form: each shard gathers every row of ``ridx`` and
    ``hidx`` at its own clamped lane, row j kept from the shard
    ``min(idx // per, shards - 1)`` (a negative index: shard 0's); each
    shard marks DEAD the lanes of ``ridx`` in its local range. Returns
    (the six arrays, the status plane), numpy."""
    parts, status = [], st.status.clone()
    r, h = torch.as_tensor(ridx).long(), torch.as_tensor(hidx).long()
    for i in range(SHARDS):
        sl = slice(i * PER, (i + 1) * PER)
        shard = st.replace(**{f: getattr(st, f)[sl] for f in TS.FIELDS
                              if f not in TS.NO_COPY})
        rl = r - i * PER
        parts.append(list(TL._retire_gather_core(shard, rl.clamp(0, PER - 1),
                                                 *floors))
                     + list(TL._resume_gather_core(
                         shard, (h - i * PER).clamp(0, PER - 1))))
        local = rl[(rl >= 0) & (rl < PER)]
        status[sl][local] = TS.DEAD
    out = []
    for c in range(6):
        idx = np.asarray(ridx if c < 3 else hidx, np.int64)
        owner = np.minimum(idx // PER, SHARDS - 1)
        arr = parts[0][c].numpy().copy()
        for i in range(1, SHARDS):
            arr[owner == i] = parts[i][c].numpy()[owner == i]
        out.append(arr)
    return out, status.numpy()


def as_u32(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x


def check(batch, ridx, hidx=None, floors=TL.RETIRE_FLOORS):
    """The one-call form (``mesh_rows`` with ``hidx``, else
    ``retire_rows_mesh``) held to JAX and to ``shard_at_a_time``;
    returns the status plane after it."""
    st, planes = batch
    window = hidx is not None
    hidx = [] if hidx is None else hidx
    r = torch.tensor(ridx, dtype=torch.int32)
    h = torch.tensor(hidx, dtype=torch.int32)
    ss = on_shards(st)
    if window:
        ss, rows = TL.mesh_rows(ss, r, h, floors)
    else:
        ss, rows = TL.retire_rows_mesh(ss, r, *floors)
    got = [np.asarray(x) for x in rows.start_pull()()]
    status = ss.lanes().status.numpy()
    wr, wh, wstatus = jax_rows(planes, ridx, hidx, floors)
    want = wr + (wh if window else [])
    assert len(got) == len(want)
    for c, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(as_u32(a), as_u32(b),
                                      err_msg=f"array {c}: JAX")
    np.testing.assert_array_equal(status, wstatus, err_msg="status: JAX")
    old, ostatus = shard_at_a_time(st, ridx, hidx, floors)
    for c, (a, b) in enumerate(zip(got, old)):
        np.testing.assert_array_equal(a, b, err_msg=f"array {c}: the "
                                      f"shard-at-a-time form")
    if min(ridx, default=0) >= 0:
        np.testing.assert_array_equal(status, ostatus, err_msg="status: "
                                      "the shard-at-a-time form")
    return status


def test_a_window_and_an_escalation_retire(batch):
    """A window's rows (retired lanes in three shards, the padding n
    after them; resumed lanes, padded) and an escalation retire of other
    lanes under narrower floors: each lane named is marked DEAD, the
    padding marks nothing."""
    ridx = [2, 9, 30, 41, LANES, LANES]
    hidx = [5, 17, 60, LANES]
    status = check(batch, ridx, hidx)
    assert (status[[2, 9, 30, 41]] == TS.DEAD).all()
    status = check(batch, [12, 13, 50, LANES], floors=ESCALATION)
    assert (status[[12, 13, 50]] == TS.DEAD).all()


def test_a_negative_index_marks_the_lane_it_wraps_to(batch):
    """``ridx`` -1 while lane n-1 runs: JAX marks lane n-1 DEAD (the
    drop rule wraps a negative index once) and gathers lane 0 (the clip);
    the shard-at-a-time form marked nothing."""
    status = check(batch, [-1, LANES, 3])
    assert status[LANES - 1] == TS.DEAD
    assert status[3] == TS.DEAD
    status = check(batch, [-1, 6], hidx=[-1, 6])
    assert status[LANES - 1] == TS.DEAD


def test_the_padding_is_dropped_and_gathers_the_last_lane(batch):
    """``ridx`` all padding: no lane changes, each row is lane n-1's."""
    st, planes = batch
    status = check(batch, [LANES] * 4, hidx=[LANES] * 2)
    np.testing.assert_array_equal(status, planes["status"])


def test_a_lane_of_the_last_shard(batch):
    """Lanes of shard 7 only, in the window's form and retired alone."""
    last = list(range(LANES - PER, LANES, 3))
    status = check(batch, last, hidx=last[:2])
    assert (status[last] == TS.DEAD).all()
    check(batch, [LANES - 1])


def test_a_lane_named_twice(batch):
    """A lane named twice (and in both lists): both rows are its row,
    the lane marked once."""
    status = check(batch, [20, 20, 33, LANES], hidx=[20, 33, 33])
    assert (status[[20, 33]] == TS.DEAD).all()


def test_an_empty_resume_list(batch):
    """The window's form with no resumed lane (an empty ``hidx``), and an
    escalation retire, whose resume list is always empty."""
    check(batch, [1, 24, 47], hidx=[])
    check(batch, [1, 24, 47])
