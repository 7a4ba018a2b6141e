"""K1's step over a mesh (``ops/symstep.sym_run_mesh``) grouped a device
(``shard_groups``: one decide and one exec a device, the fork offsets
and budget computed once on the host from every shard's counts) on CPU
shards, where each group runs each shard's plain version.

Each case's batch runs three ways from the same planes, and every plane
and the visited bitmap must agree bit for bit: the JAX ``sym_run`` over
the gathered batch placed over the 8 virtual CPU devices (lane planes
sharded, as the JAX meshed engine places them), the port's grouped
driver over 8 CPU shards (its fork rows ``_PlainForks``, under the rank,
child-slot and budget code the card's ``_CudaForks`` runs), and the
one-shard-at-a-time driver the port had before the grouping
(``one_shard_at_a_time`` below, over the same ``_PlainShard`` phases,
its fork rows copied a pair of shards at a time). The plain OR of the
shards' visited bitmaps is held to numpy's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mythril_tpu.ops import stepper as JST
from mythril_tpu.ops import symstep as JS
from mythril_tpu.parallel import mesh as JM
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.parallel.mesh import Mesh, shard_sym_lanes
from mythril_tpu_torch.support import contracts
from mythril_tpu_torch.support import device_loop as DL

#: every case's batch: 64 lanes over 8 shards, one contract and one step
#: count (the JAX run compiles once)
LANES, SHARDS, STEPS = 64, 8, 24
KW = dict(calldata_bytes=64, dlog_records=16, stack_depth=32,
          memory_bytes=128, mem_records=8, storage_slots=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def case_state(seeds: int, edit=None):
    """The k=3 symbolic contract's batch with ``seeds`` entries at lanes
    0.. after the window prologue, ``edit(planes)`` applied to its numpy
    planes: (the port's state, its code, the planes)."""
    objs = TL.ObjectTable()
    case = DL.K1Case("mesh", contracts.build_symbolic_contract(3)[0], None,
                     [DL.tx_entry_seed(objs, g + 1, KW["calldata_bytes"])
                      for g in range(seeds)], LANES, STEPS)
    st, cc = DL.k1_case_state(case, "cpu", **KW)
    planes = interop.state_to_numpy(st)
    if edit is not None:
        edit(planes)
    return interop.state_from_numpy(planes, "cpu"), cc, planes


def on_shards(st):
    """``st`` placed over SHARDS CPU shards (``parallel/mesh.SymShards``)."""
    ss = shard_sym_lanes(Mesh(["cpu"] * SHARDS), LANES, **KW)
    per = ss.per
    for i, shard in enumerate(ss.shards):
        ss.shards[i] = shard.replace(**{
            f: getattr(st, f)[i * per:(i + 1) * per].clone()
            for f in TS.FIELDS if f not in TS.NO_COPY})
    ss.home = ss.home.replace(**{f: getattr(st, f).clone()
                                 for f in TS.NO_COPY})
    return ss


def one_shard_at_a_time(cc, ss, max_steps, visited):
    """The meshed run as the port drove it before its shards were grouped
    a device: each shard's decide and read in turn, the offsets and
    budget accumulated shard by shard, each shard's exec, the fork log's
    child slots and step numbers written from host arrays, each shard's
    bitmap ORed in on its own."""
    home = ss.home
    n, m = ss.n, ss.per
    free_slots = home.free_slots.numpy()
    free_count, flog_count = int(home.free_count), int(home.flog_count)
    step_no = int(home.step_no)
    F = home.flog_parent.shape[0]
    maxf = min(TS.MAX_FORKS_PER_STEP, n)
    visited = visited.clone()
    shards = [TS._PlainShard(ss, i, cc, TS.SYM_EXECUTABLE, None, visited)
              for i in range(ss.mesh.size)]
    flog = [getattr(home, f) for f in (
        "flog_parent", "flog_pc", "flog_fentry", "flog_sid", "flog_gmin",
        "flog_gmax", "flog_dest")]
    flog_col = [0, 3, 2, 4, 5, 6, 7]
    for _ in range(max_steps):
        counts = [r() for r in [sh.decide() for sh in shards]]
        if not sum(c[1] for c in counts):
            break
        navail = min(free_count, maxf, F - flog_count)
        off, stashes = 0, []
        for sh, (req, _) in zip(shards, counts):
            k = max(0, min(req, navail - off))
            stashes.append((sh.execute(off, navail, free_count, flog_count,
                                       step_no, k), off, k))
            off += req
        nf = max(0, min(off, navail))
        if nf:
            child = free_slots[np.clip(free_count - 1 - np.arange(nf), 0,
                                       n - 1)]
            at = flog_count
            for stash, o, k in stashes:
                for plane, c in zip(flog, flog_col):
                    plane[at + o:at + o + k].copy_(stash[c, :k])
            home.flog_child[at:at + nf].copy_(
                torch.from_numpy(child.astype(np.int32)))
            home.flog_step[at:at + nf].copy_(
                torch.full((nf,), step_no, dtype=torch.int32))
            pairwise_fork_rows(ss, stashes, child, m)
        free_count -= nf
        flog_count += nf
        step_no += 1
    home.step_no.copy_(torch.tensor(step_no, dtype=torch.int32))
    home.flog_count.copy_(torch.tensor(flog_count, dtype=torch.int32))
    home.free_count.copy_(torch.tensor(free_count, dtype=torch.int32))
    for sh in shards:
        visited = TS.vis_or(visited, [sh.vis])
    return ss, visited


def pairwise_fork_rows(ss, stashes, child, m):
    """A forking step's child rows as the port copied them before one
    launch a device: for each (source, destination) pair of shards, the
    source's parents' post-step rows staged (``FORK_PLANES``, the
    stash's pc and fentry), then landed in the children's slots with an
    empty record log."""
    for q, (stash, o, k) in enumerate(stashes):
        mine = child[o:o + k]
        for dst in np.unique(mine // m):
            sel = torch.from_numpy(np.nonzero(mine // m == dst)[0])
            rows = stash[0, sel].long() - q * m
            staged = {f: getattr(ss.shards[q], f)[rows].clone()
                      for f in TS.FORK_PLANES}
            staged["pc"], staged["fentry"] = stash[1, sel], stash[2, sel]
            land = torch.from_numpy(mine[sel.numpy()] - dst * m).long()
            st = ss.shards[dst]
            new = {}
            for f in TS.FORK_PLANES + ("pc", "fentry"):
                y = getattr(st, f).clone()
                y[land] = staged[f]
                new[f] = y
            new["dlog_count"] = st.dlog_count.clone()
            new["dlog_count"][land] = 0
            ss.shards[dst] = st.replace(**new)


def jax_run(planes, cc):
    """The JAX ``sym_run`` on ``planes`` placed over the 8 virtual
    devices as the JAX meshed engine places a batch (a plane whose
    leading axis is the lanes' sharded, the rest replicated): (planes,
    visited) as numpy."""
    mesh = JM.make_mesh(SHARDS)
    lane_sh, rep = NamedSharding(mesh, P(JM.LANES_AXIS)), \
        NamedSharding(mesh, P())
    jst = JS.SymLaneState(**{
        k: jax.device_put(jnp.asarray(v), lane_sh
                          if v.ndim and v.shape[0] == LANES else rep)
        for k, v in planes.items()})
    jcc = jax.tree_util.tree_map(lambda x: jax.device_put(x, rep),
                                 JST.compile_code(cc))
    vis = jax.device_put(jnp.zeros(jcc.packed.shape[0], bool), rep)
    out, jvis = JS.sym_run_jit(jcc, jst, STEPS, jnp.asarray(
        TS.SYM_EXECUTABLE), jnp.zeros(256, bool), vis)
    return ({f: np.asarray(getattr(out, f)) for f in TS.FIELDS},
            np.asarray(jvis))


def run_three(seeds, edit=None):
    """A case through the JAX run, the grouped driver and the
    one-shard-at-a-time driver; asserts them equal. Returns the grouped
    driver's planes and the input's."""
    st, cc, planes = case_state(seeds, edit)
    code = contracts.build_symbolic_contract(3)[0]
    want, wvis = jax_run(planes, code)
    vis = torch.zeros(cc.packed.shape[0], dtype=torch.bool)
    ss, gvis = TS.sym_run_mesh({torch.device("cpu"): cc}, on_shards(st),
                               STEPS, TS.SYM_EXECUTABLE, None, vis)
    os_, ovis = one_shard_at_a_time(cc, on_shards(st), STEPS, vis)
    got = interop.state_to_numpy(ss.lanes())
    old = interop.state_to_numpy(os_.lanes())
    for f in TS.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{f}: JAX")
        np.testing.assert_array_equal(got[f], old[f],
                                      err_msg=f"{f}: one shard at a time")
    np.testing.assert_array_equal(gvis.numpy(), wvis)
    np.testing.assert_array_equal(gvis.numpy(), ovis.numpy())
    return got, planes


def _needs_the_virtual_mesh():
    if jax.device_count() < SHARDS:
        pytest.skip("needs the 8-device CPU mesh")


def test_the_fork_budget_cut_inside_one_shard():
    """20 lanes request a fork in the same step while the fork log has
    room for 11: ranks 0-7 (shard 0) and 8-10 (shard 1) fork, shard 1's
    ranks 11-15 and shard 2's 16-19 stall (below the free count)."""
    _needs_the_virtual_mesh()
    room = 11

    def edit(p):
        p["flog_count"][...] = p["flog_parent"].shape[0] - room

    got, planes = run_three(20, edit)
    F = planes["flog_parent"].shape[0]
    assert int(got["flog_count"]) == F
    children = got["flog_child"][F - room:]
    parents = got["flog_parent"][F - room:]
    assert sorted(parents.tolist()) == list(range(room))
    assert (got["status"][parents] == 0).all()
    assert (got["status"][11:20] == 0).all()
    assert len(set(children.tolist())) == room


def test_a_shard_with_no_running_lane():
    """Shard 1's lanes are DEAD and off the free stack: its counts are 0
    at every step, between shards whose lanes fork."""
    _needs_the_virtual_mesh()

    def edit(p):
        p["status"][8:16] = TS.DEAD

    got, planes = run_three(24, edit)
    assert (got["status"][8:16] == TS.DEAD).all()
    assert (got["steps"][8:16] == planes["steps"][8:16]).all()
    nf = int(got["flog_count"])
    parents = got["flog_parent"][:nf]
    assert nf > 0 and not ((parents >= 8) & (parents < 16)).any()
    assert (parents < 8).any() and (parents >= 16).any()


def test_forks_that_land_in_another_shard():
    """The children take the top of the batch's free stack: the parents
    in shards 0-2, their children in shards 3-7."""
    _needs_the_virtual_mesh()
    got, _ = run_three(24)
    nf = int(got["flog_count"])
    per = LANES // SHARDS
    parents = got["flog_parent"][:nf] // per
    children = got["flog_child"][:nf] // per
    assert nf > 0 and (parents != children).all()
    assert set(parents.tolist()) <= {0, 1, 2}
    assert len(set(children.tolist())) > 1


def first_forks(got):
    """The first forking step's (parents, children) as global lanes."""
    nf = int(got["flog_count"])
    step = got["flog_step"][:nf]
    first = step == step.min()
    return got["flog_parent"][:nf][first], got["flog_child"][:nf][first]


def test_forks_of_several_shards_that_land_in_one_shard():
    """Two running lanes in each of shards 0-2 fork at one step: their
    six children take the top of the free stack, all in shard 3."""
    _needs_the_virtual_mesh()
    per = LANES // SHARDS

    def edit(p):
        for i in range(3):
            p["status"][i * per + 2:(i + 1) * per] = TS.DEAD

    got, _ = run_three(24, edit)
    parents, children = first_forks(got)
    assert sorted(set((parents // per).tolist())) == [0, 1, 2]
    assert set((children // per).tolist()) == {3}
    assert len(children) == 6


def test_one_shards_forks_that_land_in_four_shards():
    """Shard 0's eight lanes fork at one step while the free stack's top
    alternates over shards 2-5: its children land in four shards, and
    every fork-log plane (``run_three``: parent, child, step, pc, sid,
    gas bounds, fentry, destination) agrees with JAX's and the pairwise
    copy's."""
    _needs_the_virtual_mesh()
    per = LANES // SHARDS
    want = [16, 24, 32, 40, 17, 25, 33, 41]

    def edit(p):
        fc = int(p["free_count"])
        stack = [x for x in p["free_slots"][:fc].tolist() if x not in want]
        p["free_slots"][:fc] = stack + want[::-1]

    got, planes = run_three(8, edit)
    parents, children = first_forks(got)
    assert set((parents // per).tolist()) == {0}
    assert children.tolist() == want[:len(children)]
    assert len(set((children // per).tolist())) >= 3
    # the seven words each fork's stash gives the fork log, at its rank
    k = len(children)
    assert got["flog_parent"][:k].tolist() == list(range(k))
    assert len(set(got["flog_pc"][:k].tolist())) == 1 and got["flog_pc"][0]
    assert len(set(got["flog_dest"][:k].tolist())) == 1 \
        and got["flog_dest"][0]
    assert (got["flog_sid"][:k] < 0).all()
    assert (got["flog_gmin"][:k] <= got["flog_gmax"][:k]).all()
    assert (got["flog_fentry"][:k] == planes["fentry"][:k]).all()


def test_every_lane_stopped_at_the_first_step():
    """No lane runs: the run stops at its first decide, every plane and
    the step counter as they were, nothing visited."""
    _needs_the_virtual_mesh()

    def edit(p):
        p["status"][p["status"] == 0] = 5

    got, planes = run_three(24, edit)
    for f in TS.FIELDS:
        np.testing.assert_array_equal(got[f], planes[f], err_msg=f)


@pytest.mark.parametrize("count", [3, 5, 8])
def test_the_plain_or_of_several_bitmaps(count):
    """``vis_or`` on the CPU: the batch's bitmap ORed with every shard's,
    as numpy's ``np.logical_or.reduce``."""
    rng = np.random.default_rng(15 + count)
    maps = rng.random((count + 1, 1037)) < 0.2
    got = TS.vis_or(torch.from_numpy(maps[0].copy()),
                    [torch.from_numpy(m) for m in maps[1:]])
    np.testing.assert_array_equal(got.numpy(),
                                  np.logical_or.reduce(maps, axis=0))


def test_the_budget_offsets_follow_the_global_lane_order():
    """``fork_budget``: each shard's first rank is the requests of the
    shards before it, its forks what of them fits the budget."""
    navail, off, forks, nf = TS.fork_budget([3, 0, 5, 2], free_count=50,
                                            flog_count=90, F=96, n=64)
    assert navail == 6 and nf == 6
    assert off == [0, 3, 3, 8]
    assert forks == [3, 0, 3, 0]


@pytest.mark.parametrize("spans", [
    [], [(4, 2)], [(3, 2), (0, 3)], [(0, 3), (5, 1), (6, 4)],
    [(9, 1), (2, 2), (0, 1), (4, 5)]])
def test_the_staged_rank_runs_merge_neighbouring_spans(spans):
    """``_rank_runs`` (the rank ranges in which a card's staged fork rows
    are copied to another card, a copy a range): ascending, neighbours
    merged, every rank of the (first, count) spans in one range, as a
    walk over the ranks gives them."""
    want = []
    for r in sorted(r for o, k in spans for r in range(o, o + k)):
        if want and want[-1][1] == r:
            want[-1] = (want[-1][0], r + 1)
        else:
            want.append((r, r + 1))
    assert TS._rank_runs(spans) == want
