"""The port's lane sharding (mythril_tpu_torch/parallel/mesh.py, kernel
row 14) against the JAX package's ``parallel/mesh.py``: the JAX side
runs on the 8-device virtual CPU mesh that ``tests/conftest.py`` sets
up, the port on a mesh of CPU shards (one device repeated), where each
wrapper runs its kernel's plain version. The same numpy planes go
through both, and every plane of the result must be equal, bit for bit.

Covered: the four tests of ``tests/test_parallel.py``; ``steal_balance``
and ``compact_lanes`` on seeded random statuses at 64, 256 and 8000
lanes on 1, 2, 4 and 8 shards, and on batches whose running lanes all
sit in the first shards; ``compact_lanes`` with a caller's order that
holds negative and out-of-range entries; a one-shard mesh against
``stepper.run``; and ``__graft_entry__.dryrun_multichip``'s macro step
(8 sharded steps, the live total, the rebalance order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import __graft_entry__
from mythril_tpu.ops import stepper as J
from mythril_tpu.parallel import mesh as JM
from mythril_tpu_torch import interop
from mythril_tpu_torch.ops import stepper as T
from mythril_tpu_torch.parallel import mesh as TM

from .test_parallel import make_batch

FIELDS = J.LaneState._fields
#: plane sizes of the random batches
RND = dict(stack_depth=4, memory_bytes=36, storage_slots=2,
           calldata_bytes=20)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax.devices()[:8]


def planes_of(jst) -> dict:
    return {f: np.asarray(getattr(jst, f)) for f in FIELDS}


def port_state(planes: dict) -> T.LaneState:
    return interop.state_from_numpy(planes, "cpu")


def jax_state(planes: dict) -> J.LaneState:
    return J.LaneState(**{f: jnp.asarray(planes[f]) for f in FIELDS})


def assert_same(want, got: T.LaneState, what=""):
    """Every plane of the JAX state ``want`` equals the port's."""
    mine = interop.state_to_numpy(got)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), mine[f],
                                      err_msg=f"{what}: {f}")


def cpu_mesh(n: int) -> TM.Mesh:
    return TM.Mesh(["cpu"] * n)


def both_batches(n):
    """The test_parallel batch in both packages: (JAX code, JAX state,
    port code, port state)."""
    cc, st = make_batch(n)
    return (cc, st, interop.code_from_numpy(np.asarray(cc.packed), cc.size,
                                            "cpu"),
            port_state(planes_of(st)))


# -- tests/test_parallel.py -------------------------------------------------

def test_sharded_run_matches_single_device(eight_devices):
    n = 64
    cc, st, tcc, tst = both_batches(n)
    ref = J.run(cc, st, 200)
    m = JM.make_mesh(8)
    out = JM.sharded_run(JM.replicate_code(cc, m), JM.shard_lanes(st, m),
                         200, m)
    tm = cpu_mesh(8)
    sh = TM.sharded_run(TM.replicate_code(tcc, tm),
                        TM.shard_lanes(tst, tm), 200, tm)
    assert len(sh.shards) == 8
    got = sh.lanes()
    assert_same(out, got, "sharded_run")
    assert_same(ref, got, "sharded_run against one device")
    for i in (0, 13, 63):
        x = i * 977 + 5
        assert T.extract_storage(got, i)[1] == (x * 3 + 7) % (1 << 256)
        assert int(got.status[i]) == T.Status.STOPPED


def test_live_lane_counts(eight_devices):
    cc, st, _, tst = both_batches(64)
    m, tm = JM.make_mesh(8), cpu_mesh(8)
    per_dev, total = TM.live_lane_counts(TM.shard_lanes(tst, tm), tm)
    assert total == 64 and per_dev.tolist() == [8] * 8
    status = np.asarray(st.status).copy()
    status[:32] = J.Status.STOPPED
    want = JM.live_lane_counts(
        JM.shard_lanes(st._replace(status=jnp.asarray(status)), m), m)
    tst.status[:32] = T.Status.STOPPED
    per_dev, total = TM.live_lane_counts(TM.shard_lanes(tst, tm), tm)
    assert total == want[1] == 32
    assert per_dev.dtype == want[0].dtype
    assert per_dev.tolist() == want[0].tolist() == [0, 0, 0, 0, 8, 8, 8, 8]


def test_steal_balance_evens_out_live_lanes(eight_devices):
    cc, st, _, tst = both_batches(64)
    status = np.asarray(st.status).copy()
    status[:32] = J.Status.STOPPED
    st = st._replace(status=jnp.asarray(status))
    tst.status[:32] = T.Status.STOPPED
    m, tm = JM.make_mesh(8), cpu_mesh(8)
    want = JM.steal_balance(JM.shard_lanes(st, m), m)
    bal = TM.steal_balance(TM.shard_lanes(tst, tm), tm)
    assert_same(want, bal.lanes(), "steal_balance")
    per_dev, total = TM.live_lane_counts(bal, tm)
    assert total == 32 and per_dev.tolist() == [4] * 8
    before = sorted(bytes(r) for r in tst.calldata.numpy())
    after = sorted(bytes(r) for r in bal.lanes().calldata.numpy())
    assert before == after


def test_compact_lanes():
    cc, st, _, tst = both_batches(16)
    status = np.asarray(st.status).copy()
    status[::2] = J.Status.STOPPED
    want = JM.compact_lanes(st._replace(status=jnp.asarray(status)))
    tst.status[::2] = T.Status.STOPPED
    packed = TM.compact_lanes(tst)
    assert_same(want, packed, "compact_lanes")
    assert packed.status[:8].tolist() == [0] * 8
    assert (packed.status[8:] == T.Status.STOPPED).all()


# -- random statuses, every shard count -------------------------------------

def random_planes(seed: int, n: int, pattern: str) -> dict:
    """A batch of ``n`` lanes with every plane random (so a misplaced
    row shows in every plane) and the statuses of ``pattern``:
    "random" (about a third RUNNING) or "first" (the first quarter of
    the lanes RUNNING, the rest halted: every running lane in the first
    shards)."""
    rng = np.random.default_rng(seed)
    st = J.init_lanes(n, **RND)
    planes = {}
    for f in FIELDS:
        shape = np.asarray(getattr(st, f)).shape
        if f in ("memory", "calldata"):
            planes[f] = rng.integers(0, 256, shape, dtype=np.uint8)
        else:
            planes[f] = rng.integers(0, 2 ** 32, shape, dtype=np.uint64) \
                .astype(np.uint32).astype(np.asarray(getattr(st, f)).dtype)
    if pattern == "random":
        status = rng.integers(0, 7, n).astype(np.int32)
        status[rng.random(n) < 0.2] = 0
    else:
        status = np.where(np.arange(n) < n // 4, 0,
                          rng.integers(1, 7, n)).astype(np.int32)
    planes["status"] = status
    return planes


SHAPES = [(n, d, pattern) for n in (64, 256, 8000) for d in (1, 2, 4, 8)
          for pattern in ("random", "first")]


@pytest.mark.parametrize("n,n_dev,pattern", SHAPES,
                         ids=[f"{n}x{d}-{p}" for n, d, p in SHAPES])
def test_steal_balance_on_random_batches(eight_devices, n, n_dev, pattern):
    planes = random_planes(n * 10 + n_dev, n, pattern)
    m, tm = JM.make_mesh(n_dev), cpu_mesh(n_dev)
    want = JM.steal_balance(JM.shard_lanes(jax_state(planes), m), m)
    got = TM.steal_balance(TM.shard_lanes(port_state(planes), tm), tm)
    assert_same(want, got.lanes(), f"steal_balance {n}x{n_dev}")
    per_dev, total = TM.live_lane_counts(got, tm)
    want_per, want_total = JM.live_lane_counts(want, m)
    assert per_dev.tolist() == want_per.tolist() and total == want_total
    assert int(per_dev.max()) - int(per_dev.min()) <= 1


@pytest.mark.parametrize("n,n_dev,pattern", SHAPES,
                         ids=[f"{n}x{d}-{p}" for n, d, p in SHAPES])
def test_compact_lanes_on_random_batches(eight_devices, n, n_dev, pattern):
    planes = random_planes(n * 10 + n_dev + 1, n, pattern)
    m, tm = JM.make_mesh(n_dev), cpu_mesh(n_dev)
    want = JM.compact_lanes(JM.shard_lanes(jax_state(planes), m))
    got = TM.compact_lanes(TM.shard_lanes(port_state(planes), tm))
    assert_same(want, got, f"compact_lanes {n}x{n_dev}")


@pytest.mark.parametrize("n_out", [64, 37, 100])
def test_compact_lanes_with_a_callers_order(n_out):
    """A caller's ``order`` goes through JAX ``x[order]``: a negative
    index wraps once, then an out-of-range index clamps."""
    n = 64
    planes = random_planes(7, n, "random")
    rng = np.random.default_rng(n_out)
    order = rng.integers(-3 * n, 3 * n, n_out).astype(np.int32)
    order[:8] = [-1, -n, -n - 1, -5 * n, n - 1, n, 10 * n, 0][:min(8, n_out)]
    want = JM.compact_lanes(jax_state(planes), jnp.asarray(order))
    got = TM.compact_lanes(port_state(planes), order)
    assert got.pc.shape[0] == n_out
    assert_same(want, got, "compact_lanes(order)")


def test_plain_orders_equal_the_jax_argsort():
    """The plain K13 and K12 against ``jnp.argsort(-running,
    stable=True)`` with the deal, and the per-shard sums, at lane counts
    that are no multiple of the scan block."""
    rng = np.random.default_rng(3)
    for n, n_dev in ((1, 1), (7, 7), (300, 4), (1000, 8), (4104, 8)):
        status = rng.integers(0, 3, n).astype(np.int32)
        running = jnp.asarray((status == 0).astype(np.int32))
        order = np.asarray(jnp.argsort(-running, stable=True))
        dealt = order.reshape(n // n_dev, n_dev).T.reshape(n)
        got = TM.lane_order(torch.from_numpy(status), n_dev)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), dealt)
        np.testing.assert_array_equal(
            TM.lane_live(torch.from_numpy(status), n_dev).numpy(),
            (status == 0).reshape(n_dev, -1).sum(axis=1))


def test_uneven_batches_are_refused():
    tst = T.init_lanes(10, device="cpu", **RND)
    with pytest.raises(ValueError):
        TM.shard_lanes(tst, cpu_mesh(4))
    with pytest.raises(ValueError):
        TM.steal_balance(tst, cpu_mesh(4))


# -- one shard, and the macro step -------------------------------------------

def test_one_shard_mesh_equals_stepper_run():
    _, _, tcc, tst = both_batches(32)
    ref = T.run(tcc, T.clone_lanes(tst), 200)
    tm = cpu_mesh(1)
    sh = TM.sharded_run(tcc, tst, 200, tm)
    assert len(sh.shards) == 1
    # the shard is the caller's batch, updated in place
    assert all(getattr(sh.lanes(), f).data_ptr() == getattr(tst, f).data_ptr()
               for f in T.LANE_FIELDS)
    for f in T.LANE_FIELDS:
        assert torch.equal(getattr(sh.lanes(), f), getattr(ref, f)), f


def test_dryrun_multichip_macro_step(eight_devices):
    """``__graft_entry__.dryrun_multichip``'s macro step, 8 shards of 4
    lanes: 8 fused steps, the global live-lane count, the rebalance
    order and the rebalanced batch."""
    n_dev, n = 8, 32
    cc, st = __graft_entry__._build_fixture(n)
    m = JM.make_mesh(n_dev)
    jst = JM.shard_lanes(st, m)
    jcc = JM.replicate_code(cc, m)

    def macro_step(code, state):
        state = J.run(code, state, 8)
        running = (state.status == J.Status.RUNNING).astype(jnp.int32)

        @jax.shard_map(mesh=m, in_specs=P(JM.LANES_AXIS), out_specs=P())
        def total_live(r):
            return lax.psum(jnp.sum(r), JM.LANES_AXIS)

        live = total_live(running)
        order = jnp.argsort(-running, stable=True)
        return jax.tree_util.tree_map(lambda x: x[order], state), live

    macro = jax.jit(macro_step)

    tm = cpu_mesh(n_dev)
    tcc = TM.replicate_code(
        interop.code_from_numpy(np.asarray(cc.packed), cc.size, "cpu"), tm)
    tst = port_state(planes_of(st))
    lives = []
    for rnd in range(6):
        want, want_live = macro(jcc, jst)
        sh = TM.sharded_run(tcc, TM.shard_lanes(tst, tm), 8, tm)
        _, live = TM.live_lane_counts(sh, tm)
        tst = TM.compact_lanes(sh)
        assert live == int(want_live)
        assert_same(want, tst, f"macro step {rnd}")
        lives.append(live)
        jst = JM.shard_lanes(want, m)
    assert int(tst.steps.min()) >= 1
    # lanes halt along the way, so the rebalance order moves rows
    assert lives[0] == n and 0 < lives[-1] < n, lives


# -- K14's output: one allocation ---------------------------------------------

@pytest.mark.parametrize("n_out", [0, 1, 37, 64, 100])
def test_gather_outputs_are_views_of_one_allocation(n_out):
    """The planes K14 writes: each view has its plane's shape (``n_out``
    lanes) and dtype, starts at a 16-byte-aligned offset of the one
    allocation, overlaps no other, and a write to one plane leaves the
    others unchanged."""
    tst = port_state(random_planes(11, 64, "random"))
    buf, out, _ = TM.gather_outputs(tst, n_out)
    base = buf.data_ptr()
    spans = []
    for f in T.LANE_FIELDS:
        x, src = getattr(out, f), getattr(tst, f)
        assert x.shape == (n_out,) + src.shape[1:], f
        assert x.dtype == src.dtype and x.is_contiguous(), f
        assert x.untyped_storage().data_ptr() == base, f
        off = x.data_ptr() - base
        assert off % TM.PLANE_ALIGN == 0, f
        spans.append((off, off + x.numel() * x.element_size(), f))
    spans.sort()
    for (_, end, f), (start, _, g) in zip(spans, spans[1:]):
        assert end <= start, (f, g)
    assert spans[-1][1] <= buf.numel()
    for f in T.LANE_FIELDS:
        getattr(out, f).zero_()
    for f in T.LANE_FIELDS:
        getattr(out, f).fill_(-1 if getattr(out, f).dtype == torch.int32
                              else 255)
        for g in T.LANE_FIELDS:
            if g != f:
                assert not getattr(out, g).any(), (f, g)
        getattr(out, f).zero_()


def test_gather_of_an_empty_batch():
    """An empty order gives an empty batch, also from no lanes; rows of a
    batch of no lanes are an index error (the kernel's wrapper raises
    the same)."""
    tst = port_state(random_planes(12, 64, "random"))
    none = T.LaneState(**{f: getattr(tst, f)[:0] for f in T.LANE_FIELDS})
    empty = torch.empty(0, dtype=torch.int32)
    for src in (tst, none):
        got = TM.lane_gather(src, empty)
        for f in T.LANE_FIELDS:
            assert getattr(got, f).shape == (0,) + getattr(src, f).shape[1:]
    with pytest.raises(IndexError):
        TM.lane_gather(none, torch.zeros(3, dtype=torch.int32))
