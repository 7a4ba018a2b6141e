"""K12 ``lane_live`` (mythril_tpu_torch/parallel/mesh.py) against the JAX
package on the CPU.

On every edge input of ``support/device_loop.k12_edge_cases`` (K13's
patterns, shards of 1, 3 and 5 lanes, a status view one lane into its
storage, runs across K12's tiles and shards, the seeded mix of every
status at 131072 lanes) the plain version and ``live_lane_counts`` (over
the one batch the shards are views of, and over the shards as copies,
one group a device) give the JAX ``live_lane_counts`` on the virtual CPU
devices, bit for bit. K12's launch shape (``lane_live_shape``) and its
arithmetic, warp by warp as ``k_lane_live`` walks its tiles
(``lane_live_tiled``), count every lane once, in its own shard; the
shards of a mesh group by device in mesh order (``device_groups``)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.parallel import mesh as JM
from mythril_tpu_torch.ops import stepper as T
from mythril_tpu_torch.parallel import mesh as M
from mythril_tpu_torch.support.device_loop import k12_edge_cases, k12_status

CASES = {case[0]: case for case in k12_edge_cases()}
#: K12's blocks resident at once on an H100 (132 SMs, 32 blocks of 64
#: threads each), and grids of 1 and 3 resident blocks, which make a
#: thread take several tiles
RESIDENT = (132 * 32, 1, 3)
#: plane sizes of the batches the live counts run on
TINY = dict(stack_depth=1, memory_bytes=4, storage_slots=1,
            calldata_bytes=4)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax.devices()[:8]


def jax_counts(status: np.ndarray, n_dev: int):
    """The JAX package's (per-device counts, total) over a mesh of the
    first n_dev devices."""
    return JM.live_lane_counts(SimpleNamespace(status=jnp.asarray(status)),
                               JM.make_mesh(n_dev))


def port_batch(case) -> T.LaneState:
    """A CPU batch of the case's lanes whose status plane is the case's
    view (``k12_status``)."""
    status = k12_status(case, "cpu")
    return T.init_lanes(status.shape[0], device="cpu",
                        **TINY).replace(status=status)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_live_counts_are_the_jax_counts(eight_devices, name):
    case = CASES[name]
    _, status, devs, offset = case
    assert devs and devs[0] == 1
    view = k12_status(case, "cpu")
    assert view.storage_offset() == offset
    st = port_batch(case)
    for n_dev in devs:
        want, want_total = jax_counts(status, n_dev)
        np.testing.assert_array_equal(
            M.lane_live_plain(view, n_dev).numpy(), want,
            err_msg=f"{name}, {n_dev} shards")
        mesh = M.Mesh(["cpu"] * n_dev)
        sh = M.shard_lanes(st, mesh)
        for what, state in (("views of one batch", sh),
                            ("copies", M.ShardedLanes(mesh, sh.shards))):
            per, total = M.live_lane_counts(state, mesh)
            assert per.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(
                per, want, err_msg=f"{name}, {n_dev} shards, {what}")
            assert total == want_total


def _replayed(statuses, spp, shape, name):
    """``lane_live_tiled`` against the plain counts: every shard's total
    written, every lane counted once, in its own shard."""
    counts, owner, seen = M.lane_live_tiled(statuses, spp, *shape)
    want = torch.cat([M.lane_live_plain(x, spp) for x in statuses])
    assert counts == want.tolist(), name
    per = statuses[0].shape[0] // spp
    for j, (own, hits) in enumerate(zip(owner, seen)):
        assert set(hits) <= {1}, f"{name}: array {j}"
        assert own == [j * spp + i // per for i in range(len(own))], name


#: cases whose every shard count and grid is replayed; the rest at 8
#: shards on the card's grid
SMALL = [name for name, case in CASES.items() if case[1].shape[0] <= 4104]


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernels_tiles_count_every_lane_once_in_its_shard(name):
    """K12 as it launches over one batch of every shard (an array of
    ``n_dev`` shards) and over shard copies (an array a shard)."""
    case = CASES[name]
    status = k12_status(case, "cpu")
    n = status.shape[0]
    devs, grids = (case[2], RESIDENT) if name in SMALL \
        else (case[2][-1:], RESIDENT[:1])
    for n_dev in devs:
        shards = list(status.reshape(n_dev, -1))
        threads = M.lane_live_threads(n // n_dev)
        for resident in grids:
            for statuses, spp in (([status], n_dev), (shards, 1)):
                per_array = -(-(n // len(statuses)) // M.LIVE_TILE)
                shape = (M.lane_live_shape(per_array * len(statuses),
                                           threads, resident), threads)
                _replayed(statuses, spp, shape,
                          f"{name}, {n_dev} shards, {len(statuses)} arrays, "
                          f"shape {shape}")


def test_shards_inside_a_tile_take_the_split_path():
    """Shards of 1, 3 and 5 lanes share K12's 16-lane tiles: each lane
    still lands in its own shard, and a warp spanning several shards
    does not add them all to its first."""
    for w in (1, 3, 5):
        status = k12_status(CASES[f"shards_of_{w}"], "cpu")
        counts, owner, _ = M.lane_live_tiled([status], 8, 1, M.LIVE_THREADS)
        assert owner[0] == [i // w for i in range(8 * w)]
        assert counts == M.lane_live_plain(status, 8).tolist()


@pytest.mark.parametrize("n", [0, 1, 16, 17, 1024, 32768, 131072, 1 << 24])
@pytest.mark.parametrize("resident", RESIDENT)
def test_the_launch_shape_covers_the_tiles(n, resident):
    tiles = -(-n // M.LIVE_TILE)
    for threads in (M.LIVE_THREADS, 256, M.LIVE_SHARD_THREADS):
        blocks = M.lane_live_shape(tiles, threads, resident)
        warps = threads // 32
        assert 1 <= blocks <= max(1, resident)
        # a tile a warp where the resident blocks suffice, else every
        # resident block; no block without a tile but the one of no lanes
        assert blocks * warps >= tiles or blocks == resident
        assert (blocks - 1) * warps < max(tiles, 1)


def test_a_warp_holds_its_tile_once():
    """Thread t of a warp holds the lanes 4 t + 128 k + r (k, r < 4) of
    its 512-lane tile: every lane once, each of its four 16-byte loads a
    warp's 512 contiguous bytes."""
    lanes = [4 * t + 128 * k + r for t in range(32) for k in range(4)
             for r in range(4)]
    assert sorted(lanes) == list(range(M.LIVE_TILE))
    for k in range(4):
        load = sorted(4 * t + 128 * k + r for t in range(32)
                      for r in range(4))
        assert load == list(range(128 * k, 128 * k + 128))


@pytest.mark.parametrize("per, threads", [
    (1, 64), (16, 64), (496, 64), (512, 32), (4096, 256), (4100, 64),
    (16384, 1024), (16896, 64), (131072, 64)])
def test_a_shard_of_whole_warp_tiles_is_a_block(per, threads):
    """K12's block: a shard's warp tiles where it is a whole number of
    them, up to ``LIVE_SHARD_THREADS`` threads (8 shards of 32768 lanes:
    blocks of 256, one a shard), else the grid's 64 threads (8 shards of
    131072 lanes, or one: 128 blocks, every SM of an H100 but four)."""
    if threads > M.LIVE_SHARD_THREADS:
        threads = M.LIVE_THREADS
    assert M.lane_live_threads(per) == threads
    if per in (16384, 131072):
        assert M.lane_live_shape(131072 // M.LIVE_TILE, M.lane_live_threads(
            per), RESIDENT[0]) == 128


def test_the_shards_group_by_device_in_mesh_order():
    mesh = M.Mesh(["cpu", "meta", "cpu", "cpu", "meta"])
    assert M.device_groups(mesh) == [(torch.device("cpu"), [0, 2, 3]),
                                     (torch.device("meta"), [1, 4])]
    assert M.device_groups(M.Mesh(["cpu"] * 8)) == [
        (torch.device("cpu"), list(range(8)))]
