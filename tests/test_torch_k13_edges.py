"""K13 ``lane_order`` (mythril_tpu_torch/parallel/mesh.py) against the
JAX package on the CPU: the plain version on every edge input of
``support/device_loop.k13_edge_cases`` equals ``jnp.argsort(-running,
stable=True)`` (``compact_lanes``' order) and, dealt over n_dev shards,
``steal_balance``'s reshape-transpose deal, bit for bit. The kernel's
launch shape (``lane_order_shape``) and its arithmetic, tile by tile and
block by block as ``k_order`` walks them (``lane_order_tiled``), give
the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu_torch.parallel import mesh as M
from mythril_tpu_torch.support.device_loop import k13_edge_cases

CASES = {name: (st, devs) for name, st, devs in k13_edge_cases()}


def jax_order(status: np.ndarray, n_dev: int) -> np.ndarray:
    """The JAX package's order (mythril_tpu/parallel/mesh.py: the
    argsort of ``compact_lanes`` and ``steal_balance``, then the
    deal)."""
    running = jnp.asarray(status == 0).astype(jnp.int32)
    order = jnp.argsort(-running, stable=True)
    n = status.shape[0]
    return np.asarray(jnp.reshape(jnp.reshape(order, (n // n_dev, n_dev)).T,
                                  (n,)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_plain_order_is_the_jax_order(name):
    status, devs = CASES[name]
    assert devs and devs[0] == 1
    for n_dev in devs:
        got = M.lane_order_plain(torch.from_numpy(status), n_dev)
        np.testing.assert_array_equal(got.numpy(), jax_order(status, n_dev),
                                      err_msg=f"{name}, {n_dev} shards")


#: cases small enough for the tile-by-tile arithmetic in Python; the
#: card's grid (1056 resident blocks on an H100) and grids of 1 and 3
#: resident blocks, which make K13 loop over several tiles a block
TILED = [name for name, (st, _) in CASES.items() if st.shape[0] <= 4097]


@pytest.mark.parametrize("name", sorted(TILED))
def test_the_kernels_tiles_and_block_offsets_give_the_order(name):
    status, devs = CASES[name]
    st = torch.from_numpy(status)
    n = status.shape[0]
    shapes = {M.lane_order_shape(n, r) for r in (1056, 1, 3)}
    for shape in shapes:
        for n_dev in devs:
            np.testing.assert_array_equal(
                M.lane_order_tiled(st, n_dev, shape).numpy(),
                jax_order(status, n_dev), err_msg=f"{name}, {shape}")


def test_the_wide_grid_form_gives_the_order():
    """131072 lanes as K13 launches them on an H100 (a grid of 32
    blocks of 256 threads, a tile each) and on a grid of 3 resident
    blocks (11 tiles a block)."""
    status, devs = CASES["runs_across_131072"]
    st = torch.from_numpy(status)
    for shape, want in ((M.lane_order_shape(131072, 1056), (32, 1)),
                        (M.lane_order_shape(131072, 3), (3, 11))):
        assert shape == want
        np.testing.assert_array_equal(
            M.lane_order_tiled(st, devs[-1], shape).numpy(),
            jax_order(status, devs[-1]), err_msg=str(shape))


@pytest.mark.parametrize("n", [1, 31, 33, 4097, 16384, 16385, 32768, 131072,
                               1 << 22])
@pytest.mark.parametrize("resident", [1, 3, 1056])
def test_the_launch_shape_covers_the_lanes_once(n, resident):
    blocks, tiles = M.lane_order_shape(n, resident)
    assert 1 <= blocks <= resident
    assert (blocks == 1) == (n <= M.ORDER_VEC * M.ORDER_THREADS
                             or resident == 1)
    lanes = blocks * tiles * M.ORDER_THREADS * M.ORDER_VEC
    assert lanes >= n
    # no block whose tiles all lie past the lanes
    assert (blocks - 1) * tiles * M.ORDER_THREADS * M.ORDER_VEC < n
    starts = M.order_tile_lanes((blocks, tiles), blocks - 1, tiles - 1)
    assert starts[-1] + M.ORDER_VEC == lanes
