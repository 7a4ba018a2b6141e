"""K3's remap over a mesh (``laser/lane_engine.mesh_remap``) on CPU
shards, where the call runs its plain version, held bit for bit to the
JAX package's ``_canon_remap`` on the unsharded batch, split into the
same shards.

Each case's four persistent sid planes (``ssid``, ``sval_sid``,
``skey_sid``, ``mlog_sid``) are drawn from a numpy seed, with every kind
of sid in each plane: 0, positive sids, provisional sids whose row lies
in the batch, -1 (the first record of lane 0), ``INT32_MIN`` and
provisional sids whose row lies past the last lane (JAX's gather clamps
the row to the last lane). The canon is the whole batch's (lanes x
``d_recs``), as K3 writes it at the mesh's first device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.parallel.mesh import Mesh, shard_sym_lanes

LANES = 16
#: narrow planes: 16 lanes of 8 stack words, 4 storage slots, 4 memory
#: records
KW = dict(stack_depth=8, memory_bytes=64, mem_records=4, storage_slots=4,
          calldata_bytes=32)
I32_MIN = np.iinfo(np.int32).min


def sid_plane(rng, shape, n, d_recs):
    """A sid plane of every kind, the kinds first, the rest random."""
    total = n * d_recs
    kinds = np.array([0, 7, -1, I32_MIN,
                      -1 - rng.integers(0, total),         # in the batch
                      -1 - total,                           # one row past
                      -1 - rng.integers(total, 4 * total)],  # further past
                     np.int64)
    pick = rng.integers(0, 4, size=shape)
    out = np.where(pick == 0, 0, rng.integers(1, 1 << 30, size=shape))
    out = np.where(pick == 2, -1 - rng.integers(0, total, size=shape), out)
    out = np.where(pick == 3, -1 - rng.integers(0, 3 * total, size=shape),
                   out)
    flat = out.reshape(-1)
    flat[:kinds.size] = kinds
    return out.astype(np.int32)


def case(seed, d_recs):
    """(the batch's planes in the JAX dtypes, the canon), numpy."""
    rng = np.random.default_rng(seed)
    st = TS.init_sym_lanes(LANES, device="cpu", dlog_records=d_recs, **KW)
    planes = interop.state_to_numpy(st)
    for f in TL.REMAP_PLANES:
        planes[f] = sid_plane(rng, planes[f].shape, LANES, d_recs)
    canon = rng.integers(I32_MIN, np.iinfo(np.int32).max,
                         size=(LANES, d_recs), dtype=np.int64)
    return planes, canon.astype(np.int32)


def jax_remap(planes, canon, d_recs):
    """``_canon_remap`` on the unsharded batch: the four planes, numpy."""
    jst = JS.SymLaneState(**{k: jnp.asarray(v) for k, v in planes.items()})
    out = JL._canon_remap(jst, jnp.asarray(canon), d_recs)
    return {f: np.asarray(getattr(out, f)) for f in TL.REMAP_PLANES}


def on_shards(planes, shards, d_recs):
    """The batch placed over ``shards`` CPU shards."""
    st = interop.state_from_numpy(planes, "cpu")
    ss = shard_sym_lanes(Mesh(["cpu"] * shards), LANES, dlog_records=d_recs,
                         **KW)
    per = ss.per
    for i, shard in enumerate(ss.shards):
        ss.shards[i] = shard.replace(**{
            f: getattr(st, f)[i * per:(i + 1) * per].clone()
            for f in TS.FIELDS if f not in TS.NO_COPY})
    return ss


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d_recs", [1, 64])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_mesh_remap_equals_the_jax_canon_remap(shards, d_recs, seed):
    planes, canon = case(100 * shards + 10 * d_recs + seed, d_recs)
    want = jax_remap(planes, canon, d_recs)
    ss = on_shards(planes, shards, d_recs)
    got = TL.mesh_remap(ss, torch.from_numpy(canon))
    assert got is ss and len(ss.shards) == shards
    whole = ss.lanes()
    for f in TL.REMAP_PLANES:
        np.testing.assert_array_equal(getattr(whole, f).numpy(), want[f],
                                      err_msg=f)
    untouched = interop.state_to_numpy(whole)
    for f in TS.FIELDS:
        if f not in TL.REMAP_PLANES and f not in TS.NO_COPY:
            np.testing.assert_array_equal(untouched[f], planes[f],
                                          err_msg=f)


@pytest.mark.parametrize("d_recs", [1, 64])
def test_each_kind_of_sid_maps_as_the_jax_gather_clamps_it(d_recs):
    """The kinds alone, by hand: 0 and positive sids stay, -1 is lane
    0's first record, and a row past the last lane (``INT32_MIN``'s
    too) reads the last lane's row at the index's slot."""
    planes, canon = case(7, d_recs)
    ss = on_shards(planes, 2, d_recs)
    TL.mesh_remap(ss, torch.from_numpy(canon))
    got = ss.lanes().ssid.numpy().reshape(-1)
    total = LANES * d_recs

    def clamped(v):
        idx = -int(v) - 1
        return canon[min(idx // d_recs, LANES - 1), idx % d_recs]

    kinds = planes["ssid"].reshape(-1)[:7]
    assert got[0] == 0 and got[1] == 7
    assert got[2] == canon[0, 0]
    assert got[3] == canon[LANES - 1, (2 ** 31 - 1) % d_recs]
    for j in range(4, 7):
        assert got[j] == clamped(kinds[j])
    assert -1 - int(kinds[5]) == total
