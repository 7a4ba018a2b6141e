"""K9's plain version (``lane_engine.merge_fingerprint_plain``) against
the JAX package's ``_merge_fingerprint`` on ``device_loop.k9_edge_cases``
(chip_smoke.py holds the kernel to the plain version on the same
inputs), bit for bit: the fingerprints are integers, so the tolerance
is 0. Also K9's launch plan (``lane_engine.merge_fp_plan``) at every
case's sizes, and the window boundary's pair packing
(``lane_engine._prov_pairs``) against the loop it replaced."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser import lane_engine as JL
from mythril_tpu.ops import symstep as JS
from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.ops import symstep as TS
from mythril_tpu_torch.support import device_loop as DL

_CASES = {c.name: c for c in DL.k9_edge_cases()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_k9_edge_case_matches_the_jax_package(name):
    case = _CASES[name]
    st, pairs = DL.k9_case_inputs(case, "cpu")
    got = TL.merge_fingerprint(st, pairs).numpy().view(np.uint32)
    jst = JS.SymLaneState(**{f: jnp.asarray(case.planes[f])
                             for f in TS.FIELDS})
    want = np.asarray(JL._merge_fingerprint(jst, jnp.asarray(case.pairs)))
    assert want.shape == (case.lanes, 4)
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_the_cases_cover_their_edges():
    """Negative, dropped and repeated slots; more pairs than the shared
    hash; empty and full storage tables with tied write stamps; a memory
    width no multiple of 16."""
    slots = _CASES["slots"].pairs[:, 0]
    nr = 33 * DL.WINDOW_WIDTHS["caps"]["dlog_records"]
    assert (slots < 0).sum() >= 3 and (slots > nr).any()
    assert len(set(slots[slots < nr].tolist())) < (slots < nr).sum()
    assert _CASES["past_shared"].pairs.shape[0] > TL.K9_PROV_LOCAL
    assert _CASES["no_pairs"].pairs.shape[0] == 0
    assert (_CASES["scount_0"].planes["scount"] == 0).all()
    full = _CASES["scount_full"].planes
    assert (full["scount"] == full["skeys"].shape[1]).all()
    ws = full["s_wstep"]
    assert all(len(set(r.tolist())) < len(r) for r in ws)
    assert _CASES["odd_memory"].planes["memory"].shape[1] % 16


@pytest.mark.parametrize("name", sorted(_CASES))
def test_merge_fp_plan(name):
    """A lane's team is the block up to two lanes an SM and a warp past
    it, the grid covers the lanes and fits the card at once, the hash is
    at most half full, the block's shared memory holds it all, and one
    launch serves every case up to K9_PROV_LOCAL pairs."""
    case = _CASES[name]
    w = case.widths
    pv = case.pairs.shape[0]
    n = case.lanes
    p = TL.merge_fp_plan(n, pv, w["stack_depth"], w["storage_slots"])
    assert p["team"] == (8 if n <= 264 else 1)
    teams = 8 // p["team"]
    assert 1 <= p["blocks"] <= -(-n // teams)
    per_sm = TL.K9_SM_SMEM // (p["smem"] + 1024)
    assert p["blocks"] <= max(1, min(8, per_sm)) * 132
    if pv <= TL.K9_PROV_LOCAL:
        assert p["launches"] == 1 and p["cap"] >= 2 * pv
        assert p["cap"] & (p["cap"] - 1) == 0
    else:
        assert p["launches"] == 3 and p["cap"] == 0
    assert p["smem"] == TL._k9_smem(p["cap"], p["team"], w["stack_depth"],
                                    w["storage_slots"]) <= 232448


def test_plan_at_the_paths_shapes():
    """The corpus's window boundary (64 lanes at the engine's default
    planes, a PROV_BUCKET of pairs): one launch, a block a lane. The
    symbolic path's 4096 lanes: a warp a lane, two blocks an SM."""
    p = TL.merge_fp_plan(64, TL.PROV_BUCKET, 64, 64)
    assert (p["team"], p["blocks"], p["cap"], p["launches"]) \
        == (8, 64, 8192, 1)
    p = TL.merge_fp_plan(4096, TL.PROV_BUCKET, 64, 64)
    assert (p["team"], p["blocks"], p["launches"]) == (1, 264, 1)


@pytest.mark.parametrize("n_pairs", [0, 3, 4096, 4097])
def test_prov_pairs_packs_as_the_loop_did(n_pairs):
    n, d = 80, 64
    rng = np.random.default_rng(n_pairs)
    keys = rng.choice(n * d, n_pairs, replace=False)
    prov = {(int(k) // d, int(k) % d): int(rng.integers(1, 1 << 30))
            for k in keys}
    got = TL._prov_pairs(prov, n, d, "cpu").numpy()
    pv = min(TL.PROV_BUCKET, n * d) if len(prov) <= TL.PROV_BUCKET \
        else n * d
    want = np.full((pv, 2), n * d, np.int32)
    for j, ((lane, slot), oid) in enumerate(prov.items()):
        want[j] = (lane * d + slot, oid)
    np.testing.assert_array_equal(got, want)
