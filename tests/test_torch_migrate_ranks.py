"""Path-batch migration between the port's corpus ranks
(``parallel/migrate.py`` over the port's ``parallel/corpus.py``): the
three multi-rank tests of ``tests/test_migration.py``. Rigged corpora
where drained ranks take slices of a heavy contract's open-state wave
mid-analysis (at a round boundary, mid-round, and split across three
thieves), always with the merged report identical to the port's run
without migration; the first also holds that run to the JAX package's.

Kept apart from ``tests/test_torch_corpus.py`` so that the suite's
``--dist loadfile`` gives these long multi-process tests a worker of
their own."""

import shutil

import pytest

from .fixture_paths import INPUTS
from .test_torch_corpus import canon, run_ranks

HEAVY, LIGHT = "ether_send.sol.o", "nonascii.sol.o"

#: the victim's analysis starts late enough for the drained thief to be
#: polling when round 1 ends, whatever the ranks' startup skew
DELAY = {"MTPU_ANALYZE_DELAY": "ether_send=8,nonascii=0.1"}

pytestmark = pytest.mark.skipif(not INPUTS.exists(),
                                reason="fixtures not present")


def _corpus(tmp_path, n_light=1):
    files = [tmp_path / f"a_{HEAVY}"]
    shutil.copy(INPUTS / HEAVY, files[0])
    for _, tag in zip(range(n_light), "bcdefg"):
        dst = tmp_path / f"{tag}_{LIGHT}"
        shutil.copy(INPUTS / LIGHT, dst)
        files.append(dst)
    return [str(f) for f in files]


def _run(pkg, tmp_path, files, out_name, migrate, ranks=2, extra_env=None):
    flags = ["--timeout", "90"] + (["--migrate"] if migrate else [])
    return run_ranks(pkg, files, tmp_path / out_name, ranks=ranks,
                     flags=flags, extra_env=dict(DELAY, **(extra_env or {})))


def test_midflight_batch_migrates_with_identical_report(tmp_path):
    files = _corpus(tmp_path)
    want = _run("jax", tmp_path, files, "jax", migrate=False)
    plain = _run("port", tmp_path, files, "plain", migrate=False)
    moved = _run("port", tmp_path, files, "migrate", migrate=True)

    assert canon(plain) == canon(want)
    assert canon(plain) == canon(moved), (
        f"plain: {canon(plain)}\nmigrated: {canon(moved)}")
    assert plain["errors"] == 0 and moved["errors"] == 0
    out = sum(s.get("migrated_batches_out", 0) for s in moved["shards"])
    served = sum(s.get("migrated_batches_served", 0)
                 for s in moved["shards"])
    assert out >= 1, moved["shards"]
    assert served >= 1, moved["shards"]
    thieves = [s for s in moved["shards"]
               if s["migration"].get("batches_in", 0) > 0]
    assert sum(s["solver"].get("verdicts_replayed", 0)
               for s in thieves) > 0, moved["shards"]
    assert all(s["solver"].get("queries_saved", 0) > 0
               for s in thieves), moved["shards"]


def test_midround_steal_parity(tmp_path):
    """The wave sheds while a round is still executing (the mid-round
    yield in laser/svm.py); MTPU_CKPT=0 pins the finished-state yield
    path, as in the JAX package's test."""
    files = _corpus(tmp_path)
    rig = {"MTPU_PATH_DELAY": "0.5", "MTPU_MIDROUND_K": "64",
           "MTPU_CKPT": "0"}
    plain = _run("port", tmp_path, files, "plain", migrate=False,
                 extra_env=rig)
    moved = _run("port", tmp_path, files, "midround", migrate=True,
                 extra_env=rig)

    assert canon(plain) == canon(moved), (
        f"plain: {canon(plain)}\nmigrated: {canon(moved)}")
    assert plain["errors"] == 0 and moved["errors"] == 0
    assert moved.get("midround_exports", 0) >= 1, moved["shards"]
    assert moved.get("batches_in", 0) >= 1, moved["shards"]


def test_multiway_split_three_thieves(tmp_path):
    """Four ranks, one long pole: the victim's wave splits across the
    idle ranks as several offers, with the merged report unchanged."""
    files = _corpus(tmp_path, n_light=3)
    plain = _run("port", tmp_path, files, "plain4", migrate=False, ranks=4)
    moved = _run("port", tmp_path, files, "multiway", migrate=True, ranks=4)

    assert canon(plain) == canon(moved), (
        f"plain: {canon(plain)}\nmigrated: {canon(moved)}")
    assert plain["errors"] == 0 and moved["errors"] == 0
    assert moved.get("batches_out", 0) >= 2, moved["shards"]
    assert moved.get("batches_in", 0) >= 2, moved["shards"]
