"""Multi-rank corpus mode in the port (``parallel/corpus.py`` on
torch.distributed): ranks meet at a ``TCPStore`` that rank 0 serves, a
gloo group is built over it, work claims are ``TCPStore.add`` fetch-adds
and the barrier rides the store. Counterparts of
``tests/test_corpus_distributed.py`` and
``tests/test_corpus_stealing.py``; the two-rank merged report must equal
the JAX package's two-process run's.

Every rank runs ``python -m mythril_tpu_torch.parallel.corpus`` with
``args.device = "cpu"`` set first (``PORT_CORPUS``), so the analyses
run the plain versions."""

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from mythril_tpu_torch.parallel.corpus import shard_corpus

from .fixture_paths import INPUTS

REPO = Path(__file__).resolve().parent.parent
FIXTURES = ["suicide.sol.o", "origin.sol.o", "returnvalue.sol.o",
            "nonascii.sol.o"]

#: one rank of the port's corpus mode on the CPU: the module run as
#: ``python -m`` runs it, after the analyses are sent to the CPU
PORT_CORPUS = (
    "import runpy\n"
    "from mythril_tpu_torch.support.support_args import args\n"
    "args.device = 'cpu'\n"
    "runpy.run_module('mythril_tpu_torch.parallel.corpus',\n"
    "                 run_name='__main__', alter_sys=True)\n")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(pkg, files, out_dir, ranks=2, flags=(), extra_env=None,
              timeout=900):
    """``ranks`` processes of ``pkg``'s corpus mode over ``files``;
    returns the merged report."""
    coordinator = f"127.0.0.1:{free_port()}"
    head = ([sys.executable, "-c", PORT_CORPUS] if pkg == "port" else
            [sys.executable, "-m", "mythril_tpu.parallel.corpus"])
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            head + ["--coordinator", coordinator,
                    "--num-processes", str(ranks), "--process-id",
                    str(rank), "--out-dir", str(out_dir)] + list(flags)
            + list(files),
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads((Path(out_dir) / "corpus_report.json").read_text())


def canon(report):
    return [(c["contract"], c.get("issues"), c.get("swc"))
            for c in report["contracts"]]


def test_shard_disjoint_and_complete():
    paths = [f"c{i}.o" for i in range(7)]
    shards = [shard_corpus(paths, i, 3) for i in range(3)]
    flat = [p for s in shards for p in s]
    assert sorted(flat) == sorted(paths)
    assert len(set(flat)) == len(paths)
    assert shard_corpus(list(reversed(paths)), 1, 3) == shards[1]


#: four ranks race to claim the same items through the port's store
CLAIMER = """
import json, sys
from mythril_tpu_torch.parallel import corpus
coordinator, rank, items = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
assert corpus.init_distributed(coordinator, 4, rank) == rank
client = corpus._kv_client()
won = [i for i in items if corpus._claim(client, i, owner=False)]
corpus._barrier("claims")
print(json.dumps(won))
"""


def test_exactly_one_of_four_racing_ranks_claims_each_item():
    coordinator = f"127.0.0.1:{free_port()}"
    items = [f"item{i}" for i in range(64)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLAIMER, coordinator, str(rank)] + items,
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    won = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    flat = [i for w in won for i in w]
    assert sorted(flat) == sorted(items)
    assert len(set(flat)) == len(items)


def test_standalone_has_no_store_and_no_barrier():
    from mythril_tpu_torch.parallel import corpus

    assert corpus.init_distributed(None) == 0
    assert corpus._kv_client() is None
    corpus._barrier("standalone")


@pytest.mark.skipif(not INPUTS.exists(), reason="fixtures not present")
def test_two_rank_corpus_equals_the_jax_package(tmp_path):
    files = [str(INPUTS / f) for f in FIXTURES]
    flags = ["--timeout", "60", "--no-steal"]
    want = run_ranks("jax", files, tmp_path / "jax", flags=flags)
    merged = run_ranks("port", files, tmp_path / "port", flags=flags)
    assert merged["num_processes"] == 2
    assert [c["contract"] for c in merged["contracts"]] == sorted(FIXTURES)
    assert merged["errors"] == 0
    assert [s["n"] for s in merged["shards"]] == [2, 2]
    names = [{r["contract"] for r in json.loads(
        (tmp_path / "port" / f"shard_{rank}.json").read_text())["results"]}
        for rank in range(2)]
    assert not (names[0] & names[1])
    assert canon(merged) == canon(want)
    by_name = {c["contract"]: c for c in merged["contracts"]}
    assert "106" in by_name["suicide.sol.o"]["swc"]


# shards are round-robin over sorted names: heavy copies at even sort
# positions all land on rank 0, featherweight copies at odd positions on
# rank 1; per-name MTPU_ANALYZE_DELAY rules keep the heavy shard's wall
# about 4x the light one's, so the light rank drains first and steals
HEAVY, LIGHT = "metacoin.sol.o", "nonascii.sol.o"


@pytest.mark.skipif(not INPUTS.exists(), reason="fixtures not present")
def test_stealing_balances_imbalanced_corpus(tmp_path):
    files = []
    for i in range(4):
        for k, name in ((2 * i, HEAVY), (2 * i + 1, LIGHT)):
            dst = tmp_path / f"f{k}_{name}"
            shutil.copy(INPUTS / name, dst)
            files.append(str(dst))
    env = {"MTPU_ANALYZE_DELAY": "metacoin=4.0,nonascii=0.2"}
    static = run_ranks("port", files, tmp_path / "static",
                       flags=["--timeout", "60", "--no-steal"],
                       extra_env=env)
    stolen = run_ranks("port", files, tmp_path / "steal",
                       flags=["--timeout", "60"], extra_env=env)
    assert canon(static) == canon(stolen)
    assert static["errors"] == 0 and stolen["errors"] == 0
    assert stolen["stolen"] >= 1
    static_makespan = max(s["wall_s"] for s in static["shards"])
    steal_makespan = max(s["wall_s"] for s in stolen["shards"])
    assert steal_makespan < static_makespan * 1.25


def test_stats_persist_and_lpt_warm_start(tmp_path):
    """A corpus run persists per-contract walls and fork peaks into
    --out-dir/stats.json; the next run over the same dir schedules LPT
    from them and declares the long pole splittable."""
    from mythril_tpu_torch.parallel import cost_model as cm
    from mythril_tpu_torch.parallel.corpus import run_corpus

    def fake(path):
        name = Path(path).name
        heavy = "heavy" in name
        return {"contract": name, "issues": 0, "swc": [],
                "wall_s": 10.0 if heavy else 1.0,
                "fork_peak": 300 if heavy else 0}

    files = []
    for n in ("a_heavy.sol.o", "b_light.sol.o", "c_light.sol.o",
              "d_light.sol.o"):
        f = tmp_path / n
        f.write_text("00")
        files.append(str(f))
    out = tmp_path / "out"
    run_corpus(files, str(out), 0, 1, analyze=fake, steal=False)
    stats = cm.load_stats(out)
    assert stats["a_heavy.sol.o"]["wall_s"] == 10.0
    assert stats["a_heavy.sol.o"]["fork_peak"] == 300
    shards, split = cm.make_shards(files, 2, stats)
    heavy_shards = [s for s in shards if any("heavy" in p for p in s)]
    assert len(heavy_shards) == 1 and len(heavy_shards[0]) == 1
    assert split == {files[0]}

    def fake2(path):
        r = fake(path)
        if "heavy" in r["contract"]:
            r["wall_s"], r["fork_peak"] = 20.0, 120
        return r

    run_corpus(files, str(out), 0, 1, analyze=fake2, steal=False)
    stats = cm.load_stats(out)
    assert stats["a_heavy.sol.o"]["wall_s"] == pytest.approx(15.0)
    assert stats["a_heavy.sol.o"]["fork_peak"] == 300
