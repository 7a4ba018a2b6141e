#!/usr/bin/env python3
"""Write the JAX package's canonical issue lists for the 18 vendored
fixtures, the reference ``chip_smoke.py`` holds the PyTorch port's
``myth analyze`` against on a machine that has no JAX.

Usage (from the repository root, on the CPU)::

    JAX_PLATFORMS=cpu python3 tools/make_torch_reference.py \
        [-o tests/torch_data/lane_issues.json] [fixture ...]

Each fixture runs through ``python3 myth analyze`` (the JAX package)
with the flags ``chip_smoke.py`` gives the port:
``-t 2 --no-onchain-data -o json --solver-timeout 15000 --tpu-lanes
64``, plus ``--bin-runtime`` except for the four creation fixtures.
The file maps each fixture name to ``{"issues": canonical list,
"run_stats": the JAX lane engine's RUN_STATS_TOTAL for the run,
"engine_failures": sweeps whose explore raised, "wall_s": seconds}``;
the canonical list is ``mythril_tpu_torch.support.lane_compare.canon``.
``chip_smoke.py`` requires the port's engine to run the JAX engine's
windows, forks and device steps on each fixture where no JAX sweep
failed (a failed sweep falls back to the host in the JAX package and
counts nothing; the port raises instead), and a window where one did.

With ``--corpus`` it writes instead the reference of the multi-rank
corpus mode (``tests/torch_data/corpus_issues.json`` by default): the
JAX package's ``python -m mythril_tpu.parallel.corpus`` over the
fixtures as one rank, with the flags ``chip_smoke.py`` gives the port's
(``CORPUS_FLAGS``). Its ``default_analyze`` loads every file with
``--bin-runtime`` and runs two transactions with the full detector set,
so its issues differ from the CLI corpus'. The file maps each fixture to
``{"issues": count, "swc": sorted SWC ids}``, the fields of the merged
``corpus_report.json``.

This is the one script of the port that runs the JAX package: the
import scan of ``tests/test_torch_imports.py`` names it as excluded.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mythril_tpu_torch.support.lane_compare import (  # noqa: E402
    INPUTS, analyze_argv, canon,
)

#: runs the JAX package's CLI with the argv after the stats path, its
#: report on stdout, and writes to the path the lane engine's run stats,
#: the number of sweeps whose explore raised (the JAX package then goes
#: on on the host, and the failed sweep adds nothing to the run stats)
#: and the analysis' exceptions (the JSON report leaves them out)
RUNNER = """
import json, sys
sys.path.insert(0, {repo!r})
from mythril_tpu.interfaces import cli
from mythril_tpu.laser import lane_engine
from mythril_tpu.orchestration.mythril_analyzer import MythrilAnalyzer
stats, sys.argv = sys.argv[1], ["myth"] + sys.argv[2:]
out = {{"engine_failures": 0, "exceptions": []}}
explore, fire = lane_engine.LaneEngine.explore, MythrilAnalyzer.fire_lasers

def explore_counted(*a, **k):
    try:
        return explore(*a, **k)
    except Exception:
        out["engine_failures"] += 1
        raise

def fire_recorded(*a, **k):
    report = fire(*a, **k)
    out["exceptions"] += report.exceptions
    return report

lane_engine.LaneEngine.explore = explore_counted
MythrilAnalyzer.fire_lasers = fire_recorded
try:
    cli.main()
except SystemExit as e:
    if e.code not in (None, 0, 1):
        raise
finally:
    out["run_stats"] = lane_engine.RUN_STATS_TOTAL
    with open(stats, "w") as f:
        json.dump(out, f)
"""


#: the corpus-mode flags of the reference and of chip_smoke.py's
#: four-rank phase (a timeout far above any fixture's wall, so that the
#: issues do not depend on the machine's speed)
CORPUS_FLAGS = ["--tpu-lanes", "64", "--timeout", "600"]


def corpus_reference(names, out_path):
    """The JAX package's corpus mode over ``names`` as one rank."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "mythril_tpu.parallel.corpus",
               "--out-dir", tmp, "--no-steal"] + CORPUS_FLAGS + [
            str(INPUTS / n) for n in names]
        t0 = time.time()
        run = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=str(REPO), env=dict(os.environ),
                             timeout=3600)
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-3000:])
            raise SystemExit(f"corpus mode exited {run.returncode}")
        with open(os.path.join(tmp, "corpus_report.json")) as f:
            merged = json.load(f)
    if merged["errors"]:
        raise SystemExit(f"corpus mode: {merged['errors']} errors")
    out = {c["contract"]: {"issues": c["issues"], "swc": c["swc"]}
           for c in merged["contracts"]}
    path = pathlib.Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"corpus mode: {merged['total_issues']} issues over {len(out)} "
          f"fixtures in {time.time() - t0:.1f} s -> {path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--corpus", action="store_true",
                    help="the corpus-mode reference instead")
    ap.add_argument("fixtures", nargs="*")
    a = ap.parse_args()
    names = a.fixtures or sorted(p.name for p in INPUTS.glob("*.sol.o"))
    data = REPO / "tests" / "torch_data"
    if a.corpus:
        return corpus_reference(names, a.out or data / "corpus_issues.json")
    a.out = a.out or str(data / "lane_issues.json")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            stats = os.path.join(tmp, name + ".json")
            cmd = [sys.executable, "-c", RUNNER.format(repo=str(REPO)),
                   stats] + analyze_argv(INPUTS / name, lanes=64)
            t0 = time.time()
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=str(REPO), env=dict(os.environ),
                                 timeout=1800)
            wall = time.time() - t0
            if run.returncode != 0:
                sys.stderr.write(run.stderr[-3000:])
                raise SystemExit(f"{name}: myth exited {run.returncode}")
            issues = canon(json.loads(run.stdout))
            with open(stats) as f:
                got = json.load(f)
            if got["exceptions"]:
                sys.stderr.write(got["exceptions"][0][-3000:])
                raise SystemExit(f"{name}: the analysis raised")
            rs = got["run_stats"]
            out[name] = {"issues": issues, "run_stats": rs,
                         "engine_failures": got["engine_failures"],
                         "wall_s": round(wall, 3)}
            print(f"{name:32s} {len(issues):3d} issues {wall:7.1f} s "
                  f"{rs.get('windows', 0)} windows, "
                  f"{got['engine_failures']} engine failures", flush=True)
    path = pathlib.Path(a.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"{sum(len(v['issues']) for v in out.values())} issues over "
          f"{len(out)} fixtures -> {path}")


if __name__ == "__main__":
    main()
