"""The fixture corpus ``myth analyze`` is held to, and its canonical
issue lists: a copy of ``canon`` and the flags of
``tests/compare_lane_host.py``, so that ``chip_smoke.py`` can compare
the port's reports with the JAX package's on a machine without JAX.

``canon`` keeps the identity fields of each issue: tx_sequence model
values (initial balances, which of several valid selectors reaches a
shared site) depend on the solver's query order and are reduced to
whether a sequence exists.
"""

import json
import pathlib

#: the 18 vendored fixtures
INPUTS = (pathlib.Path(__file__).resolve().parents[2] / "tests"
          / "fixtures" / "testdata" / "inputs")

#: creation bytecode: analyzed without --bin-runtime
CREATION_FIXTURES = {
    "flag_array.sol.o",
    "exceptions_0.8.0.sol.o",
    "symbolic_exec_bytecode.sol.o",
    "extcall.sol.o",
}


def analyze_argv(path, lanes: int = 64):
    """The ``analyze`` arguments of the corpus comparison."""
    path = pathlib.Path(path)
    argv = ["analyze", "-f", str(path), "-t", "2", "--no-onchain-data",
            "-o", "json", "--solver-timeout", "15000"]
    if path.name not in CREATION_FIXTURES:
        argv.append("--bin-runtime")
    if lanes:
        argv += ["--tpu-lanes", str(lanes)]
    return argv


def canon(report):
    """Comparable issue list: identity fields only, sorted."""
    issues = []
    for i in report.get("issues") or []:
        i = dict(i)
        i.pop("discoveryTime", None)
        seq = i.pop("tx_sequence", None)
        i["has_tx_sequence"] = bool(seq and seq.get("steps"))
        issues.append(i)
    return sorted(issues, key=lambda i: json.dumps(i, sort_keys=True))
