"""The port stands alone: no module of mythril_tpu_torch/, not
chip_smoke.py and not tools/prof_torch_port.py imports JAX or the JAX
package, and the copies the port keeps of the JAX package's tables and
constants are equal to the originals."""

import ast
import os
import re

import numpy as np
import pytest
import torch

from mythril_tpu.ops import stepper as JST
from mythril_tpu.ops import symstep as JS
from mythril_tpu.support import eth_constants as JE
from mythril_tpu.support import opcodes as JO
from mythril_tpu_torch.ops import bv256, stepper, symstep
from mythril_tpu_torch.support import devices, eth_constants, opcodes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mythril_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tools", "prof_torch_port.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mythril_tpu") or top.startswith("jax_")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package(path):
    bad = [m for m in _imported(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_sees_the_package():
    names = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"ops/symstep.py", "laser/lane_engine.py", "_build.py",
            "ops/intervals.py", "ops/propagate.py", "smt/terms.py",
            "smt/interval.py", "smt/solver/solver_statistics.py",
            "models/pruner.py", "support/telemetry/spans.py",
            "support/screen_waves.py"} <= names


def _source(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("rel", ["smt/terms.py", "smt/interval.py",
                                 "support/support_args.py"])
def test_verbatim_copies_equal_their_originals(rel):
    """The term DAG, the host interval domain and the analysis flags are
    copies of the JAX package's modules, modulo the package name."""
    mine = _source(PKG, rel).replace("mythril_tpu_torch", "mythril_tpu")
    assert mine == _source(ROOT, "mythril_tpu", rel)


def test_copied_singleton_and_counters_match():
    from mythril_tpu.smt.solver.solver_statistics import SolverStatistics
    from mythril_tpu.support.support_utils import Singleton
    from mythril_tpu_torch.smt.solver import solver_statistics
    from mythril_tpu_torch.support import support_utils

    def body(cls):
        import inspect

        return inspect.getsource(cls).split('"""', 2)[2]

    assert body(support_utils.Singleton) == body(Singleton)
    mine = solver_statistics.SolverStatistics().counters()
    theirs = SolverStatistics().batch_counters()
    assert set(mine) <= set(theirs)
    assert set(mine) == {"propagate_kills", "propagate_sweeps",
                         "facts_harvested", "static_facts_seeded"}
    fresh = SolverStatistics.__new__(SolverStatistics)
    SolverStatistics.__init__(fresh)
    assert all(getattr(fresh, k) == 0 for k in mine)


def test_screen_kernel_opcodes_follow_the_python_numbering():
    from mythril_tpu_torch.ops import intervals

    src = _source(PKG, "csrc", "screen.cu")
    enum = re.search(r"enum \{\s*(NOP = 0,.*?)\};", src, re.S).group(1)
    names = [x.strip().split(" ")[0] for x in enum.split(",") if x.strip()]
    assert [getattr(intervals, n) for n in names] == list(range(26))


def test_copied_tables_equal_the_originals():
    assert opcodes.OPCODES == JO.OPCODES
    assert eth_constants.ARB_PROBE_SLOT == JE.ARB_PROBE_SLOT
    for name in ("NPOP_TABLE", "NPUSH_TABLE", "GAS_TABLE", "SUPPORTED_TABLE",
                 "ENV_TABLE", "RESULT_CLASS_TABLE"):
        np.testing.assert_array_equal(getattr(stepper, name),
                                      getattr(JST, name), err_msg=name)
    assert stepper.ENV_SLOTS == JST.ENV_SLOTS
    assert stepper.RESULT_CLASSES == JST.RESULT_CLASSES
    for name in ("GAS_MIN_TABLE", "GAS_MAX_TABLE", "SYM_EXECUTABLE",
                 "DEFERRABLE", "MSTORE_PAT_MASK", "MSTORE_PAT_EXPECT"):
        np.testing.assert_array_equal(getattr(symstep, name),
                                      getattr(JS, name), err_msg=name)
    assert (symstep.REC_SLOAD_RW, symstep.MAX_FORKS_PER_STEP,
            symstep.DEAD) == (JS.REC_SLOAD_RW, JS.MAX_FORKS_PER_STEP,
                              JS.DEAD)


def test_kernel_constants_equal_the_python_ones():
    """The constants csrc/ spells out again: the probe slot, the
    result-class order, the dedup table size."""
    csrc = os.path.join(PKG, "csrc")
    step = open(os.path.join(csrc, "symstep.cu")).read()
    lo = int(re.search(r"PROBE_LO = (0x[0-9a-f]+)u", step).group(1), 16)
    hi = int(re.search(r"PROBE_HI = (0x[0-9a-f]+)u", step).group(1), 16)
    assert (hi << 32) | lo == eth_constants.ARB_PROBE_SLOT
    enum = re.search(r"enum \{\s*(RC_ZERO.*?)\};", step, re.S).group(1)
    names = [x.strip()[3:] for x in enum.split(",") if x.strip()]
    assert names == stepper.RESULT_CLASSES
    win = open(os.path.join(csrc, "window.cu")).read()
    from mythril_tpu_torch.laser import lane_engine

    assert f"DEDUP_H = {lane_engine._DEDUP_H};" in win
    fields = re.search(r"#define SYM_FIELDS\(X\)(.*?)\n\n",
                       open(os.path.join(csrc, "common.cuh")).read(),
                       re.S).group(1)
    assert tuple(re.findall(r"X\(\w+, (\w+)\)", fields)) == symstep.FIELDS


def test_bv256_op_codes_follow_the_kernel_switch():
    src = open(os.path.join(PKG, "csrc", "bv256.cu")).read()
    cases = dict(re.findall(r"case (\d+): .*?bv::(\w+)", src))
    assert len(cases) == len(bv256.OPS)


def test_entry_points_default_to_the_card():
    """Without a card an entry point that is not asked for the CPU
    raises; asked for the CPU it runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        devices.resolve()
    with pytest.raises(RuntimeError):
        symstep.init_sym_lanes(4)
    st = symstep.init_sym_lanes(4, device="cpu")
    assert st.pc.device.type == "cpu"
