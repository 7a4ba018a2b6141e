"""The port stands alone: no module of mythril_tpu_torch/, not
chip_smoke.py and not tools/prof_torch_port.py imports JAX or the JAX
package, every module imports on the CPU without JAX, and the copies the
port keeps of the JAX package's modules, tables and constants are equal
to the originals: byte for byte (modulo the package name) for the
verbatim copies, and outside the named functions for the few copies
edited where, as copied, they would hide the device.

``tools/make_torch_reference.py`` is the one script of the port's that
runs the JAX package (it writes the reference the card's analysis is
held to, on the CPU); the import scan excludes it by name."""

import ast
import os
import re
import subprocess
import sys

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
REF = os.path.join(ROOT, "mythril_tpu")

#: the port's script that runs the JAX package (see the docstring)
EXCLUDED = {os.path.join("tools", "make_torch_reference.py")}

#: modules the port writes itself over a JAX package module of the same
#: path: the device half and the device discovery
PORT_OWN = {"__init__.py", "ops/bv256.py", "ops/intervals.py",
            "ops/propagate.py", "ops/stepper.py", "ops/symstep.py",
            "laser/lane_engine.py", "support/devices.py"}

#: copies edited where, as copied, they would hide the device:
#: {file: (the units whose source may differ, why)}. A unit is a
#: function, a method ("Class.name"), the module docstring ("<doc>") or
#: the rest of the module level ("<module>").
EDITED = {
    "laser/svm.py": (
        {"LaserEVM._lane_engine_sweep",
         "LaserEVM._screen_open_states_inner",
         "LaserEVM._prune_unreachable_states",
         "LaserEVM._execute_transactions"},
        "a lane engine that fails to import or to explore, an "
        "open-state screen that fails (at once or in the background) "
        "and a round-boundary merge whose device screen fails raise "
        "instead of returning the states to the host worklist or "
        "skipping the merge; no XLA variant warm-up"),
    "smt/solver/batch.py": (
        {"_propagate_prescreen"},
        "the propagation prescreen's device failure reaches the caller"),
    "support/model.py": (
        {"check_batch"},
        "the propagation prescreen's device failure reaches the caller"),
    "smt/solver/verdicts.py": (
        {"VerdictCache._device_ok", "VerdictCache.shadow_prepass"},
        "the shadow prepass's device call and its gate do not swallow "
        "errors"),
    "analysis/symbolic.py": (
        {"_device_exec_ok"},
        "a missing or broken card raises instead of keeping the host "
        "pruners"),
    "laser/merge.py": (
        {"_abstraction_memos"},
        "the opt-in propagation abstraction source does not swallow a "
        "device failure"),
    "native/__init__.py": (
        {"_build"},
        "the first build writes its own file and renames it into place: "
        "test workers that import the package together must never load "
        "a half-written library"),
    "models/pruner.py": (
        {"<doc>", "<module>", "_raws", "_device_threshold",
         "prefilter_world_states", "_screen_interval",
         "_device_prefilter", "_prefilter_device", "_device_should_try",
         "_device_failed", "_device_succeeded"},
        "a device screen that fails is counted and raised (no host "
        "fallback, no backoff); one batch threshold; a device argument"),
}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tools", "prof_torch_port.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    """Package-relative paths of every .py file of the port."""
    out = []
    for d, _, files in os.walk(PKG):
        out += [os.path.relpath(os.path.join(d, f), PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _copies():
    """The port's modules that have a JAX package original and are not
    the port's own."""
    return [rel for rel in _port_modules()
            if os.path.exists(os.path.join(REF, rel))
            and rel not in PORT_OWN]


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
            "support/screen_waves.py", "laser/svm.py",
            "interfaces/cli.py", "__main__.py", "support/runs.py",
            "support/lane_compare.py", "ops/stepper.py", "interop.py",
            "support/contracts.py"} <= names
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in EXCLUDED:
        assert os.path.exists(os.path.join(ROOT, rel))
        assert rel not in scanned


def _source(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("rel", [r for r in _copies() if r not in EDITED])
def test_verbatim_copies_equal_their_originals(rel):
    """Every host module the port copies (the term DAG, the solver, the
    interpreter, the detectors, the CLI ...) equals the JAX package's,
    modulo the package name."""
    mine = _source(PKG, rel).replace("mythril_tpu_torch", "mythril_tpu")
    assert mine == _source(REF, rel)


def _units(src):
    """{unit: source} of a module (see EDITED)."""
    tree = ast.parse(src)
    body = tree.body
    out = {}
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        out["<doc>"] = body[0].value.value
        body = body[1:]
    rest = []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.get_source_segment(src, node)
        elif isinstance(node, ast.ClassDef):
            other = []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = \
                        ast.get_source_segment(src, sub)
                else:
                    other.append(ast.get_source_segment(src, sub))
            out[f"{node.name}.<body>"] = "\n".join(other)
        else:
            rest.append(ast.get_source_segment(src, node))
    out["<module>"] = "\n".join(rest)
    return out


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copies_differ_only_in_the_named_functions(rel):
    allowed, why = EDITED[rel]
    assert why
    mine = _units(_source(PKG, rel).replace("mythril_tpu_torch",
                                            "mythril_tpu"))
    theirs = _units(_source(REF, rel))
    differ = {k for k in set(mine) | set(theirs)
              if mine.get(k) != theirs.get(k)}
    assert differ, f"{rel} is listed as edited but equals its original"
    assert differ <= allowed, f"{rel}: unlisted edits {differ - allowed}"


def test_every_copy_is_accounted_for():
    copies = set(_copies())
    assert set(EDITED) <= copies
    assert len(copies) > 150
    # what myth analyze loads and the port leaves out on purpose
    for rel in ("daemon/server.py", "parallel/mesh.py",
                "parallel/corpus.py", "parallel/migrate.py",
                "support/checkpoint.py", "concolic/__init__.py"):
        assert not os.path.exists(os.path.join(PKG, rel)), rel


@pytest.mark.parametrize("rel", ["native/Makefile", "native/sat.cpp",
                                 "native/keccak.cpp", "native/blaster.cpp",
                                 "support/assets/signatures.txt"])
def test_copied_sources_and_assets_equal_their_originals(rel):
    with open(os.path.join(PKG, rel), "rb") as f:
        mine = f.read()
    with open(os.path.join(REF, rel), "rb") as f:
        assert mine == f.read()


def test_every_module_imports_without_jax():
    """Import every module of the port in a fresh interpreter where
    ``jax`` cannot be imported."""
    mods = ["mythril_tpu_torch" + ("." + rel[:-3].replace(os.sep, ".")
                                   if rel != "__init__.py" else "")
            for rel in _port_modules()]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys, importlib\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'mythril_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mythril_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]


def test_copied_singleton_and_counters_match():
    from mythril_tpu.smt.solver.solver_statistics import SolverStatistics
    from mythril_tpu.support.support_utils import Singleton
    from mythril_tpu_torch.smt.solver import solver_statistics
    from mythril_tpu_torch.support import support_utils

    def body(cls):
        import inspect

        return inspect.getsource(cls).split('"""', 2)[2]

    assert body(support_utils.Singleton) == body(Singleton)
    mine = solver_statistics.SolverStatistics().batch_counters()
    theirs = SolverStatistics().batch_counters()
    assert set(mine) == set(theirs)
    assert {"propagate_kills", "propagate_sweeps", "facts_harvested",
            "static_facts_seeded", "lanes_merged"} <= set(mine)


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


def test_the_lane_kernel_constants_follow_the_port():
    """csrc/stepper.cu (K10): its plane list is ``LaneState``'s field
    order, its result classes and op-table columns are the Python
    side's, and its opcode and status constants are the opcode table's
    and ``Status``'s."""
    src = _source(PKG, "csrc", "stepper.cu")
    fields = re.search(r"#define LANE_FIELDS\(X\)(.*?)\n\n", src,
                       re.S).group(1)
    assert tuple(re.findall(r"X\(\w+, (\w+)\)", fields)) == \
        stepper.LANE_FIELDS
    enum = re.search(r"enum \{\s*(RC_ZERO.*?)\};", src, re.S).group(1)
    assert [x.strip()[3:] for x in enum.split(",") if x.strip()] == \
        stepper.RESULT_CLASSES
    cols = re.search(r"enum \{ (T_NPOP.*?) \};", src).group(1)
    assert [c.strip() for c in cols.split(",")] == [
        "T_NPOP", "T_NPUSH", "T_GAS", "T_SUP", "T_ENV", "T_RCLASS",
        "T_COLS"]
    assert stepper.LANE_OP_TABLE.shape == (256, 6)
    for name, val in re.findall(r"OP_(\w+) = (0x[0-9A-F]+)", src):
        assert stepper._OP[name] == int(val, 16), name
    for name, val in re.findall(r"\b([A-Z_]+) = (\d)\b", src):
        if hasattr(stepper.Status, name):
            assert getattr(stepper.Status, name) == int(val), name


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
