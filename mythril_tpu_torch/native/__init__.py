"""Native runtime: CDCL SAT core + keccak-256, built from C++ on first import.

This package is the build's native-substrate analog of the reference's
third-party native wheels (z3-solver C++ lib, eth-hash keccak backend —
reference requirements.txt:40, mythril/support/support_utils.py:94). The
shared library is compiled once with the system toolchain and bound via
ctypes (no pybind11 in this environment).
"""

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "_native.so")
_lock = threading.Lock()
_lib = None


def _build() -> None:
    # build into this process's own file and rename it into place:
    # processes that start the first build together (test workers
    # importing the package at once) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["make", "-s", f"TARGET={os.path.basename(tmp)}"], cwd=_HERE,
        capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, _LIB_PATH)


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library and bind signatures."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or _needs_rebuild():
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mtpu_keccak256.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        lib.mtpu_keccak256.restype = None
        lib.mtpu_sat_new.restype = ctypes.c_void_p
        lib.mtpu_sat_free.argtypes = [ctypes.c_void_p]
        lib.mtpu_sat_new_var.argtypes = [ctypes.c_void_p]
        lib.mtpu_sat_new_var.restype = ctypes.c_int32
        lib.mtpu_sat_add_clause.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.mtpu_sat_add_clause.restype = ctypes.c_int32
        lib.mtpu_sat_add_clauses.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.mtpu_sat_add_clauses.restype = ctypes.c_int32
        lib.mtpu_sat_solve.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.c_int64,
        ]
        lib.mtpu_sat_solve.restype = ctypes.c_int32
        lib.mtpu_sat_value.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.mtpu_sat_value.restype = ctypes.c_int32
        if hasattr(lib, "mtpu_sat_core"):
            lib.mtpu_sat_core.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.mtpu_sat_core.restype = ctypes.c_int32
        try:
            lib.mtpu_sat_assignment.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int32,
            ]
            lib.mtpu_sat_assignment.restype = ctypes.c_int32
            lib.mtpu_sat_values.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int8),
            ]
            lib.mtpu_sat_values.restype = None
        except AttributeError:
            pass  # stale library: per-literal value() still works
        lib.mtpu_sat_stats.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.mtpu_sat_stats.restype = ctypes.c_int64
        if hasattr(lib, "mtpu_sat_seed_phases"):
            lib.mtpu_sat_seed_phases.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int32,
            ]
            lib.mtpu_sat_seed_phases.restype = None
        # blaster bindings are optional: a stale library without them
        # must still serve SAT/keccak (make_blaster falls back to the
        # Python Blaster when the symbols are absent)
        try:
            lib.mtpu_blaster_new.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
            ]
            lib.mtpu_blaster_new.restype = ctypes.c_void_p
            lib.mtpu_blaster_free.argtypes = [ctypes.c_void_p]
            lib.mtpu_blaster_exec.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mtpu_blaster_exec.restype = ctypes.c_int32
            lib.mtpu_blaster_bool_lit.argtypes = [
                ctypes.c_void_p, ctypes.c_int32
            ]
            lib.mtpu_blaster_bool_lit.restype = ctypes.c_int32
            lib.mtpu_blaster_get_bits.argtypes = [
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            lib.mtpu_blaster_get_bits.restype = ctypes.c_int32
            lib.mtpu_blaster_ult.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mtpu_blaster_ult.restype = ctypes.c_int32
        except AttributeError:
            log.warning(
                "native library lacks blaster symbols; Python "
                "bit-blaster fallback in effect"
            )
        _lib = lib
        return _lib


def _needs_rebuild() -> bool:
    so_mtime = os.path.getmtime(_LIB_PATH)
    for src in ("sat.cpp", "keccak.cpp", "blaster.cpp"):
        if os.path.getmtime(os.path.join(_HERE, src)) > so_mtime:
            return True
    return False


def keccak256(data: bytes) -> bytes:
    """EVM keccak-256 of ``data``."""
    lib = get_lib()
    out = ctypes.create_string_buffer(32)
    lib.mtpu_keccak256(data, len(data), out)
    return out.raw


class SatSolver:
    """Thin OO wrapper over the native CDCL core.

    Literals are DIMACS-style signed ints over 1-based variables.

    Clauses are buffered host-side and shipped through one bulk FFI
    crossing at solve time: the bit-blaster emits hundreds of thousands
    of Tseitin clauses, and a per-clause ctypes call dominated solver
    wall-clock. Variable allocation is likewise a local counter — the
    native core extends its tables lazily on first use of a variable.
    """

    def __init__(self) -> None:
        import array as _array

        self._lib = get_lib()
        self._h = self._lib.mtpu_sat_new()
        self.nvars = 0
        self._buf = _array.array("i")
        self._latched_unsat = False

    def __del__(self) -> None:
        try:
            if self._h:
                self._lib.mtpu_sat_free(self._h)
                self._h = None
        except Exception:
            pass

    def new_var(self) -> int:
        # no FFI: the native core creates variables lazily when a clause
        # or assumption first mentions them
        self.nvars += 1
        return self.nvars

    def add_clause(self, lits) -> bool:
        for l in lits:
            v = abs(l)
            if v > self.nvars:
                self.nvars = v
        self._buf.extend(lits)
        self._buf.append(0)
        return True

    def emit_flat(self, lits_with_terminators) -> None:
        """Fast path for trusted emitters (the bit-blaster): append a
        pre-terminated clause stream whose variables all came from
        new_var() (so the nvars scan is unnecessary)."""
        self._buf.extend(lits_with_terminators)

    def flush(self) -> bool:
        """Ship buffered clauses to the native core in one FFI crossing.
        Returns False if the formula became trivially UNSAT."""
        if self._latched_unsat:
            return False
        n = len(self._buf)
        if n == 0:
            return True
        addr, _ = self._buf.buffer_info()
        r = self._lib.mtpu_sat_add_clauses(
            self._h, ctypes.cast(addr, ctypes.POINTER(ctypes.c_int32)), n
        )
        del self._buf[:]
        if r < 0:
            self._latched_unsat = True
            return False
        return True

    def solve(self, assumptions=(), timeout: float = 0.0, conflicts: int = 0):
        """Returns True (sat), False (unsat), or None (budget exhausted)."""
        if not self.flush():
            return False
        arr = (ctypes.c_int32 * len(assumptions))(*assumptions)
        r = self._lib.mtpu_sat_solve(
            self._h, arr, len(assumptions), timeout, conflicts
        )
        if r == 1:
            return True
        if r == 0:
            return False
        return None

    def value(self, var: int) -> bool:
        return self._lib.mtpu_sat_value(self._h, var) == 1

    def core(self):
        """Failed-assumption core of the last unsat solve: the subset
        of the assumption literals the clause set refutes (empty =
        refuted with no assumptions). [] on a stale library."""
        if not hasattr(self._lib, "mtpu_sat_core"):
            return []
        cap = 256
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.mtpu_sat_core(self._h, buf, cap)
            if n <= cap:
                return list(buf[:n])
            cap = n

    def assignment_snapshot(self):
        """The full current assignment as one int8 buffer (index 0 =
        var 1): one native memcpy-style call instead of one FFI crossing
        per model bit. None on a stale library without the symbol. The
        buffer is reused (grow-only) — callers must not hold it across
        solves."""
        if not hasattr(self._lib, "mtpu_sat_assignment"):
            return None
        n = max(int(self._lib.mtpu_sat_stats(self._h, 3)),
                self.nvars, 1)
        buf = getattr(self, "_snap_buf", None)
        if buf is None or len(buf) < n:
            buf = self._snap_buf = (ctypes.c_int8 * (n * 2))()
        self._lib.mtpu_sat_assignment(self._h, buf, len(buf))
        return buf

    def values_bulk(self, lits):
        """Signed-literal truth values in one native call (1/0/-1 per
        entry); None when the library predates the bulk symbol."""
        if not hasattr(self._lib, "mtpu_sat_values"):
            return None
        n = len(lits)
        arr = (ctypes.c_int32 * n)(*lits)
        out = (ctypes.c_int8 * n)()
        self._lib.mtpu_sat_values(self._h, arr, n, out)
        return out

    def seed_phases(self, var_vals) -> None:
        """Bias decision phases toward a known-good assignment:
        var_vals is an iterable of (DIMACS var, bool). No-op on a
        stale library without the symbol."""
        if not hasattr(self._lib, "mtpu_sat_seed_phases"):
            return
        pairs = list(var_vals)
        if not pairs:
            return
        n = len(pairs)
        vars_arr = (ctypes.c_int32 * n)(*[v for v, _ in pairs])
        vals_arr = (ctypes.c_int8 * n)(*[1 if b else 0
                                         for _, b in pairs])
        self._lib.mtpu_sat_seed_phases(self._h, vars_arr, vals_arr, n)

    def stats(self) -> dict:
        return {
            "conflicts": self._lib.mtpu_sat_stats(self._h, 0),
            "propagations": self._lib.mtpu_sat_stats(self._h, 1),
            "decisions": self._lib.mtpu_sat_stats(self._h, 2),
        }
