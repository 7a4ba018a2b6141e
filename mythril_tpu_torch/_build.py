"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which ``ctypes`` loads. The
build runs at first use, from the sources in this checkout only, into
``BUILD_DIR`` (listed in ``.gitignore``); a library is named after the
hash of its sources, so an edited source never binds a stale build.
All sources build at once, one ``nvcc`` each, in parallel.

Every C entry returns ``cudaGetLastError()`` after its launches;
``check`` raises when that is not 0. ``LAUNCHES`` counts the launches of
each kernel: a wrapper adds one where it launches its kernel and
nowhere else, so a run can show that it went through the kernels.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches per kernel (see module docstring); chip_smoke.py resets and
#: reads it around each path it drives. "bv256" counts only its test
#: launch ``bv256_apply``: K1 and K5-K7 inline ``csrc/bv256.cuh``.
#: "prop_tables" counts K8's three entries (init, exchange, verdicts).
LAUNCHES = {"bv256": 0, "sym_init": 0, "sym_step": 0,
            "window_prologue": 0, "window_dedup": 0, "window_epilogue": 0,
            "interval_level": 0, "prop_fwd_level": 0, "prop_back_round": 0,
            "prop_tables": 0, "merge_fingerprint": 0, "lane_run": 0,
            "prop_fixpoint": 0}

_LOCK = threading.Lock()
_LIBS = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name == src or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(src: str) -> str:
    stem = src[:-3]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(src)}.so")


def build_all() -> dict:
    """Compile every source that has no current build, all at once.
    Returns {source: seconds} for the sources built now. Raises with
    the compiler's output when one fails."""
    import time

    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in _sources():
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = out + f".{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                        os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT),
                      tmp, out)
    took = {}
    errors = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        with open(out[:-3] + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build_log(src: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build of ``src``."""
    path = _lib_path(src)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def lib(src: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``src`` (built first if needed), with each
    function of ``signatures`` ({name: [argtypes]}) given its argument
    types and an int result."""
    with _LOCK:
        if src not in _LIBS:
            path = _lib_path(src)
            if not os.path.exists(path):
                build_all()
            handle = ctypes.CDLL(path)
            for name, argtypes in signatures.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.mtt_error_string.argtypes = [ctypes.c_int]
            handle.mtt_error_string.restype = ctypes.c_char_p
            _LIBS[src] = handle
        return _LIBS[src]


def check(handle, rc: int, what: str) -> None:
    if rc != 0:
        msg = handle.mtt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (``void**``)."""
    arr = (ctypes.c_void_p * len(tensors))()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def int_array(values) -> ctypes.Array:
    arr = (ctypes.c_int * len(values))()
    for i, v in enumerate(values):
        arr[i] = int(v)
    return arr


def need_cuda(t: torch.Tensor, dtype, name: str) -> None:
    """Check a kernel argument the wrapper passes by pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
