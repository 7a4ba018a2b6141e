"""The 256-bit products of ``csrc/bv256.cuh`` against PTX carry chains,
timed in turns on one card.

    python3 tools/bv256_mul_forms.py

The forms: ``acc64``, the header's own (``bv::mul``, ``bv::mul_full``:
each 32x32->64 digit product added into a 64-bit accumulator; a square
as ``bv::mul(a, a)``), ``ptx``, PTX carry chains (``mad.lo.cc.u32`` /
``madc.hi.cc.u32``: a row's low halves in one chain, its high halves in
another), and ``sqr``, acc64 with the header's ``bv::sqr`` (20 digit
products) for a square. Each is built into one test kernel with nvcc
beside the header and run on ``chip_smoke.bv256_words``' 4096 seeded
words: mul, mul_hi and mulmod (the header's ``bv::divrem`` on each
form's full product), held bit for bit against the header's own ops
(``bv256_apply``), and 64 dependent low products, squares and full
products a word (each product's own latency; held against acc64's).
Timed acc64, ptx, sqr, sqr, ptx, acc64: the call on CUDA events and the
device time behind a spin kernel after an L2 flush
(``chip_smoke.queued_ms``), means of 10 each turn. Prints one JSON line
with the card's name and power limit, the times and each form's
registers.
"""

import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include "common.cuh"
#include "bv256.cuh"

using bv::NL;
using bv::W;

namespace {

// carry-chain steps: a * b (its low or high half) + c, taking the carry
// flag in (madc) and setting it (.cc)
#define MAD(name, op)                                                         \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t d;                                                               \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));    \
    return d;                                                                 \
  }
MAD(mad_lo_cc, "mad.lo.cc.u32")
MAD(madc_lo_cc, "madc.lo.cc.u32")
MAD(madc_lo, "madc.lo.u32")
MAD(mad_hi_cc, "mad.hi.cc.u32")
MAD(madc_hi_cc, "madc.hi.cc.u32")
MAD(madc_hi, "madc.hi.u32")
#undef MAD

// the carry flag as a value
__device__ __forceinline__ uint32_t carry() {
  uint32_t d;
  asm volatile("addc.u32 %0, %1, %1;" : "=r"(d) : "r"(0u));
  return d;
}

// the low word in carry chains: row i's low halves at i .. 7, its high
// halves at i + 1 .. 7
__device__ __forceinline__ W mul_ptx(const W& a, const W& b) {
  uint32_t r[NL] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int n = NL - i;
    if (n == 1) {
      r[7] += a.l[i] * b.l[0];
    } else {
      r[i] = mad_lo_cc(a.l[i], b.l[0], r[i]);
#pragma unroll
      for (int j = 1; j < n; ++j)
        r[i + j] = i + j == 7 ? madc_lo(a.l[i], b.l[j], r[i + j])
                              : madc_lo_cc(a.l[i], b.l[j], r[i + j]);
    }
    const int m = NL - 1 - i;
    if (m == 1) {
      r[7] += __umulhi(a.l[i], b.l[0]);
    } else if (m > 1) {
      r[i + 1] = mad_hi_cc(a.l[i], b.l[0], r[i + 1]);
#pragma unroll
      for (int j = 1; j < m; ++j)
        r[i + 1 + j] = i + 1 + j == 7 ? madc_hi(a.l[i], b.l[j], r[i + 1 + j])
                                      : madc_hi_cc(a.l[i], b.l[j], r[i + 1 + j]);
    }
  }
  W w;
#pragma unroll
  for (int i = 0; i < NL; ++i) w.l[i] = r[i];
  return w;
}

// both words in carry chains: a row a digit of a, its low halves in one
// chain (the carry into the row's top limb), its high halves in another
__device__ __forceinline__ void mul_full_ptx(const W& a, const W& b, W& lo, W& hi) {
  uint32_t r[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    r[i] = mad_lo_cc(a.l[i], b.l[0], r[i]);
#pragma unroll
    for (int j = 1; j < NL; ++j) r[i + j] = madc_lo_cc(a.l[i], b.l[j], r[i + j]);
    r[i + NL] = carry();
    r[i + 1] = mad_hi_cc(a.l[i], b.l[0], r[i + 1]);
#pragma unroll
    for (int j = 1; j < NL - 1; ++j) r[i + 1 + j] = madc_hi_cc(a.l[i], b.l[j], r[i + 1 + j]);
    r[i + NL] = madc_hi(a.l[i], b.l[NL - 1], r[i + NL]);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    lo.l[i] = r[i];
    hi.l[i] = r[i + NL];
  }
}

struct Acc64 {
  static __device__ __forceinline__ W mul(const W& a, const W& b) { return bv::mul(a, b); }
  static __device__ __forceinline__ W sqr(const W& a) { return bv::mul(a, a); }
  static __device__ __forceinline__ void full(const W& a, const W& b, W& lo, W& hi) {
    bv::mul_full(a, b, lo, hi);
  }
};
struct Ptx {
  static __device__ __forceinline__ W mul(const W& a, const W& b) { return mul_ptx(a, b); }
  static __device__ __forceinline__ W sqr(const W& a) { return mul_ptx(a, a); }
  static __device__ __forceinline__ void full(const W& a, const W& b, W& lo, W& hi) {
    mul_full_ptx(a, b, lo, hi);
  }
};
struct Sqr : Acc64 {
  static __device__ __forceinline__ W sqr(const W& a) { return bv::sqr(a); }
};

template <class F>
__global__ void forms_kernel(int op, const uint32_t* a, const uint32_t* b, const uint32_t* c,
                             uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const W x = bv::load(a + 8 * i), y = bv::load(b + 8 * i), z = bv::load(c + 8 * i);
  W r = x, lo, hi;
  if (op == 0) {
    r = F::mul(x, y);
  } else if (op == 1) {
    F::full(x, y, lo, r);
  } else if (op == 2) {
    W q;
    F::full(x, y, lo, hi);
    bv::divrem(lo, hi, z, q, r);
  } else if (op == 3) {
#pragma unroll 1
    for (int k = 0; k < 64; ++k) r = F::mul(r, y);
  } else if (op == 4) {
#pragma unroll 1
    for (int k = 0; k < 64; ++k) r = F::sqr(bv::bxor(r, y));
  } else {
#pragma unroll 1
    for (int k = 0; k < 64; ++k) {
      F::full(r, y, lo, hi);
      r = bv::bxor(lo, hi);
    }
  }
  bv::store(out + 8 * i, r);
}

}  // namespace

MTT_EXPORT int forms_apply(int form, int op, const void* a, const void* b, const void* c,
                           void* out, int n, void* stream) {
  const dim3 grid((n + 127) / 128), block(128);
  auto s = (cudaStream_t)stream;
  const auto* x = (const uint32_t*)a;
  const auto* y = (const uint32_t*)b;
  const auto* z = (const uint32_t*)c;
  if (form == 0)
    forms_kernel<Acc64><<<grid, block, 0, s>>>(op, x, y, z, (uint32_t*)out, n);
  else if (form == 1)
    forms_kernel<Ptx><<<grid, block, 0, s>>>(op, x, y, z, (uint32_t*)out, n);
  else
    forms_kernel<Sqr><<<grid, block, 0, s>>>(op, x, y, z, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
"""
#: the kernel's ops and the header op each is held against (None: the
#: forms against each other)
OPS = {"mul": "mul", "mul_hi": "mul_hi", "mulmod": "mulmod",
       "mul_chain": None, "sqr_chain": None, "mul_hi_chain": None}
FORMS = ("acc64", "ptx", "sqr")


def build():
    """The forms' library (built into the package's build directory,
    named by the hash of this source and the header) and its
    ``-Xptxas -v`` log."""
    sys.path.insert(0, ROOT)
    from mythril_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "bv256.cuh"), "rb") as f:
        digest = hashlib.sha256(SOURCE.encode() + f.read()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(_build.BUILD_DIR, f"libbv256_forms_{digest}")
    src = stem + ".cu"
    with open(src, "w") as f:
        f.write(SOURCE)
    proc = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS +
                          ["-I", _build.CSRC, "-o", stem + ".so", src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(stem + ".so")
    lib.forms_apply.argtypes = [ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.forms_apply.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("bv256_mul_forms: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mythril_tpu_torch import _build
    from mythril_tpu_torch.ops import bv256

    dev = torch.device("cuda", 0)
    lib, log = build()
    a, b, c = cs.bv256_words(dev)
    out = torch.empty_like(a)

    def run(form, op):
        rc = lib.forms_apply(form, list(OPS).index(op), _build.ptr(a),
                             _build.ptr(b), _build.ptr(c), _build.ptr(out),
                             a.shape[0], _build.stream(dev))
        if rc:
            raise RuntimeError(f"forms_apply({form}, {op}): CUDA error {rc}")
        return out

    for op, header_op in OPS.items():
        want = bv256.bv256_apply(header_op, a, b, c) if header_op \
            else run(0, op).clone()
        for form in range(len(FORMS)):
            got = run(form, op).clone()
            torch.cuda.synchronize()
            if cs.max_err(got, want):
                raise AssertionError(f"{FORMS[form]} {op} differs from "
                                     f"bv256_apply")
    times = {}
    for form in (0, 1, 2, 2, 1, 0):
        for op in OPS:
            key = f"{op} {FORMS[form]}"
            got = {"call_ms": cs.cuda_ms(lambda: run(form, op), reps=10),
                   "device_ms": cs.queued_ms(lambda _: run(form, op),
                                             lambda: None, reps=10)}
            times.setdefault(key, []).append(got)
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line or "stack frame" in line]
    print(json.dumps({"card": cs.smi(), "times": times, "ptxas": regs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
