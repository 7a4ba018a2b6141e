// bv256_apply: one bv256 op over N words, one thread per word.
//
// The test launch of the device functions in bv256.cuh (which replace
// the inlined mythril_tpu/ops/bv256.py:93-539): chip_smoke.py calls it
// on seeded random and edge operands and holds each op against the
// plain PyTorch version, ops/bv256.bv256_plain. Op codes follow
// ops/bv256.OPS. Bound: integer operations (the division ops run 256
// or 512 restoring rounds per word); the bytes moved are 4 words/lane.
#include "common.cuh"
#include "bv256.cuh"

using bv::W;

__global__ void bv256_kernel(int op, const uint32_t* a, const uint32_t* b,
                             const uint32_t* c, uint32_t* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  W x = bv::load(a + 8 * i), y = bv::load(b + 8 * i), z = bv::load(c + 8 * i);
  W r, t;
  switch (op) {
    case 0: r = bv::add(x, y); break;
    case 1: r = bv::sub(x, y); break;
    case 2: r = bv::neg(x); break;
    case 3: r = bv::mul(x, y); break;
    case 4: bv::mul_full(x, y, t, r); break;
    case 5: r = bv::div(x, y); break;
    case 6: r = bv::mod(x, y); break;
    case 7: bv::sdivmod(x, y, r, t); break;
    case 8: bv::sdivmod(x, y, t, r); break;
    case 9: r = bv::addmod(x, y, z); break;
    case 10: r = bv::mulmod(x, y, z); break;
    case 11: r = bv::exp(x, y); break;
    case 12: r = bv::shl(x, y); break;
    case 13: r = bv::shr(x, y); break;
    case 14: r = bv::sar(x, y); break;
    case 15: r = bv::byte_op(x, y); break;
    case 16: r = bv::signextend(x, y); break;
    case 17: r = bv::bool_word(bv::ult(x, y)); break;
    case 18: r = bv::bool_word(bv::ult(y, x)); break;
    case 19: r = bv::bool_word(bv::slt(x, y)); break;
    case 20: r = bv::bool_word(bv::slt(y, x)); break;
    case 21: r = bv::bool_word(bv::eq(x, y)); break;
    case 22: r = bv::bool_word(bv::is_zero(x)); break;
    case 23: r = bv::band(x, y); break;
    case 24: r = bv::bor(x, y); break;
    case 25: r = bv::bxor(x, y); break;
    case 26: r = bv::bnot(x); break;
    default: r = bv::zero(); break;
  }
  bv::store(out + 8 * i, r);
}

MTT_EXPORT int bv256_apply(int op, const void* a, const void* b, const void* c,
                           void* out, int n, void* stream) {
  if (n > 0) {
    bv256_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        op, (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
        (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
