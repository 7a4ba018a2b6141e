// 256-bit EVM word arithmetic as CUDA device functions.
//
// Replaces the bv256 ops that mythril_tpu/ops/bv256.py:93-539 inlines
// into the symbolic stepper (add/sub/neg, compares, bitwise, mul and
// mul_full, shl/shr/sar, byte, signextend, divmod_u, the 512-by-256
// reduction of addmod/mulmod, exp). A word is 8 little-endian uint32
// limbs, the layout of the lane-state planes. Results are identical to
// the JAX functions bit for bit; the algorithms may differ where the
// result is defined by the arithmetic alone (mul uses 32x32->64
// products where JAX multiplies 16-bit digits; exp stops after the top
// set exponent bit).
//
// Bound: these run inside one thread per lane; they are integer-ALU
// bound (a division is 256 shift-compare-subtract rounds on 8 limbs),
// and everything stays in registers.
#pragma once
#include <cstdint>

namespace bv {

constexpr int NL = 8;

struct W {
  uint32_t l[NL];
};

__device__ __forceinline__ W zero() {
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.l[i] = 0;
  return r;
}

__device__ __forceinline__ W from_u32(uint32_t x) {
  W r = zero();
  r.l[0] = x;
  return r;
}

__device__ __forceinline__ W load(const uint32_t* p) {
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.l[i] = p[i];
  return r;
}

__device__ __forceinline__ void store(uint32_t* p, const W& w) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i] = w.l[i];
}

__device__ __forceinline__ W add(const W& a, const W& b) {
  W r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t s = (uint64_t)a.l[i] + b.l[i] + c;
    r.l[i] = (uint32_t)s;
    c = s >> 32;
  }
  return r;
}

__device__ __forceinline__ W sub(const W& a, const W& b) {
  W r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t d = (uint64_t)a.l[i] - b.l[i] - borrow;
    r.l[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return r;
}

__device__ __forceinline__ W neg(const W& a) { return sub(zero(), a); }

__device__ __forceinline__ bool is_zero(const W& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= a.l[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const W& a, const W& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= a.l[i] ^ b.l[i];
  return acc == 0;
}

__device__ __forceinline__ bool ult(const W& a, const W& b) {
  for (int i = NL - 1; i >= 0; --i) {
    if (a.l[i] != b.l[i]) return a.l[i] < b.l[i];
  }
  return false;
}

__device__ __forceinline__ bool sign_bit(const W& a) {
  return (a.l[NL - 1] >> 31) != 0;
}

__device__ __forceinline__ bool slt(const W& a, const W& b) {
  bool sa = sign_bit(a), sb = sign_bit(b);
  return sa == sb ? ult(a, b) : (sa && !sb);
}

__device__ __forceinline__ W bool_word(bool m) { return from_u32(m ? 1u : 0u); }

__device__ __forceinline__ W band(const W& a, const W& b) {
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.l[i] = a.l[i] & b.l[i];
  return r;
}
__device__ __forceinline__ W bor(const W& a, const W& b) {
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.l[i] = a.l[i] | b.l[i];
  return r;
}
__device__ __forceinline__ W bxor(const W& a, const W& b) {
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.l[i] = a.l[i] ^ b.l[i];
  return r;
}
__device__ __forceinline__ W bnot(const W& a) {
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.l[i] = ~a.l[i];
  return r;
}

// full 512-bit product: lo and hi words
__device__ __forceinline__ void mul_full(const W& a, const W& b, W& lo, W& hi) {
  uint32_t r[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      uint64_t t = (uint64_t)a.l[i] * b.l[j] + r[i + j] + c;
      r[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    r[i + NL] = (uint32_t)c;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    lo.l[i] = r[i];
    hi.l[i] = r[i + NL];
  }
}

__device__ __forceinline__ W mul(const W& a, const W& b) {
  uint32_t r[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL - i; ++j) {
      uint64_t t = (uint64_t)a.l[i] * b.l[j] + r[i + j] + c;
      r[i + j] = (uint32_t)t;
      c = t >> 32;
    }
  }
  W w;
#pragma unroll
  for (int i = 0; i < NL; ++i) w.l[i] = r[i];
  return w;
}

// true where a shift-amount word is >= 256
__device__ __forceinline__ bool shift_oob(const W& s) {
  uint32_t rest = 0;
#pragma unroll
  for (int i = 1; i < NL; ++i) rest |= s.l[i];
  return s.l[0] >= 256u || rest != 0;
}

__device__ __forceinline__ W shl(const W& a, const W& shift) {
  if (shift_oob(shift)) return zero();
  uint32_t s = shift.l[0];
  int ls = (int)(s >> 5);
  uint32_t bs = s & 31u;
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int src = i - ls;
    uint32_t lo = src >= 0 ? a.l[src] : 0u;
    uint32_t lo2 = src - 1 >= 0 ? a.l[src - 1] : 0u;
    uint32_t hi_part = bs == 0 ? 0u : (lo2 >> (32u - bs));
    r.l[i] = (lo << bs) | hi_part;
  }
  return r;
}

__device__ __forceinline__ W shr(const W& a, const W& shift) {
  if (shift_oob(shift)) return zero();
  uint32_t s = shift.l[0];
  int ls = (int)(s >> 5);
  uint32_t bs = s & 31u;
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int src = i + ls;
    uint32_t lo = src < NL ? a.l[src] : 0u;
    uint32_t hi = src + 1 < NL ? a.l[src + 1] : 0u;
    uint32_t hi_part = bs == 0 ? 0u : (hi << (32u - bs));
    r.l[i] = (lo >> bs) | hi_part;
  }
  return r;
}

__device__ __forceinline__ W sar(const W& a, const W& shift) {
  W logical = shr(a, shift);
  if (!sign_bit(a)) return logical;
  W ones;
#pragma unroll
  for (int i = 0; i < NL; ++i) ones.l[i] = 0xFFFFFFFFu;
  return bor(logical, bnot(shr(ones, shift)));
}

__device__ __forceinline__ W byte_op(const W& pos, const W& x) {
  if (shift_oob(pos) || pos.l[0] >= 32u) return zero();
  int bi = 31 - (int)pos.l[0];
  return from_u32((x.l[bi >> 2] >> ((bi & 3) * 8)) & 0xFFu);
}

__device__ __forceinline__ W signextend(const W& k, const W& x) {
  if (shift_oob(k) || k.l[0] >= 31u) return x;
  int top = (int)k.l[0] * 8 + 7;
  int limb = top >> 5;
  uint32_t off = (uint32_t)(top & 31);
  uint32_t sign = (x.l[limb] >> off) & 1u;
  W r;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint32_t keep;
    if (i < limb) keep = 0xFFFFFFFFu;
    else if (i == limb) keep = off == 31u ? 0xFFFFFFFFu : ((1u << (off + 1u)) - 1u);
    else keep = 0u;
    r.l[i] = (x.l[i] & keep) | (sign ? ~keep : 0u);
  }
  return r;
}

__device__ __forceinline__ W shl_one(const W& a) {
  W r;
  r.l[0] = a.l[0] << 1;
#pragma unroll
  for (int i = 1; i < NL; ++i) r.l[i] = (a.l[i] << 1) | (a.l[i - 1] >> 31);
  return r;
}

// one restoring step: rem = (rem << 1 | bit) reduced by m; returns
// whether m was subtracted (the quotient bit)
__device__ __forceinline__ bool reduce_step(W& rem, const W& m, uint32_t bit) {
  bool carry257 = (rem.l[NL - 1] >> 31) != 0;
  rem = shl_one(rem);
  rem.l[0] |= bit;
  bool ge = carry257 || !ult(rem, m);
  if (ge) rem = sub(rem, m);
  return ge;
}

__device__ __forceinline__ void divmod_u(const W& a, const W& b, W& q, W& r) {
  q = zero();
  r = zero();
  if (is_zero(b)) return;
  for (int i = 0; i < 256; ++i) {
    int bi = 255 - i;
    uint32_t bit = (a.l[bi >> 5] >> (bi & 31)) & 1u;
    if (reduce_step(r, b, bit)) q.l[bi >> 5] |= 1u << (bi & 31);
  }
}

__device__ __forceinline__ W div(const W& a, const W& b) {
  W q, r;
  divmod_u(a, b, q, r);
  return q;
}

__device__ __forceinline__ W mod(const W& a, const W& b) {
  W q, r;
  divmod_u(a, b, q, r);
  return r;
}

__device__ __forceinline__ void sdivmod(const W& a, const W& b, W& sq, W& sr) {
  bool sa = sign_bit(a), sb = sign_bit(b);
  W q, r;
  divmod_u(sa ? neg(a) : a, sb ? neg(b) : b, q, r);
  sq = (sa != sb) ? neg(q) : q;
  sr = sa ? neg(r) : r;
}

// (hi * 2^256 + lo) mod m; 0 when m == 0
__device__ __forceinline__ W mod512(const W& lo, const W& hi, const W& m) {
  W rem = zero();
  if (is_zero(m)) return rem;
  for (int i = 0; i < 512; ++i) {
    int bi = 511 - i;
    const W& src = bi >= 256 ? hi : lo;
    int b = bi & 255;
    reduce_step(rem, m, (src.l[b >> 5] >> (b & 31)) & 1u);
  }
  return rem;
}

__device__ __forceinline__ W addmod(const W& a, const W& b, const W& m) {
  W s = add(a, b);
  return mod512(s, from_u32(ult(s, a) ? 1u : 0u), m);
}

__device__ __forceinline__ W mulmod(const W& a, const W& b, const W& m) {
  W lo, hi;
  mul_full(a, b, lo, hi);
  return mod512(lo, hi, m);
}

__device__ __forceinline__ W exp(const W& base, const W& e) {
  W result = from_u32(1u);
  W acc = base;
  int top = -1;
  for (int i = 255; i >= 0; --i) {
    if ((e.l[i >> 5] >> (i & 31)) & 1u) { top = i; break; }
  }
  for (int i = 0; i <= top; ++i) {
    if ((e.l[i >> 5] >> (i & 31)) & 1u) result = mul(result, acc);
    if (i < top) acc = mul(acc, acc);
  }
  return result;
}

}  // namespace bv
