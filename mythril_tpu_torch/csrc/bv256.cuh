// 256-bit EVM word arithmetic as CUDA device functions.
//
// Replaces the bv256 ops that mythril_tpu/ops/bv256.py:93-539 inlines
// into the symbolic stepper: add/sub/neg, the compares, the bitwise ops,
// mul and mul_full (a 16-bit digit schoolbook there), shl/shr/sar, byte,
// signextend, divmod_u with sdiv/smod, the 512-by-256 reduction of
// addmod/mulmod (restoring shift-subtract rounds under lax.fori_loop
// there: 256 or 512 of them) and exp. A word is 8 little-endian uint32
// limbs, the layout of the lane-state planes. Every result equals the
// JAX function's bit for bit; the algorithms differ wherever the
// arithmetic alone defines the result.
//
// Each op's algorithm, fast paths first:
// - add, sub, neg, the compares and the bitwise ops: one pass over the
//   limbs; ult stops at the top limb that differs (a select chain over
//   all eight, with no branch, made K5's compare class 1.5x slower).
// - mul (the low word): schoolbook on 32-bit digits, 36 products, each
//   32x32->64 product added into a 64-bit accumulator; sqr: the low
//   word of a square in 20 (the cross products once, doubled);
//   mul_full (both words): the same schoolbook, 64 products. PTX carry
//   chains (mad.lo.cc / madc.hi.cc) were no faster on the card's users
//   of these products (tools/bv256_mul_forms.py times both forms).
// - shl, shr, sar: the whole-limb part of the shift in three select
//   stages (by 4, 2 and 1 limbs, on the bits of shift >> 5), the bit
//   part a funnel shift a limb; sar shifts its sign in. byte and
//   signextend pick their limb by a select chain.
// - div, mod, sdiv, smod, addmod, mulmod: bv::divide on one core,
//   divrem, which divides a 512-bit dividend (0 above the low word but
//   for addmod's carry and mulmod's product) by a word. In order: a zero
//   divisor gives (0, 0); a dividend below the divisor (0, a); a divisor
//   2^k a shift and a mask (solc's selector DIV by 2^224, storage
//   unpacking by 0x100**k); a divisor of one limb short division over the
//   dividend's digits, each digit one 2-by-1 step (Moller and Granlund,
//   "Improved division by invariant integers", 2011) with the
//   reciprocal of the normalised divisor: two products and no divide.
//   Otherwise Knuth's algorithm D (TAOCP 4.3.1) on 32-bit digits: the
//   divisor shifted up to the top of its word (so every digit the loop
//   reads sits at a fixed place), the dividend by as much; each
//   quotient digit estimated from the top two remainder digits by the
//   same 2-by-1 step, at most two corrections with the third digit, a
//   multiply and subtract over 8 digits, an add-back where it went
//   negative (rare). At most 7 quotient digits for a 256-bit dividend
//   and 15 for a 512-bit one (two limbs of divisor or more).
// - exp: 1 for an exponent of 0, the base for a base of 0 or 1; a base
//   2^k gives 1 << k*e, or 0 once k*e >= 256 (e any word); otherwise
//   square and multiply over the exponent's bits, low bit first, on the
//   low-half product and sqr (up to 255 squarings).
//
// What bounds them on this card: each runs inside one thread of its
// kernel, so an op is a chain of dependent integer operations (a
// division ~100 a quotient digit where the restoring loop took ~40 a
// bit; an exp ~100 a product), and lanes of one warp that take
// different paths (a fast path against algorithm D, other digit counts,
// other exponent lengths) run one after the other. No limb is ever
// indexed by a value known only at run time: the card keeps a register
// array indexed so in local memory (a stack frame, with loads and
// stores), so a runtime position is a select chain or a staged shift,
// and a loop over digits moves a register array by static indices.
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

// a * a, the low word: the 16 cross products below 2^256 once, doubled,
// plus the 4 squares on the diagonal (20 digit products where mul
// takes 36)
__device__ __forceinline__ W sqr(const W& a) {
  uint32_t r[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL / 2; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NL - i; ++j) {
      uint64_t t = (uint64_t)a.l[i] * a.l[j] + r[i + j] + c;
      r[i + j] = (uint32_t)t;
      c = t >> 32;
    }
  }
#pragma unroll
  for (int i = NL - 1; i > 0; --i) r[i] = __funnelshift_l(r[i - 1], r[i], 1u);
  r[0] <<= 1;
  W w;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL / 2; ++i) {
    const uint64_t d = (uint64_t)a.l[i] * a.l[i];
    c += (uint64_t)r[2 * i] + (uint32_t)d;
    w.l[2 * i] = (uint32_t)c;
    c = (c >> 32) + r[2 * i + 1] + (d >> 32);
    w.l[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  return w;
}

// ---- runtime positions without runtime indices

// limb i of w for a runtime i, 0 past the word: a select chain
__device__ __forceinline__ uint32_t limb_at(const W& w, uint32_t i) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) r = i == (uint32_t)j ? w.l[j] : r;
  return r;
}

// w shifted up by n < 256 bits: limbs in three select stages, then a
// funnel shift a limb
__device__ __forceinline__ W shl_n(W w, uint32_t n) {
#pragma unroll
  for (int st = 4; st >= 1; st >>= 1) {
    const bool on = ((n >> 5) & (uint32_t)st) != 0;
#pragma unroll
    for (int i = NL - 1; i >= 0; --i) w.l[i] = on ? (i >= st ? w.l[i - st] : 0u) : w.l[i];
  }
  W r;
  r.l[0] = w.l[0] << (n & 31u);
#pragma unroll
  for (int i = 1; i < NL; ++i) r.l[i] = __funnelshift_l(w.l[i - 1], w.l[i], n);
  return r;
}

// w shifted down by n < 256 bits, `fill` (0 or all ones) shifted in
__device__ __forceinline__ W shr_n(W w, uint32_t n, uint32_t fill) {
#pragma unroll
  for (int st = 4; st >= 1; st >>= 1) {
    const bool on = ((n >> 5) & (uint32_t)st) != 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) w.l[i] = on ? (i + st < NL ? w.l[i + st] : fill) : w.l[i];
  }
  W r;
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) r.l[i] = __funnelshift_r(w.l[i], w.l[i + 1], n);
  r.l[NL - 1] = __funnelshift_r(w.l[NL - 1], fill, n);
  return r;
}

// true where a shift-amount word is >= 256
__device__ __forceinline__ bool shift_oob(const W& s) {
  uint32_t rest = 0;
#pragma unroll
  for (int i = 1; i < NL; ++i) rest |= s.l[i];
  return s.l[0] >= 256u || rest != 0;
}

__device__ __forceinline__ W shl(const W& a, const W& shift) {
  return shift_oob(shift) ? zero() : shl_n(a, shift.l[0]);
}

__device__ __forceinline__ W shr(const W& a, const W& shift) {
  return shift_oob(shift) ? zero() : shr_n(a, shift.l[0], 0u);
}

__device__ __forceinline__ W sar(const W& a, const W& shift) {
  const uint32_t fill = sign_bit(a) ? 0xFFFFFFFFu : 0u;
  if (shift_oob(shift)) {
    W r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.l[i] = fill;
    return r;
  }
  return shr_n(a, shift.l[0], fill);
}

__device__ __forceinline__ W byte_op(const W& pos, const W& x) {
  if (shift_oob(pos) || pos.l[0] >= 32u) return zero();
  const uint32_t bi = 31u - pos.l[0];
  return from_u32((limb_at(x, bi >> 2) >> ((bi & 3u) * 8u)) & 0xFFu);
}

__device__ __forceinline__ W signextend(const W& k, const W& x) {
  if (shift_oob(k) || k.l[0] >= 31u) return x;
  const int top = (int)k.l[0] * 8 + 7;
  const int limb = top >> 5;
  const uint32_t off = (uint32_t)(top & 31);
  const uint32_t sign = (limb_at(x, (uint32_t)limb) >> off) & 1u;
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

// ---- division

// floor((2^64 - 1) / d) - 2^32 for d >= 2^31, the reciprocal of the
// 2-by-1 step: 2^64 / d in double (relative error 2^-53, so within one
// of it), then one remainder test makes it exact
__device__ __forceinline__ uint32_t reciprocal(uint32_t d) {
  uint64_t t = (uint64_t)(__drcp_rn((double)d) * 18446744073709551616.0);
  const uint64_t rem = ~(t * (uint64_t)d);  // 2^64 - 1 - t*d, mod 2^64
  t = (int64_t)rem < 0 ? t - 1u : (rem >= d ? t + 1u : t);
  return (uint32_t)t;
}

// (u1 * 2^32 + u0) / d for u1 < d, d >= 2^31, v = reciprocal(d): the
// quotient, the remainder into r
__device__ __forceinline__ uint32_t div2by1(uint32_t u1, uint32_t u0, uint32_t d,
                                            uint32_t v, uint32_t& r) {
  const uint64_t p = (uint64_t)v * u1 + (((uint64_t)u1 << 32) | u0);
  uint32_t q = (uint32_t)(p >> 32) + 1u;
  uint32_t rr = u0 - q * d;
  if (rr > (uint32_t)p) {
    q -= 1u;
    rr += d;
  }
  if (rr >= d) {
    q += 1u;
    rr -= d;
  }
  r = rr;
  return q;
}

// q, r of the 512-bit (hi, lo) by d; q is the quotient's low word (the
// whole quotient where hi is 0). d == 0 gives q = r = 0.
__device__ __forceinline__ void divrem(const W& lo, const W& hi, const W& d, W& q, W& r) {
  q = zero();
  r = zero();
  if (is_zero(d)) return;
  const bool wide = !is_zero(hi);
  if (!wide && ult(lo, d)) {
    r = lo;
    return;
  }
  // L: zero limbs above the divisor's top limb
  uint32_t L = 0, pop = 0;
  bool z = true;
#pragma unroll
  for (int i = NL - 1; i > 0; --i) {
    z = z && d.l[i] == 0u;
    L += z ? 1u : 0u;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) pop += __popc(d.l[i]);
  const uint32_t top = limb_at(d, NL - 1 - L);
  const uint32_t s = __clz(top);
  if (pop == 1u) {  // d = 2^k
    q = shr_n(lo, 32u * (NL - 1 - L) + 31u - s, 0u);
    r = band(lo, sub(d, from_u32(1u)));
    return;
  }
  // the dividend, 16 digits with a 256-bit one in the low eight,
  // shifted up by s bits into 17
  uint32_t u[2 * NL + 1];
  {
    uint32_t x[2 * NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      x[i] = lo.l[i];
      x[NL + i] = wide ? hi.l[i] : 0u;
    }
    u[0] = x[0] << s;
#pragma unroll
    for (int i = 1; i < 2 * NL; ++i) u[i] = __funnelshift_l(x[i - 1], x[i], s);
    u[2 * NL] = __funnelshift_l(x[2 * NL - 1], 0u, s);
  }
  if (L == NL - 1) {
    // short division: a digit a step from the top, the remainder in
    // one register (below the normalised divisor from the start)
    const uint32_t dn = top << s, v = reciprocal(dn);
    uint32_t rem = wide ? u[2 * NL] : u[NL];
#pragma unroll
    for (int t = 0; t < 2 * NL; ++t) {
      if (t < NL && !wide) continue;
      const uint32_t qd = div2by1(rem, u[2 * NL - 1 - t], dn, v, rem);
      if (t >= NL) q.l[2 * NL - 1 - t] = qd;
    }
    r = from_u32(rem >> s);
    return;
  }
  // algorithm D: the divisor shifted up to the top of its word, the
  // remainder's window the top 9 digits of u, u shifted up a digit a
  // step (Knuth's u_j .. u_{j+n} at fixed places)
  const uint32_t sh = 32u * L + s;
  const W dv = shl_n(d, sh);
  const uint32_t d7 = dv.l[NL - 1], d6 = dv.l[NL - 2], v = reciprocal(d7);
  if (!wide) {
#pragma unroll
    for (int i = 2 * NL; i >= 0; --i) u[i] = i >= NL ? u[i - NL] : 0u;
  }
  const int steps = (wide ? NL + 1 : 1) + (int)L;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    if (t) {
#pragma unroll
      for (int i = 2 * NL; i > 0; --i) u[i] = u[i - 1];
      u[0] = 0u;
    }
    // the quotient digit from the window's top two digits, then at
    // most two corrections with its third
    uint32_t qh, rh;
    bool big;
    if (u[2 * NL] < d7) {
      qh = div2by1(u[2 * NL], u[2 * NL - 1], d7, v, rh);
      big = false;
    } else {
      qh = 0xFFFFFFFFu;
      rh = u[2 * NL - 1] + d7;
      big = rh < d7;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!big && (uint64_t)qh * d6 > (((uint64_t)rh << 32) | u[2 * NL - 2])) {
        qh -= 1u;
        rh += d7;
        big = rh < d7;
      }
    }
    if (qh) {
      // window -= qh * dv, then add dv back where that went negative
      int64_t k = 0, t2;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const uint64_t p = (uint64_t)qh * dv.l[i];
        t2 = (int64_t)u[NL + i] - k - (int64_t)(p & 0xFFFFFFFFu);
        u[NL + i] = (uint32_t)t2;
        k = (int64_t)(p >> 32) - (t2 >> 32);
      }
      t2 = (int64_t)u[2 * NL] - k;
      u[2 * NL] = (uint32_t)t2;
      if (t2 < 0) {
        qh -= 1u;
        uint64_t c = 0;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          c = (uint64_t)u[NL + i] + dv.l[i] + (c >> 32);
          u[NL + i] = (uint32_t)c;
        }
        u[2 * NL] = 0u;
      }
    }
#pragma unroll
    for (int i = NL - 1; i > 0; --i) q.l[i] = q.l[i - 1];
    q.l[0] = qh;
  }
  W rw;
#pragma unroll
  for (int i = 0; i < NL; ++i) rw.l[i] = u[NL + i];
  r = shr_n(rw, sh, 0u);
}

// the division family in its opcode order (DIV 0x04 .. MULMOD 0x09), on
// one divrem: a kernel that routes all six through one call inlines the
// core once
enum { DIV = 0, SDIV, MOD, SMOD, ADDMOD, MULMOD };

__device__ __forceinline__ W divide(int kind, const W& a, const W& b, const W& c) {
  const bool sgn = kind == SDIV || kind == SMOD;
  const bool sa = sgn && sign_bit(a), sb = sgn && sign_bit(b);
  W lo = sa ? neg(a) : a, hi = zero(), d = sb ? neg(b) : b;
  if (kind == ADDMOD) {
    lo = add(a, b);
    hi = from_u32(ult(lo, a) ? 1u : 0u);
    d = c;
  } else if (kind == MULMOD) {
    mul_full(a, b, lo, hi);
    d = c;
  }
  W q, r;
  divrem(lo, hi, d, q, r);
  if (kind == DIV) return q;
  if (kind == SDIV) return sa != sb ? neg(q) : q;
  if (kind == SMOD) return sa ? neg(r) : r;
  return r;
}

__device__ __forceinline__ W div(const W& a, const W& b) { return divide(DIV, a, b, b); }

// ---- exp

__device__ __forceinline__ W exp(const W& base, const W& e) {
  const W one = from_u32(1u);
  if (is_zero(e)) return one;
  uint32_t pop = 0, k = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    pop += __popc(base.l[i]);
    k += base.l[i] ? 32u * i + 31u - __clz(base.l[i]) : 0u;
  }
  if (pop == 0u) return base;
  if (pop == 1u) {  // (2^k)^e = 2^(k*e); k*e >= e >= 256 for k >= 1
    if (k == 0u) return one;
    if (shift_oob(e)) return zero();
    const uint32_t ke = k * e.l[0];
    return ke >= 256u ? zero() : shl_n(one, ke);
  }
  // square and multiply, the exponent's low limb first: ex moves down a
  // limb at a time by static indices
  W result = one, acc = base, ex = e;
#pragma unroll 1
  while (true) {
    uint32_t bits = ex.l[0];
#pragma unroll
    for (int i = 0; i < NL - 1; ++i) ex.l[i] = ex.l[i + 1];
    ex.l[NL - 1] = 0u;
    const bool last = is_zero(ex);
    const int nb = last ? 32 - __clz(bits) : 32;
#pragma unroll 1
    for (int j = 0; j < nb; ++j) {
      if (bits & 1u) result = mul(result, acc);
      bits >>= 1;
      if (!last || j + 1 < nb) acc = sqr(acc);
    }
    if (last) return result;
  }
}

}  // namespace bv
