// K5-K8: the solver's device feasibility screens.
//
// Replace the jitted programs of mythril_tpu/ops/intervals.py and
// mythril_tpu/ops/propagate.py:
//
//   K5 interval_level   intervals.py:611 _eval_level (_transfer_level
//                       :403, _smear :394): one forward interval level,
//                       overwriting its nodes' rows.
//   K6 prop_fwd_level   propagate.py:340 _fwd_level: the same interval
//                       transfer plus the known-bits transfer, MET with
//                       the node's current row.
//   K7 prop_back_round  propagate.py:463 _back_round: one backward round
//                       of inverse transfer functions, MET into targets.
//   K8 prop_init        propagate.py:699 _init_tables
//      prop_exchange    propagate.py:327 _exchange_all
//      prop_verdicts    propagate.py:720 _verdicts
//   K11 prop_fixpoint   propagate.py:798 _fixpoint: the whole fixpoint
//                       (init, sweeps to a fixpoint or the cap,
//                       verdicts) in one launch, built from the device
//                       functions of K6-K8 (see its own note below).
//
// Tables are (S, T, 8) uint32 limb words per state and node row (lo,
// hi, and for the product domain k0, k1); levels and rounds are the
// host plan's arrays (ops/intervals.linearize, ops/propagate.build_plan).
// Every function is bit for bit the JAX one; each opcode's transfer is a
// switch case computing only what that node needs (the JAX kernels
// compute every op of the level's cover and select by opcode, which
// gives the same row).
//
// Bound: bytes. A level moves, per (state, node), its argument rows and
// its own row (32 B each per table); a table-wide pass reads and writes
// every row. Rows are 32-byte aligned and loaded as two 16-byte vectors.
// The transfer arithmetic (a few dozen 8-limb ops; 512-bit MUL and
// 256-round division where a node needs them) stays in registers.
//
// The "changed" flag: the JAX driver compares a sweep's start tables
// with its end tables. Refinement is monotone (max-lo, min-hi, bit
// unions and bool intersections), so a stored word that differs from
// the current one never returns to its start value: K6, K7 and
// prop_exchange set *changed when they store a differing word, and the
// host reads that one int per sweep instead of comparing the tables.
#include "common.cuh"
#include "bv256.cuh"

using bv::W;

namespace scr {

enum {
  NOP = 0, ADD, SUB, MUL, UDIV, UREM, BAND, BOR, BXOR, BNOT, NEG, SHL, LSHR,
  COPY, SEXT, EXTRACT, CONCAT2, ITE, EQ, ULT, ULE, BAND2, BOR2, BNOT1,
  BXOR2, BITE
};

__device__ __forceinline__ W ldw(const uint32_t* p) {
  uint4 a = reinterpret_cast<const uint4*>(p)[0];
  uint4 b = reinterpret_cast<const uint4*>(p)[1];
  W w;
  w.l[0] = a.x; w.l[1] = a.y; w.l[2] = a.z; w.l[3] = a.w;
  w.l[4] = b.x; w.l[5] = b.y; w.l[6] = b.z; w.l[7] = b.w;
  return w;
}

__device__ __forceinline__ void stw(uint32_t* p, const W& w) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(w.l[0], w.l[1], w.l[2], w.l[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(w.l[4], w.l[5], w.l[6], w.l[7]);
}

__device__ __forceinline__ bool ugt(const W& a, const W& b) { return bv::ult(b, a); }
__device__ __forceinline__ W pick(bool c, const W& a, const W& b) { return c ? a : b; }
__device__ __forceinline__ W max_n(const W& a, const W& b) { return bv::ult(a, b) ? b : a; }
__device__ __forceinline__ W min_n(const W& a, const W& b) { return bv::ult(b, a) ? b : a; }

__device__ __forceinline__ W ones() {
  W r;
#pragma unroll
  for (int i = 0; i < bv::NL; ++i) r.l[i] = 0xFFFFFFFFu;
  return r;
}

// all bits at/below the most significant set bit (_smear)
__device__ __forceinline__ W smear(W x) {
  for (uint32_t s = 1; s <= 128; s <<= 1) x = bv::bor(x, bv::shr(x, bv::from_u32(s)));
  return x;
}

__device__ __forceinline__ W bool_abs(bool b) { return bv::from_u32(b ? 1u : 0u); }

// The interval transfer of one node (_transfer_level for one row).
// c is the third argument's rows, read only by ITE and BITE. Returns
// false for NOP and any unknown opcode: the row keeps its value.
__device__ bool transfer(int op, const W& alo, const W& ahi, const W& blo,
                         const W& bhi, const W& clo, const W& chi, const W& mask,
                         const W& aux, int arg1, int arg2, W& lo, W& hi) {
  const W z = bv::zero();
  switch (op) {
    case ADD: {
      W sl = bv::add(alo, blo), sh = bv::add(ahi, bhi);
      bool ok = !(bv::ult(sh, ahi) || ugt(sh, mask));
      lo = pick(ok, sl, z);
      hi = pick(ok, sh, mask);
      return true;
    }
    case SUB: {
      bool ok = !bv::ult(alo, bhi);
      lo = pick(ok, bv::sub(alo, bhi), z);
      hi = pick(ok, bv::sub(ahi, blo), mask);
      return true;
    }
    case MUL: {
      W plo, phi;
      bv::mul_full(ahi, bhi, plo, phi);
      bool ok = bv::is_zero(phi) && !ugt(plo, mask);
      lo = ok ? bv::mul(alo, blo) : z;
      hi = pick(ok, plo, mask);
      return true;
    }
    case UDIV:
      if (!bv::is_zero(blo)) {
        lo = bv::div(alo, bhi);
        hi = bv::div(ahi, blo);
      } else {
        lo = z;
        hi = mask;
      }
      return true;
    case UREM: {
      // divisor may be 0 -> x % 0 = x (pass the dividend interval)
      bool dz = bv::is_zero(bhi);
      lo = pick(dz, alo, z);
      hi = dz ? ahi : (!bv::is_zero(blo) ? bv::sub(bhi, bv::from_u32(1u)) : mask);
      return true;
    }
    case BAND:
      lo = z;
      hi = pick(bv::ult(ahi, bhi), ahi, bhi);
      return true;
    case BOR:
    case BXOR: {
      W os = bv::bor(smear(ahi), smear(bhi));
      hi = pick(bv::ult(os, mask), os, mask);
      lo = op == BOR ? pick(bv::ult(alo, blo), blo, alo) : z;
      return true;
    }
    case BNOT:
      lo = bv::sub(mask, ahi);
      hi = bv::sub(mask, alo);
      return true;
    case NEG: {
      // (-x) mod 2^w for 0 < x <= 2^w
      W exact = bv::band(bv::neg(alo), mask);
      bool a_const = bv::eq(alo, ahi), a_pos = !bv::is_zero(alo);
      lo = a_const ? exact : (a_pos ? bv::band(bv::neg(ahi), mask) : z);
      hi = a_const ? exact : (a_pos ? exact : mask);
      return true;
    }
    case SHL: {
      // constant in-range shift without overflow
      W sht = bv::shl(ahi, bhi);
      bool ok = bv::eq(blo, bhi) && bv::eq(bv::shr(sht, bhi), ahi) && !ugt(sht, mask);
      lo = ok ? bv::shl(alo, blo) : z;
      hi = pick(ok, sht, mask);
      return true;
    }
    case LSHR:
      lo = bv::shr(alo, bhi);
      hi = bv::shr(ahi, blo);
      return true;
    case COPY:
      lo = alo;
      hi = ahi;
      return true;
    case SEXT: {
      // provably non-negative input passes through
      bool ok = bv::ult(ahi, aux);
      lo = pick(ok, alo, z);
      hi = pick(ok, ahi, mask);
      return true;
    }
    case EXTRACT: {
      // arg1 = lo bit, arg2 = hi bit (immediates), aux = field mask
      W lob = bv::from_u32((uint32_t)arg1), hib1 = bv::from_u32((uint32_t)(arg2 + 1));
      bool same_high = bv::eq(bv::shr(alo, hib1), bv::shr(ahi, hib1));
      W slo = bv::shr(alo, lob), shi = bv::shr(ahi, lob);
      bool diff_ok = !ugt(bv::sub(shi, slo), aux);
      W slm = bv::band(slo, aux), shm = bv::band(shi, aux);
      bool ok = same_high && diff_ok && !ugt(slm, shm);
      lo = pick(ok, slm, z);
      hi = pick(ok, shm, mask);
      return true;
    }
    case CONCAT2: {
      W bw = bv::from_u32(aux.l[0]);
      lo = bv::bor(bv::shl(alo, bw), blo);
      hi = bv::bor(bv::shl(ahi, bw), bhi);
      return true;
    }
    case ITE: {
      // the condition's bool abstraction rides in limb 0 of arg 0
      bool mf = alo.l[0] != 0, mt = ahi.l[0] != 0;
      lo = !mf ? blo : (!mt ? clo : pick(bv::ult(blo, clo), blo, clo));
      hi = !mf ? bhi : (!mt ? chi : pick(ugt(bhi, chi), bhi, chi));
      return true;
    }
    case EQ: {
      bool disjoint = bv::ult(ahi, blo) || bv::ult(bhi, alo);
      bool all_const = bv::eq(alo, ahi) && bv::eq(blo, bhi) && bv::eq(alo, blo);
      lo = bool_abs(!all_const);
      hi = bool_abs(!disjoint);
      return true;
    }
    case ULT:
      lo = bool_abs(!bv::ult(ahi, blo));
      hi = bool_abs(bv::ult(alo, bhi));
      return true;
    case ULE:
      lo = bool_abs(ugt(ahi, blo));
      hi = bool_abs(!ugt(alo, bhi));
      return true;
    case BAND2:
    case BOR2:
    case BNOT1:
    case BXOR2:
    case BITE: {
      bool amf = alo.l[0] != 0, amt = ahi.l[0] != 0;
      bool bmf = blo.l[0] != 0, bmt = bhi.l[0] != 0;
      bool mf, mt;
      if (op == BAND2) {
        mf = amf || bmf;
        mt = amt && bmt;
      } else if (op == BOR2) {
        mf = amf && bmf;
        mt = amt || bmt;
      } else if (op == BNOT1) {
        mf = amt;
        mt = amf;
      } else if (op == BXOR2) {
        mf = (amt && bmt) || (amf && bmf);
        mt = (amt && bmf) || (amf && bmt);
      } else {
        bool cmf = clo.l[0] != 0, cmt = chi.l[0] != 0;
        mf = (amt && bmf) || (amf && cmf);
        mt = (amt && bmt) || (amf && cmt);
      }
      lo = bool_abs(mf);
      hi = bool_abs(mt);
      return true;
    }
    default:
      return false;
  }
}

// The known-bits half of _fwd_level for one node: (nk0, nk1), zero for
// opcodes without a known-bits transfer.
__device__ void kbits(int op, const W& alo, const W& ahi, const W& blo, const W& bhi,
                      const W& ak0, const W& ak1, const W& bk0, const W& bk1,
                      const W& ck0, const W& ck1, const W& mask, const W& aux,
                      int arg1, W& nk0, W& nk1) {
  const W z = bv::zero();
  const W nw = bv::bnot(mask);  // out-of-width bits
  nk0 = z;
  nk1 = z;
  switch (op) {
    case BAND:
      nk0 = bv::bor(bv::bor(ak0, bk0), nw);
      nk1 = bv::band(bv::band(ak1, bk1), mask);
      break;
    case BOR:
      nk0 = bv::bor(bv::band(ak0, bk0), nw);
      nk1 = bv::band(bv::bor(ak1, bk1), mask);
      break;
    case BXOR:
      nk0 = bv::bor(bv::band(bv::bor(bv::band(ak0, bk0), bv::band(ak1, bk1)), mask), nw);
      nk1 = bv::band(bv::bor(bv::band(ak0, bk1), bv::band(ak1, bk0)), mask);
      break;
    case BNOT:
      nk0 = bv::bor(bv::band(ak1, mask), nw);
      nk1 = bv::band(ak0, mask);
      break;
    case COPY:
      nk0 = bv::bor(ak0, nw);
      nk1 = bv::band(ak1, mask);
      break;
    case SHL:
      if (bv::eq(blo, bhi)) {
        W sk0 = bv::band(bv::bor(bv::shl(ak0, blo), bv::bnot(bv::shl(mask, blo))), mask);
        nk0 = bv::bor(sk0, nw);
        nk1 = bv::band(bv::shl(ak1, blo), mask);
      } else {
        nk0 = nw;
      }
      break;
    case LSHR:
      if (bv::eq(blo, bhi)) {
        W surv = bv::shr(mask, blo);
        nk0 = bv::bor(bv::band(bv::shr(ak0, blo), surv), bv::bnot(surv));
        nk1 = bv::band(bv::shr(ak1, blo), surv);
      } else {
        nk0 = nw;
      }
      break;
    case EXTRACT: {
      W lob = bv::from_u32((uint32_t)arg1);
      nk0 = bv::bor(bv::band(bv::shr(ak0, lob), aux), bv::bnot(aux));
      nk1 = bv::band(bv::shr(ak1, lob), aux);
      break;
    }
    case CONCAT2: {
      W bw = bv::from_u32(aux.l[0]);
      W low = bv::bnot(bv::shl(ones(), bw));
      nk0 = bv::bor(bv::band(bv::bor(bv::shl(ak0, bw), bv::band(bk0, low)), mask), nw);
      nk1 = bv::band(bv::bor(bv::shl(ak1, bw), bv::band(bk1, low)), mask);
      break;
    }
    case ADD:
    case SUB: {
      bool both = bv::is_zero(bv::bnot(bv::bor(ak0, ak1))) &&
                  bv::is_zero(bv::bnot(bv::bor(bk0, bk1)));
      if (both) {
        W r = bv::band(op == ADD ? bv::add(ak1, bk1) : bv::sub(ak1, bk1), mask);
        nk0 = bv::bnot(r);
        nk1 = r;
      }
      break;
    }
    case ITE: {
      bool mf = alo.l[0] != 0, mt = ahi.l[0] != 0;
      nk0 = !mf ? bk0 : (!mt ? ck0 : bv::band(bk0, ck0));
      nk1 = !mf ? bk1 : (!mt ? ck1 : bv::band(bk1, ck1));
      break;
    }
    default:
      break;
  }
}

// _meet: bools intersect their (mf, mt) bits, numerics take max-lo /
// min-hi and union the known bits, other rows keep the current value.
__device__ __forceinline__ void meet(bool isb, bool isn, W& lo, W& hi, W& k0, W& k1,
                                     const W& nlo, const W& nhi, const W& nk0,
                                     const W& nk1) {
  if (isb) {
    lo = bv::band(lo, nlo);
    hi = bv::band(hi, nhi);
  } else if (isn) {
    lo = max_n(lo, nlo);
    hi = min_n(hi, nhi);
    k0 = bv::bor(k0, nk0);
    k1 = bv::bor(k1, nk1);
  }
}

struct Tabs {
  uint32_t *lo, *hi, *k0, *k1;
  int S, T;
  __device__ __forceinline__ size_t row(int s, int r) const {
    return ((size_t)s * T + r) * bv::NL;
  }
};

// store w at p when it differs; returns whether it did
__device__ __forceinline__ bool put(uint32_t* p, const W& w, const W& old) {
  if (bv::eq(w, old)) return false;
  stw(p, w);
  return true;
}

// ---------------------------------------------------------------------------
// K5 / K6: one forward level, one thread per (state, node)
// ---------------------------------------------------------------------------

struct Level {
  const int32_t *node, *op, *args;
  const uint32_t *mask, *aux;
  const uint8_t *lvl_bool, *lvl_num;
  int W;
};

// entry j of a level for state s; returns whether it stored a word that
// differs (always false for the interval-only K5, which overwrites)
template <bool PRODUCT>
__device__ bool fwd_entry(const Tabs& t, const Level& L, int s, int j) {
  int o = L.op[j], nd = L.node[j];
  if (o == NOP || nd < 0 || nd >= t.T) return false;  // NOP/pad rows keep their value
  const int32_t* args = L.args;
  int a0 = clampi(args[3 * j], 0, t.T - 1);
  int a1 = clampi(args[3 * j + 1], 0, t.T - 1);
  int a2 = clampi(args[3 * j + 2], 0, t.T - 1);
  W m = ldw(L.mask + 8 * j), x = ldw(L.aux + 8 * j);
  W alo = ldw(t.lo + t.row(s, a0)), ahi = ldw(t.hi + t.row(s, a0));
  W blo = ldw(t.lo + t.row(s, a1)), bhi = ldw(t.hi + t.row(s, a1));
  W clo = bv::zero(), chi = bv::zero();
  bool third = o == ITE || o == BITE;
  if (third) {
    clo = ldw(t.lo + t.row(s, a2));
    chi = ldw(t.hi + t.row(s, a2));
  }
  W lo, hi;
  if (!transfer(o, alo, ahi, blo, bhi, clo, chi, m, x, args[3 * j + 1],
                args[3 * j + 2], lo, hi))
    return false;
  size_t r = t.row(s, nd);
  if (!PRODUCT) {
    stw(t.lo + r, lo);
    stw(t.hi + r, hi);
    return false;
  }
  W ak0 = ldw(t.k0 + t.row(s, a0)), ak1 = ldw(t.k1 + t.row(s, a0));
  W bk0 = ldw(t.k0 + t.row(s, a1)), bk1 = ldw(t.k1 + t.row(s, a1));
  W ck0 = bv::zero(), ck1 = bv::zero();
  if (o == ITE) {
    ck0 = ldw(t.k0 + t.row(s, a2));
    ck1 = ldw(t.k1 + t.row(s, a2));
  }
  W nk0, nk1;
  kbits(o, alo, ahi, blo, bhi, ak0, ak1, bk0, bk1, ck0, ck1, m, x, args[3 * j + 1],
        nk0, nk1);
  // known-bits refutation of EQ: a bit one side must set and the other
  // must clear makes the equality must-false
  if (o == EQ && !bv::is_zero(bv::bor(bv::band(ak1, bk0), bv::band(ak0, bk1))))
    hi.l[0] = 0;
  W clo0 = ldw(t.lo + r), chi0 = ldw(t.hi + r), ck00 = ldw(t.k0 + r), ck10 = ldw(t.k1 + r);
  W flo = clo0, fhi = chi0, fk0 = ck00, fk1 = ck10;
  meet(L.lvl_bool[j] != 0, L.lvl_num[j] != 0, flo, fhi, fk0, fk1, lo, hi, nk0, nk1);
  bool diff = put(t.lo + r, flo, clo0);
  diff |= put(t.hi + r, fhi, chi0);
  diff |= put(t.k0 + r, fk0, ck00);
  diff |= put(t.k1 + r, fk1, ck10);
  return diff;
}

template <bool PRODUCT>
__global__ void __launch_bounds__(128)
level_kernel(Tabs t, Level L, int32_t* changed) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)t.S * L.W) return;
  if (fwd_entry<PRODUCT>(t, L, (int)(i / L.W), (int)(i % L.W)) && changed) *changed = 1;
}

// ---------------------------------------------------------------------------
// K7: one backward round
// ---------------------------------------------------------------------------

struct Round {
  const int32_t *parent, *a, *b, *tgt, *tgt_c, *role, *op;
  const uint32_t *pmask, *paux, *lob;
  const uint8_t *tnum, *tbool;
};

// the candidate of entry j for state s, met into the target's current
// row (_back_round for one entry)
__device__ void back_entry(const Tabs& t, const Round& R, int s, int j, W& lo, W& hi,
                           W& k0, W& k1) {
  const int p = R.parent[j], ai = R.a[j], bi = R.b[j], tc = R.tgt_c[j];
  const int o = R.op[j], role = R.role[j];
  W rlo = ldw(t.lo + t.row(s, p)), rhi = ldw(t.hi + t.row(s, p));
  W rk0 = ldw(t.k0 + t.row(s, p)), rk1 = ldw(t.k1 + t.row(s, p));
  W alo = ldw(t.lo + t.row(s, ai)), ahi = ldw(t.hi + t.row(s, ai));
  W ak0 = ldw(t.k0 + t.row(s, ai)), ak1 = ldw(t.k1 + t.row(s, ai));
  W blo = ldw(t.lo + t.row(s, bi)), bhi = ldw(t.hi + t.row(s, bi));
  W bk0 = ldw(t.k0 + t.row(s, bi)), bk1 = ldw(t.k1 + t.row(s, bi));
  const W clo = ldw(t.lo + t.row(s, tc)), chi = ldw(t.hi + t.row(s, tc));
  const W ck0 = ldw(t.k0 + t.row(s, tc)), ck1 = ldw(t.k1 + t.row(s, tc));
  const W pmask = ldw(R.pmask + 8 * j), paux = ldw(R.paux + 8 * j);
  const bool r0 = role == 0, r1 = role == 1, r2 = role == 2;
  // sibling of the refined arg (binary numeric rules)
  const W slo = r0 ? blo : alo, shi = r0 ? bhi : ahi;
  const W sk0 = r0 ? bk0 : ak0, sk1 = r0 ? bk1 : ak1;
  const bool mtrue = rlo.l[0] == 0;   // parent bool cannot be false
  const bool mfalse = rhi.l[0] == 0;  // parent bool cannot be true
  const W one = bv::from_u32(1u), z = bv::zero();
  W nlo = clo, nhi = chi, nk0 = ck0, nk1 = ck1;
  switch (o) {
    case EQ:
      if (mtrue) {
        nlo = slo;
        nhi = shi;
        nk0 = sk0;
        nk1 = sk1;
      }
      break;
    case ULT: {
      // a < b: a <= b.hi-1, b >= a.lo+1; !(a < b): a >= b.lo, b <= a.hi
      W alo_p1 = bv::add(alo, one);
      if (mtrue && !bv::is_zero(bhi) && r0) nhi = bv::sub(bhi, one);
      if (mfalse && r0) nlo = blo;
      if (mtrue && !bv::is_zero(alo_p1) && r1) nlo = alo_p1;
      if (mfalse && r1) nhi = ahi;
      break;
    }
    case ULE: {
      // a <= b: a <= b.hi, b >= a.lo; !(a <= b): a >= b.lo+1, b <= a.hi-1
      W blo_p1 = bv::add(blo, one);
      if (mtrue && r0) nhi = bhi;
      if (mfalse && !bv::is_zero(blo_p1) && r0) nlo = blo_p1;
      if (mtrue && r1) nlo = alo;
      if (mfalse && !bv::is_zero(ahi) && r1) nhi = bv::sub(ahi, one);
      break;
    }
    case ADD: {
      W s_hi = bv::add(ahi, bhi);
      bool no_ovf = !(bv::ult(s_hi, ahi) || ugt(s_hi, pmask));
      if (no_ovf) {
        bool ok_hi = !bv::ult(rhi, slo);
        if (ok_hi) {
          nlo = !bv::ult(rlo, shi) ? bv::sub(rlo, shi) : z;
          nhi = bv::sub(rhi, slo);
        } else {
          nlo = one;  // empty interval
          nhi = z;
        }
      }
      break;
    }
    case SUB: {
      // forward-exact gate: a >= b guaranteed (alo >= bhi)
      if (bv::ult(alo, bhi)) break;
      if (r0) {
        // a = r + b under add no-wrap
        W s2 = bv::add(rhi, bhi);
        if (!(bv::ult(s2, rhi) || ugt(s2, pmask))) {
          nlo = bv::add(rlo, blo);
          nhi = s2;
        }
      } else if (r1) {
        // b = a - r
        if (!bv::ult(ahi, rlo)) {
          nlo = !bv::ult(alo, rhi) ? bv::sub(alo, rhi) : z;
          nhi = bv::sub(ahi, rlo);
        } else {
          nlo = one;
          nhi = z;
        }
      }
      break;
    }
    case BAND:
      nk0 = bv::bor(ck0, bv::band(rk0, sk1));
      nk1 = bv::bor(ck1, bv::band(rk1, pmask));
      break;
    case BOR:
      nk0 = bv::bor(ck0, bv::band(rk0, pmask));
      nk1 = bv::bor(ck1, bv::band(rk1, sk0));
      break;
    case BXOR:
      nk0 = bv::bor(ck0, bv::band(bv::bor(bv::band(rk0, sk0), bv::band(rk1, sk1)), pmask));
      nk1 = bv::bor(ck1, bv::band(bv::bor(bv::band(rk1, sk0), bv::band(rk0, sk1)), pmask));
      break;
    case BNOT:
      nk0 = bv::bor(ck0, bv::band(rk1, pmask));
      nk1 = bv::bor(ck1, bv::band(rk0, pmask));
      break;
    case SHL:
      if (bv::eq(blo, bhi)) {
        W surv = bv::shr(pmask, blo);
        nk0 = bv::bor(ck0, bv::band(bv::shr(rk0, blo), surv));
        nk1 = bv::bor(ck1, bv::band(bv::shr(rk1, blo), surv));
      }
      break;
    case LSHR:
      if (bv::eq(blo, bhi)) {
        nk0 = bv::bor(ck0, bv::band(bv::shl(rk0, blo), pmask));
        nk1 = bv::bor(ck1, bv::band(bv::shl(rk1, blo), pmask));
      }
      break;
    case COPY:
      nlo = max_n(clo, rlo);
      nhi = min_n(chi, rhi);
      nk0 = bv::bor(ck0, rk0);
      nk1 = bv::bor(ck1, rk1);
      break;
    case EXTRACT: {
      W lb = bv::from_u32(R.lob[j]);
      nk0 = bv::bor(ck0, bv::shl(bv::band(rk0, paux), lb));
      nk1 = bv::bor(ck1, bv::shl(bv::band(rk1, paux), lb));
      break;
    }
    case CONCAT2: {
      W bw = bv::from_u32(paux.l[0]);
      if (r0) {
        W hs = bv::shr(pmask, bw);
        nk0 = bv::bor(ck0, bv::band(bv::shr(rk0, bw), hs));
        nk1 = bv::bor(ck1, bv::band(bv::shr(rk1, bw), hs));
      } else {
        W low = bv::bnot(bv::shl(ones(), bw));
        nk0 = bv::bor(ck0, bv::band(rk0, low));
        nk1 = bv::bor(ck1, bv::band(rk1, low));
      }
      break;
    }
    case ITE:
      // args = (cond, then, else): a branch the condition selects
      // equals the parent
      if ((alo.l[0] == 0 && r1) || (ahi.l[0] == 0 && r2)) {
        nlo = rlo;
        nhi = rhi;
        nk0 = rk0;
        nk1 = rk1;
      }
      break;
    case BAND2:  // AND true -> target true; AND false, sibling true
      if (mtrue) nlo.l[0] = 0;
      if (mfalse && slo.l[0] == 0) nhi.l[0] = 0;
      break;
    case BOR2:  // OR false -> target false; OR true, sibling false
      if (mtrue && shi.l[0] == 0) nlo.l[0] = 0;
      if (mfalse) nhi.l[0] = 0;
      break;
    case BNOT1:
      if (mfalse) nlo.l[0] = 0;
      if (mtrue) nhi.l[0] = 0;
      break;
    default:
      break;
  }
  lo = clo;
  hi = chi;
  k0 = ck0;
  k1 = ck1;
  meet(R.tbool[j] != 0, R.tnum[j] != 0, lo, hi, k0, k1, nlo, nhi, nk0, nk1);
}

// One round for state s, by the whole block. Phase 1: every entry's
// candidate from the pre-round rows into the block's staging slots;
// phase 2, after the barrier: the targets. An entry's target may be
// another entry's parent or sibling in the same round; the barrier makes
// every read precede every write, as the JAX gather-then-scatter does.
// Targets are unique within a round (build_plan), and a thread reads
// back only the slots it wrote. Every thread of the block must call it;
// it ends with a barrier. Returns whether this thread stored a word that
// differs.
__device__ bool back_state(const Tabs& t, int Wd, const Round& R, uint32_t* slot, int s) {
  for (int j = threadIdx.x; j < Wd; j += blockDim.x) {
    if (R.tgt[j] < 0 || R.tgt[j] >= t.T) continue;  // pad: dropped
    W lo, hi, k0, k1;
    back_entry(t, R, s, j, lo, hi, k0, k1);
    stw(slot + 32 * j, lo);
    stw(slot + 32 * j + 8, hi);
    stw(slot + 32 * j + 16, k0);
    stw(slot + 32 * j + 24, k1);
  }
  __syncthreads();
  bool diff = false;
  for (int j = threadIdx.x; j < Wd; j += blockDim.x) {
    int tg = R.tgt[j];
    if (tg < 0 || tg >= t.T) continue;
    size_t r = t.row(s, tg);
    diff |= put(t.lo + r, ldw(slot + 32 * j), ldw(t.lo + r));
    diff |= put(t.hi + r, ldw(slot + 32 * j + 8), ldw(t.hi + r));
    diff |= put(t.k0 + r, ldw(slot + 32 * j + 16), ldw(t.k0 + r));
    diff |= put(t.k1 + r, ldw(slot + 32 * j + 24), ldw(t.k1 + r));
  }
  __syncthreads();
  return diff;
}

// K7: a block takes one state at a time
__global__ void __launch_bounds__(256)
back_kernel(Tabs t, int Wd, Round R, uint32_t* stage, int32_t* changed) {
  uint32_t* slot = stage + (size_t)blockIdx.x * Wd * 32;
  for (int s = blockIdx.x; s < t.S; s += gridDim.x)
    if (back_state(t, Wd, R, slot, s) && changed) *changed = 1;
}

// ---------------------------------------------------------------------------
// K8: the table-wide passes
// ---------------------------------------------------------------------------

// the inputs of the init pass
struct Init {
  const uint32_t *ilo, *ihi, *ik0, *ik1;
  const int32_t* seed_idx;
  const uint32_t *seed_lo, *seed_hi;
  int V;
  const int32_t* aidx;
  const uint8_t* amask;
  int A;
};

// state s by the whole block: broadcast the init rows, scatter the
// seeds, pin asserted roots TRUE; slots at rows past the table are
// dropped (mode="drop"). Ends with a barrier.
__device__ void init_state(const Tabs& t, const Init& in, int s) {
  const int n4 = t.T * 2;  // 16-byte vectors per table
  size_t base = t.row(s, 0) / 4;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    reinterpret_cast<uint4*>(t.lo)[base + q] = reinterpret_cast<const uint4*>(in.ilo)[q];
    reinterpret_cast<uint4*>(t.hi)[base + q] = reinterpret_cast<const uint4*>(in.ihi)[q];
    reinterpret_cast<uint4*>(t.k0)[base + q] = reinterpret_cast<const uint4*>(in.ik0)[q];
    reinterpret_cast<uint4*>(t.k1)[base + q] = reinterpret_cast<const uint4*>(in.ik1)[q];
  }
  __syncthreads();
  for (int v = threadIdx.x; v < in.V; v += blockDim.x) {
    int r = in.seed_idx[(size_t)s * in.V + v];
    if (r < 0 || r >= t.T) continue;
    stw(t.lo + t.row(s, r), ldw(in.seed_lo + ((size_t)s * in.V + v) * 8));
    stw(t.hi + t.row(s, r), ldw(in.seed_hi + ((size_t)s * in.V + v) * 8));
  }
  __syncthreads();
  for (int a = threadIdx.x; a < in.A; a += blockDim.x) {
    int r = in.aidx[(size_t)s * in.A + a];
    if (!in.amask[(size_t)s * in.A + a] || r < 0 || r >= t.T) continue;
    t.lo[t.row(s, r)] = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(256) init_kernel(Tabs t, Init in) {
  for (int s = blockIdx.x; s < t.S; s += gridDim.x) init_state(t, in, s);
}

// interval <-> known bits on numeric row r of state s; returns whether
// it stored a word that differs
__device__ __forceinline__ bool exchange_row(const Tabs& t, const uint8_t* numeric, int s,
                                             int r) {
  if (!numeric[r]) return false;
  size_t o = t.row(s, r);
  W lo = ldw(t.lo + o), hi = ldw(t.hi + o), k0 = ldw(t.k0 + o), k1 = ldw(t.k1 + o);
  W known = bv::bnot(smear(bv::bxor(lo, hi)));
  W k1n = bv::bor(k1, bv::band(lo, known));
  W k0n = bv::bor(k0, bv::band(bv::bnot(lo), known));
  bool diff = put(t.lo + o, max_n(lo, k1n), lo);
  diff |= put(t.hi + o, min_n(hi, bv::bnot(k0n)), hi);
  diff |= put(t.k0 + o, k0n, k0);
  diff |= put(t.k1 + o, k1n, k1);
  return diff;
}

// one thread per (state, row)
__global__ void __launch_bounds__(128)
exchange_kernel(Tabs t, const uint8_t* numeric, int32_t* changed) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)t.S * t.T) return;
  if (exchange_row(t, numeric, (int)(i / t.T), (int)(i % t.T)) && changed) *changed = 1;
}

// state s by the whole block: contra = some row conflicts, ok = every
// live assertion may be true and no conflict. Ends with a barrier.
__device__ void verdict_state(const Tabs& t, const uint8_t* numeric, const uint8_t* isbool,
                              const int32_t* aidx, const uint8_t* amask, int A, int s,
                              uint8_t* ok, uint8_t* contra) {
  int conf = 0, bad = 0;
  for (int r = threadIdx.x; r < t.T && !conf; r += blockDim.x) {
    size_t o = t.row(s, r);
    if (numeric[r]) {
      W lo = ldw(t.lo + o), hi = ldw(t.hi + o);
      conf = !bv::is_zero(bv::band(ldw(t.k0 + o), ldw(t.k1 + o))) || bv::ult(hi, lo);
    } else if (isbool[r]) {
      conf = t.lo[o] == 0 && t.hi[o] == 0;
    }
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    if (amask[(size_t)s * A + a]) {
      int r = clampi(aidx[(size_t)s * A + a], 0, t.T - 1);
      bad |= t.hi[t.row(s, r)] == 0;
    }
  }
  conf = __syncthreads_or(conf);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    contra[s] = conf ? 1 : 0;
    ok[s] = (conf || bad) ? 0 : 1;
  }
}

// a block per state
__global__ void __launch_bounds__(256)
verdicts_kernel(Tabs t, const uint8_t* numeric, const uint8_t* isbool,
                const int32_t* aidx, const uint8_t* amask, int A, uint8_t* ok,
                uint8_t* contra) {
  for (int s = blockIdx.x; s < t.S; s += gridDim.x)
    verdict_state(t, numeric, isbool, aidx, amask, A, s, ok, contra);
}

// ---------------------------------------------------------------------------
// K11: the fused fixpoint
// ---------------------------------------------------------------------------
//
// JAX's _fixpoint runs init, then sweeps (forward levels, exchange,
// backward rounds from the last level, exchange) while some table of
// the wave changed and fewer than cap sweeps ran, then the verdicts.
// Here a block takes one system at a time and runs that whole sequence
// for it, with a barrier between passes (each pass is the K6, K8 or K7
// device function, for one system). No grid-wide sync is needed: every
// read and write of a pass is of the system's own rows (the level and
// round row sets are shared, the tables are not; _exchange_all's
// numeric mask broadcasts over systems), so systems never depend on one
// another. A system stops at its own first sweep that stores no
// differing word. Its tables are then unchanged by that sweep, and a
// sweep is a function of the system's tables alone, so every further
// sweep the wave would run is the identity on it. The wave's sweep
// count is therefore the largest per-system count (each capped at cap);
// the kernel writes each system's count and the wrapper takes the
// maximum. Whether a sweep changed nothing is the flag K6-K8 set, which
// stands for the JAX comparison of start and end tables because
// refinement is monotone (see the changed flag above).
//
// Bound: bytes. Per sweep a system's four tables are read (and the rows
// that change written) by its passes; chip_smoke.py counts each
// system's tables once per sweep it ran. The staging slot of the
// backward rounds is the block's own (global memory, L1/L2 resident).

struct Passes {
  int L;
  const int32_t* loff;  // L+1 entry offsets of the levels
  Level lv;             // the levels' arrays, concatenated (W unused)
  int R;
  const int32_t* roff;  // R+1 entry offsets of the rounds, run order
  Round rd;             // the rounds' arrays, concatenated
};

__device__ __forceinline__ Level level_at(const Passes& P, int l) {
  int o = P.loff[l];
  Level L = P.lv;
  L.node += o;
  L.op += o;
  L.args += 3 * o;
  L.mask += 8 * o;
  L.aux += 8 * o;
  L.lvl_bool += o;
  L.lvl_num += o;
  L.W = P.loff[l + 1] - o;
  return L;
}

__device__ __forceinline__ Round round_at(const Passes& P, int q) {
  int o = P.roff[q];
  Round R = P.rd;
  R.parent += o;
  R.a += o;
  R.b += o;
  R.tgt += o;
  R.tgt_c += o;
  R.role += o;
  R.op += o;
  R.pmask += 8 * o;
  R.paux += 8 * o;
  R.lob += o;
  R.tnum += o;
  R.tbool += o;
  return R;
}

__global__ void __launch_bounds__(128)
fixpoint_kernel(Tabs t, Passes P, Init in, const uint8_t* numeric, const uint8_t* isbool,
                int cap, uint32_t* stage, int stage_w, uint8_t* ok, uint8_t* contra,
                int32_t* sweeps) {
  uint32_t* slot = stage + (size_t)blockIdx.x * stage_w * 32;
  for (int s = blockIdx.x; s < t.S; s += gridDim.x) {
    init_state(t, in, s);
    int n = 0;
    while (n < cap) {
      bool diff = false;
      for (int l = 0; l < P.L; ++l) {
        const Level L = level_at(P, l);
        for (int j = threadIdx.x; j < L.W; j += blockDim.x) diff |= fwd_entry<true>(t, L, s, j);
        __syncthreads();
      }
      for (int r = threadIdx.x; r < t.T; r += blockDim.x) diff |= exchange_row(t, numeric, s, r);
      __syncthreads();
      for (int q = 0; q < P.R; ++q)
        diff |= back_state(t, P.roff[q + 1] - P.roff[q], round_at(P, q), slot, s);
      for (int r = threadIdx.x; r < t.T; r += blockDim.x) diff |= exchange_row(t, numeric, s, r);
      ++n;
      if (!__syncthreads_or(diff)) break;
    }
    verdict_state(t, numeric, isbool, in.aidx, in.amask, in.A, s, ok, contra);
    if (threadIdx.x == 0) sweeps[s] = n;
  }
}

inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

inline unsigned state_grid(int S) { return (unsigned)(S < 4096 ? S : 4096); }

}  // namespace scr

using namespace scr;

MTT_EXPORT int interval_level(void* lo, void* hi, int S, int T, int Wd, const void* node,
                              const void* op, const void* args, const void* mask,
                              const void* aux, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, nullptr, nullptr, S, T};
  Level L{(const int32_t*)node, (const int32_t*)op, (const int32_t*)args,
          (const uint32_t*)mask, (const uint32_t*)aux, nullptr, nullptr, Wd};
  long long n = (long long)S * Wd;
  if (n > 0)
    level_kernel<false><<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(t, L, nullptr);
  return (int)cudaGetLastError();
}

MTT_EXPORT int prop_fwd_level(void* lo, void* hi, void* k0, void* k1, int S, int T, int Wd,
                              const void* node, const void* op, const void* args,
                              const void* mask, const void* aux, const void* lvl_bool,
                              const void* lvl_num, void* changed, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  Level L{(const int32_t*)node, (const int32_t*)op, (const int32_t*)args,
          (const uint32_t*)mask, (const uint32_t*)aux, (const uint8_t*)lvl_bool,
          (const uint8_t*)lvl_num, Wd};
  long long n = (long long)S * Wd;
  if (n > 0)
    level_kernel<true><<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        t, L, (int32_t*)changed);
  return (int)cudaGetLastError();
}

MTT_EXPORT int prop_back_round(void* lo, void* hi, void* k0, void* k1, int S, int T, int Wd,
                               const void* parent, const void* a, const void* b,
                               const void* tgt, const void* tgt_c, const void* role,
                               const void* op, const void* pmask, const void* paux,
                               const void* lob, const void* tnum, const void* tbool,
                               void* stage, int blocks, void* changed, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  Round R{(const int32_t*)parent, (const int32_t*)a, (const int32_t*)b,
          (const int32_t*)tgt, (const int32_t*)tgt_c, (const int32_t*)role,
          (const int32_t*)op, (const uint32_t*)pmask, (const uint32_t*)paux,
          (const uint32_t*)lob, (const uint8_t*)tnum, (const uint8_t*)tbool};
  int threads = 32;
  while (threads < Wd && threads < 256) threads <<= 1;
  if (S > 0 && Wd > 0 && blocks > 0)
    back_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(t, Wd, R, (uint32_t*)stage,
                                                              (int32_t*)changed);
  return (int)cudaGetLastError();
}

static Init make_init(const void* init_lo, const void* init_hi, const void* init_k0,
                      const void* init_k1, const void* seed_idx, const void* seed_lo,
                      const void* seed_hi, int V, const void* aidx, const void* amask,
                      int A) {
  return Init{(const uint32_t*)init_lo, (const uint32_t*)init_hi, (const uint32_t*)init_k0,
              (const uint32_t*)init_k1, (const int32_t*)seed_idx, (const uint32_t*)seed_lo,
              (const uint32_t*)seed_hi, V, (const int32_t*)aidx, (const uint8_t*)amask, A};
}

MTT_EXPORT int prop_init(void* lo, void* hi, void* k0, void* k1, int S, int T,
                         const void* init_lo, const void* init_hi, const void* init_k0,
                         const void* init_k1, const void* seed_idx, const void* seed_lo,
                         const void* seed_hi, int V, const void* aidx, const void* amask,
                         int A, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  if (S > 0 && T > 0)
    init_kernel<<<state_grid(S), 256, 0, (cudaStream_t)stream>>>(
        t, make_init(init_lo, init_hi, init_k0, init_k1, seed_idx, seed_lo, seed_hi, V,
                     aidx, amask, A));
  return (int)cudaGetLastError();
}

MTT_EXPORT int prop_exchange(void* lo, void* hi, void* k0, void* k1, int S, int T,
                             const void* numeric, void* changed, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  long long n = (long long)S * T;
  if (n > 0)
    exchange_kernel<<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        t, (const uint8_t*)numeric, (int32_t*)changed);
  return (int)cudaGetLastError();
}

MTT_EXPORT int prop_verdicts(void* lo, void* hi, void* k0, void* k1, int S, int T,
                             const void* numeric, const void* isbool, const void* aidx,
                             const void* amask, int A, void* ok, void* contra,
                             void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  if (S > 0)
    verdicts_kernel<<<state_grid(S), 256, 0, (cudaStream_t)stream>>>(
        t, (const uint8_t*)numeric, (const uint8_t*)isbool, (const int32_t*)aidx,
        (const uint8_t*)amask, A, (uint8_t*)ok, (uint8_t*)contra);
  return (int)cudaGetLastError();
}

// K11. tabs: the four (S, T, 8) tables, written whole; lv: node, op,
// args, mask, aux, lvl_bool, lvl_num of every level, concatenated;
// rd: parent, a, b, tgt, tgt_c, role, op, pmask, paux, lob, tnum, tbool
// of every round in run order (levels from the last, each level's rounds
// in order), concatenated; loff, roff: device offsets (L+1, R+1) of each
// level and round; init: init_lo, init_hi, init_k0, init_k1, seed_idx,
// seed_lo, seed_hi, assert_idx, assert_mask. stage: blocks x stage_w x 32
// words (stage_w at least the widest round); blocks: the grid
// (prop_fixpoint_blocks gives the count resident at once). Writes ok,
// contra and each system's sweep count.
MTT_EXPORT int prop_fixpoint(void** tabs, int S, int T, void** lv, const void* loff, int L,
                             void** rd, const void* roff, int R, void** init, int V, int A,
                             const void* numeric, const void* isbool, int cap, void* stage,
                             int stage_w, int blocks, void* ok, void* contra, void* sweeps,
                             void* stream) {
  Tabs t{(uint32_t*)tabs[0], (uint32_t*)tabs[1], (uint32_t*)tabs[2], (uint32_t*)tabs[3],
         S, T};
  Passes P;
  P.L = L;
  P.loff = (const int32_t*)loff;
  P.lv = Level{(const int32_t*)lv[0], (const int32_t*)lv[1], (const int32_t*)lv[2],
               (const uint32_t*)lv[3], (const uint32_t*)lv[4], (const uint8_t*)lv[5],
               (const uint8_t*)lv[6], 0};
  P.R = R;
  P.roff = (const int32_t*)roff;
  P.rd = Round{(const int32_t*)rd[0], (const int32_t*)rd[1], (const int32_t*)rd[2],
               (const int32_t*)rd[3], (const int32_t*)rd[4], (const int32_t*)rd[5],
               (const int32_t*)rd[6], (const uint32_t*)rd[7], (const uint32_t*)rd[8],
               (const uint32_t*)rd[9], (const uint8_t*)rd[10], (const uint8_t*)rd[11]};
  Init in = make_init(init[0], init[1], init[2], init[3], init[4], init[5], init[6], V,
                      init[7], init[8], A);
  if (S > 0 && T > 0 && blocks > 0)
    fixpoint_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        t, P, in, (const uint8_t*)numeric, (const uint8_t*)isbool, cap, (uint32_t*)stage,
        stage_w, (uint8_t*)ok, (uint8_t*)contra, (int32_t*)sweeps);
  return (int)cudaGetLastError();
}

// blocks of K11 resident at once on the current device (its grid)
MTT_EXPORT int prop_fixpoint_blocks() {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fixpoint_kernel, 128, 0);
  return sms * (per > 0 ? per : 1);
}
