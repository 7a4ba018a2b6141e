// K5-K8: the solver's device feasibility screens.
//
// Replace the jitted programs of mythril_tpu/ops/intervals.py and
// mythril_tpu/ops/propagate.py:
//
//   K5 interval_level   intervals.py:611 _eval_level (_transfer_level
//                       :403, _smear :394), driven over every level by
//                       _run_tables (:623): the seeds and then every
//                       forward interval level of an encoding,
//                       overwriting the nodes' rows.
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
//                       verdicts) in one launch, built from K6's, K7's
//                       and K8's device functions over the same kernel
//                       layout (see its own note below).
//
// Tables are (S, T, 8) uint32 limb words per state and node row (lo,
// hi, and for the product domain k0, k1); levels and rounds are the
// host plan's arrays (ops/intervals.linearize, ops/propagate.build_plan).
// Every function is bit for bit the JAX one; each opcode's transfer is a
// switch case computing only what that node needs (the JAX kernels
// compute every op of the level's cover and select by opcode, which
// gives the same row).
//
// K6 and K7 take the plan's kernel layout (ops/propagate.kernel_layout,
// built once a plan): each level's and round's real entries only (no
// NOP node, no pad: the rows the JAX scatter writes), ordered by op
// (K6: by op class, then op; K7: by op, role and target kind), two int4
// of indices an entry. A level's nodes are distinct and write only
// their own rows, and a round's targets are distinct and read the
// pre-round rows, so the order changes nothing.
//
//   K6: a launch per op class present (fwd_kernel<0..2>: the bool-valued
//       ops; the rest; MUL, UDIV, UREM and BOR/BXOR's smear; fwd_class,
//       which the layout builder reads through prop_fwd_class), so the
//       heavy transfers do not set the light ones' registers; a thread a
//       (state, node), the node fastest, so a warp runs neighbouring
//       nodes of one op and one state. Each op loads only what its
//       transfer, its known-bits transfer and the meet read. A level
//       that reads a row it writes (the layout's hazard flag; only a
//       wrapped index makes one) is one staged launch instead, under
//       K7's staging rule (fwd_staged_kernel: a block a state, every
//       node's candidate into the staging, one barrier, then met and
//       stored), since JAX reads every operand before it scatters.
//   K7: a block a state at a time, the grid the blocks resident at once
//       (prop_back_shape's occupancy query). Each rule loads only what
//       it and the meet read (the bool gate first where there is one);
//       the rows that differ are staged in the block's dynamic shared
//       memory, each entry's slot sized by its rule and target (limb 0
//       of lo and hi for a bool target: 8 B; lo and hi, or k0 and k1:
//       64 B; all four: 128 B), then one barrier, then stored. The
//       staging rule: a round whose staging (one flag word an entry and
//       the slots) exceeds a block's shared memory (the opt-in maximum,
//       227 KB on an H100) stages in a global buffer the plan
//       allocates once, a block's part each (as many blocks as the grid
//       or the plan's states, the fewer). A round's staging is a
//       multiple of 4 words, so every block's part, and in it every
//       slot of 16 or 32 words, is 16-byte aligned for ldw and stw.
//   K11 runs K6's fwd_node (fwd_block on a hazardous level, in its own
//       instance) and K7's back_block over the same layout.
//
// K5 takes its own layout (ops/intervals.interval_layout, built once an
// encoding and copied to the card in one copy of one pinned buffer): each
// level's real entries in (class, op) order, every index resolved by
// JAX's rules (an operand row wrapped once and clamped, a node wrapped
// once and dropped when still outside), and a flag on each operand row
// that no seed and no level writes: that row is the init table's in every
// state, so it is read from the one shared init table (in L2 across the
// states) and not from the state's table. Launches: the seeds, a thread a
// state; then a launch a level and op class present (iv_level_kernel<CLS>,
// a thread a (state, entry), K6's form), each op loading only the operands
// and mask and aux words its transfer reads; a level that reads a row it
// writes (only a wrapped index makes one) in one staged launch instead.
// One launch over every level (a block a state, a barrier between levels)
// was measured and was slower: 0.1754 against 0.1481 ms on the screen wave
// (PERF.md §6), each block walking its states' levels in turn. Rows
// are stored whole: limb 0 of a bool row alone made every 32-byte sector a
// partial write that the card reads back (0.2956 against 0.1754 ms).
//
// The bool-row invariant: a bool row holds (may_false, may_true) in
// limb 0 of lo and hi and zeros above. The init rows are so, and every
// pass ANDs a bool row or clears limb 0, so every table the screen makes
// keeps it; K6's and K7's bool rows read and write limb 0 only, which
// under it is the JAX meet of the whole row (chip_smoke.py checks it on
// every table it starts from).
//
// Bound: bytes. A level moves, per (state, node), the parts of its
// argument rows and its own row that its op reads (32 B a table of a
// numeric row, 4 B of limb 0 of a bool row's lo or hi); a round the
// parts of its entries' parent, argument and target rows that each rule
// reads on the round's data (chip_smoke.py: rule_parts); a table-wide
// pass reads and writes every row. Rows are 32-byte aligned and loaded as two 16-byte vectors. The
// transfer arithmetic (a few dozen 8-limb ops; 512-bit MUL and
// bv256.cuh's digit division where a node needs them) stays in
// registers.
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
__device__ __forceinline__ bool transfer(int op, const W& alo, const W& ahi, const W& blo,
                                         const W& bhi, const W& clo, const W& chi,
                                         const W& mask, const W& aux, int arg1, int arg2,
                                         W& lo, W& hi) {
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
__device__ __forceinline__ void kbits(int op, const W& alo, const W& ahi, const W& blo,
                                      const W& bhi, const W& ak0, const W& ak1,
                                      const W& bk0, const W& bk1, const W& ck0,
                                      const W& ck1, const W& mask, const W& aux, int arg1,
                                      W& nk0, W& nk1) {
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
// K6: one forward level over the layout's real nodes, a launch an op class
// ---------------------------------------------------------------------------

// A level of the kernel layout: its real nodes, ordered by (class, op),
// two int4 a node: {node, op, a0, a1} and {a2, arg1, arg2, flags}, the
// argument rows clamped into the table, arg1 and arg2 as the plan holds
// them (EXTRACT's immediates); mask and aux eight words a node.
struct FwdNodes {
  const int4* ent;
  const uint32_t *mask, *aux;
};

// a node's or a target's row flags (the plan's lvl_bool/lvl_num, tbool/tnum)
enum { FL_BOOL = 1, FL_NUM = 2 };

// K6's op classes, one instantiation (and launch) each, so that the heavy
// transfers do not set the light ones' register count: 0 the bool-valued
// ops, 2 MUL, UDIV, UREM and BOR/BXOR's smear, 1 the rest. The layout
// builder orders nodes by these classes (ops/intervals.py fwd_classes
// reads them through prop_fwd_class).
__host__ __device__ constexpr int fwd_class(int op) {
  return (op == EQ || op == ULT || op == ULE || op == BAND2 || op == BOR2 ||
          op == BNOT1 || op == BXOR2 || op == BITE)
             ? 0
             : (op == MUL || op == UDIV || op == UREM || op == BOR || op == BXOR) ? 2 : 1;
}

// a row's limb 0, or the whole row
template <bool LIMB0>
__device__ __forceinline__ W ldrow(const uint32_t* p) {
  if (LIMB0) {
    W w = bv::zero();
    w.l[0] = p[0];
    return w;
  }
  return ldw(p);
}

// MET (lo, hi, nk0, nk1) into node row r; kb: the op has a known-bits
// transfer. A bool row holds (mf, mt) in limb 0 and zeros above (the
// invariant in the header), so its meet is an AND of limb 0.
__device__ __forceinline__ bool fwd_store(const Tabs& t, size_t r, int flags, const W& lo,
                                          const W& hi, const W& nk0, const W& nk1,
                                          bool kb) {
  if (flags & FL_BOOL) {
    const uint32_t clo = t.lo[r], chi = t.hi[r];
    const uint32_t nlo = clo & lo.l[0], nhi = chi & hi.l[0];
    if (nlo != clo) t.lo[r] = nlo;
    if (nhi != chi) t.hi[r] = nhi;
    return nlo != clo || nhi != chi;
  }
  if (!(flags & FL_NUM)) return false;
  const W clo = ldw(t.lo + r), chi = ldw(t.hi + r);
  bool d = put(t.lo + r, max_n(clo, lo), clo);
  d |= put(t.hi + r, min_n(chi, hi), chi);
  if (kb && !(bv::is_zero(nk0) && bv::is_zero(nk1))) {  // k | 0 keeps k
    const W ck0 = ldw(t.k0 + r), ck1 = ldw(t.k1 + r);
    d |= put(t.k0 + r, bv::bor(ck0, nk0), ck0);
    d |= put(t.k1 + r, bv::bor(ck1, nk1), ck1);
  }
  return d;
}

// node j of state s under opcode OP: loads only what OP's transfer, its
// known-bits transfer and the meet read, and stores the met rows that
// differ; returns whether it did. STAGED: it leaves the candidate (lo,
// hi, nk0, nk1: 32 words) in the slot sl instead, for fwd_block to meet
// and store after a barrier, and returns false.
template <int OP, bool STAGED>
__device__ __forceinline__ bool fwd_op(const Tabs& t, const FwdNodes& L, int s, int j,
                                       const int4& e0, const int4& e1, uint32_t* sl) {
  // bool arguments: limb 0 only (ITE's condition too)
  constexpr bool A0 = OP == BAND2 || OP == BOR2 || OP == BNOT1 || OP == BXOR2 ||
                      OP == BITE || OP == ITE;
  constexpr bool B0 = OP == BAND2 || OP == BOR2 || OP == BXOR2 || OP == BITE;
  constexpr int NARGS = (OP == BNOT || OP == NEG || OP == COPY || OP == SEXT ||
                         OP == EXTRACT || OP == BNOT1)
                            ? 1
                            : (OP == ITE || OP == BITE) ? 3 : 2;
  constexpr bool KB = OP == BAND || OP == BOR || OP == BXOR || OP == BNOT || OP == COPY ||
                      OP == SHL || OP == LSHR || OP == EXTRACT || OP == CONCAT2 ||
                      OP == ADD || OP == SUB || OP == ITE;  // a known-bits transfer
  constexpr bool KA = (KB && OP != ITE) || OP == EQ;        // reads a's known bits
  constexpr bool KBB = OP == BAND || OP == BOR || OP == BXOR || OP == CONCAT2 ||
                       OP == ADD || OP == SUB || OP == EQ || OP == ITE;  // b's
  constexpr bool MASK = fwd_class(OP) != 0;
  constexpr bool AUX = OP == SEXT || OP == EXTRACT || OP == CONCAT2;
  const W z = bv::zero();
  const size_t ra = t.row(s, e0.z), rb = t.row(s, e0.w), rc = t.row(s, e1.x);
  const W m = MASK ? ldw(L.mask + 8 * j) : z, x = AUX ? ldw(L.aux + 8 * j) : z;
  const W alo = ldrow<A0>(t.lo + ra), ahi = ldrow<A0>(t.hi + ra);
  W blo = z, bhi = z, clo = z, chi = z;
  if (NARGS > 1) {
    blo = ldrow<B0>(t.lo + rb);
    bhi = ldrow<B0>(t.hi + rb);
  }
  if (NARGS > 2) {
    clo = ldrow<OP == BITE>(t.lo + rc);
    chi = ldrow<OP == BITE>(t.hi + rc);
  }
  W ak0 = z, ak1 = z, bk0 = z, bk1 = z, ck0 = z, ck1 = z;
  if (KA) {
    ak0 = ldw(t.k0 + ra);
    ak1 = ldw(t.k1 + ra);
  }
  if (KBB) {
    bk0 = ldw(t.k0 + rb);
    bk1 = ldw(t.k1 + rb);
  }
  if (OP == ITE) {
    ck0 = ldw(t.k0 + rc);
    ck1 = ldw(t.k1 + rc);
  }
  W lo, hi, nk0 = z, nk1 = z;
  transfer(OP, alo, ahi, blo, bhi, clo, chi, m, x, e1.y, e1.z, lo, hi);
  if (KB) kbits(OP, alo, ahi, blo, bhi, ak0, ak1, bk0, bk1, ck0, ck1, m, x, e1.y, nk0, nk1);
  if (OP == EQ && !bv::is_zero(bv::bor(bv::band(ak1, bk0), bv::band(ak0, bk1))))
    hi.l[0] = 0;  // known-bits refutation of EQ
  if constexpr (STAGED) {
    stw(sl, lo);
    stw(sl + 8, hi);
    stw(sl + 16, nk0);  // zero without a known-bits transfer
    stw(sl + 24, nk1);
    return false;
  }
  return fwd_store(t, t.row(s, e0.x), e1.w, lo, hi, nk0, nk1, KB);
}

// node j of state s, by its op; CLS: the op class compiled in (the
// nodes of other classes are not this instantiation's), -1 every class;
// STAGED: fwd_op's staged form, into the slot sl
template <int CLS, bool STAGED = false>
__device__ __forceinline__ bool fwd_node(const Tabs& t, const FwdNodes& L, int s, int j,
                                         uint32_t* sl = nullptr) {
  const int4 e0 = L.ent[2 * j], e1 = L.ent[2 * j + 1];
  switch (e0.y) {
#define FWD_CASE(OP)                                      \
  case OP:                                                \
    if constexpr (CLS < 0 || fwd_class(OP) == CLS)        \
      return fwd_op<OP, STAGED>(t, L, s, j, e0, e1, sl);  \
    break;
    FWD_CASE(ADD) FWD_CASE(SUB) FWD_CASE(MUL) FWD_CASE(UDIV) FWD_CASE(UREM)
    FWD_CASE(BAND) FWD_CASE(BOR) FWD_CASE(BXOR) FWD_CASE(BNOT) FWD_CASE(NEG)
    FWD_CASE(SHL) FWD_CASE(LSHR) FWD_CASE(COPY) FWD_CASE(SEXT) FWD_CASE(EXTRACT)
    FWD_CASE(CONCAT2) FWD_CASE(ITE) FWD_CASE(EQ) FWD_CASE(ULT) FWD_CASE(ULE)
    FWD_CASE(BAND2) FWD_CASE(BOR2) FWD_CASE(BNOT1) FWD_CASE(BXOR2) FWD_CASE(BITE)
#undef FWD_CASE
    default:
      break;
  }
  return false;
}

// The nodes [base, base + n) of a level, all of class CLS: a thread a
// (state, node), the node fastest, so a warp runs 32 neighbouring nodes
// of one state, of one op but where the op changes (the layout is
// ordered by op), whose argument and own rows lie side by side in the
// state's table as the plan numbers them. (The state fastest, a warp
// one node over 32 states, spreads a warp's loads over 32 tables:
// 0.6825 ms on the screen wave against 0.7223 before; PERF.md.)
template <int CLS>
__global__ void __launch_bounds__(128)
fwd_kernel(Tabs t, FwdNodes L, int base, int n, int32_t* changed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * t.S) return;
  if (fwd_node<CLS>(t, L, (int)(i / n), base + (int)(i % n)) && changed) *changed = 1;
}

// The nodes [lo, hi) of a level that reads a row it writes, for state s,
// by the whole block (every thread calls it), in two phases: each thread
// computes its nodes' candidates from the pre-level rows into their
// slots of the staging (32 words a node), one barrier, then the same
// thread meets each candidate into its node's row and stores the words
// that differ (fwd_store, as in place). So every read of the level's
// operands comes before every write, as in JAX's gather-then-scatter; a
// node's own row, read by the meet after the barrier, is the pre-level
// row: the level writes it only there. Returns whether this thread
// stored a word that differs. A thread reads back only the slots it
// wrote, so the staging can take the next state without a second
// barrier (a pass that then reads the tables needs one).
__device__ __forceinline__ bool fwd_block(const Tabs& t, const FwdNodes& L, int lo, int hi,
                                          uint32_t* stage, int s) {
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x)
    fwd_node<-1, true>(t, L, s, j, stage + 32 * (size_t)(j - lo));
  __syncthreads();
  bool d = false;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const uint32_t* sl = stage + 32 * (size_t)(j - lo);
    d |= fwd_store(t, t.row(s, L.ent[2 * j].x), L.ent[2 * j + 1].w, ldw(sl), ldw(sl + 8),
                   ldw(sl + 16), ldw(sl + 24), true);
  }
  return d;
}

// K6 on a hazardous level of n nodes: a block takes a state at a time
// (grid-stride), the level by fwd_block. SMEM: the staging is the
// block's dynamic shared memory, else its part of a global buffer (K7's
// staging rule).
template <bool SMEM>
__global__ void __launch_bounds__(256)
fwd_staged_kernel(Tabs t, FwdNodes L, int n, uint32_t* gstage, int stage_words,
                  int32_t* changed) {
  extern __shared__ uint4 smem_stage[];
  uint32_t* stage =
      SMEM ? reinterpret_cast<uint32_t*>(smem_stage) : gstage + (size_t)blockIdx.x * stage_words;
  bool any = false;
  for (int s = blockIdx.x; s < t.S; s += gridDim.x) any |= fwd_block(t, L, 0, n, stage, s);
  if (any && changed) *changed = 1;
}

// ---------------------------------------------------------------------------
// K5: every forward interval level of an encoding
// ---------------------------------------------------------------------------

// K5's layout (ops/intervals.interval_layout): each level's real entries
// (not NOP, a node JAX's scatter keeps), ordered by (class, op), two int4
// an entry: {node, op, a, b} and {c, arg1, arg2, flags}, the node's row
// wrapped once (JAX's mode="drop"), the operand rows wrapped once and
// clamped (JAX's gather), arg1 and arg2 as the encoding holds them
// (EXTRACT's immediates); mask and aux eight words an entry; the init
// tables and the seeds where the tables are the init tables with the
// seeds scattered in.
struct IvLayout {
  const int4* ent;
  const uint32_t *mask, *aux;
  const uint32_t *ilo, *ihi;  // (T, 8) init tables, or null
  const int32_t* seed_idx;    // (S, V) seed rows, or null
  const uint32_t *seed_lo, *seed_hi;
  int V;
};

// an entry's flags: operand a, b or c is a row no seed and no level
// writes, read from the shared init tables (one copy for every state)
enum { IV_SA = 1, IV_SB = 2, IV_SC = 4 };

// what K5's transfer of an op reads (iv_op; ops/intervals.py iv_reads
// reads it through interval_reads for K5's byte bound): bits 0-1 the
// operand rows it reads (1-3; 0 for an op K5 has no transfer for);
// IV_R_A0, IV_R_B0, IV_R_C0 operand a, b or c read as a bool (limb 0 of
// lo and hi: the transfer reads nothing else of it); IV_R_MASK the
// mask; IV_R_AUX the aux; IV_R_AUX0 the aux's word 0 alone (CONCAT2's
// low part's width).
enum { IV_R_A0 = 4, IV_R_B0 = 8, IV_R_C0 = 16, IV_R_MASK = 32, IV_R_AUX = 64, IV_R_AUX0 = 128 };
__host__ __device__ constexpr int iv_reads(int op) {
  const bool handled = op == ADD || op == SUB || op == MUL || op == UDIV || op == UREM ||
                       op == BAND || op == BOR || op == BXOR || op == BNOT || op == NEG ||
                       op == SHL || op == LSHR || op == COPY || op == SEXT || op == EXTRACT ||
                       op == CONCAT2 || op == ITE || op == EQ || op == ULT || op == ULE ||
                       op == BAND2 || op == BOR2 || op == BNOT1 || op == BXOR2 || op == BITE;
  const int nargs = (op == BNOT || op == NEG || op == COPY || op == SEXT || op == EXTRACT ||
                     op == BNOT1)
                        ? 1
                        : (op == ITE || op == BITE) ? 3 : 2;
  const bool a0 = op == BAND2 || op == BOR2 || op == BNOT1 || op == BXOR2 || op == BITE ||
                  op == ITE;
  const bool b0 = op == BAND2 || op == BOR2 || op == BXOR2 || op == BITE;
  const bool mask = op == ADD || op == SUB || op == MUL || op == UDIV || op == UREM ||
                    op == BOR || op == BXOR || op == BNOT || op == NEG || op == SHL ||
                    op == SEXT || op == EXTRACT;
  return !handled ? 0
                  : nargs | (a0 ? IV_R_A0 : 0) | (b0 ? IV_R_B0 : 0) | (op == BITE ? IV_R_C0 : 0) |
                        (mask ? IV_R_MASK : 0) |
                        (op == SEXT || op == EXTRACT ? IV_R_AUX : 0) |
                        (op == CONCAT2 ? IV_R_AUX0 : 0);
}

// operand row r of state s: the state's table, or the init table
template <bool LIMB0>
__device__ __forceinline__ void iv_arg(const Tabs& t, const IvLayout& L, int s, int r, bool stat,
                                       W& lo, W& hi) {
  const size_t off = stat ? (size_t)r * bv::NL : t.row(s, r);
  lo = ldrow<LIMB0>((stat ? L.ilo : t.lo) + off);
  hi = ldrow<LIMB0>((stat ? L.ihi : t.hi) + off);
}

// entry j of state s under opcode OP: loads only the operands OP reads
// (limb 0 of those it reads as bools: the transfer reads nothing else of
// them) and the mask and aux words it uses; stores the node's rows whole
// (two full 32-byte sectors: a 4-byte store of limb 0 alone makes the
// card read each sector back, and ran slower), or, with a staging slot,
// into the slot
template <int OP>
__device__ __forceinline__ void iv_op(const Tabs& t, const IvLayout& L, int s, int j,
                                      const int4& e0, const int4& e1, uint32_t* slot) {
  constexpr int R = iv_reads(OP), NARGS = R & 3;
  const W z = bv::zero();
  W alo, ahi, blo = z, bhi = z, clo = z, chi = z;
  iv_arg<(R & IV_R_A0) != 0>(t, L, s, e0.z, e1.w & IV_SA, alo, ahi);
  if (NARGS > 1) iv_arg<(R & IV_R_B0) != 0>(t, L, s, e0.w, e1.w & IV_SB, blo, bhi);
  if (NARGS > 2) iv_arg<(R & IV_R_C0) != 0>(t, L, s, e1.x, e1.w & IV_SC, clo, chi);
  const W m = (R & IV_R_MASK) ? ldw(L.mask + 8 * (size_t)j) : z;
  W x = (R & IV_R_AUX) ? ldw(L.aux + 8 * (size_t)j) : z;
  if (R & IV_R_AUX0) x.l[0] = L.aux[8 * (size_t)j];  // the low part's width
  W lo, hi;
  transfer(OP, alo, ahi, blo, bhi, clo, chi, m, x, e1.y, e1.z, lo, hi);
  uint32_t *plo = slot, *phi = slot + 8;
  if (!slot) {
    plo = t.lo + t.row(s, e0.x);
    phi = t.hi + t.row(s, e0.x);
  }
  stw(plo, lo);
  stw(phi, hi);
}

// entry j of state s, by its op; CLS: the op class compiled in (K6's
// fwd_class: a launch a class, so the heavy transfers do not set the
// light ones' registers), -1 every class
template <int CLS>
__device__ __forceinline__ void iv_node(const Tabs& t, const IvLayout& L, int s, int j,
                                        uint32_t* slot) {
  const int4 e0 = L.ent[2 * (size_t)j], e1 = L.ent[2 * (size_t)j + 1];
  switch (e0.y) {
#define IV_CASE(OP)                                   \
  case OP:                                            \
    if constexpr (CLS < 0 || fwd_class(OP) == CLS)    \
      iv_op<OP>(t, L, s, j, e0, e1, slot);            \
    break;
    IV_CASE(ADD) IV_CASE(SUB) IV_CASE(MUL) IV_CASE(UDIV) IV_CASE(UREM)
    IV_CASE(BAND) IV_CASE(BOR) IV_CASE(BXOR) IV_CASE(BNOT) IV_CASE(NEG)
    IV_CASE(SHL) IV_CASE(LSHR) IV_CASE(COPY) IV_CASE(SEXT) IV_CASE(EXTRACT)
    IV_CASE(CONCAT2) IV_CASE(ITE) IV_CASE(EQ) IV_CASE(ULT) IV_CASE(ULE)
    IV_CASE(BAND2) IV_CASE(BOR2) IV_CASE(BNOT1) IV_CASE(BXOR2) IV_CASE(BITE)
#undef IV_CASE
    default:
      break;
  }
}

// a seed slot's row by JAX's mode="drop" rule: wrapped once where
// negative; -1 where it is dropped
__device__ __forceinline__ int seed_row(int r, int T) {
  if (r < 0) r += T;
  return r < 0 || r >= T ? -1 : r;
}

// K5's seeds: a thread a state, its slots in order (a later slot naming
// the same row wins, as the scatter applies them)
__global__ void __launch_bounds__(128) iv_seed_kernel(Tabs t, IvLayout L) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= t.S) return;
  for (int v = 0; v < L.V; ++v) {
    const size_t k = (size_t)s * L.V + v;
    const int r = seed_row(L.seed_idx[k], t.T);
    if (r < 0) continue;
    stw(t.lo + t.row(s, r), ldw(L.seed_lo + 8 * k));
    stw(t.hi + t.row(s, r), ldw(L.seed_hi + 8 * k));
  }
}

// K5, a level's entries [base, base + n), all of class CLS: a thread a
// (state, entry), the entry fastest, so a warp runs 32 neighbouring
// entries of one op and one state, whose node rows the plan numbers side
// by side (a warp's stores: 1 KB of each table)
template <int CLS>
__global__ void __launch_bounds__(128) iv_level_kernel(Tabs t, IvLayout L, int base, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * t.S) return;
  iv_node<CLS>(t, L, (int)(i / n), base + (int)(i % n), nullptr);
}

// K5, a level [base, base + n) that reads a row it writes (only a wrapped
// index makes one; JAX reads every operand before it scatters): a block a
// state at a time, every entry computed into the block's staging (16
// words an entry), one barrier, then stored
__global__ void __launch_bounds__(256)
iv_staged_kernel(Tabs t, IvLayout L, int base, int n, uint32_t* stage, int stage_w) {
  uint32_t* st = stage + (size_t)blockIdx.x * stage_w;
  for (int s = blockIdx.x; s < t.S; s += gridDim.x) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) iv_node<-1>(t, L, s, base + j, st + 16 * j);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const size_t r = t.row(s, L.ent[2 * (size_t)(base + j)].x);
      stw(t.lo + r, ldw(st + 16 * j));
      stw(t.hi + r, ldw(st + 16 * j + 8));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K7: one backward round over the layout's real entries
// ---------------------------------------------------------------------------

// A round of the kernel layout: its real entries, ordered by (op, role,
// target kind), two int4 an entry: {parent, a, b, tgt} and {tgt_c, code,
// soff, lob}; code = op | role << 8 | flags << 16 (the target's FL_BOOL,
// FL_NUM); soff is the word offset of the entry's staging slot. Rows
// are clamped into the table (the JAX gather clamps).
struct BackEntries {
  const int4* ent;
  const uint32_t *pmask, *paux;
  int n;
};

// what phase 1 staged for an entry: which of the target's rows differ,
// and where they sit in its slot (F_L0: limb 0 of lo and hi at words 0
// and 1; else lo at 0, hi at 8, k0 and k1 at 16 and 24, or at 0 and 8
// with F_KLOW)
enum { F_LO = 1, F_HI = 2, F_K0 = 4, F_K1 = 8, F_L0 = 16, F_KLOW = 32 };

// a bool target: limb 0 of lo and hi ANDed with the candidate's (a bool
// row is zero above limb 0: the header's invariant)
__device__ __forceinline__ int meet_l0(const Tabs& t, size_t r, bool setlo, uint32_t nlo,
                                       bool sethi, uint32_t nhi, uint32_t* sl) {
  int fl = 0;
  if (setlo) {
    const uint32_t c = t.lo[r], v = c & nlo;
    if (v != c) {
      sl[0] = v;
      fl |= F_LO;
    }
  }
  if (sethi) {
    const uint32_t c = t.hi[r], v = c & nhi;
    if (v != c) {
      sl[1] = v;
      fl |= F_HI;
    }
  }
  return fl ? fl | F_L0 : 0;
}

// an interval candidate (lo where setlo, hi where sethi, else the
// target's own) met into target row r: max-lo, min-hi for a numeric
// target, an AND of limb 0 for a bool one
__device__ __forceinline__ int meet_iv(const Tabs& t, size_t r, bool tb, bool setlo,
                                       const W& nlo, bool sethi, const W& nhi,
                                       uint32_t* sl) {
  if (tb) return meet_l0(t, r, setlo, nlo.l[0], sethi, nhi.l[0], sl);
  int fl = 0;
  if (setlo) {
    const W c = ldw(t.lo + r), v = max_n(c, nlo);
    if (!bv::eq(v, c)) {
      stw(sl, v);
      fl |= F_LO;
    }
  }
  if (sethi) {
    const W c = ldw(t.hi + r), v = min_n(c, nhi);
    if (!bv::eq(v, c)) {
      stw(sl + 8, v);
      fl |= F_HI;
    }
  }
  return fl;
}

// known bits x0, x1 ORed into numeric target row r (zero keeps a row)
__device__ __forceinline__ int meet_k(const Tabs& t, size_t r, const W& x0, const W& x1,
                                      uint32_t* sl) {
  int fl = 0;
  if (!bv::is_zero(x0)) {
    const W c = ldw(t.k0 + r), v = bv::bor(c, x0);
    if (!bv::eq(v, c)) {
      stw(sl, v);
      fl |= F_K0;
    }
  }
  if (!bv::is_zero(x1)) {
    const W c = ldw(t.k1 + r), v = bv::bor(c, x1);
    if (!bv::eq(v, c)) {
      stw(sl + 8, v);
      fl |= F_K1;
    }
  }
  return fl ? fl | F_KLOW : 0;
}

// a whole-row candidate (the sibling's or the parent's rows) met into
// target row r
__device__ __forceinline__ int meet_rows(const Tabs& t, size_t r, bool tb, size_t q,
                                         uint32_t* sl) {
  if (tb) return meet_l0(t, r, true, t.lo[q], true, t.hi[q], sl);
  int fl = meet_iv(t, r, false, true, ldw(t.lo + q), true, ldw(t.hi + q), sl);
  const W c0 = ldw(t.k0 + r), v0 = bv::bor(c0, ldw(t.k0 + q));
  const W c1 = ldw(t.k1 + r), v1 = bv::bor(c1, ldw(t.k1 + q));
  if (!bv::eq(v0, c0)) {
    stw(sl + 16, v0);
    fl |= F_K0;
  }
  if (!bv::eq(v1, c1)) {
    stw(sl + 24, v1);
    fl |= F_K1;
  }
  return fl;
}

// Phase 1 of entry j for state s: the rule's candidate from the
// pre-round rows, loading only what the rule and the meet read, met
// into the target's current rows; the rows that differ go to the slot
// sl. Returns the F_ flags (0: the target keeps its rows).
__device__ int back_rule(const Tabs& t, const BackEntries& R, int s, int j, const int4& e0,
                         const int4& e1, uint32_t* sl) {
  const int op = e1.y & 0xff, role = (e1.y >> 8) & 0xff, tf = e1.y >> 16;
  if (!(tf & (FL_BOOL | FL_NUM))) return 0;  // neither: the meet keeps the row
  const bool tb = tf & FL_BOOL, r0 = role == 0, r1 = role == 1;
  const size_t rp = t.row(s, e0.x), ra = t.row(s, e0.y), rb = t.row(s, e0.z);
  const size_t rc = t.row(s, e1.x), rs = r0 ? rb : ra;  // target, sibling
  const W one = bv::from_u32(1u), z = bv::zero();
  switch (op) {
    case EQ:
      if (t.lo[rp] != 0) return 0;  // the parent may be false
      return meet_rows(t, rc, tb, rs, sl);
    case ULT:
    case ULE: {
      const bool mt = t.lo[rp] == 0, mf = t.hi[rp] == 0;
      bool sl_ = false, sh = false;
      W nlo = z, nhi = z;
      if (op == ULT) {
        // a < b: a <= b.hi-1, b >= a.lo+1; !(a < b): a >= b.lo, b <= a.hi
        if (r0 && mt) {
          const W bhi = ldw(t.hi + rb);
          sh = !bv::is_zero(bhi);
          nhi = bv::sub(bhi, one);
        }
        if (r0 && mf) {
          nlo = ldw(t.lo + rb);
          sl_ = true;
        }
        if (r1 && mt) {
          nlo = bv::add(ldw(t.lo + ra), one);
          sl_ = !bv::is_zero(nlo);
        }
        if (r1 && mf) {
          nhi = ldw(t.hi + ra);
          sh = true;
        }
      } else {
        // a <= b: a <= b.hi, b >= a.lo; !(a <= b): a >= b.lo+1, b <= a.hi-1
        if (r0 && mt) {
          nhi = ldw(t.hi + rb);
          sh = true;
        }
        if (r0 && mf) {
          nlo = bv::add(ldw(t.lo + rb), one);
          sl_ = !bv::is_zero(nlo);
        }
        if (r1 && mt) {
          nlo = ldw(t.lo + ra);
          sl_ = true;
        }
        if (r1 && mf) {
          const W ahi = ldw(t.hi + ra);
          sh = !bv::is_zero(ahi);
          nhi = bv::sub(ahi, one);
        }
      }
      if (!sl_ && !sh) return 0;
      return meet_iv(t, rc, tb, sl_, nlo, sh, nhi, sl);
    }
    case ADD: {
      const W ahi = ldw(t.hi + ra), bhi = ldw(t.hi + rb), pm = ldw(R.pmask + 8 * j);
      const W rlo = ldw(t.lo + rp), rhi = ldw(t.hi + rp), slo = ldw(t.lo + rs);
      const W s_hi = bv::add(ahi, bhi);
      if (bv::ult(s_hi, ahi) || ugt(s_hi, pm)) return 0;
      const W shi = r0 ? bhi : ahi;
      W nlo = one, nhi = z;  // empty interval
      if (!bv::ult(rhi, slo)) {
        nlo = !bv::ult(rlo, shi) ? bv::sub(rlo, shi) : z;
        nhi = bv::sub(rhi, slo);
      }
      return meet_iv(t, rc, tb, true, nlo, true, nhi, sl);
    }
    case SUB: {
      // forward-exact gate: a >= b guaranteed (alo >= bhi)
      const W alo = ldw(t.lo + ra), bhi = ldw(t.hi + rb);
      const W rlo = ldw(t.lo + rp), rhi = ldw(t.hi + rp);
      if (bv::ult(alo, bhi)) return 0;
      W nlo = one, nhi = z;
      if (r0) {
        // a = r + b under add no-wrap
        const W s2 = bv::add(rhi, bhi);
        if (bv::ult(s2, rhi) || ugt(s2, ldw(R.pmask + 8 * j))) return 0;
        nlo = bv::add(rlo, ldw(t.lo + rb));
        nhi = s2;
      } else if (r1) {
        // b = a - r
        const W ahi = ldw(t.hi + ra);
        if (!bv::ult(ahi, rlo)) {
          nlo = !bv::ult(alo, rhi) ? bv::sub(alo, rhi) : z;
          nhi = bv::sub(ahi, rlo);
        }
      } else {
        return 0;
      }
      return meet_iv(t, rc, tb, true, nlo, true, nhi, sl);
    }
    case COPY:
      if (tb) {
        const W clo = ldw(t.lo + rc), chi = ldw(t.hi + rc);
        return meet_l0(t, rc, true, max_n(clo, ldw(t.lo + rp)).l[0], true,
                       min_n(chi, ldw(t.hi + rp)).l[0], sl);
      }
      return meet_rows(t, rc, false, rp, sl);
    case ITE:
      // args = (cond, then, else): a branch the condition selects
      // equals the parent
      if (!((t.lo[ra] == 0 && r1) || (t.hi[ra] == 0 && role == 2))) return 0;
      return meet_rows(t, rc, tb, rp, sl);
    case BAND2:
    case BOR2:
    case BNOT1: {
      // bool unit propagation; a numeric target's lo keeps its value
      // (max with itself, limb 0 cleared) and its hi takes limb 0 cleared
      const bool mt = t.lo[rp] == 0, mf = t.hi[rp] == 0;
      bool clo, chi;
      if (op == BAND2) {  // AND true -> target true; AND false, sibling true
        clo = mt;
        chi = mf && t.lo[rs] == 0;
      } else if (op == BOR2) {  // OR false -> target false; OR true, sibling false
        clo = mt && t.hi[rs] == 0;
        chi = mf;
      } else {
        clo = mf;
        chi = mt;
      }
      return meet_l0(t, rc, clo && tb, 0u, chi, 0u, sl);
    }
    default:
      break;
  }
  // the known-bits rules: a numeric target's k0, k1; a bool target keeps
  // its rows
  if (tb) return 0;
  const W rk0 = ldw(t.k0 + rp), rk1 = ldw(t.k1 + rp);
  switch (op) {
    case BAND: {
      const W pm = ldw(R.pmask + 8 * j);
      return meet_k(t, rc, bv::band(rk0, ldw(t.k1 + rs)), bv::band(rk1, pm), sl);
    }
    case BOR: {
      const W pm = ldw(R.pmask + 8 * j);
      return meet_k(t, rc, bv::band(rk0, pm), bv::band(rk1, ldw(t.k0 + rs)), sl);
    }
    case BXOR: {
      const W pm = ldw(R.pmask + 8 * j), sk0 = ldw(t.k0 + rs), sk1 = ldw(t.k1 + rs);
      return meet_k(t, rc, bv::band(bv::bor(bv::band(rk0, sk0), bv::band(rk1, sk1)), pm),
                    bv::band(bv::bor(bv::band(rk1, sk0), bv::band(rk0, sk1)), pm), sl);
    }
    case BNOT: {
      const W pm = ldw(R.pmask + 8 * j);
      return meet_k(t, rc, bv::band(rk1, pm), bv::band(rk0, pm), sl);
    }
    case SHL:
    case LSHR: {
      const W blo = ldw(t.lo + rb), bhi = ldw(t.hi + rb), pm = ldw(R.pmask + 8 * j);
      if (!bv::eq(blo, bhi)) return 0;
      if (op == SHL) {
        const W surv = bv::shr(pm, blo);
        return meet_k(t, rc, bv::band(bv::shr(rk0, blo), surv),
                      bv::band(bv::shr(rk1, blo), surv), sl);
      }
      return meet_k(t, rc, bv::band(bv::shl(rk0, blo), pm), bv::band(bv::shl(rk1, blo), pm),
                    sl);
    }
    case EXTRACT: {
      const W pa = ldw(R.paux + 8 * j), lb = bv::from_u32((uint32_t)e1.w);
      return meet_k(t, rc, bv::shl(bv::band(rk0, pa), lb), bv::shl(bv::band(rk1, pa), lb),
                    sl);
    }
    case CONCAT2: {
      const W bw = bv::from_u32(R.paux[8 * j]);
      if (r0) {
        const W hs = bv::shr(ldw(R.pmask + 8 * j), bw);
        return meet_k(t, rc, bv::band(bv::shr(rk0, bw), hs), bv::band(bv::shr(rk1, bw), hs),
                      sl);
      }
      const W low = bv::bnot(bv::shl(ones(), bw));
      return meet_k(t, rc, bv::band(rk0, low), bv::band(rk1, low), sl);
    }
    default:
      return 0;
  }
}

// Phase 2: the rows phase 1 staged for entry j of state s
__device__ __forceinline__ void back_write(const Tabs& t, int s, int tgt, int fl,
                                           const uint32_t* sl) {
  const size_t r = t.row(s, tgt);
  if (fl & F_L0) {
    if (fl & F_LO) t.lo[r] = sl[0];
    if (fl & F_HI) t.hi[r] = sl[1];
    return;
  }
  if (fl & F_LO) stw(t.lo + r, ldw(sl));
  if (fl & F_HI) stw(t.hi + r, ldw(sl + 8));
  const int k = (fl & F_KLOW) ? 0 : 16;
  if (fl & F_K0) stw(t.k0 + r, ldw(sl + k));
  if (fl & F_K1) stw(t.k1 + r, ldw(sl + k + 8));
}

// The entries [lo, hi) of a round for state s, by the whole block (every
// thread calls it). Phase 1: each thread computes its entries'
// candidates from the pre-round rows and stages the rows that differ,
// with their flags, in its own slots of the block's staging (flags:
// words [0, hi - lo); slots: at each entry's soff); then one barrier,
// which also tells whether any entry changed a row (the return value,
// the same in every thread); phase 2: the same thread stores its
// entries' staged rows. An entry's target may be another entry's
// parent, sibling or condition in the same round: the barrier puts
// every read of the round before every write, as the JAX
// gather-then-scatter does. A thread reads back only the slots it
// wrote, so the staging can take the next state or round without a
// second barrier (a pass that then reads the tables needs one).
__device__ __forceinline__ bool back_block(const Tabs& t, const BackEntries& R, int lo, int hi,
                                           uint32_t* stage, int s) {
  int* flags = reinterpret_cast<int*>(stage);
  bool d = false;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const int4 e0 = R.ent[2 * j], e1 = R.ent[2 * j + 1];
    const int fl = back_rule(t, R, s, j, e0, e1, stage + e1.z);
    flags[j - lo] = fl;
    d |= fl != 0;
  }
  if (!__syncthreads_or(d)) return false;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const int fl = flags[j - lo];
    if (fl) back_write(t, s, R.ent[2 * j].w, fl, stage + R.ent[2 * j + 1].z);
  }
  return true;
}

// A block takes a state at a time (grid-stride), the round's entries by
// back_block. SMEM: the staging is the block's dynamic shared memory,
// else its part of a global buffer.
template <bool SMEM>
__global__ void __launch_bounds__(256)
back_kernel(Tabs t, BackEntries R, uint32_t* gstage, int stage_words, int32_t* changed) {
  extern __shared__ uint4 smem_stage[];
  uint32_t* stage =
      SMEM ? reinterpret_cast<uint32_t*>(smem_stage) : gstage + (size_t)blockIdx.x * stage_words;
  bool any = false;
  for (int s = blockIdx.x; s < t.S; s += gridDim.x) any |= back_block(t, R, 0, R.n, stage, s);
  if (any && changed && threadIdx.x == 0) *changed = 1;
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
// seeds, pin asserted roots TRUE; seed and assertion slots by JAX's
// mode="drop" rule (seed_row: a negative slot wraps once, one still
// outside the table is dropped). Ends with a barrier.
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
    const int r = seed_row(in.seed_idx[(size_t)s * in.V + v], t.T);
    if (r < 0) continue;
    stw(t.lo + t.row(s, r), ldw(in.seed_lo + ((size_t)s * in.V + v) * 8));
    stw(t.hi + t.row(s, r), ldw(in.seed_hi + ((size_t)s * in.V + v) * 8));
  }
  __syncthreads();
  for (int a = threadIdx.x; a < in.A; a += blockDim.x) {
    const int r = seed_row(in.aidx[(size_t)s * in.A + a], t.T);
    if (!in.amask[(size_t)s * in.A + a] || r < 0) continue;
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
      int r = aidx[(size_t)s * A + a];  // JAX's gather: wrap once, clamp
      r = clampi(r < 0 ? r + t.T : r, 0, t.T - 1);
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
// device function, for one system: fwd_node over each level's nodes of
// the kernel layout, exchange_row, back_block over each round's
// entries). No grid-wide sync is needed: every
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
// system's tables once per sweep it ran. The backward rounds stage in
// the block's own part of a global buffer (L1/L2 resident), each round
// as K7 lays it out, and so does a level that reads a row it writes
// (fwd_block, as K6's staged launch; fixpoint_kernel<true>, launched
// only for a plan that has one); the other levels run in place.

struct Passes {
  int L;
  const int32_t* loff;  // L+1 node offsets of the levels
  const int32_t* lhaz;  // L: 1 where a level reads a row it writes
  FwdNodes lv;          // the levels' kernel layout, concatenated
  int R;
  const int32_t* roff;  // R+1 entry offsets of the rounds, run order
  BackEntries rd;       // the rounds' kernel layout, concatenated (n unused)
};

// HAZ: the plan has a level that reads a row it writes (Passes.lhaz),
// which this instance stages (fwd_block); the other instance, for every
// other plan, is the in-place kernel alone, so the staged code does not
// set its registers.
template <bool HAZ>
__global__ void __launch_bounds__(128)
fixpoint_kernel(Tabs t, Passes P, Init in, const uint8_t* numeric, const uint8_t* isbool,
                int cap, uint32_t* stage, int stage_w, uint8_t* ok, uint8_t* contra,
                int32_t* sweeps) {
  uint32_t* slot = stage + (size_t)blockIdx.x * stage_w;
  for (int s = blockIdx.x; s < t.S; s += gridDim.x) {
    init_state(t, in, s);
    int n = 0;
    while (n < cap) {
      bool diff = false;
      for (int l = 0; l < P.L; ++l) {
        if (HAZ && P.lhaz[l]) {
          diff |= fwd_block(t, P.lv, P.loff[l], P.loff[l + 1], slot, s);
        } else {
          for (int j = P.loff[l] + threadIdx.x; j < P.loff[l + 1]; j += blockDim.x)
            diff |= fwd_node<-1>(t, P.lv, s, j);
        }
        __syncthreads();
      }
      for (int r = threadIdx.x; r < t.T; r += blockDim.x) diff |= exchange_row(t, numeric, s, r);
      __syncthreads();
      for (int q = 0; q < P.R; ++q) {
        if (back_block(t, P.rd, P.roff[q], P.roff[q + 1], slot, s)) {
          diff = true;
          __syncthreads();  // the next pass reads the rows stored
        }
      }
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

// K5. ent, mask, aux: the layout (IvLayout); init_lo, init_hi: the init
// tables it reads its static rows from (null where it has none);
// seed_idx, seed_lo, seed_hi, V: the seeds to scatter first (null and 0
// for none); L levels, host arrays: counts (L x 3, each level's entries
// of op classes 0, 1, 2, in that order in the layout) and hazard (1 for a
// level that reads a row it writes); threads, blocks: the staged block
// and grid (ops/intervals.iv_launch_shape; blocks no more than
// interval_levels_blocks gives); stage: blocks x stage_w words, or null
// where no level is staged. Launches: the seeds (a thread a state), then
// a launch a level and class present, or one staged launch a level;
// *launched gets the kernels it launched.
MTT_EXPORT int interval_levels(void* lo, void* hi, int S, int T, const void* ent,
                               const void* mask, const void* aux, const void* init_lo,
                               const void* init_hi, const void* seed_idx, const void* seed_lo,
                               const void* seed_hi, int V, int L, const int* counts,
                               const int* hazard, int threads, int blocks, void* stage,
                               int stage_w, int* launched, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, nullptr, nullptr, S, T};
  IvLayout lay{(const int4*)ent,         (const uint32_t*)mask,     (const uint32_t*)aux,
               (const uint32_t*)init_lo, (const uint32_t*)init_hi, (const int32_t*)seed_idx,
               (const uint32_t*)seed_lo, (const uint32_t*)seed_hi, V};
  cudaStream_t st = (cudaStream_t)stream;
  *launched = 0;
  if (S <= 0 || T <= 0) return 0;
  if (seed_idx != nullptr && V > 0) {
    iv_seed_kernel<<<grid_for(S, 128), 128, 0, st>>>(t, lay);
    ++*launched;
  }
  int base = 0;
  for (int l = 0; l < L; ++l) {
    const int* c = counts + 3 * l;
    if (hazard[l]) {
      const int n = c[0] + c[1] + c[2];
      if (threads < 32 || threads > 256 || blocks <= 0 || stage == nullptr ||
          stage_w < 16 * n)
        return (int)cudaErrorInvalidValue;
      iv_staged_kernel<<<blocks, threads, 0, st>>>(t, lay, base, n, (uint32_t*)stage, stage_w);
      ++*launched;
      base += n;
      continue;
    }
    for (int k = 0; k < 3; ++k) {
      if (c[k] <= 0) continue;
      const unsigned g = grid_for((long long)c[k] * S, 128);
      if (k == 0) iv_level_kernel<0><<<g, 128, 0, st>>>(t, lay, base, c[k]);
      else if (k == 1) iv_level_kernel<1><<<g, 128, 0, st>>>(t, lay, base, c[k]);
      else iv_level_kernel<2><<<g, 128, 0, st>>>(t, lay, base, c[k]);
      ++*launched;
      base += c[k];
    }
  }
  return (int)cudaGetLastError();
}

// blocks of K5's staged kernel, of threads threads, resident at once on
// the current device (the most its grid takes)
MTT_EXPORT int interval_levels_blocks(int threads) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, iv_staged_kernel, threads, 0);
  return sms * (per > 0 ? per : 1);
}

// K6. ent, mask, aux: the level's kernel layout (FwdNodes); counts: the
// nodes of op classes 0, 1, 2, in that order in the layout. One launch
// a class that has nodes; for a level that reads a row it writes
// (stage_words > 0: its staging a block), one staged launch of threads
// and blocks (prop_fwd_shape's block and grid), staging in shared
// memory where gstage is null, else in gstage (blocks x stage_words
// words).
MTT_EXPORT int prop_fwd_level(void* lo, void* hi, void* k0, void* k1, int S, int T,
                              const void* ent, const void* mask, const void* aux, int n0,
                              int n1, int n2, int stage_words, int threads, int blocks,
                              void* gstage, void* changed, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  FwdNodes L{(const int4*)ent, (const uint32_t*)mask, (const uint32_t*)aux};
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* ch = (int32_t*)changed;
  const int n = n0 + n1 + n2;
  if (stage_words > 0) {
    if (threads < 32 || threads > 256 || stage_words < 32 * n)
      return (int)cudaErrorInvalidValue;
    if (S > 0 && n > 0 && blocks > 0) {
      if (gstage == nullptr)
        fwd_staged_kernel<true><<<blocks, threads, 4 * (size_t)stage_words, st>>>(
            t, L, n, nullptr, stage_words, ch);
      else
        fwd_staged_kernel<false><<<blocks, threads, 0, st>>>(t, L, n, (uint32_t*)gstage,
                                                              stage_words, ch);
    }
    return (int)cudaGetLastError();
  }
  if (n0 > 0 && S > 0)
    fwd_kernel<0><<<grid_for((long long)n0 * S, 128), 128, 0, st>>>(t, L, 0, n0, ch);
  if (n1 > 0 && S > 0)
    fwd_kernel<1><<<grid_for((long long)n1 * S, 128), 128, 0, st>>>(t, L, n0, n1, ch);
  if (n2 > 0 && S > 0)
    fwd_kernel<2><<<grid_for((long long)n2 * S, 128), 128, 0, st>>>(t, L, n0 + n1, n2, ch);
  return (int)cudaGetLastError();
}

// K6's op class of op (fwd_class), for the layout builder to order a
// level's nodes by
MTT_EXPORT int prop_fwd_class(int op) { return fwd_class(op); }

// K5: what its transfer of op reads (iv_reads)
MTT_EXPORT int interval_reads(int op) { return iv_reads(op); }

// dynamic shared memory a block of K7 may take (the opt-in maximum)
static int back_smem_max() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// The launch shape of a staged kernel (SK: its shared-memory instance,
// GK: its global one) for stage_words staging words and blocks of
// threads: out[0] the blocks resident at once (the grid), out[1] 1 where
// the staging fits a block's shared memory, else 0 (it then stages in a
// global buffer of out[0] x stage_words words).
template <typename Kernel>
static int staged_shape(Kernel SK, Kernel GK, int threads, int stage_words, int* out) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long bytes = 4LL * stage_words;
  const int cap = back_smem_max(), smem = bytes <= cap;
  if (smem) {
    // the cap every launch may then take (an attribute of the kernel,
    // not of a launch)
    cudaFuncSetAttribute(SK, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, SK, threads, (size_t)bytes);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, GK, threads, 0);
  }
  out[0] = sms * (per > 0 ? per : 1);
  out[1] = smem;
  return (int)cudaGetLastError();
}

// K7's launch shape for a round (staged_shape). Called for every round
// before its first launch (ops/propagate.kernel_layout).
MTT_EXPORT int prop_back_shape(int threads, int stage_words, int* out) {
  return staged_shape(back_kernel<true>, back_kernel<false>, threads, stage_words, out);
}

// K6's launch shape for a level that reads a row it writes
// (staged_shape), called for each such level before its first launch
MTT_EXPORT int prop_fwd_shape(int threads, int stage_words, int* out) {
  return staged_shape(fwd_staged_kernel<true>, fwd_staged_kernel<false>, threads, stage_words,
                      out);
}

// K7. ent, pmask, paux, n: the round's kernel layout (BackEntries);
// stage_words: its staging a block; threads, blocks: prop_back_shape's
// block and grid; gstage: null to stage in shared memory, else a buffer
// of blocks x stage_words words.
MTT_EXPORT int prop_back_round(void* lo, void* hi, void* k0, void* k1, int S, int T,
                               const void* ent, const void* pmask, const void* paux, int n,
                               int stage_words, int threads, int blocks, void* gstage,
                               void* changed, void* stream) {
  Tabs t{(uint32_t*)lo, (uint32_t*)hi, (uint32_t*)k0, (uint32_t*)k1, S, T};
  BackEntries R{(const int4*)ent, (const uint32_t*)pmask, (const uint32_t*)paux, n};
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 0 && n > 0 && blocks > 0) {
    if (gstage == nullptr) {
      back_kernel<true><<<blocks, threads, 4 * (size_t)stage_words, st>>>(
          t, R, nullptr, stage_words, (int32_t*)changed);
    } else {
      back_kernel<false><<<blocks, threads, 0, st>>>(t, R, (uint32_t*)gstage, stage_words,
                                                     (int32_t*)changed);
    }
  }
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

// K11. tabs: the four (S, T, 8) tables, written whole; lv: ent, mask,
// aux of every level's kernel layout (FwdNodes), concatenated; rd: ent,
// pmask, paux of every round's (BackEntries) in run order (levels from
// the last, each level's rounds in order), concatenated; loff, roff:
// device offsets (L+1, R+1) of each level and round; lhaz: device
// flags (L), 1 for a level that reads a row it writes, read where haz
// (some level is flagged: the staging instance); init: init_lo,
// init_hi, init_k0, init_k1, seed_idx, seed_lo, seed_hi, assert_idx,
// assert_mask. stage: blocks x stage_w words (stage_w a multiple of 4,
// at least the largest staging of a round or of a flagged level, 32
// words a node); blocks: the grid
// (prop_fixpoint_blocks gives the count resident at once). Writes ok,
// contra and each system's sweep count.
MTT_EXPORT int prop_fixpoint(void** tabs, int S, int T, void** lv, const void* loff,
                             const void* lhaz, int haz, int L, void** rd, const void* roff, int R,
                             void** init, int V, int A, const void* numeric,
                             const void* isbool, int cap, void* stage,
                             int stage_w, int blocks, void* ok, void* contra, void* sweeps,
                             void* stream) {
  Tabs t{(uint32_t*)tabs[0], (uint32_t*)tabs[1], (uint32_t*)tabs[2], (uint32_t*)tabs[3],
         S, T};
  Passes P;
  P.L = L;
  P.loff = (const int32_t*)loff;
  P.lhaz = (const int32_t*)lhaz;
  P.lv = FwdNodes{(const int4*)lv[0], (const uint32_t*)lv[1], (const uint32_t*)lv[2]};
  P.R = R;
  P.roff = (const int32_t*)roff;
  P.rd = BackEntries{(const int4*)rd[0], (const uint32_t*)rd[1], (const uint32_t*)rd[2], 0};
  Init in = make_init(init[0], init[1], init[2], init[3], init[4], init[5], init[6], V,
                      init[7], init[8], A);
  if (S > 0 && T > 0 && blocks > 0) {
    auto kernel = haz ? fixpoint_kernel<true> : fixpoint_kernel<false>;
    kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        t, P, in, (const uint8_t*)numeric, (const uint8_t*)isbool, cap, (uint32_t*)stage,
        stage_w, (uint8_t*)ok, (uint8_t*)contra, (int32_t*)sweeps);
  }
  return (int)cudaGetLastError();
}

// blocks of K11 resident at once on the current device (its grid); haz:
// the instance for a plan with a flagged level
MTT_EXPORT int prop_fixpoint_blocks(int haz) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, haz ? fixpoint_kernel<true> : fixpoint_kernel<false>, 128, 0);
  return sms * (per > 0 ? per : 1);
}
