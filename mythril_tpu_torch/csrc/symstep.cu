// K1: the symbolic lane step, sym_step + its fork phase, looped by
// sym_run.
//
// Replaces mythril_tpu/ops/symstep.py:419 sym_step with :1264
// _do_forks, looped by :1332 sym_run / :1382 sym_run_jit. The JAX step
// evaluates every op family over the whole batch and selects per lane;
// here one thread runs one lane and computes only what its own opcode
// needs (per lane the JAX lax.cond gates change nothing, so the result
// is the same). As the JAX while_loop runs a window's steps as one
// program, one cooperative launch (k_sym_run) runs the steps of one
// read window: a persistent grid whose blocks must all be resident
// (cudaLaunchCooperativeKernel; sym_run_shape sizes it from the
// occupancy and refuses a card without cooperative launch). Its blocks
// of 256 threads hold 32-256 lanes each (their first threads), so the
// lanes spread over every SM while all the threads copy fork rows;
// where the batch needs more blocks than fit at once, each thread holds
// a lane in each of several rounds (round j: lane j * lanes held a
// round + the block's). A step:
//   decide  each lane's decisions up to park0, computed once: its fork
//           request, the block's request count (per round), the
//           visited bitmap; a thread of one lane keeps them in
//           registers, else the block stages each round's in shared
//           memory and writes them out as one coalesced run of its
//           scratch;                     --- grid barrier
//   budget  every block sums the counts (fork order is the lane order
//           of requests, as JAX's cumsum: a block's rank is the counts
//           of the blocks and rounds before it plus its ballot rank,
//           never a racing atomic) and fixes the step's fork budget;
//   exec    each lane executes; forking parents write their fork table
//           row and stash what the child needs; the block's lanes still
//           RUNNING are added to the next count;   --- grid barrier
//   forks   a warp a fork copies the parent's post-step row into the
//           child slot (one pass over a table of the planes, the widest
//           word each row allows, four words in flight a thread); block
//           0 bumps the step counters;  --- grid barrier, when a lane
//           forked.
// A grid of one block (up to 256 lanes: the corpus' 64) has
// __syncthreads as its barrier. The running count lives in a ring of
// three ints (step t reads slot t % 3, adds to the next, zeroes the one
// after): a step that finds it 0 ends the launch, so the host may enqueue
// a window of steps between reads of the count and still stop at
// exactly the step the JAX while_loop stops at.
//
// Row 2p, the packed arena (mythril_tpu/ops/symstep.py:453-467, used at
// :546-556, :1084-1095, :1199-1216): with seg_of/seg_tab set, lane pcs
// are arena pcs and each lane resolves its own member's [base, size] row
// once a step (seg_row, from the clamped pc decide() computes and
// exec_lane reuses through Dec): jump bounds and CODESIZE are the member's size,
// PC pushes pc - base, jumps take dest + base, and fentry and the fork
// log keep the member-local dest. Null tables give exactly the plain
// path (base 0, size code_size). The two table reads add 12 bytes a
// lane a step.
//
// Bound: bytes. A step reads each running lane's operands, its opcode
// row and whatever window its op touches (32 memory/kind bytes, the
// MR overlay records, the S storage keys), and writes a few words; a
// fork copies the whole ~25 KB row. A lane's step is a chain of
// dependent loads and 256-bit arithmetic in one thread, so at these
// batch sizes latency, not bandwidth, bounds it: the design removes the
// launches and the second decide, and spreads the lanes over the SMs.
//
// K0 sym_init replaces mythril_tpu/ops/symstep.py:250
// _init_sym_lanes_dev: every plane of a fresh batch written in place
// (zeros, status DEAD, fentry/last_jump -1, the gas limit, the free-slot
// stack n-1..0). One launch, a block per 64 KB of a plane, 16-byte
// stores.
// Bound: bytes (each plane written once, nothing read).
#include <algorithm>
#include <cstddef>

#include <cooperative_groups.h>

#include "common.cuh"
#include "bv256.cuh"

namespace cg = cooperative_groups;

using bv::W;

namespace {

// opcode bytes
constexpr int OP_ADD = 0x01, OP_MUL = 0x02, OP_SUB = 0x03, OP_EXP = 0x0A,
              OP_SHA3 = 0x20, OP_BALANCE = 0x31, OP_CALLDATALOAD = 0x35,
              OP_CALLDATASIZE = 0x36, OP_MLOAD = 0x51, OP_MSTORE = 0x52,
              OP_MSTORE8 = 0x53, OP_SLOAD = 0x54, OP_SSTORE = 0x55,
              OP_JUMP = 0x56, OP_JUMPI = 0x57, OP_GAS = 0x5A,
              OP_JUMPDEST = 0x5B;
constexpr int RUNNING = 0, NEEDS_HOST = 5;
constexpr int KIND_BYTE_INT = 1, KIND_CONC_WORD = 2, KIND_SYM_WORD = 3;
constexpr int REC_SLOAD_RW = 0x154;
constexpr int GASLIMIT_SLOT = 9;
constexpr int CODE_COLS = 14;
constexpr uint32_t PROBE_LO = 0x847e6e1bu, PROBE_HI = 0x4bu;  // ARB_PROBE_SLOT
// result classes (ops/stepper.RESULT_CLASSES)
enum {
  RC_ZERO, RC_ADD, RC_MUL, RC_SUB, RC_DIV, RC_SDIV, RC_MOD, RC_SMOD,
  RC_ADDMOD, RC_MULMOD, RC_EXP, RC_SIGNEXTEND, RC_LT, RC_GT, RC_SLT, RC_SGT,
  RC_EQ, RC_ISZERO, RC_AND, RC_OR, RC_XOR, RC_NOT, RC_BYTE, RC_SHL, RC_SHR,
  RC_SAR, RC_MLOAD, RC_SLOAD, RC_PC, RC_MSIZE, RC_GAS, RC_CALLDATALOAD,
  RC_CALLDATASIZE, RC_CODESIZE, RC_ENV, RC_PUSH, RC_DUP
};
// op table columns (ops/symstep.op_table)
enum { T_NPOP, T_NPUSH, T_GMIN, T_GMAX, T_DEFER, T_RCLASS, T_ENV, T_EXEC, T_TAINT, T_COLS };

// user-assertions 0xcafe... pattern: value >> 4*(nd-60) == pattern for a
// value of nd hex digits, 60 <= nd <= 64 (symstep.MSTORE_PAT_*)
__device__ __forceinline__ bool cafe_pattern(const W& v, int nbits) {
  int nd = (nbits + 3) / 4;
  if (nd < 60) return false;
  int s = (nd - 60) * 4;  // low s bits are free
  // expected word: (cafe*15) << s, compared above bit s
  const uint32_t pat[8] = {0xcafecafeu, 0xcafecafeu, 0xcafecafeu, 0xcafecafeu,
                           0xcafecafeu, 0xcafecafeu, 0xcafecafeu, 0x0000cafeu};
  W expect;
#pragma unroll
  for (int i = 0; i < 8; ++i) expect.l[i] = pat[i];
  W sh = bv::from_u32((uint32_t)s);
  expect = bv::shl(expect, sh);
  W mask;
#pragma unroll
  for (int i = 0; i < 8; ++i) mask.l[i] = 0xFFFFFFFFu;
  mask = bv::shl(mask, sh);
  return bv::eq(bv::band(v, mask), expect);
}

__device__ __forceinline__ int nbits(const W& x) {
  for (int i = 7; i >= 0; --i)
    if (x.l[i]) return 32 * i + (32 - __clz(x.l[i]));
  return 0;
}

__device__ __forceinline__ uint32_t mem_fee(uint32_t old_bytes, uint32_t new_bytes) {
  uint32_t ow = old_bytes / 32u, nw = new_bytes / 32u;
  uint32_t of = ow * 3u + (ow * ow) / 512u;
  uint32_t nf = nw * 3u + (nw * nw) / 512u;
  return nf - of;
}

struct Env {
  Sym s;
  const int32_t* code;  // (L+1, 14)
  int code_size;
  const int32_t* optab;  // (256, T_COLS)
  // packed arena (ops/stepper.compile_packed_code): arena pc -> member
  // (seg_of_len entries) and the member's [base, size] rows; both null
  // for single-contract code
  const int32_t* seg_of;
  int seg_of_len;
  const int32_t* seg_tab;
  int seg_rows;
};

__device__ __forceinline__ int code_at(const Env& e, int pc, int col) {
  return e.code[(size_t)pc * CODE_COLS + col];
}

// The member segment of the lane at clamped pc pc_c: its arena base and
// its code size (row 2p, mythril_tpu/ops/symstep.py:453-467). Plain code
// is one segment at base 0 of size code_size.
struct Seg {
  int base, size;
};

__device__ __forceinline__ Seg seg_row(const Env& e, int pc_c) {
  Seg g{0, e.code_size};
  if (e.seg_tab) {
    int sg = e.seg_of[clampi(pc_c, 0, e.seg_of_len - 1)];
    const int32_t* r = e.seg_tab + 2 * clampi(sg, 0, e.seg_rows - 1);
    g.base = r[0];
    g.size = r[1];
  }
  return g;
}

__device__ __forceinline__ W stack_at(const Sym& s, int lane, int idx) {
  return bv::load(s.stack + ((size_t)lane * s.D + idx) * 8);
}

// the 32-byte window at woff: big-endian word of its bytes (indices
// clipped to the plane, zero past its end when `mask_end`), and the kind
// summary
struct Win {
  W val;
  bool any_sym, all_sym;
  uint32_t klo, khi;
};

__device__ __forceinline__ Win read_window(const Sym& s, int lane, int woff, bool mask_end) {
  Win w;
  w.any_sym = false;
  w.all_sym = true;
  w.klo = w.khi = 0;
  w.val = bv::zero();
  const uint8_t* mem = s.memory + (size_t)lane * s.M;
  const uint8_t* kind = s.mkind + (size_t)lane * s.M;
  for (int j = 0; j < 32; ++j) {
    int bi = woff + j;
    int bc = clampi(bi, 0, s.M - 1);
    uint32_t k = kind[bc];
    bool sym = k == KIND_SYM_WORD;
    w.any_sym |= sym;
    w.all_sym &= sym;
    if (j < 16) w.klo |= k << (2 * j);
    else w.khi |= k << (2 * (j - 16));
    uint32_t byte = (!mask_end || bi < s.M) ? mem[bc] : 0u;
    int limb = 7 - (j >> 2);
    w.val.l[limb] |= byte << (8 * (3 - (j & 3)));
  }
  return w;
}

// (exact, sid) of the last overlay record overlapping [woff, woff+32)
__device__ __forceinline__ bool overlay_exact(const Sym& s, int lane, int woff, int* sid) {
  const int32_t* off = s.mlog_off + (size_t)lane * s.MR;
  const int32_t* len = s.mlog_len + (size_t)lane * s.MR;
  int cnt = s.mlog_count[lane];
  int last = -1;
  for (int r = 0; r < s.MR; ++r) {
    if (r < cnt && off[r] < woff + 32 && off[r] + len[r] > woff) last = r;
  }
  int lc = clampi(last, 0, s.MR - 1);
  bool exact = last >= 0 && off[lc] == woff && len[lc] == 32;
  *sid = exact ? s.mlog_sid[(size_t)lane * s.MR + lc] : 0;
  return exact;
}

// everything sym_step decides before the fork phase (16-byte aligned:
// a block moves its lanes' decisions to and from its scratch in 16-byte
// words)
struct __align__(16) Dec {
  bool running;
  int op, npop, npush, rclass;
  bool is_dup, is_swap;
  int dup_n, swap_n;
  W a, b, c;
  int sid_a, sid_b, sid_c;
  bool sym_a, sym_b, any_sym;
  int mem_off, acc_len;
  bool mem_ops, sym_store_val;
  uint32_t new_msize, gmin, gmax;
  // the lane's member segment; dest is member-local (what the program
  // pushed, recorded in fentry and the fork log), dest_eff the arena pc
  // control flow takes
  int seg_base, seg_size;
  int dest, dest_eff;
  bool dest_ok, jumpi_taken;
  // MLOAD
  int mload_sid;
  // SHA3
  bool sha3_defer, sha3_two;
  int sha3_len;
  int s3_sid0, s3_sid1;
  W s3_val0, s3_val1;
  uint32_t s3_k0lo, s3_k0hi, s3_k1lo, s3_k1hi;
  // storage
  bool s_found, mode_on_now, mode_eff, sload_rw, sload_miss, sload_miss_sym;
  int s_idx;
  // calldata
  bool cd_symbolic;
  int cd_off;
  // outcome
  bool defer, sstore_rec_want, park0, fork_req;
};

__device__ void decide(const Env& e, int lane, Dec& d) {
  const Sym& s = e.s;
  d.running = s.status[lane] == RUNNING;
  int pc = s.pc[lane];
  int pc_c = clampi(pc, 0, e.code_size);
  Seg g = seg_row(e, pc_c);
  d.seg_base = g.base;
  d.seg_size = g.size;
  int op = d.running ? code_at(e, pc_c, 0) : OP_JUMPDEST;
  d.op = op;
  const int32_t* t = e.optab + op * T_COLS;
  d.npop = t[T_NPOP];
  d.npush = t[T_NPUSH];
  d.rclass = t[T_RCLASS];
  d.is_dup = op >= 0x80 && op <= 0x8F;
  d.is_swap = op >= 0x90 && op <= 0x9F;
  d.dup_n = d.is_dup ? op - 0x7F : 1;
  d.swap_n = d.is_swap ? op - 0x8F : 1;
  int eff_pop = d.is_dup ? d.dup_n : (d.is_swap ? d.swap_n + 1 : d.npop);
  int sp = s.sp[lane];
  bool underflow = sp < eff_pop;
  bool overflow = (sp - d.npop + d.npush) > s.D;

  int ia = clampi(sp - 1, 0, s.D - 1), ib = clampi(sp - 2, 0, s.D - 1),
      ic = clampi(sp - 3, 0, s.D - 1);
  d.a = stack_at(s, lane, ia);
  d.b = stack_at(s, lane, ib);
  d.c = stack_at(s, lane, ic);
  const int32_t* ssid = s.ssid + (size_t)lane * s.D;
  d.sid_a = ssid[ia];
  d.sid_b = ssid[ib];
  d.sid_c = ssid[ic];
  d.sym_a = d.sid_a != 0;
  d.sym_b = d.sid_b != 0;
  bool sym_c = d.sid_c != 0;
  d.any_sym = (d.npop >= 1 && d.sym_a) || (d.npop >= 2 && d.sym_b) || (d.npop >= 3 && sym_c);

  bool is_mload = op == OP_MLOAD, is_mstore = op == OP_MSTORE,
       is_mstore8 = op == OP_MSTORE8, is_sload = op == OP_SLOAD,
       is_sstore = op == OP_SSTORE, is_cdl = op == OP_CALLDATALOAD,
       is_jump = op == OP_JUMP, is_jumpi = op == OP_JUMPI, is_exp = op == OP_EXP,
       is_sha3 = op == OP_SHA3, is_balance = op == OP_BALANCE;

  auto hi_of = [](const W& w) {
    uint32_t h = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i) h |= w.l[i];
    return h != 0;
  };
  bool a_hi = hi_of(d.a), b_hi = hi_of(d.b);

  // ---- memory offsets / fees
  bool sha3_lenok = is_sha3 && !d.sym_b && !b_hi && (d.b.l[0] == 32u || d.b.l[0] == 64u);
  d.sha3_len = sha3_lenok ? (int)d.b.l[0] : 32;
  bool mem_big = a_hi || d.a.l[0] >= (1u << 30);
  d.mem_off = mem_big ? 0 : (int)d.a.l[0];
  d.mem_ops = is_mload || is_mstore || is_mstore8 || sha3_lenok;
  d.acc_len = is_mstore8 ? 1 : (is_sha3 ? d.sha3_len : 32);
  int mem_end = d.mem_off + d.acc_len;
  bool mem_oob = d.mem_ops && !d.sym_a && (mem_big || mem_end > s.M);
  int msize = s.msize[lane];
  int nm = msize;
  if (d.mem_ops && !d.sym_a && !mem_oob) nm = max(msize, ((mem_end + 31) / 32) * 32);
  d.new_msize = (uint32_t)nm;
  uint32_t fee = mem_fee((uint32_t)msize, (uint32_t)nm);

  // ---- jump destination
  // a destination at or past the member's size is invalid even where
  // dest + base is another member's JUMPDEST
  bool dest_small = !a_hi && d.a.l[0] < (uint32_t)d.seg_size;
  d.dest = dest_small ? (int)d.a.l[0] : 0;
  d.dest_eff = dest_small ? d.dest + d.seg_base : 0;
  d.dest_ok = dest_small && code_at(e, clampi(d.dest_eff, 0, e.code_size), 2) != 0;
  d.jumpi_taken = !d.sym_b && !bv::is_zero(d.b);

  int popc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) popc += __popc(d.a.l[i]);
  bool exp_pure = !d.sym_a && popc <= 1;

  // ---- drain-side taint support
  bool is_add = op == OP_ADD, is_sub = op == OP_SUB, is_mul = op == OP_MUL;
  bool taint_op = t[T_TAINT] != 0;
  bool wrap_cand = d.running && !d.any_sym && taint_op &&
                   (is_add || is_sub || is_mul || (is_exp && exp_pure));
  bool wrap_rec = false;
  if (wrap_cand) {
    int nb_a = nbits(d.a), nb_b = nbits(d.b);
    bool w_add = is_add && bv::ult(bv::add(d.a, d.b), d.a);
    bool w_sub = is_sub && bv::ult(d.a, d.b);
    bool w_mul = false;
    if (is_mul && nb_a + nb_b >= 257) {
      W lo, hi;
      bv::mul_full(d.a, d.b, lo, hi);
      w_mul = !bv::is_zero(hi);
    }
    int m_exp = nb_a - 1;
    int e0 = (int)min(d.b.l[0], 1u << 20);
    bool w_exp = is_exp && exp_pure && popc == 1 && m_exp >= 1 && (b_hi || m_exp * e0 >= 256);
    wrap_rec = w_add || w_sub || w_mul || w_exp;
  }
  // the ArbitraryStorage probe slot (support/eth_constants.py)
  bool key_is_probe = d.a.l[0] == PROBE_LO && d.a.l[1] == PROBE_HI;
#pragma unroll
  for (int i = 2; i < 8; ++i) key_is_probe &= d.a.l[i] == 0u;
  bool sink_want = is_sstore && taint_op && (d.sid_b != 0 || key_is_probe);
  bool mstore_pat_park = false;
  if (d.running && is_mstore && !d.sym_b && taint_op) mstore_pat_park = cafe_pattern(d.b, nbits(d.b));

  // ---- MLOAD overlay decisions
  d.sym_store_val = is_mstore && d.sym_b;
  bool mload_park = false;
  d.mload_sid = 0;
  if (is_mload) {
    Win w = read_window(s, lane, d.mem_off, false);
    int hs;
    bool hit = overlay_exact(s, lane, d.mem_off, &hs);
    bool exact = w.all_sym && hit;
    d.mload_sid = exact ? hs : 0;
    mload_park = !d.sym_a && !mem_oob && !(exact || !w.any_sym);
  }
  bool mlog_full = d.sym_store_val && s.mlog_count[lane] >= s.MR;

  // ---- SHA3 word reads
  bool sha3_cand = d.running && sha3_lenok && !d.sym_a && !mem_oob && !mem_big;
  d.sha3_two = d.sha3_len == 64;
  d.sha3_defer = false;
  d.s3_sid0 = d.s3_sid1 = 0;
  d.s3_val0 = d.s3_val1 = bv::zero();
  d.s3_k0lo = d.s3_k0hi = d.s3_k1lo = d.s3_k1hi = 0;
  if (sha3_cand) {
    bool ok01[2];
    for (int wi = 0; wi < 2; ++wi) {
      int woff = d.mem_off + 32 * wi;
      Win w = read_window(s, lane, woff, true);
      int hs;
      bool hit = overlay_exact(s, lane, woff, &hs);
      bool exact = w.all_sym && hit;
      ok01[wi] = exact || !w.any_sym;
      int sid = exact ? hs : 0;
      W val = exact ? bv::zero() : w.val;
      uint32_t klo = exact ? 0xFFFFFFFFu : w.klo, khi = exact ? 0xFFFFFFFFu : w.khi;
      if (wi == 0) { d.s3_sid0 = sid; d.s3_val0 = val; d.s3_k0lo = klo; d.s3_k0hi = khi; }
      else { d.s3_sid1 = sid; d.s3_val1 = val; d.s3_k1lo = klo; d.s3_k1hi = khi; }
    }
    d.sha3_defer = ok01[0] && (!d.sha3_two || ok01[1]);
  }

  // ---- storage decisions
  d.s_found = false;
  d.s_idx = 0;
  bool any_written = false;
  if (d.running && (is_sload || is_sstore)) {
    int cnt = s.scount[lane];
    int best = 0;
    for (int k = 0; k < s.S; ++k) {
      if (k >= cnt) break;
      size_t sk = (size_t)lane * s.S + k;
      int ksid = s.skey_sid[sk];
      bool match;
      if (d.sym_a) {
        match = ksid == d.sid_a;
      } else {
        match = ksid == 0 && bv::eq(bv::load(s.skeys + sk * 8), d.a);
      }
      if (match) best = k + 1;
      any_written |= s.s_written[sk] > 0;
    }
    d.s_found = best > 0;
    d.s_idx = clampi(best - 1, 0, s.S - 1);
  }
  bool sym_key_op = (is_sload || is_sstore) && d.sym_a;
  int s_mode = s.s_mode[lane];
  d.mode_on_now = sym_key_op && s_mode == 0 && !any_written;
  bool mode_park = sym_key_op && s_mode == 0 && any_written;
  d.mode_eff = s_mode != 0 || d.mode_on_now;
  d.sload_rw = is_sload && d.mode_eff;
  d.sload_miss = is_sload && !d.s_found;
  d.sload_miss_sym = d.sload_miss && !d.mode_eff && s.sbase[lane] != 0;
  bool storage_insert = (is_sstore && !d.s_found) || d.sload_miss;
  bool storage_full = storage_insert && s.scount[lane] >= s.S;

  // ---- calldata
  d.cd_symbolic = s.cd_sym[lane] != 0;
  bool cdl_defer = is_cdl && d.cd_symbolic;
  bool cd_big = a_hi || d.a.l[0] >= (1u << 30);
  d.cd_off = cd_big ? s.C : (int)d.a.l[0];
  int cd_size = s.cd_size[lane];
  bool cd_oob = is_cdl && !d.cd_symbolic && !d.sym_a && (d.cd_off < cd_size && d.cd_off + 32 > s.C);

  // ---- deferral
  bool defer = t[T_DEFER] != 0 && d.any_sym;
  defer = defer && !(is_exp && !exp_pure);
  defer = defer || cdl_defer || d.sload_miss_sym || wrap_rec || d.sha3_defer || d.sload_rw;
  d.defer = defer;
  d.sstore_rec_want = sink_want || (is_sstore && d.mode_eff);
  bool dlog_full = (defer || d.sstore_rec_want) && s.dlog_count[lane] >= s.R;

  // ---- gas
  d.gmin = (uint32_t)t[T_GMIN] + fee;
  d.gmax = (uint32_t)t[T_GMAX] + fee;
  if (d.sha3_defer) {
    uint32_t f = 30u + 6u * (uint32_t)(d.sha3_len / 32) + fee;
    d.gmin = d.gmax = f;
  }
  bool oog = s.min_gas[lane] + d.gmin > s.gas_limit[lane];

  d.park0 = t[T_EXEC] == 0 || underflow || overflow || oog || dlog_full ||
            (is_exp && !exp_pure) || (d.mem_ops && d.sym_a) || (is_mstore8 && d.sym_b) ||
            mem_oob || mload_park || mlog_full || (is_sha3 && !d.sha3_defer) ||
            (is_balance && !d.sym_a) || mode_park || storage_full ||
            (is_cdl && !d.cd_symbolic && d.sym_a) || cd_oob || mstore_pat_park ||
            (is_jump && (d.sym_a || !d.dest_ok)) ||
            (is_jumpi && !d.sym_b && d.jumpi_taken && (d.sym_a || !d.dest_ok)) ||
            (is_jumpi && d.sym_b && (d.sym_a || !d.dest_ok)) ||
            code_at(e, pc_c, 13) != 0;
  d.fork_req = d.running && is_jumpi && d.sym_b && !d.sym_a && d.dest_ok && !d.park0;
}

// ---- the block's collectives (blockDim.x a multiple of 32, at most 1024)

// the sum of v over the block; every thread of the block must call it
__device__ int block_sum(int v) {
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  if (lane == 0) sums[warp] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += sums[w];
  __syncthreads();
  return t;
}

// exclusive prefix of `flag` over the block's threads (thread order);
// every thread of the block must call it
__device__ int block_rank(int flag) {
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag != 0);
  if (lane == 0) sums[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += sums[w];
  __syncthreads();
  return before;
}

struct ForkStash {
  int32_t *parent, *child, *fall_pc, *fentry;
};

// A shard's step (ops/symstep.sym_run_mesh): the global index of its
// first lane, the global fork rank of its first request, and its fork
// stash: a column a field (ops/symstep.STASH: parent, fall-through pc,
// fentry, pc, sid, gmin, gmax, dest), a row a fork in fork order.
struct ShardStep {
  int base, off;
  int32_t* col[8];
};

// One lane's step after its decisions `d` (the fork phase's row copy
// excepted): forder is its rank among the step's fork requests in lane
// order, navail the step's fork budget; free_count, step_no and
// flog_count are the values before the step. Returns whether the lane
// is RUNNING after it.
// With SHARD the batch is a shard of a larger one (sh): provisional
// sids and the fork stash carry global lane indices, and a forking
// parent's fork-log fields go to the shard's stash, not the fork log.
template <bool SHARD = false>
__device__ bool exec_lane(const Env& e, int lane, const Dec& d, int forder, int navail,
                          int free_count, int step_no, int flog_count, const ForkStash& fs,
                          const ShardStep* sh = nullptr) {
  const Sym& s = e.s;
  const int d_recs = s.R;
  bool fork_can = d.fork_req && forder < navail;
  bool fork_stall = d.fork_req && !fork_can && forder < free_count;
  bool fork_nocap = d.fork_req && !fork_can && !fork_stall;
  bool park = d.park0 || fork_nocap;
  bool ok = d.running && !park && !fork_stall;
  bool defer = d.defer && ok;
  bool logrec = defer || (d.sstore_rec_want && ok);
  fork_can = fork_can && ok;
  bool live_alu = ok && !defer;
  const int op = d.op;
  const int pc = s.pc[lane];
  const int pc_c = clampi(pc, 0, e.code_size);
  const int sp = s.sp[lane];
  const int dcount = s.dlog_count[lane];
  const int glane = SHARD ? sh->base + lane : lane;
  const int prov_id = -(glane * d_recs + clampi(dcount, 0, d_recs - 1) + 1);
  const bool is_jump = op == OP_JUMP, is_jumpi = op == OP_JUMPI;
  const uint32_t pre_min = s.min_gas[lane], pre_max = s.max_gas[lane];
  const int pre_fentry = s.fentry[lane];

  // ---- result and its sid
  W result = bv::zero();
  int result_sid = defer ? prov_id : 0;
  uint32_t msize2 = (ok && d.mem_ops) ? d.new_msize : (uint32_t)s.msize[lane];
  if (live_alu && d.npush == 1) {
    const W& a = d.a;
    const W& b = d.b;
    switch (d.rclass) {
      case RC_ADD: result = bv::add(a, b); break;
      case RC_MUL: result = bv::mul(a, b); break;
      case RC_SUB: result = bv::sub(a, b); break;
      case RC_DIV: case RC_SDIV: case RC_MOD: case RC_SMOD:
      case RC_ADDMOD: case RC_MULMOD:  // one division core, in opcode order
        result = bv::divide(d.rclass - RC_DIV, a, b, d.c);
        break;
      case RC_EXP: result = bv::exp(a, b); break;
      case RC_SIGNEXTEND: result = bv::signextend(a, b); break;
      case RC_LT: result = bv::bool_word(bv::ult(a, b)); break;
      case RC_GT: result = bv::bool_word(bv::ult(b, a)); break;
      case RC_SLT: result = bv::bool_word(bv::slt(a, b)); break;
      case RC_SGT: result = bv::bool_word(bv::slt(b, a)); break;
      case RC_EQ: result = bv::bool_word(bv::eq(a, b)); break;
      case RC_ISZERO: result = bv::bool_word(bv::is_zero(a)); break;
      case RC_AND: result = bv::band(a, b); break;
      case RC_OR: result = bv::bor(a, b); break;
      case RC_XOR: result = bv::bxor(a, b); break;
      case RC_NOT: result = bv::bnot(a); break;
      case RC_BYTE: result = bv::byte_op(a, b); break;
      case RC_SHL: result = bv::shl(b, a); break;
      case RC_SHR: result = bv::shr(b, a); break;
      case RC_SAR: result = bv::sar(b, a); break;
      case RC_MLOAD: result = read_window(s, lane, d.mem_off, false).val; break;
      case RC_SLOAD:
        result = d.s_found ? bv::load(s.svals + ((size_t)lane * s.S + d.s_idx) * 8) : bv::zero();
        break;
      case RC_PC: result = bv::from_u32((uint32_t)(pc - d.seg_base)); break;
      case RC_MSIZE: result = bv::from_u32(msize2); break;
      case RC_GAS:
        result = bv::load(s.env + ((size_t)lane * s.NENV + GASLIMIT_SLOT) * 8);
        break;
      case RC_CALLDATALOAD: {
        const uint8_t* cd = s.calldata + (size_t)lane * s.C;
        int cds = s.cd_size[lane];
        for (int j = 0; j < 32; ++j) {
          int ci = d.cd_off + j;
          uint32_t byte = (ci < cds && ci < s.C) ? cd[clampi(ci, 0, s.C - 1)] : 0u;
          result.l[7 - (j >> 2)] |= byte << (8 * (3 - (j & 3)));
        }
        break;
      }
      case RC_CALLDATASIZE: result = bv::from_u32((uint32_t)s.cd_size[lane]); break;
      case RC_CODESIZE: result = bv::from_u32((uint32_t)d.seg_size); break;
      case RC_ENV: {
        int slot = clampi(e.optab[op * T_COLS + T_ENV], 0, s.NENV - 1);
        result = bv::load(s.env + ((size_t)lane * s.NENV + slot) * 8);
        break;
      }
      case RC_PUSH: {
        W w;
#pragma unroll
        for (int i = 0; i < 8; ++i) w.l[i] = (uint32_t)code_at(e, pc_c, 4 + i);
        result = w;
        break;
      }
      case RC_DUP: result = stack_at(s, lane, clampi(sp - d.dup_n, 0, s.D - 1)); break;
      default: break;
    }
  }
  if (!defer) {
    if (d.rclass == RC_ENV) {
      int slot = clampi(e.optab[op * T_COLS + T_ENV], 0, s.NENV - 1);
      result_sid = s.env_sid[(size_t)lane * s.NENV + slot];
    }
    if (op == OP_CALLDATASIZE) result_sid = s.cd_size_sid[lane];
    if (op == OP_GAS) result_sid = s.env_sid[(size_t)lane * s.NENV + GASLIMIT_SLOT];
    if (d.is_dup) result_sid = s.ssid[(size_t)lane * s.D + clampi(sp - d.dup_n, 0, s.D - 1)];
    if (op == OP_MLOAD) result_sid = d.mload_sid;
    if (op == OP_SLOAD && d.s_found) result_sid = s.sval_sid[(size_t)lane * s.S + d.s_idx];
  }

  // ---- memory execution
  if (ok) {
    uint8_t* mem = s.memory + (size_t)lane * s.M;
    uint8_t* kind = s.mkind + (size_t)lane * s.M;
    if (op == OP_MSTORE) {
      uint8_t kv = d.sym_b ? KIND_SYM_WORD : KIND_CONC_WORD;
      for (int j = 0; j < 32; ++j) {
        int bi = d.mem_off + j;
        if (bi >= s.M) continue;
        if (!d.sym_b) mem[bi] = (uint8_t)(d.b.l[7 - (j >> 2)] >> (8 * (3 - (j & 3))));
        kind[bi] = kv;
      }
    } else if (op == OP_MSTORE8) {
      if (d.mem_off < s.M) {
        mem[d.mem_off] = (uint8_t)(d.b.l[0] & 0xFFu);
        kind[d.mem_off] = KIND_BYTE_INT;
      }
    }
    if (d.sym_store_val) {
      int cnt = s.mlog_count[lane];
      size_t rp = (size_t)lane * s.MR + clampi(cnt, 0, s.MR - 1);
      s.mlog_off[rp] = d.mem_off;
      s.mlog_len[rp] = d.acc_len;
      s.mlog_sid[rp] = d.sid_b;
      s.mlog_count[lane] = cnt + 1;
    }
    s.msize[lane] = (int)msize2;
  }

  // ---- storage execution
  if (ok && (op == OP_SLOAD || op == OP_SSTORE)) {
    bool do_sstore = op == OP_SSTORE;
    bool do_write = do_sstore || d.sload_miss;
    int cnt = s.scount[lane];
    int pos_c = clampi(d.s_found ? d.s_idx : cnt, 0, s.S - 1);
    size_t sk = (size_t)lane * s.S + pos_c;
    int prior_written = s.s_written[sk];
    int prior_read = s.s_read[sk];
    if (do_write) {
      bv::store(s.skeys + sk * 8, d.a);
      s.skey_sid[sk] = d.sid_a;
      bv::store(s.svals + sk * 8, do_sstore ? d.b : bv::zero());
      s.sval_sid[sk] = do_sstore ? d.sid_b
                                 : ((d.sload_miss_sym || (d.sload_rw && d.sload_miss)) ? prov_id : 0);
      s.s_written[sk] = max(do_sstore ? 1 : 0, prior_written);
      if (!d.s_found) s.scount[lane] = cnt + 1;
    }
    if (do_sstore) s.s_wstep[sk] = step_no;
    if (op == OP_SLOAD) s.s_read[sk] = (prior_written > 0 ? 2 : 1) | prior_read;
  }
  if (ok && d.mode_on_now) s.s_mode[lane] = 1;

  // ---- stack updates
  int new_sp = sp - d.npop + d.npush;
  if (ok && d.npush == 1) {
    int pi = clampi(new_sp - 1, 0, s.D - 1);
    bv::store(s.stack + ((size_t)lane * s.D + pi) * 8, result);
    s.ssid[(size_t)lane * s.D + pi] = result_sid;
  }
  if (ok && d.is_swap) {
    int ti = clampi(sp - 1, 0, s.D - 1);
    int si = clampi(sp - 1 - d.swap_n, 0, s.D - 1);
    int wi = clampi(sp - (d.swap_n + 1), 0, s.D - 1);
    W swap_val = stack_at(s, lane, wi);
    int swap_sid = s.ssid[(size_t)lane * s.D + wi];
    bv::store(s.stack + ((size_t)lane * s.D + ti) * 8, swap_val);
    bv::store(s.stack + ((size_t)lane * s.D + si) * 8, d.a);
    s.ssid[(size_t)lane * s.D + ti] = swap_sid;
    s.ssid[(size_t)lane * s.D + si] = d.sid_a;
  }

  // ---- deferred-record append
  if (logrec) {
    int pos = clampi(dcount, 0, d_recs - 1);
    size_t rp = (size_t)lane * d_recs + pos;
    bool sd = d.sha3_defer;
    s.dlog_op[rp] = d.sload_rw ? REC_SLOAD_RW : op;
    s.dlog_pc[rp] = pc;
    s.dlog_step[rp] = step_no;
    s.dlog_fentry[rp] = pre_fentry;
    s.dlog_sid[rp * 3 + 0] = sd ? d.s3_sid0 : d.sid_a;
    s.dlog_sid[rp * 3 + 1] = sd ? (d.sha3_two ? d.s3_sid1 : 0) : d.sid_b;
    s.dlog_sid[rp * 3 + 2] = sd ? 0 : d.sid_c;
    W v0 = sd ? d.s3_val0 : d.a;
    W v1 = sd ? ((d.sha3_two && d.s3_sid1 == 0) ? d.s3_val1 : bv::zero()) : d.b;
    W v2 = d.c;
    if (sd) {
      v2 = bv::zero();
      v2.l[0] = (uint32_t)d.sha3_len;
      v2.l[1] = d.s3_k0lo;
      v2.l[2] = d.s3_k0hi;
      v2.l[3] = d.sha3_two ? d.s3_k1lo : 0u;
      v2.l[4] = d.sha3_two ? d.s3_k1hi : 0u;
    }
    bv::store(s.dlog_val + (rp * 3 + 0) * 8, v0);
    bv::store(s.dlog_val + (rp * 3 + 1) * 8, v1);
    bv::store(s.dlog_val + (rp * 3 + 2) * 8, v2);
    s.dlog_count[lane] = dcount + 1;
  }

  // ---- control flow, gas, status
  int next_pc = code_at(e, pc_c, 1);
  int new_pc = next_pc;
  if (is_jump) new_pc = d.dest_eff;
  if (is_jumpi && !d.sym_b && d.jumpi_taken) new_pc = d.dest_eff;
  if (fork_can) new_pc = d.dest_eff;
  if (ok && is_jumpi) s.depth[lane] += 1;
  bool jumped = ok && (is_jump || (is_jumpi && !d.sym_b && d.jumpi_taken) || fork_can);
  if (jumped && code_at(e, clampi(d.dest_eff, 0, e.code_size), 3) != 0) s.fentry[lane] = d.dest;
  if (ok) {
    s.pc[lane] = new_pc;
    s.sp[lane] = new_sp;
    s.min_gas[lane] = pre_min + d.gmin;
    s.max_gas[lane] = pre_max + d.gmax;
    s.steps[lane] += 1;
    if (is_jump) s.last_jump[lane] = pc;
  }
  if (d.running && park) s.status[lane] = NEEDS_HOST;

  // ---- fork bookkeeping: the row copy waits for the fork phase
  if constexpr (SHARD) {
    if (fork_can) {
      const int j = forder - sh->off;
      sh->col[0][j] = glane;
      sh->col[1][j] = next_pc;
      sh->col[2][j] = pre_fentry;
      sh->col[3][j] = pc;
      sh->col[4][j] = d.sid_b;
      sh->col[5][j] = (int32_t)pre_min;
      sh->col[6][j] = (int32_t)pre_max;
      sh->col[7][j] = d.dest;
    }
  } else if (fork_can) {
    int f = forder;
    int child = s.free_slots[clampi(free_count - 1 - f, 0, s.n - 1)];
    fs.parent[f] = lane;
    fs.child[f] = child;
    fs.fall_pc[f] = next_pc;  // arena pc; flog_dest below stays member-local
    fs.fentry[f] = pre_fentry;
    int row = flog_count + f;
    s.flog_parent[row] = lane;
    s.flog_child[row] = child;
    s.flog_step[row] = step_no;
    s.flog_pc[row] = pc;
    s.flog_sid[row] = d.sid_b;
    s.flog_gmin[row] = pre_min;
    s.flog_gmax[row] = pre_max;
    s.flog_fentry[row] = pre_fentry;
    s.flog_dest[row] = d.dest;
  }
  return s.status[lane] == RUNNING;
}

// The fork phase's row table: every per-lane plane a child takes from
// its parent, but pc, fentry and dlog_count, which the child gets from
// the stash (and 0). The first `scalar` planes have 4-byte rows (one
// lane of the copying warp each); the rest copy `vec` bytes at a time,
// the widest word dividing the row and the base.
constexpr int MAX_ROWS = 48;
struct Rows {
  char* base[MAX_ROWS];
  int bytes[MAX_ROWS];
  int vec[MAX_ROWS];
  int n, scalar;
};

template <typename V>
__device__ __forceinline__ void copy_words(char* base, int bytes, int src, int dst, int lane) {
  const V* a = (const V*)(base + (size_t)src * bytes);
  V* b = (V*)(base + (size_t)dst * bytes);
  const int words = bytes / (int)sizeof(V);
  int w = lane;
  // four words in flight a thread, neighbouring lanes on neighbouring words
  for (; w + 96 < words; w += 128) {
    V v0 = a[w], v1 = a[w + 32], v2 = a[w + 64], v3 = a[w + 96];
    b[w] = v0;
    b[w + 32] = v1;
    b[w + 64] = v2;
    b[w + 96] = v3;
  }
  for (; w < words; w += 32) b[w] = a[w];
}

// one warp copies lane src's row of every plane of the table to lane dst
__device__ void copy_lane(const Rows& t, int src, int dst, int lane) {
  if (lane < t.scalar) {
    int32_t* p = (int32_t*)t.base[lane];
    p[dst] = p[src];
  }
  for (int k = t.scalar; k < t.n; ++k) {
    switch (t.vec[k]) {
      case 16: copy_words<int4>(t.base[k], t.bytes[k], src, dst, lane); break;
      case 8: copy_words<int2>(t.base[k], t.bytes[k], src, dst, lane); break;
      case 4: copy_words<int>(t.base[k], t.bytes[k], src, dst, lane); break;
      case 2: copy_words<short>(t.base[k], t.bytes[k], src, dst, lane); break;
      default: copy_words<char>(t.base[k], t.bytes[k], src, dst, lane); break;
    }
  }
}

// threads a block of K1: every one copies fork rows; the first `lanes`
// hold lanes
constexpr int RUN_THREADS = 256;

// a block's run of `count` decisions between shared memory and its
// scratch, 16 bytes a thread at a time
__device__ __forceinline__ void move_decs(int4* to, const int4* from, int count) {
  const int words = count * (int)(sizeof(Dec) / 16);
  for (int i = threadIdx.x; i < words; i += RUN_THREADS) to[i] = from[i];
}

// what a window's launch needs beside the state
struct Run {
  int32_t* ctl;     // [0, 3): the running-count ring (module comment)
  int32_t* counts;  // nl * gridDim.x: each block's fork requests a round
  Dec* dec;         // the decisions of every round's lanes, a block's run
                    // of `lanes` after another's, when a thread holds
                    // several lanes; else null
  int lanes;        // lanes a block holds a round (its first threads)
  ForkStash fs;
  Rows rows;
  uint8_t* visited;
  int vis_len;
  int steps, maxf, count_first;
  // or null: SM cycles block 0 spends in decide, exec and forks (each up
  // to its barrier's exit), and the steps run
  long long* phase;
};

// K1: up to r.steps steps of the whole batch in one cooperative launch
// (the module comment has the phases and barriers).
// (__grid_constant__: the phases index the tables of e and r at run
// time without a per-thread copy of either)
__global__ void __launch_bounds__(RUN_THREADS)
k_sym_run(const __grid_constant__ Env e, const __grid_constant__ Run r) {
  cg::grid_group grid = cg::this_grid();
  const Sym& s = e.s;
  const int G = gridDim.x;
  // round j's lanes: j * GL + the block's L, one a thread of its first L
  const long long GL = (long long)G * r.lanes;
  const long long me = (long long)blockIdx.x * RUN_THREADS + threadIdx.x;
  const bool holds = (int)threadIdx.x < r.lanes;
  const long long mine0 = (long long)blockIdx.x * r.lanes + threadIdx.x;
  const int nl = (int)((s.n + GL - 1) / GL);
  const int wlane = threadIdx.x & 31;
  auto barrier = [&]() {
    if (G == 1) __syncthreads();
    else grid.sync();
  };
  if (r.count_first) {  // the first window counts the running lanes
    int c = 0;
    for (int j = 0; j < nl; ++j) {
      long long lane = j * GL + mine0;
      c += holds && lane < s.n && s.status[lane] == RUNNING;
    }
    c = block_sum(c);
    if (threadIdx.x == 0 && c) atomicAdd(r.ctl, c);
    barrier();
  }
  Dec dk;  // the decisions of the thread's lane this round
  // a round's decisions of the block's lanes, staged (r.dec set)
  extern __shared__ int4 staged_raw[];
  Dec* staged = reinterpret_cast<Dec*>(staged_raw);
  const bool timed = r.phase && me == 0;
  long long mark = 0;
  auto stamp = [&](int k) {
    if (timed) {
      long long now = clock64();
      r.phase[k] += now - mark;
      mark = now;
    }
  };
  int t = 0;
  for (; t < r.steps; ++t) {
    if (*(volatile int32_t*)(r.ctl + t % 3) == 0) break;  // uniform
    const int next = (t + 1) % 3;
    if (me == 0) r.ctl[next] = 0;
    if (timed) mark = clock64();
    // decide: each lane's decisions, once; the fork requests per block
    for (int j = 0; j < nl; ++j) {
      long long lane = j * GL + mine0;
      int f = 0;
      if (holds && lane < s.n) {
        Dec d;
        decide(e, (int)lane, d);
        f = d.fork_req;
        if (r.visited && d.running) {
          int pc = s.pc[lane];
          if (pc >= 0 && pc < r.vis_len) r.visited[pc] = 1;
        }
        if (r.dec) staged[threadIdx.x] = d;
        else dk = d;
      }
      f = block_sum(f);  // (its __syncthreads also publish `staged`)
      if (threadIdx.x == 0) r.counts[j * G + blockIdx.x] = f;
      if (r.dec) {
        move_decs((int4*)(r.dec + (j * G + blockIdx.x) * (long long)r.lanes),
                  staged_raw, r.lanes);
        __syncthreads();
      }
    }
    barrier();
    stamp(0);
    // the step's fork budget, as every block computes it
    const int free_count = *(volatile int32_t*)s.free_count;
    const int flog_count = *(volatile int32_t*)s.flog_count;
    const int step_no = *(volatile int32_t*)s.step_no;
    const int ncounts = nl * G;
    int part = 0;
    for (int i = threadIdx.x; i < ncounts; i += RUN_THREADS) part += r.counts[i];
    const int total = block_sum(part);
    const int navail = min(min(free_count, r.maxf), s.F - flog_count);
    const int nf = max(0, min(total, navail));
    // exec: fork ranks in lane order (blocks of round j after every
    // block of the rounds before it)
    int still = 0;
    for (int j = 0; j < nl; ++j) {
      long long lane = j * GL + mine0;
      const int mine = j * G + blockIdx.x;
      part = 0;
      for (int i = threadIdx.x; i < mine; i += RUN_THREADS) part += r.counts[i];
      const int off = block_sum(part);
      const bool have = holds && lane < s.n;
      if (r.dec) {
        move_decs(staged_raw,
                  (const int4*)(r.dec + (j * G + blockIdx.x) * (long long)r.lanes),
                  r.lanes);
        __syncthreads();
        if (have) dk = staged[threadIdx.x];
      }
      const int forder = off + block_rank(have && dk.fork_req);
      if (have)
        still += exec_lane(e, (int)lane, dk, forder, navail, free_count, step_no, flog_count,
                           r.fs);
    }
    still = block_sum(still);
    if (threadIdx.x == 0 && still) atomicAdd(r.ctl + next, still);
    barrier();
    stamp(1);
    // forks: a warp a fork, each child a copy of its parent's row
    if (nf > 0) {
      const long long warps = (long long)G * (RUN_THREADS / 32);
      for (long long f = me >> 5; f < nf; f += warps) {
        const int src = r.fs.parent[f], dst = r.fs.child[f];
        copy_lane(r.rows, src, dst, wlane);
        if (wlane == 0) {
          s.pc[dst] = r.fs.fall_pc[f];
          s.fentry[dst] = r.fs.fentry[f];
          s.dlog_count[dst] = 0;
        }
      }
    }
    if (me == 0) {
      *s.step_no = step_no + 1;
      *s.flog_count = flog_count + nf;
      *s.free_count = free_count - nf;
    }
    if (nf > 0) barrier();
    stamp(2);
  }
  // the running count before step t is the count the host reads
  if (me == 0 && t % 3) r.ctl[0] = *(volatile int32_t*)(r.ctl + t % 3);
  if (timed) r.phase[3] += t;
}

// K0: plane f of the batch is ip.bytes[f] bytes at ip.p[f]; its 32-bit
// words get ip.val[f] (u8 planes always 0), or with ip.desc[f] the
// descending stack len-1, ..., 0. Block b writes INIT_CHUNK bytes of
// the plane f with first[f] <= b < first[f + 1]: one launch sized to
// the bytes, so small planes cost one block each.
constexpr long long INIT_CHUNK = 65536;

struct InitPlan {
  void* p[SYM_NFIELDS];
  long long bytes[SYM_NFIELDS];
  int32_t val[SYM_NFIELDS];
  int32_t desc[SYM_NFIELDS];
  int32_t first[SYM_NFIELDS + 1];
};

__global__ void k_init(InitPlan ip) {
  int b = blockIdx.x, f = 0;
  while (f + 1 < SYM_NFIELDS && ip.first[f + 1] <= b) ++f;
  char* base = (char*)ip.p[f];
  long long lo = (long long)(b - ip.first[f]) * INIT_CHUNK;
  long long hi = min(lo + INIT_CHUNK, ip.bytes[f]);
  int32_t v = ip.val[f];
  if (ip.desc[f]) {
    long long nw = ip.bytes[f] >> 2;
    for (long long i = (lo >> 2) + threadIdx.x; i < (hi >> 2); i += blockDim.x)
      ((int32_t*)base)[i] = (int32_t)(nw - 1 - i);
    return;
  }
  // 16-byte stores where the plane is aligned, then words, then the
  // bytes of a u8 plane's tail
  long long e16 = ((uintptr_t)base & 15) == 0 ? hi >> 4 : lo >> 4;
  int4 v4 = make_int4(v, v, v, v);
  for (long long i = (lo >> 4) + threadIdx.x; i < e16; i += blockDim.x) ((int4*)base)[i] = v4;
  for (long long i = 4 * e16 + threadIdx.x; i < (hi >> 2); i += blockDim.x)
    ((int32_t*)base)[i] = v;
  for (long long i = 4 * (hi >> 2) + threadIdx.x; i < hi; i += blockDim.x) base[i] = 0;
}

}  // namespace

// K0. bytes, vals, desc: host arrays of SYM_NFIELDS entries, in field
// order (see k_init).
MTT_EXPORT int sym_init(void** planes, const long long* bytes, const int* vals,
                        const int* desc, void* stream) {
  InitPlan ip;
  ip.first[0] = 0;
  for (int f = 0; f < SYM_NFIELDS; ++f) {
    ip.p[f] = planes[f];
    ip.bytes[f] = bytes[f];
    ip.val[f] = vals[f];
    ip.desc[f] = desc[f];
    ip.first[f + 1] = ip.first[f] + (int)((bytes[f] + INIT_CHUNK - 1) / INIT_CHUNK);
  }
  if (ip.first[SYM_NFIELDS] > 0)
    k_init<<<ip.first[SYM_NFIELDS], 256, 0, (cudaStream_t)stream>>>(ip);
  return (int)cudaGetLastError();
}

// shared memory a block of K1 stages a round's decisions in, when a
// thread holds several lanes
inline size_t staging_bytes(int lanes) { return (size_t)lanes * sizeof(Dec); }

inline cudaError_t staging_allowed() {
  return cudaFuncSetAttribute((const void*)k_sym_run,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)staging_bytes(RUN_THREADS));
}

// The launch shape of K1 over n lanes: out = {threads a block, blocks,
// lanes a thread, bytes of one lane's decisions, lanes a block}. A
// block holds 32-256 lanes a round, so the lanes spread over every SM
// (one block of n lanes up to 256); the grid is capped at the blocks
// that fit on the card at once (a cooperative launch needs all of them
// resident), and a thread then holds several lanes. Refuses a card
// without cooperative launch.
MTT_EXPORT int sym_run_shape(int n, int* out) {
  int dev, coop = 0, sms = 0, occ = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = staging_allowed();
  if (rc != cudaSuccess) return (int)rc;
  if (!coop) return (int)cudaErrorNotSupported;
  int lanes = 32;
  if (n <= RUN_THREADS) {
    lanes = std::max(32, (n + 31) / 32 * 32);
  } else {
    int per = (n + sms - 1) / sms;
    while (lanes < per && lanes < RUN_THREADS) lanes <<= 1;
  }
  const int need = (n + lanes - 1) / lanes;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k_sym_run, RUN_THREADS, 0);
  if (rc == cudaSuccess && need > occ * sms)  // rounds: with the staging
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k_sym_run, RUN_THREADS,
                                                       staging_bytes(lanes));
  if (rc != cudaSuccess) return (int)rc;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  int blocks = std::max(1, std::min(need, occ * sms));
  long long held = (long long)blocks * lanes;
  out[0] = RUN_THREADS;
  out[1] = blocks;
  out[2] = (int)((n + held - 1) / held);
  out[3] = (int)sizeof(Dec);
  out[4] = lanes;
  return 0;
}

// K1: up to `steps` steps in one cooperative launch of `blocks` blocks
// of `lanes` lanes a round (sym_run_shape). ctl: the 3-int running-count
// ring, ctl[0] the count (counted here when count_first is set: ctl
// zeroed by the caller); scratch: rounds * blocks block counts, then the
// fork stash (4 x min(max_forks, n)); dec: rounds * blocks * lanes
// decisions when a thread holds several lanes (rounds > 1), else null.
// seg_of/seg_tab: a packed arena's segment
// tables (row 2p), or null for single-contract code. phase: null, or 4
// int64 the phases' cycles are added to (Run::phase).
MTT_EXPORT int sym_run(void** planes, const int* dims, const void* code, int code_size,
                       const void* seg_of, int seg_of_len, const void* seg_tab, int seg_rows,
                       const void* optab, void* ctl, void* scratch, void* dec, int lanes,
                       int blocks, int steps, int max_forks, void* visited, int vis_len,
                       int count_first, void* phase, void* stream) {
  Sym s = make_sym(planes, dims);
  if (s.n <= 0 || steps <= 0) return 0;
  Env e{s, (const int32_t*)code, code_size, (const int32_t*)optab,
        (const int32_t*)seg_of, seg_of_len, (const int32_t*)seg_tab, seg_rows};
  if (lanes < 1 || lanes > RUN_THREADS || blocks < 1) return (int)cudaErrorInvalidValue;
  long long held = (long long)blocks * lanes;
  int nl = (int)((s.n + held - 1) / held);
  if (nl > 1 && !dec) return (int)cudaErrorInvalidValue;
  int maxf = std::min(max_forks, s.n);
  Run r;
  r.ctl = (int32_t*)ctl;
  r.counts = (int32_t*)scratch;
  r.dec = nl > 1 ? (Dec*)dec : nullptr;
  r.lanes = lanes;
  r.fs.parent = r.counts + (size_t)nl * blocks;
  r.fs.child = r.fs.parent + maxf;
  r.fs.fall_pc = r.fs.child + maxf;
  r.fs.fentry = r.fs.fall_pc + maxf;
  r.visited = (uint8_t*)visited;
  r.vis_len = vis_len;
  r.steps = steps;
  r.maxf = maxf;
  r.count_first = count_first;
  r.phase = (long long*)phase;
  Rows& t = r.rows;
  t.n = 0;
  auto put = [&t](void* p, long long bytes) {
    int k = t.n++;
    int v = 16;
    while (v > 1 && (bytes % v || (uintptr_t)p % v)) v >>= 1;
    t.base[k] = (char*)p;
    t.bytes[k] = (int)bytes;
    t.vec[k] = v;
  };
  for (int32_t* p : {s.sp, s.depth, s.group, s.last_jump, s.msize, s.mlog_count, s.s_mode,
                     s.scount, s.sbase, s.cd_size, s.cd_sym, s.cd_size_sid, (int32_t*)s.min_gas,
                     (int32_t*)s.max_gas, (int32_t*)s.gas_limit, s.status, s.steps})
    put(p, 4);
  t.scalar = t.n;
  put(s.stack, 32LL * s.D);
  put(s.ssid, 4LL * s.D);
  put(s.memory, s.M);
  put(s.mkind, s.M);
  put(s.mlog_off, 4LL * s.MR);
  put(s.mlog_len, 4LL * s.MR);
  put(s.mlog_sid, 4LL * s.MR);
  put(s.skeys, 32LL * s.S);
  put(s.svals, 32LL * s.S);
  put(s.sval_sid, 4LL * s.S);
  put(s.s_written, 4LL * s.S);
  put(s.s_read, 4LL * s.S);
  put(s.skey_sid, 4LL * s.S);
  put(s.s_wstep, 4LL * s.S);
  put(s.calldata, s.C);
  put(s.env, 32LL * s.NENV);
  put(s.env_sid, 4LL * s.NENV);
  put(s.dlog_op, 4LL * s.R);
  put(s.dlog_pc, 4LL * s.R);
  put(s.dlog_step, 4LL * s.R);
  put(s.dlog_fentry, 4LL * s.R);
  put(s.dlog_sid, 12LL * s.R);
  put(s.dlog_val, 96LL * s.R);
  void* args[] = {&e, &r};
  cudaError_t rc = staging_allowed();
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaLaunchCooperativeKernel((const void*)k_sym_run, dim3(blocks), dim3(RUN_THREADS), args,
                                   nl > 1 ? staging_bytes(lanes) : 0, (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K1 over a mesh
//
// K1 over a batch placed on a mesh (ops/symstep.sym_run_mesh): the
// same decide and exec_lane device functions, a step as two launches a
// device with the host between them, since the fork order (JAX's cumsum
// over every lane's request, :859-877) and budget are the whole
// batch's. Each launch takes every shard the device holds, up to
// MAX_MESH_SHARDS (a table of MeshShard in device memory, built once a
// run; block b of the grid serves shard b / bps, bps blocks of
// MESH_THREADS a shard), so a device steps its shards in two launches.
// sym_decide writes each lane's decisions to a
// scratch, each block's fork requests and RUNNING lanes to a device
// array and to a pinned host array mapped into the card's address space
// (no copy: the host waits for the launch once and reads them in
// place), and marks the visited bitmap; the host stops at the first
// step where no lane of any shard runs and gives each shard the global
// rank of its first request. sym_exec runs each lane at its global rank
// (its shard's rank, the counts of the shard's blocks before it, its
// rank in its block: never a racing atomic), its forking parents into
// the shard's stash; the launch on the batch's home device also writes
// the step's fork-log child slots (the top of the free stack) and step
// numbers. A fork's child row is its parent's post-step row:
// sym_fork_rows (below) copies every fork's row into its child's slot,
// one launch a device.
//
// Bound: bytes, each lane's decisions written (decide) and read (exec).
// A lane's decide and exec are chains of dependent loads in one thread,
// so a step's time is latency: blocks of MESH_THREADS spread a shard
// over many SMs (a 512-lane shard 8 blocks, was 2); the scratch holds a
// 16-byte word of every lane of the shard, then the next word
// (neighbouring lanes store and load neighbouring words), and leaves out
// the three stack words a, b, c, which exec rereads from the stack
// (unchanged between the two launches).
namespace {

constexpr int SHARD_THREADS = 256;
constexpr int MESH_THREADS = 64;
constexpr int MAX_MESH_SHARDS = 64;
constexpr int MAX_VIS_SRCS = 64;

// a shard of a device's launch: its planes (with the device's code and
// op table), the global index of its first lane, its fork stash (8 x
// cap int32, a column a field of ops/symstep.STASH)
struct MeshShard {
  Env e;
  int32_t* stash;
  int base;
};

// the scratch's 16-byte words of a Dec: all but those of a, b, c
constexpr int DEC_WORDS = (int)(sizeof(Dec) / 16);
constexpr int ABC_W0 = (int)(offsetof(Dec, a) / 16);
constexpr int ABC_W1 = (int)((offsetof(Dec, c) + sizeof(W)) / 16);
constexpr int DEC_KEPT = DEC_WORDS - (ABC_W1 - ABC_W0);
static_assert(sizeof(Dec) % 16 == 0, "Dec is a whole number of 16-byte words");
static_assert(offsetof(Dec, a) % 16 == 0 && offsetof(Dec, b) == offsetof(Dec, a) + sizeof(W) &&
                  offsetof(Dec, c) == offsetof(Dec, b) + sizeof(W) &&
                  (offsetof(Dec, c) + sizeof(W)) % 16 == 0,
              "a, b, c are whole 16-byte words of Dec, in a row");

// lane's decisions into its shard's scratch (word k of lane i at
// k * per + i)
__device__ __forceinline__ void put_dec(int4* dec, int per, int lane, const Dec& d) {
  const int4* w = reinterpret_cast<const int4*>(&d);
  int k = 0;
#pragma unroll
  for (int i = 0; i < DEC_WORDS; ++i)
    if (i < ABC_W0 || i >= ABC_W1) dec[(size_t)(k++) * per + lane] = w[i];
}

// lane's decisions back, a, b, c reread from the stack as decide read them
__device__ __forceinline__ void get_dec(const int4* dec, int per, int lane, const Sym& s,
                                        Dec& d) {
  int4* w = reinterpret_cast<int4*>(&d);
  int k = 0;
#pragma unroll
  for (int i = 0; i < DEC_WORDS; ++i)
    if (i < ABC_W0 || i >= ABC_W1) w[i] = dec[(size_t)(k++) * per + lane];
  const int sp = s.sp[lane];
  d.a = stack_at(s, lane, clampi(sp - 1, 0, s.D - 1));
  d.b = stack_at(s, lane, clampi(sp - 2, 0, s.D - 1));
  d.c = stack_at(s, lane, clampi(sp - 3, 0, s.D - 1));
}

// the block's shard's Env into shared memory (every thread calls it; the
// caller's next barrier publishes it)
__device__ __forceinline__ void load_env(Env& to, const Env& from) {
  static_assert(sizeof(Env) % 4 == 0, "Env is a whole number of words");
  const int* a = reinterpret_cast<const int*>(&from);
  int* b = reinterpret_cast<int*>(&to);
  for (int i = threadIdx.x; i < (int)(sizeof(Env) / 4); i += blockDim.x) b[i] = a[i];
}

struct MeshDecide {
  const MeshShard* tab;
  int4* dec;        // shards x DEC_KEPT x per words
  int32_t* counts;  // 2 x blocks: each block's fork requests, then its RUNNING lanes
  int32_t* host;    // the same, pinned host memory mapped into the card
  uint8_t* visited;
  int vis_len, per, bps;
};

__global__ void __launch_bounds__(MESH_THREADS) k_sym_decide(const __grid_constant__ MeshDecide p) {
  __shared__ Env env;
  const int q = blockIdx.x / p.bps;
  const int lane = (blockIdx.x - q * p.bps) * MESH_THREADS + threadIdx.x;
  load_env(env, p.tab[q].e);
  __syncthreads();
  const Sym& s = env.s;
  int f = 0, r = 0;
  if (lane < p.per) {
    Dec d;
    decide(env, lane, d);
    f = d.fork_req;
    r = d.running;
    if (p.visited && d.running) {
      const int pc = s.pc[lane];
      if (pc >= 0 && pc < p.vis_len) p.visited[pc] = 1;
    }
    put_dec(p.dec + (size_t)q * DEC_KEPT * p.per, p.per, lane, d);
  }
  f = block_sum(f);
  r = block_sum(r);
  if (threadIdx.x == 0) {
    p.counts[blockIdx.x] = f;
    p.counts[gridDim.x + blockIdx.x] = r;
    p.host[blockIdx.x] = f;
    p.host[gridDim.x + blockIdx.x] = r;
  }
}

struct MeshExec {
  const MeshShard* tab;
  const int4* dec;
  const int32_t* counts;  // sym_decide's
  int per, bps, cap;
  // the step's fork budget; the batch's free-slot count, fork-log count
  // and step number before the step
  int navail, free_count, flog_count, step_no;
  // on the home device: the batch's fork log and free stack, the step's
  // forks nf and the batch's lanes n; elsewhere flog_child is null
  int32_t* flog_child;
  int32_t* flog_step;
  const int32_t* free_slots;
  int nf, n;
  int off[MAX_MESH_SHARDS];  // each shard's global rank of its first request
};

__global__ void __launch_bounds__(MESH_THREADS) k_sym_exec(const __grid_constant__ MeshExec p) {
  __shared__ Env env;
  __shared__ ShardStep sh;
  const int q = blockIdx.x / p.bps, b = blockIdx.x - q * p.bps;
  const int lane = b * MESH_THREADS + threadIdx.x;
  const MeshShard& t = p.tab[q];
  load_env(env, t.e);
  if (threadIdx.x == 0) {
    sh.base = t.base;
    sh.off = p.off[q];
    for (int c = 0; c < 8; ++c) sh.col[c] = t.stash + (size_t)c * p.cap;
  }
  int part = 0;
  for (int i = threadIdx.x; i < b; i += MESH_THREADS) part += p.counts[q * p.bps + i];
  const int off = p.off[q] + block_sum(part);  // (its barrier publishes env and sh)
  const bool have = lane < p.per;
  Dec d;
  if (have) get_dec(p.dec + (size_t)q * DEC_KEPT * p.per, p.per, lane, env.s, d);
  const int forder = off + block_rank(have && d.fork_req);
  if (have) {
    const ForkStash none{nullptr, nullptr, nullptr, nullptr};
    exec_lane<true>(env, lane, d, forder, p.navail, p.free_count, p.step_no, p.flog_count, none,
                    &sh);
  }
  if (p.flog_child) {
    for (int f = blockIdx.x * MESH_THREADS + threadIdx.x; f < p.nf; f += gridDim.x * MESH_THREADS) {
      p.flog_child[p.flog_count + f] = p.free_slots[clampi(p.free_count - 1 - f, 0, p.n - 1)];
      p.flog_step[p.flog_count + f] = p.step_no;
    }
  }
}

// The fork rows of a step over a mesh (ops/symstep._CudaForks), one
// launch a device that holds a child's shard, FORK_BLOCKS blocks a
// fork: fork f (global rank) is the (f - off[q])-th of the shard q with
// off[q] <= f < off[q] + forks[q] (its stash row); its child is the
// batch's free-stack slot free_slots[clamp(free_count - 1 - f, 0, n - 1)]
// (the home sym_exec wrote the same into flog_child). Where this device
// holds the child's shard, its blocks copy the parent's post-step row
// from the source planes into the child's, a plane a warp (the widest
// word that divides the plane's rows, four words a lane in flight, every
// plane's loads in flight together: a row's copy is latency-bound),
// and writes the child's pc, fentry and an empty record log; on the home
// device it also writes the fork's seven fork-log words from the stash.
// A source shard on another card is read in place over peer access;
// where a pair has none, the source's device first stages its forks'
// rows and stash words by rank (the same launch with stage set), the
// host copies them to the destination's stage buffer once, and the
// destination reads them there. Children are free slots and parents are
// running lanes, so no block writes a row another reads.
//
// Bound: bytes, each fork's row read once and written once.
constexpr int FORK_MAX = 48;
// a fork's blocks and their threads: its planes over 32 warps
constexpr int FORK_BLOCKS = 4;
constexpr int FORK_THREADS = 256;
constexpr int FORK_WARPS = FORK_BLOCKS * FORK_THREADS / 32;

// a shard of a fork plan: its planes (in fork-plane order), stash,
// pc/fentry/dlog_count planes and first global lane; whether the plan's
// device holds it, and whether its forks' rows come through the plan's
// stage buffer
struct ForkShard {
  char* row[FORK_MAX];
  const int32_t* stash;
  int32_t *pc, *fentry, *dlog_count;
  int lane0, mine, staged;
};

// a device's plan of a run's fork rows, in its memory (sym_fork_plan):
// each fork plane's row bytes, copy word and offset in a stage row; the
// batch's free stack (on the device), its fork-log planes (the home
// device's; else null: flog_parent, flog_pc, flog_fentry, flog_sid,
// flog_gmin, flog_gmax, flog_dest), the stage buffer (cap rows, or
// null), then a ForkShard for each of the mesh's d shards of m lanes
struct ForkPlan {
  int bytes[FORK_MAX], vec[FORK_MAX], off[FORK_MAX];
  int planes, scalar, row, tail, cap, m, n, d;
  const int32_t* free_slots;
  int32_t* flog[7];
  char* stage;
  ForkShard shard[1];
};

struct ForkStep {
  const ForkPlan* plan;
  int nf, free_count, flog_count, stage;
  int off[MAX_MESH_SHARDS], forks[MAX_MESH_SHARDS];
};

template <typename V>
__device__ __forceinline__ void warp_words(char* dst, const char* src, int bytes, int lane) {
  const V* a = (const V*)src;
  V* b = (V*)dst;
  const int words = bytes / (int)sizeof(V);
  int w = lane;
  for (; w + 96 < words; w += 128) {
    V v0 = a[w], v1 = a[w + 32], v2 = a[w + 64], v3 = a[w + 96];
    b[w] = v0;
    b[w + 32] = v1;
    b[w + 64] = v2;
    b[w + 96] = v3;
  }
  for (; w < words; w += 32) b[w] = a[w];
}

// a fork's row from (src_at(k)) to (dst_at(k)) by its FORK_BLOCKS
// blocks: unit 0 (the scalar planes, a lane each) and each other plane
// are dealt to the fork's warps in turn, so the planes' loads are in
// flight together (a warp four words a lane)
template <class S, class D>
__device__ __forceinline__ void copy_row(const ForkPlan& t, int slot, S src_at, D dst_at) {
  const int lane = threadIdx.x & 31;
  const int units = 1 + t.planes - t.scalar;
  for (int u = slot; u < units; u += FORK_WARPS) {
    if (u == 0) {
      if (lane < t.scalar) *(int32_t*)dst_at(lane) = *(const int32_t*)src_at(lane);
      continue;
    }
    const int k = t.scalar + u - 1;
    char* d = dst_at(k);
    const char* s = src_at(k);
    switch (t.vec[k]) {
      case 16: warp_words<int4>(d, s, t.bytes[k], lane); break;
      case 8: warp_words<int2>(d, s, t.bytes[k], lane); break;
      case 4: warp_words<int>(d, s, t.bytes[k], lane); break;
      case 2: warp_words<short>(d, s, t.bytes[k], lane); break;
      default: warp_words<char>(d, s, t.bytes[k], lane); break;
    }
  }
}

__global__ void __launch_bounds__(FORK_THREADS) k_fork_rows(const __grid_constant__ ForkStep p) {
  const ForkPlan& t = *p.plan;
  const int f = blockIdx.x / FORK_BLOCKS, part = blockIdx.x % FORK_BLOCKS;
  const int slot = part * (FORK_THREADS / 32) + (int)(threadIdx.x >> 5);
  const bool head = part == 0;  // its first block writes the fork's words
  int q = 0;
  while (q < t.d && !(p.forks[q] > 0 && f >= p.off[q] && f < p.off[q] + p.forks[q])) ++q;
  if (q == t.d) return;
  const int j = f - p.off[q];
  const ForkShard& src = t.shard[q];
  char* srow = t.stage ? t.stage + (size_t)f * t.row : nullptr;
  if (p.stage) {  // the source side of a pair with no peer access
    if (!src.mine) return;
    const size_t par = (size_t)(src.stash[j] - src.lane0);
    copy_row(t, slot, [&](int k) { return (const char*)src.row[k] + par * t.bytes[k]; },
             [&](int k) { return srow + t.off[k]; });
    if (head && threadIdx.x < 8)
      ((int32_t*)(srow + t.tail))[threadIdx.x] = src.stash[threadIdx.x * t.cap + j];
    return;
  }
  auto stash = [&](int c) {
    return src.staged ? ((const int32_t*)(srow + t.tail))[c] : src.stash[c * t.cap + j];
  };
  if (head && t.flog[0] && threadIdx.x < 7) {  // stash columns 0, 3, 2, 4, 5, 6, 7
    const int c = threadIdx.x == 1 ? 3 : threadIdx.x == 2 ? 2 : threadIdx.x ? threadIdx.x + 1 : 0;
    t.flog[threadIdx.x][p.flog_count + f] = stash(c);
  }
  const int child = t.free_slots[clampi(p.free_count - 1 - f, 0, t.n - 1)];
  const int dq = child / t.m;
  if (child < 0 || dq >= t.d || !t.shard[dq].mine) return;
  const ForkShard& dst = t.shard[dq];
  const size_t dl = (size_t)(child - dq * t.m);
  if (src.staged) {
    copy_row(t, slot, [&](int k) { return (const char*)srow + t.off[k]; },
             [&](int k) { return dst.row[k] + dl * t.bytes[k]; });
  } else {
    const size_t par = (size_t)(src.stash[j] - src.lane0);
    copy_row(t, slot, [&](int k) { return (const char*)src.row[k] + par * t.bytes[k]; },
             [&](int k) { return dst.row[k] + dl * t.bytes[k]; });
  }
  if (head && threadIdx.x == 0) {
    dst.pc[dl] = stash(1);
    dst.fentry[dl] = stash(2);
    dst.dlog_count[dl] = 0;
  }
}

// the fork planes of a shard (ops/symstep.FORK_PLANES' order): put(p,
// bytes) for each, the scalar planes first; returns how many are scalar
template <class F>
inline int fork_planes(const Sym& s, F put) {
  int k = 0;
  for (int32_t* p : {s.sp, s.depth, s.group, s.last_jump, s.msize, s.mlog_count, s.s_mode,
                     s.scount, s.sbase, s.cd_size, s.cd_sym, s.cd_size_sid, (int32_t*)s.min_gas,
                     (int32_t*)s.max_gas, (int32_t*)s.gas_limit, s.status, s.steps}) {
    put(p, 4LL);
    ++k;
  }
  put(s.stack, 32LL * s.D);
  put(s.ssid, 4LL * s.D);
  put(s.memory, (long long)s.M);
  put(s.mkind, (long long)s.M);
  put(s.mlog_off, 4LL * s.MR);
  put(s.mlog_len, 4LL * s.MR);
  put(s.mlog_sid, 4LL * s.MR);
  put(s.skeys, 32LL * s.S);
  put(s.svals, 32LL * s.S);
  put(s.sval_sid, 4LL * s.S);
  put(s.s_written, 4LL * s.S);
  put(s.s_read, 4LL * s.S);
  put(s.skey_sid, 4LL * s.S);
  put(s.s_wstep, 4LL * s.S);
  put(s.calldata, (long long)s.C);
  put(s.env, 32LL * s.NENV);
  put(s.env_sid, 4LL * s.NENV);
  put(s.dlog_op, 4LL * s.R);
  put(s.dlog_pc, 4LL * s.R);
  put(s.dlog_step, 4LL * s.R);
  put(s.dlog_fentry, 4LL * s.R);
  put(s.dlog_sid, 12LL * s.R);
  put(s.dlog_val, 96LL * s.R);
  return k;
}

// a stage row's layout: each fork plane at a 16-byte aligned offset,
// then the fork's 8 stash words; returns the row's bytes
inline int stage_layout(const Sym& s, ForkPlan* t) {
  int at = 0, k = 0;
  t->scalar = fork_planes(s, [&](void*, long long bytes) {
    t->bytes[k] = (int)bytes;
    t->off[k++] = at;
    at += (int)((bytes + 15) / 16 * 16);
  });
  t->planes = k;
  t->tail = at;
  t->row = at + 32;
  return t->row;
}

}  // namespace

// bytes of one fork's stage row
MTT_EXPORT int sym_fork_row_bytes(const int* dims) {
  void* none[SYM_NFIELDS] = {};
  ForkPlan t;
  return stage_layout(make_sym(none, dims), &t);
}

// bytes of a fork plan over d shards
MTT_EXPORT int sym_fork_plan_bytes(int d) {
  return (int)(sizeof(ForkPlan) + (size_t)(d > 1 ? d - 1 : 0) * sizeof(ForkShard));
}

// a device's fork plan (sym_fork_plan_bytes(d)) into host: planes, d x
// SYM_NFIELDS plane pointers (every shard's, on its own device); dims,
// the shards' (n: lanes a shard); stash, each shard's (8 x cap int32);
// mine and staged, each shard's flags for this device; n the batch's
// lanes; free_slots on this device; flog, the home batch's seven fork-log
// planes on the home device, else null; stage, cap stage rows or null.
MTT_EXPORT int sym_fork_plan(void* const* planes, int d, const int* dims, void* const* stash,
                             const int* mine, const int* staged, int cap, int n,
                             const void* free_slots, void* const* flog, void* stage, void* host) {
  if (d < 1 || d > MAX_MESH_SHARDS) return (int)cudaErrorInvalidValue;
  ForkPlan* t = (ForkPlan*)host;
  const Sym s0 = make_sym((void**)planes, dims);
  stage_layout(s0, t);
  if (t->planes > FORK_MAX) return (int)cudaErrorInvalidValue;
  t->cap = cap;
  t->m = s0.n;
  t->n = n;
  t->d = d;
  t->free_slots = (const int32_t*)free_slots;
  for (int c = 0; c < 7; ++c) t->flog[c] = flog ? (int32_t*)flog[c] : nullptr;
  t->stage = (char*)stage;
  for (int k = 0; k < t->planes; ++k) t->vec[k] = 16;
  for (int q = 0; q < d; ++q) {
    const Sym s = make_sym((void**)planes + (size_t)q * SYM_NFIELDS, dims);
    ForkShard& sh = t->shard[q];
    int k = 0;
    fork_planes(s, [&](void* p, long long bytes) {
      sh.row[k] = (char*)p;
      int& v = t->vec[k++];
      while (v > 1 && (bytes % v || (uintptr_t)p % v)) v >>= 1;
    });
    sh.stash = (const int32_t*)stash[q];
    sh.pc = s.pc;
    sh.fentry = s.fentry;
    sh.dlog_count = s.dlog_count;
    sh.lane0 = q * s0.n;
    sh.mine = mine[q];
    sh.staged = staged[q];
  }
  return 0;
}

// a step's fork rows on the current device (plan: its sym_fork_plan, in
// its memory): off and forks, each of the d shards' global rank of its
// first request and forks (ops/symstep.fork_budget); nf the step's
// forks; free_count and flog_count the batch's before the step; stage:
// only stage the rows of this device's source shards for a pair with no
// peer access. One launch.
MTT_EXPORT int sym_fork_rows(const void* plan, int d, const int* off, const int* forks, int nf,
                             int free_count, int flog_count, int stage, void* stream) {
  if (d < 1 || d > MAX_MESH_SHARDS) return (int)cudaErrorInvalidValue;
  if (nf <= 0) return 0;
  ForkStep p;
  p.plan = (const ForkPlan*)plan;
  p.nf = nf;
  p.free_count = free_count;
  p.flog_count = flog_count;
  p.stage = stage;
  for (int q = 0; q < MAX_MESH_SHARDS; ++q) {
    p.off[q] = q < d ? off[q] : 0;
    p.forks[q] = q < d ? forks[q] : 0;
  }
  k_fork_rows<<<nf * FORK_BLOCKS, FORK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// K1 over a mesh's constants: bytes of a MeshShard, scratch bytes a
// lane, threads a block, shards a launch, bitmaps a sym_vis_or launch
MTT_EXPORT void sym_mesh_sizes(int* out) {
  out[0] = (int)sizeof(MeshShard);
  out[1] = DEC_KEPT * 16;
  out[2] = MESH_THREADS;
  out[3] = MAX_MESH_SHARDS;
  out[4] = MAX_VIS_SRCS;
}

// the table of a device's shards for sym_decide and sym_exec into host
// (shards MeshShards): planes, shards x SYM_NFIELDS plane pointers;
// dims, every shard's (n the shard's lanes); base, each shard's first
// global lane; stash, shards x 8 x cap int32 on the device.
MTT_EXPORT int sym_mesh_table(void* const* planes, int shards, const int* dims, const void* code,
                              int code_size, const void* optab, const int* base, void* stash,
                              int cap, void* host) {
  if (shards < 1 || shards > MAX_MESH_SHARDS) return (int)cudaErrorInvalidValue;
  MeshShard* t = (MeshShard*)host;
  for (int q = 0; q < shards; ++q) {
    Sym s = make_sym((void**)planes + (size_t)q * SYM_NFIELDS, dims);
    t[q].e = Env{s, (const int32_t*)code, code_size, (const int32_t*)optab, nullptr, 0, nullptr, 0};
    t[q].stash = (int32_t*)stash + (size_t)q * 8 * cap;
    t[q].base = base[q];
  }
  return 0;
}

// n ints of pinned host memory mapped into every card's address space
// (*dev: its device address); sym_decide writes its counts there
MTT_EXPORT int sym_host_alloc(int n, void** host, void** dev) {
  cudaError_t rc = cudaHostAlloc(host, sizeof(int32_t) * (size_t)(n > 0 ? n : 1),
                                 cudaHostAllocMapped | cudaHostAllocPortable);
  if (rc == cudaSuccess) rc = cudaHostGetDevicePointer(dev, *host, 0);
  return (int)rc;
}

MTT_EXPORT int sym_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

// K1's decide over a device's shards (tab: sym_mesh_table's, on the
// device), per lanes each, one launch: dec (shards x sym_mesh_sizes[1]
// x per bytes), counts (device) and host (mapped) 2 x shards x bps
// ints: each block's fork requests, then its RUNNING lanes; visited (or
// null) marked.
MTT_EXPORT int sym_decide(const void* tab, int shards, int per, void* dec, void* counts,
                          void* host, void* visited, int vis_len, void* stream) {
  if (shards < 1 || shards > MAX_MESH_SHARDS || per < 0) return (int)cudaErrorInvalidValue;
  if (per == 0) return 0;
  const int bps = (per + MESH_THREADS - 1) / MESH_THREADS;
  MeshDecide p{(const MeshShard*)tab, (int4*)dec, (int32_t*)counts, (int32_t*)host,
               (uint8_t*)visited, vis_len, per, bps};
  k_sym_decide<<<shards * bps, MESH_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// K1's exec over the same shards after their decide: off, each shard's
// global rank of its first request; navail, free_count, flog_count and
// step_no the batch's before the step; on the batch's home device
// flog_child, flog_step and free_slots are the home batch's planes (nf
// the step's forks, n the batch's lanes), elsewhere null.
MTT_EXPORT int sym_exec(const void* tab, int shards, int per, int cap, const void* dec,
                        const void* counts, const int* off, int navail, int free_count,
                        int flog_count, int step_no, void* flog_child, void* flog_step,
                        const void* free_slots, int nf, int n, void* stream) {
  if (shards < 1 || shards > MAX_MESH_SHARDS || per < 0) return (int)cudaErrorInvalidValue;
  if (per == 0) return 0;
  MeshExec p;
  p.tab = (const MeshShard*)tab;
  p.dec = (const int4*)dec;
  p.counts = (const int32_t*)counts;
  p.per = per;
  p.bps = (per + MESH_THREADS - 1) / MESH_THREADS;
  p.cap = cap;
  p.navail = navail;
  p.free_count = free_count;
  p.flog_count = flog_count;
  p.step_no = step_no;
  p.flog_child = (int32_t*)flog_child;
  p.flog_step = (int32_t*)flog_step;
  p.free_slots = (const int32_t*)free_slots;
  p.nf = nf;
  p.n = n;
  for (int q = 0; q < MAX_MESH_SHARDS; ++q) p.off[q] = q < shards ? off[q] : 0;
  k_sym_exec<<<shards * p.bps, MESH_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The visited bitmaps of a mesh's other devices ORed into the batch's
// (lane_engine.py:1807-1823: GSPMD combines the shards' marks), one
// launch on the batch's device: each source read in place over peer
// access (or a copy on the batch's device where a pair has none), a
// 16-byte word a thread where every bitmap is 16-byte aligned, bytes
// otherwise. Bound: bytes, every bitmap read once and the batch's
// written once.
namespace {
struct VisSrcs {
  const uint8_t* p[MAX_VIS_SRCS];
};

__global__ void k_vis_or(uint8_t* dst, const __grid_constant__ VisSrcs v, int count, int len,
                         int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!vec) {
    if (i >= len) return;
    uint8_t x = dst[i];
    for (int j = 0; j < count; ++j) x |= v.p[j][i];
    dst[i] = x;
    return;
  }
  const int words = len / 16, tail = len - 16 * words;
  if (i < words) {
    int4 x = reinterpret_cast<const int4*>(dst)[i];
    for (int j = 0; j < count; ++j) {
      const int4 y = reinterpret_cast<const int4*>(v.p[j])[i];
      x.x |= y.x;
      x.y |= y.y;
      x.z |= y.z;
      x.w |= y.w;
    }
    reinterpret_cast<int4*>(dst)[i] = x;
  }
  if (i < tail) {
    const int k = 16 * words + i;
    uint8_t x = dst[k];
    for (int j = 0; j < count; ++j) x |= v.p[j][k];
    dst[k] = x;
  }
}
}  // namespace

// dst |= every srcs[j] (j < count) over len bytes, one launch on the
// current device; each source is device memory the current device may
// read (its own, or a peer's with access enabled: peer_access)
MTT_EXPORT int sym_vis_or(void* dst, void* const* srcs, int count, int len, void* stream) {
  if (count < 0 || count > MAX_VIS_SRCS) return (int)cudaErrorInvalidValue;
  if (len <= 0 || count == 0) return 0;
  VisSrcs v;
  uintptr_t bits = (uintptr_t)dst;
  for (int j = 0; j < MAX_VIS_SRCS; ++j) {
    v.p[j] = j < count ? (const uint8_t*)srcs[j] : nullptr;
    if (j < count) bits |= (uintptr_t)srcs[j];
  }
  const int vec = (bits & 15) == 0;
  const int items = vec ? std::max(len / 16, len % 16) : len;
  k_vis_or<<<(items + 255) / 256, 256, 0, (cudaStream_t)stream>>>((uint8_t*)dst, v, count, len,
                                                                  vec);
  return (int)cudaGetLastError();
}

// lets the current device read device `peer`'s memory (once a pair;
// access already enabled, by this or by PyTorch, is success)
MTT_EXPORT int peer_access(int peer) {
  cudaError_t rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    rc = cudaSuccess;
  }
  return (int)rc;
}
