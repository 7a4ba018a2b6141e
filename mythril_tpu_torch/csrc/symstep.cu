// K1: the symbolic lane step, sym_step + its fork phase, looped by
// sym_run.
//
// Replaces mythril_tpu/ops/symstep.py:419 sym_step with :1264
// _do_forks, looped by :1332 sym_run / :1382 sym_run_jit. The JAX step
// evaluates every op family over the whole batch and selects per lane;
// here one thread runs one lane and computes only what its own opcode
// needs (per lane the JAX lax.cond gates change nothing, so the result
// is the same). A step is four launches:
//   A  k_decide : each lane's decisions up to park0 -> its fork request
//                 flag, and the per-block count of requests; marks the
//                 visited bitmap;
//   B  k_scan   : one block scans the block counts (fork order is the
//                 lane order of requests, as JAX's cumsum: a prefix
//                 scan, never a racing atomic), fixes the step's fork
//                 budget, and decides whether the step runs at all;
//   C  k_exec   : each lane recomputes its decisions, takes its fork
//                 rank, and executes; forking parents write their fork
//                 table row and stash what the child needs;
//   D  k_fork   : one block per fork copies the parent's post-step row
//                 into the child slot, then bumps the step counters.
// A step after the last RUNNING lane stopped is a no-op in all four
// (B clears the active flag), so the host may enqueue several steps
// between reads of the running count and still stop at exactly the
// step the JAX while_loop stops at.
//
// Bound: bytes. A step reads each running lane's operands, its opcode
// row and whatever window its op touches (32 memory/kind bytes, the
// MR overlay records, the S storage keys), and writes a few words; a
// fork copies the whole ~25 KB row. The lane loop is one thread per
// lane with no cross-lane traffic except the scan and the fork copies.
//
// K0 sym_init replaces mythril_tpu/ops/symstep.py:250
// _init_sym_lanes_dev: every plane of a fresh batch written in place
// (zeros, status DEAD, fentry/last_jump -1, the gas limit, the free-slot
// stack n-1..0). One launch, a block per 64 KB of a plane, 16-byte
// stores.
// Bound: bytes (each plane written once, nothing read).
#include "common.cuh"
#include "bv256.cuh"

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
// control words
enum { C_CNT, C_ACTIVE, C_NAVAIL, C_NF };

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
};

__device__ __forceinline__ int code_at(const Env& e, int pc, int col) {
  return e.code[(size_t)pc * CODE_COLS + col];
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

// everything sym_step decides before the fork phase
struct Dec {
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
  int dest;
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
  bool dest_small = !a_hi && d.a.l[0] < (uint32_t)e.code_size;
  d.dest = dest_small ? (int)d.a.l[0] : 0;
  d.dest_ok = dest_small && code_at(e, clampi(d.dest, 0, e.code_size), 2) != 0;
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

__global__ void k_count_running(Sym s, int32_t* ctl) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int run = lane < s.n && s.status[lane] == RUNNING;
  int c = __syncthreads_count(run);
  if (threadIdx.x == 0 && c) atomicAdd(ctl + C_CNT, c);
}

__global__ void k_decide(Env e, int32_t* ctl, int32_t* req, int32_t* block_off,
                         uint8_t* visited, int vis_len) {
  if (ctl[C_CNT] == 0) return;  // uniform: no lane running
  const Sym& s = e.s;
  int lane = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  int f = 0;
  if (lane < s.n) {
    Dec d;
    decide(e, lane, d);
    f = d.fork_req;
    req[lane] = f;
    if (visited && d.running) {
      int pc = s.pc[lane];
      if (pc >= 0 && pc < vis_len) visited[pc] = 1;
    }
  }
  int total;
  block_exclusive_scan(f, &total);
  if (threadIdx.x == 0) block_off[blockIdx.x] = total;
}

__device__ int scan_counts(int32_t* block_off, int nblocks) {
  __shared__ int carry;
  __shared__ int buf[SCAN_BLOCK];
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nblocks; base += SCAN_BLOCK) {
    int i = base + threadIdx.x;
    int v = i < nblocks ? block_off[i] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int off = 1; off < SCAN_BLOCK; off <<= 1) {
      int t = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
      __syncthreads();
      buf[threadIdx.x] += t;
      __syncthreads();
    }
    if (i < nblocks) block_off[i] = carry + buf[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == SCAN_BLOCK - 1) carry += buf[SCAN_BLOCK - 1];
    __syncthreads();
  }
  return carry;
}

__global__ void k_scan(Sym s, int32_t* ctl, int32_t* block_off, int nblocks, int maxf) {
  if (ctl[C_CNT] == 0) {
    if (threadIdx.x == 0) ctl[C_ACTIVE] = 0;
    return;
  }
  int total = scan_counts(block_off, nblocks);
  if (threadIdx.x == 0) {
    int navail = min(min(*s.free_count, maxf), s.F - *s.flog_count);
    ctl[C_ACTIVE] = 1;
    ctl[C_NAVAIL] = navail;
    ctl[C_NF] = max(0, min(total, navail));
    ctl[C_CNT] = 0;
  }
}

struct ForkStash {
  int32_t *parent, *child, *fall_pc, *fentry;
};

__global__ void k_exec(Env e, int32_t* ctl, const int32_t* req, const int32_t* block_off,
                       ForkStash fs) {
  if (ctl[C_ACTIVE] == 0) return;
  const Sym& s = e.s;
  int lane = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  int flag = lane < s.n ? req[lane] : 0;
  int total;
  int forder = block_exclusive_scan(flag, &total) + block_off[blockIdx.x];
  bool still = false;
  if (lane < s.n) {
    Dec d;
    decide(e, lane, d);
    const int navail = ctl[C_NAVAIL];
    const int free_count = *s.free_count;
    const int step_no = *s.step_no;
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
    const int prov_id = -(lane * d_recs + clampi(dcount, 0, d_recs - 1) + 1);
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
      W q, r;
      switch (d.rclass) {
        case RC_ADD: result = bv::add(a, b); break;
        case RC_MUL: result = bv::mul(a, b); break;
        case RC_SUB: result = bv::sub(a, b); break;
        case RC_DIV: result = bv::div(a, b); break;
        case RC_SDIV: bv::sdivmod(a, b, result, r); break;
        case RC_MOD: result = bv::mod(a, b); break;
        case RC_SMOD: bv::sdivmod(a, b, q, result); break;
        case RC_ADDMOD: result = bv::addmod(a, b, d.c); break;
        case RC_MULMOD: result = bv::mulmod(a, b, d.c); break;
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
        case RC_PC: result = bv::from_u32((uint32_t)pc); break;
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
        case RC_CODESIZE: result = bv::from_u32((uint32_t)e.code_size); break;
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
    if (is_jump) new_pc = d.dest;
    if (is_jumpi && !d.sym_b && d.jumpi_taken) new_pc = d.dest;
    if (fork_can) new_pc = d.dest;
    if (ok && is_jumpi) s.depth[lane] += 1;
    bool jumped = ok && (is_jump || (is_jumpi && !d.sym_b && d.jumpi_taken) || fork_can);
    if (jumped && code_at(e, clampi(d.dest, 0, e.code_size), 3) != 0) s.fentry[lane] = d.dest;
    if (ok) {
      s.pc[lane] = new_pc;
      s.sp[lane] = new_sp;
      s.min_gas[lane] = pre_min + d.gmin;
      s.max_gas[lane] = pre_max + d.gmax;
      s.steps[lane] += 1;
      if (is_jump) s.last_jump[lane] = pc;
    }
    if (d.running && park) s.status[lane] = NEEDS_HOST;
    still = s.status[lane] == RUNNING;

    // ---- fork bookkeeping: the row copy waits for k_fork
    if (fork_can) {
      int f = forder;
      int child = s.free_slots[clampi(free_count - 1 - f, 0, s.n - 1)];
      fs.parent[f] = lane;
      fs.child[f] = child;
      fs.fall_pc[f] = next_pc;
      fs.fentry[f] = pre_fentry;
      int row = *s.flog_count + f;
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
  }
  int c = __syncthreads_count(still);
  if (threadIdx.x == 0 && c) atomicAdd(ctl + C_CNT, c);
}

template <typename T>
__device__ __forceinline__ void copy_row(T* p, size_t elems, int src, int dst) {
  for (size_t i = threadIdx.x; i < elems; i += blockDim.x) p[(size_t)dst * elems + i] = p[(size_t)src * elems + i];
}

__global__ void k_fork(Sym s, int32_t* ctl, ForkStash fs) {
  if (ctl[C_ACTIVE] == 0) return;
  int nf = ctl[C_NF];
  int f = blockIdx.x;
  if (f < nf) {
    int src = fs.parent[f], dst = fs.child[f];
    copy_row(s.pc, 1, src, dst);
    copy_row(s.sp, 1, src, dst);
    copy_row(s.depth, 1, src, dst);
    copy_row(s.group, 1, src, dst);
    copy_row(s.fentry, 1, src, dst);
    copy_row(s.last_jump, 1, src, dst);
    copy_row(s.stack, (size_t)s.D * 8, src, dst);
    copy_row(s.ssid, s.D, src, dst);
    copy_row(s.memory, s.M, src, dst);
    copy_row(s.mkind, s.M, src, dst);
    copy_row(s.msize, 1, src, dst);
    copy_row(s.mlog_off, s.MR, src, dst);
    copy_row(s.mlog_len, s.MR, src, dst);
    copy_row(s.mlog_sid, s.MR, src, dst);
    copy_row(s.mlog_count, 1, src, dst);
    copy_row(s.skeys, (size_t)s.S * 8, src, dst);
    copy_row(s.svals, (size_t)s.S * 8, src, dst);
    copy_row(s.sval_sid, s.S, src, dst);
    copy_row(s.s_written, s.S, src, dst);
    copy_row(s.s_read, s.S, src, dst);
    copy_row(s.skey_sid, s.S, src, dst);
    copy_row(s.s_wstep, s.S, src, dst);
    copy_row(s.s_mode, 1, src, dst);
    copy_row(s.scount, 1, src, dst);
    copy_row(s.sbase, 1, src, dst);
    copy_row(s.calldata, s.C, src, dst);
    copy_row(s.cd_size, 1, src, dst);
    copy_row(s.cd_sym, 1, src, dst);
    copy_row(s.cd_size_sid, 1, src, dst);
    copy_row(s.env, (size_t)s.NENV * 8, src, dst);
    copy_row(s.env_sid, s.NENV, src, dst);
    copy_row(s.min_gas, 1, src, dst);
    copy_row(s.max_gas, 1, src, dst);
    copy_row(s.gas_limit, 1, src, dst);
    copy_row(s.status, 1, src, dst);
    copy_row(s.steps, 1, src, dst);
    copy_row(s.dlog_op, s.R, src, dst);
    copy_row(s.dlog_pc, s.R, src, dst);
    copy_row(s.dlog_step, s.R, src, dst);
    copy_row(s.dlog_fentry, s.R, src, dst);
    copy_row(s.dlog_sid, (size_t)s.R * 3, src, dst);
    copy_row(s.dlog_val, (size_t)s.R * 24, src, dst);
    __syncthreads();
    if (threadIdx.x == 0) {
      s.pc[dst] = fs.fall_pc[f];
      s.fentry[dst] = fs.fentry[f];
      s.dlog_count[dst] = 0;
    }
  }
  if (f == 0 && threadIdx.x == 0) {
    *s.step_no += 1;
    *s.flog_count += nf;
    *s.free_count -= nf;
  }
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

MTT_EXPORT int sym_count_running(void** planes, const int* dims, void* ctl, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  fill_i32<<<1, 1, 0, st>>>((int32_t*)ctl, 1, 0);
  if (s.n > 0) k_count_running<<<nblocks_for(s.n, 256), 256, 0, st>>>(s, (int32_t*)ctl);
  return (int)cudaGetLastError();
}

// `steps` steps of K1. scratch: req[n], block_off[nb+1], then the fork
// stash (4 x maxf).
MTT_EXPORT int sym_run_steps(void** planes, const int* dims, const void* code, int code_size,
                             const void* optab, void* ctl, void* scratch, int steps,
                             int max_forks, void* visited, int vis_len, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  Env e{s, (const int32_t*)code, code_size, (const int32_t*)optab};
  int n = s.n;
  int nb = (int)nblocks_for(n, SCAN_BLOCK);
  int maxf = min(max_forks, n);
  int32_t* req = (int32_t*)scratch;
  int32_t* block_off = req + n;
  ForkStash fs;
  fs.parent = block_off + nb + 1;
  fs.child = fs.parent + maxf;
  fs.fall_pc = fs.child + maxf;
  fs.fentry = fs.fall_pc + maxf;
  int32_t* c = (int32_t*)ctl;
  for (int i = 0; i < steps && n > 0; ++i) {
    k_decide<<<nb, SCAN_BLOCK, 0, st>>>(e, c, req, block_off, (uint8_t*)visited, vis_len);
    k_scan<<<1, SCAN_BLOCK, 0, st>>>(s, c, block_off, nb, maxf);
    k_exec<<<nb, SCAN_BLOCK, 0, st>>>(e, c, req, block_off, fs);
    k_fork<<<maxf, 256, 0, st>>>(s, c, fs);
  }
  return (int)cudaGetLastError();
}
