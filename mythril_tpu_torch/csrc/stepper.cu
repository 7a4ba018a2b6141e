// K10 lane_run: the concrete lane stepper, run to the end in one launch.
//
// Replaces mythril_tpu/ops/stepper.py:902 run (with :919 run_jit), a
// lax.while_loop of :540 step over a LaneState. The JAX step executes
// every op family over the whole batch and selects per lane; here one
// thread runs one lane and computes only what its own opcode needs.
//
// Why one thread looping on its own lane gives exactly the JAX planes:
//  - in concrete execution the lanes never interact: every read and
//    write of step is indexed by the lane itself (its stack, memory,
//    storage log, calldata and env rows), and a lane that is not
//    RUNNING executes STOP under the running mask, which changes none
//    of its planes (no push, no store, no status mark, gas_used and
//    steps unchanged);
//  - the lax.cond gates (stepper.py:600-765: shifts, MUL, the division
//    family, ADDMOD/MULMOD, EXP, memory, storage, calldata) only choose
//    whether a family is computed for the whole batch; a lane whose
//    opcode needs a family always gets it computed, and a lane whose
//    opcode does not never reads it. So a gate changes what is
//    computed, never a result;
//  - run stops when no lane is RUNNING or after max_steps batch steps.
//    A lane that stopped stays unchanged by the steps after, so each
//    lane stepping until it leaves RUNNING or has taken max_steps steps
//    ends in the state the batch loop leaves it in.
//
// What the step keeps of the JAX function, line by line: pc clipped to
// code.size (the STOP pad past the end); underflow against eff_pop
// (DUPn n, SWAPn n+1); the push written even when the lane then goes
// INVALID for gas or a bad jump (the JAX mask leaves those out only for
// underflow and parking), with sp and pc unchanged; memory, storage and
// ret_offset/ret_len updates under the JAX masks; msize rounded up to
// 32 also for an underflowing lane; the status marks in the JAX order,
// later marks winning; gas_used (uint32, wrapping) advancing unless the
// lane parked; steps counting every step the lane was RUNNING.
//
// Bound: a run's data is small (chip_smoke.py counts its bytes and 8
// integer operations an instruction from a traced run), so the kernel
// is bound by each lane's chain of dependent steps (some 700 cycles a
// step on an H100) and by how many lanes the card holds at once. The
// thread-a-lane kernel it replaces took ~4500 cycles a step: every step
// read its code row, op-table row and stack words from L2, and the word
// pushed one step before came back from L2. Here (ops/stepper.
// lane_run_plan):
//  - a lane's stack, memory and storage log live in shared memory for
//    the whole run (LOCAL), copied in once by the block's threads
//    together (16 bytes a thread where the wrapper found the plane
//    aligned) and written back once (memory and storage only if a lane
//    of the block stored); a stack row is 4 words past a multiple of 8,
//    so 8 lanes reading one slot 16 bytes each hit 8 bank groups; the
//    storage rows, read 4 bytes at a time, have an odd stride. Past the
//    on-chip budget (init_lanes' default planes) the same kernel reads
//    the rows in place;
//  - the code's rows sit in shared memory with each op's stack effect,
//    result class, env slot and gas packed in: one 8-byte load a step;
//  - blocks of 64 lanes (32 where the batch would leave SMs idle) with
//    57 KB of shared memory for the bench batch, so 4 blocks share an SM
//    and 32768 lanes run in one wave; a block past 48 KB opts in once a
//    device (common.cuh allow_smem), so one process may run lanes on
//    several cards (parallel/mesh.py sharded_run);
//  - no limb is indexed by a runtime value (a register array indexed so
//    would live in local memory): the word ops are bv256.cuh's, whose
//    shifts, BYTE and SIGNEXTEND select limbs; MLOAD/MSTORE/
//    CALLDATALOAD move fixed limbs; the division family (bv::divide,
//    the header's one core) and EXP run out of line on the stack's
//    words into a word of shared scratch.
// A split of a lane over 8 threads (a limb each: carries by ballot,
// MUL by shuffles) was built, held exact and measured slower at every
// width (PERF.md §6): it repeats the step's control 8 times.
#include "common.cuh"
#include "bv256.cuh"

using bv::W;

namespace {

constexpr int CODE_COLS = 14;
constexpr int OP_STOP = 0x00, OP_DIV = 0x04, OP_EXP = 0x0A,
              OP_CALLDATALOAD = 0x35, OP_MLOAD = 0x51, OP_MSTORE = 0x52,
              OP_MSTORE8 = 0x53, OP_SLOAD = 0x54, OP_SSTORE = 0x55,
              OP_JUMP = 0x56, OP_JUMPI = 0x57, OP_RETURN = 0xF3,
              OP_REVERT = 0xFD, OP_INVALID = 0xFE, OP_SELFDESTRUCT = 0xFF;
constexpr int RUNNING = 0, STOPPED = 1, RETURNED = 2, REVERTED = 3,
              INVALID = 4, NEEDS_HOST = 5, SELFDESTRUCT = 6;
constexpr uint32_t BIG = 1u << 30;
// result classes (ops/stepper.RESULT_CLASSES)
enum {
  RC_ZERO, RC_ADD, RC_MUL, RC_SUB, RC_DIV, RC_SDIV, RC_MOD, RC_SMOD,
  RC_ADDMOD, RC_MULMOD, RC_EXP, RC_SIGNEXTEND, RC_LT, RC_GT, RC_SLT, RC_SGT,
  RC_EQ, RC_ISZERO, RC_AND, RC_OR, RC_XOR, RC_NOT, RC_BYTE, RC_SHL, RC_SHR,
  RC_SAR, RC_MLOAD, RC_SLOAD, RC_PC, RC_MSIZE, RC_GAS, RC_CALLDATALOAD,
  RC_CALLDATASIZE, RC_CODESIZE, RC_ENV, RC_PUSH, RC_DUP
};
// op table columns (ops/stepper.LANE_OP_TABLE)
enum { T_NPOP, T_NPUSH, T_GAS, T_SUP, T_ENV, T_RCLASS, T_COLS };

// Every plane of ops/stepper.LaneState, in its field order.
#define LANE_FIELDS(X)                                                   \
  X(int32_t, pc) X(int32_t, sp) X(uint32_t, stack) X(uint8_t, memory)   \
  X(int32_t, msize) X(uint32_t, skeys) X(uint32_t, svals)               \
  X(int32_t, scount) X(uint8_t, calldata) X(int32_t, cd_size)           \
  X(uint32_t, env) X(uint32_t, gas_used) X(uint32_t, gas_limit)         \
  X(int32_t, status) X(int32_t, ret_offset) X(int32_t, ret_len)         \
  X(int32_t, steps)

#define LANE_DECL(T, name) T* name;
#define LANE_COUNT(T, name) +1
#define LANE_NAME(T, name) #name ","

constexpr int LANE_NFIELDS = 0 LANE_FIELDS(LANE_COUNT);

// dims order: n, D, M, S, C, NENV
struct Lanes {
  LANE_FIELDS(LANE_DECL)
  int n, D, M, S, C, NENV;
};

Lanes make_lanes(void** p, const int* dims) {
  Lanes s;
  int i = 0;
#define LANE_SET(T, name) s.name = (T*)p[i++];
  LANE_FIELDS(LANE_SET)
#undef LANE_SET
  s.n = dims[0];
  s.D = dims[1];
  s.M = dims[2];
  s.S = dims[3];
  s.C = dims[4];
  s.NENV = dims[5];
  return s;
}

// ops/stepper.lane_run_plan, in its order: lanes a block, LOCAL (the
// lanes' rows on chip), code rows in shared memory, the lane rows'
// strides (stack and storage in words, memory in bytes), the bytes
// before the lanes' rows (the code's rows, or the op table), the shared
// bytes of a block, and which planes 16-byte copies may move (VEC_*)
enum { P_LPB, P_LOCAL, P_CODE_SH, P_STACK_W, P_STORE_W, P_MEM_B, P_HEAD_B, P_SMEM, P_VEC,
       P_COUNT };
enum { VEC_STACK = 1, VEC_MEM = 4 };

struct Plan {
  int lpb, stack_w, store_w, mem_b, head_b, vec;
};

__device__ __forceinline__ W heavy(int op, const W& a, const W& b, const W& c) {
  // DIV .. MULMOD (0x04-0x09) are bv::divide's kinds in opcode order
  return op == OP_EXP ? bv::exp(a, b) : bv::divide(op - OP_DIV, a, b, c);
}

#ifndef MTT_DYN_SMEM
#define MTT_DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

// an op's stack effect, support, result class and env slot in 15 bits
__device__ __forceinline__ uint32_t pack_meta(const int32_t* t) {
  return (uint32_t)(t[T_NPOP] & 3) | (uint32_t)(t[T_NPUSH] & 1) << 2 |
         (uint32_t)(t[T_SUP] != 0) << 3 | (uint32_t)(t[T_RCLASS] & 63) << 4 |
         (uint32_t)((t[T_ENV] + 1) & 31) << 10;
}

// a block's tables in shared memory: (CODE_SH) the code's rows, one
// 8-byte load a step: {opcode | jumpdest << 8 | the op's meta << 9, next
// pc | the op's gas << 17} (a shared code has fewer than 2^17 rows, and
// no static gas reaches 2^15); otherwise each op's packed meta and gas
// (the rows in shared memory start where the op table would)
template <bool CODE_SH>
__device__ __forceinline__ void load_tables(uint32_t* opmeta, uint32_t* opgas, uint2* rows,
                                            const int32_t* code, int code_size,
                                            const int32_t* optab) {
  if (!CODE_SH) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      opmeta[i] = pack_meta(optab + i * T_COLS);
      opgas[i] = (uint32_t)optab[i * T_COLS + T_GAS];
    }
  } else {
    for (int r = threadIdx.x; r <= code_size; r += blockDim.x) {
      const int32_t* row = code + (size_t)r * CODE_COLS;
      const int op = row[0] & 0xFF;
      const int32_t* t = optab + op * T_COLS;
      rows[r] = make_uint2((uint32_t)op | (uint32_t)(row[2] != 0) << 8 | pack_meta(t) << 9,
                           (uint32_t)row[1] | (uint32_t)t[T_GAS] << 17);
    }
  }
}

// a step's row: opcode, next pc, the op's meta and gas
template <bool CODE_SH>
__device__ __forceinline__ void fetch(const uint2* rows, const uint32_t* opmeta,
                                      const uint32_t* opgas, const int32_t* code, int pc_c,
                                      int& op, int& next_pc, uint32_t& meta, uint32_t& gas) {
  if (CODE_SH) {
    const uint2 e = rows[pc_c];
    op = (int)(e.x & 0xFFu);
    meta = e.x >> 9;
    next_pc = (int)(e.y & 0x1FFFFu);
    gas = e.y >> 17;
  } else {
    op = __ldg(code + (size_t)pc_c * CODE_COLS);
    next_pc = __ldg(code + (size_t)pc_c * CODE_COLS + 1);
    meta = opmeta[op];
    gas = opgas[op];
  }
}

// ---- a block's rows, copied in and out by all its threads together

// nl rows of `words` words from src (contiguous) into rows `stride`
// words apart at dst, or back (OUT), 16 bytes a thread where vec
template <bool OUT>
__device__ __forceinline__ void block_rows(uint32_t* sh, int stride, uint32_t* gl, int words,
                                           int nl, bool vec) {
  if (vec) {
    const int units = words / 4, total = nl * units;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / units, u = i - r * units;
      uint4* d = reinterpret_cast<uint4*>(sh + (size_t)r * stride) + u;
      uint4* g = reinterpret_cast<uint4*>(gl) + i;
      if (OUT) *g = *d; else *d = *g;
    }
  } else {
    const int total = nl * words;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      if (OUT) gl[i] = sh[(size_t)r * stride + w]; else sh[(size_t)r * stride + w] = gl[i];
    }
  }
}

template <bool OUT>
__device__ __forceinline__ void block_bytes(uint8_t* sh, int stride, uint8_t* gl, int bytes,
                                            int nl, bool vec) {
  if (vec) {
    block_rows<OUT>(reinterpret_cast<uint32_t*>(sh), stride / 4,
                    reinterpret_cast<uint32_t*>(gl), bytes / 4, nl, true);
    return;
  }
  const int total = nl * bytes;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / bytes, w = i - r * bytes;
    if (OUT) gl[i] = sh[(size_t)r * stride + w]; else sh[(size_t)r * stride + w] = gl[i];
  }
}

// a word of a shared stack row (16-byte aligned: two 16-byte loads)
__device__ __forceinline__ W ld_sh(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  W w;
  w.l[0] = lo.x; w.l[1] = lo.y; w.l[2] = lo.z; w.l[3] = lo.w;
  w.l[4] = hi.x; w.l[5] = hi.y; w.l[6] = hi.z; w.l[7] = hi.w;
  return w;
}

__device__ __forceinline__ void st_sh(uint32_t* p, const W& w) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(w.l[0], w.l[1], w.l[2], w.l[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(w.l[4], w.l[5], w.l[6], w.l[7]);
}

__device__ __forceinline__ uint32_t low32w(const W& w, bool* hi) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 1; i < bv::NL; ++i) acc |= w.l[i];
  *hi = acc != 0;
  return w.l[0];
}

// the heavy families on the stack's words a, b, c (shared or global),
// the result into out (a lane's shared scratch), out of line
__device__ __noinline__ void heavy_sh(int op, const uint32_t* a, const uint32_t* b,
                                      const uint32_t* c, uint32_t* out) {
  st_sh(out, heavy(op, bv::load(a), bv::load(b), bv::load(c)));
}

// a stack word: 16-byte loads on chip, 4-byte ones in place
template <bool LOCAL>
__device__ __forceinline__ W ld_stack(const uint32_t* p) {
  return LOCAL ? ld_sh(p) : bv::load(p);
}

template <bool LOCAL>
__device__ __forceinline__ void st_stack(uint32_t* p, const W& w) {
  if (LOCAL) st_sh(p, w); else bv::store(p, w);
}

template <bool CODE_SH, bool LOCAL>
__global__ void __launch_bounds__(128)
k_lane_run(Lanes s, const int32_t* __restrict__ code, int code_size,
            const int32_t* __restrict__ optab, int max_steps, Plan p) {
  MTT_DYN_SMEM(k10_smem);
  if (max_steps <= 0) return;
  uint32_t* const opmeta = reinterpret_cast<uint32_t*>(k10_smem);
  uint32_t* const opgas = opmeta + 256;
  uint2* const rows = reinterpret_cast<uint2*>(k10_smem);
  load_tables<CODE_SH>(opmeta, opgas, rows, code, code_size, optab);
  const int D = s.D, M = s.M, S = s.S, C = s.C;
  const long long l0 = (long long)blockIdx.x * p.lpb;
  const int nl = (int)(s.n - l0 < p.lpb ? s.n - l0 : p.lpb);
  // a word of scratch a lane (the division family's result), then
  // (LOCAL) the lanes' stacks, storage logs and memory
  uint32_t* const scratch = reinterpret_cast<uint32_t*>(k10_smem + p.head_b);
  uint32_t* const stacks = scratch + (size_t)p.lpb * 8;
  uint32_t* const keys_sh = stacks + (size_t)p.lpb * p.stack_w;
  uint32_t* const vals_sh = keys_sh + (size_t)p.lpb * p.store_w;
  uint8_t* const mem_sh = reinterpret_cast<uint8_t*>(vals_sh + (size_t)p.lpb * p.store_w);
  if (LOCAL) {
    block_rows<false>(stacks, p.stack_w, s.stack + l0 * D * 8, D * 8, nl, p.vec & VEC_STACK);
    block_rows<false>(keys_sh, p.store_w, s.skeys + l0 * S * 8, S * 8, nl, false);
    block_rows<false>(vals_sh, p.store_w, s.svals + l0 * S * 8, S * 8, nl, false);
    block_bytes<false>(mem_sh, p.mem_b, s.memory + l0 * M, M, nl, p.vec & VEC_MEM);
  }
  __syncthreads();

  const int li = threadIdx.x;
  const long long lane = l0 + li;
  bool mem_dirty = false, store_dirty = false;
  int status = li < nl ? s.status[lane] : -1;
  if (status == RUNNING) {
    int pc = s.pc[lane], sp = s.sp[lane], msize = s.msize[lane];
    int scount = s.scount[lane];
    int ret_offset = s.ret_offset[lane], ret_len = s.ret_len[lane];
    int steps = s.steps[lane];
    uint32_t gas_used = s.gas_used[lane];
    const uint32_t gas_limit = s.gas_limit[lane];
    const int cd_size = s.cd_size[lane];
    uint32_t* const stk = LOCAL ? stacks + (size_t)li * p.stack_w : s.stack + lane * D * 8;
    uint32_t* const mine = scratch + (size_t)li * 8;
    uint32_t* const skeys = LOCAL ? keys_sh + (size_t)li * p.store_w : s.skeys + lane * S * 8;
    uint32_t* const svals = LOCAL ? vals_sh + (size_t)li * p.store_w : s.svals + lane * S * 8;
    uint8_t* const mem = LOCAL ? mem_sh + (size_t)li * p.mem_b : s.memory + lane * M;
    const uint8_t* cd = s.calldata + lane * C;
    const uint32_t* env = s.env + lane * s.NENV * 8;

    for (int it = 0; it < max_steps && status == RUNNING; ++it) {
      const int pc_c = clampi(pc, 0, code_size);
      int op, next_pc;
      uint32_t meta, gas;
      fetch<CODE_SH>(rows, opmeta, opgas, code, pc_c, op, next_pc, meta, gas);
      const int npop = (int)(meta & 3u), npush = (int)((meta >> 2) & 1u);
      const bool sup = (meta >> 3) & 1u;
      const int rclass = (int)((meta >> 4) & 63u), env_slot = (int)((meta >> 10) & 31u) - 1;
      const bool is_dup = op >= 0x80 && op <= 0x8F, is_swap = op >= 0x90 && op <= 0x9F;
      const int dup_n = is_dup ? op - 0x7F : 1, swap_n = is_swap ? op - 0x8F : 1;
      const int eff_pop = is_dup ? dup_n : (is_swap ? swap_n + 1 : npop);
      const bool underflow = sp < eff_pop;
      const bool overflow = (sp - npop + npush) > D;
      const W a = ld_stack<LOCAL>(stk + 8 * clampi(sp - 1, 0, D - 1));
      const W b = ld_stack<LOCAL>(stk + 8 * clampi(sp - 2, 0, D - 1));
      bool mem_oob = false, cd_oob = false, storage_full = false;
      W res = bv::zero();

      switch (rclass) {
        case RC_ADD: res = bv::add(a, b); break;
        case RC_MUL: res = bv::mul(a, b); break;
        case RC_SUB: res = bv::sub(a, b); break;
        case RC_DIV: case RC_SDIV: case RC_MOD: case RC_SMOD:
        case RC_ADDMOD: case RC_MULMOD: case RC_EXP:
          heavy_sh(op, stk + 8 * clampi(sp - 1, 0, D - 1), stk + 8 * clampi(sp - 2, 0, D - 1),
                   stk + 8 * clampi(sp - 3, 0, D - 1), mine);
          res = ld_sh(mine);
          break;
        case RC_SIGNEXTEND: res = bv::signextend(a, b); break;
        case RC_LT: res = bv::bool_word(bv::ult(a, b)); break;
        case RC_GT: res = bv::bool_word(bv::ult(b, a)); break;
        case RC_SLT: res = bv::bool_word(bv::slt(a, b)); break;
        case RC_SGT: res = bv::bool_word(bv::slt(b, a)); break;
        case RC_EQ: res = bv::bool_word(bv::eq(a, b)); break;
        case RC_ISZERO: res = bv::bool_word(bv::is_zero(a)); break;
        case RC_AND: res = bv::band(a, b); break;
        case RC_OR: res = bv::bor(a, b); break;
        case RC_XOR: res = bv::bxor(a, b); break;
        case RC_NOT: res = bv::bnot(a); break;
        case RC_BYTE: res = bv::byte_op(a, b); break;
        case RC_SHL: res = bv::shl(b, a); break;
        case RC_SHR: res = bv::shr(b, a); break;
        case RC_SAR: res = bv::sar(b, a); break;
        case RC_PC: res = bv::from_u32((uint32_t)pc); break;
        case RC_MSIZE: res = bv::from_u32((uint32_t)msize); break;
        case RC_GAS: res = bv::from_u32(gas_limit - gas_used); break;
        case RC_CALLDATASIZE: res = bv::from_u32((uint32_t)cd_size); break;
        case RC_CODESIZE: res = bv::from_u32((uint32_t)code_size); break;
        case RC_ENV: {
          const uint32_t* e = env + 8 * clampi(env_slot, 0, s.NENV - 1);
#pragma unroll
          for (int i = 0; i < 8; ++i) res.l[i] = __ldg(e + i);
          break;
        }
        case RC_PUSH: {
          const int32_t* row = code + (size_t)pc_c * CODE_COLS + 4;
#pragma unroll
          for (int i = 0; i < 8; ++i) res.l[i] = (uint32_t)__ldg(row + i);
          break;
        }
        case RC_DUP: res = ld_stack<LOCAL>(stk + 8 * clampi(sp - dup_n, 0, D - 1)); break;
        default: break;  // MLOAD, SLOAD, CALLDATALOAD below; ZERO
      }

      // ---- memory
      if (op == OP_MLOAD || op == OP_MSTORE || op == OP_MSTORE8) {
        bool hi;
        const uint32_t off_u = low32w(a, &hi);
        const bool big = hi || off_u >= BIG;
        const int off = big ? 0 : (int)off_u;
        const bool word = op != OP_MSTORE8;
        mem_oob = word ? (big || off + 32 > M) : (big || off >= M);
        if (op == OP_MLOAD) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            uint32_t v = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) v = v << 8 | mem[clampi(off + 28 - 4 * i + k, 0, M - 1)];
            res.l[i] = v;
          }
        } else if (!mem_oob && !underflow) {
          if (op == OP_MSTORE) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                mem[off + 28 - 4 * i + k] = (uint8_t)(b.l[i] >> (8 * (3 - k)));
          } else {
            mem[off] = (uint8_t)(b.l[0] & 0xFFu);
          }
          mem_dirty = true;
        }
        if (!mem_oob) {
          const int touched = word ? off + 32 : off + 1;
          const int tw = ((touched + 31) / 32) * 32;
          msize = msize > tw ? msize : tw;
        }
      }

      // ---- storage: read-over-write log, the last matching slot
      if (op == OP_SLOAD || op == OP_SSTORE) {
        int best = 0;
        const int lim = scount < S ? scount : S;
        for (int k = 0; k < lim; ++k)
          if (bv::eq(bv::load(skeys + 8 * k), a)) best = k + 1;
        const bool found = best > 0;
        const int fidx = clampi(best - 1, 0, S - 1);
        if (op == OP_SLOAD) {
          res = found ? bv::load(svals + 8 * fidx) : bv::zero();
        } else {
          storage_full = !found && scount >= S;
          if (!storage_full && !underflow) {
            const int pos = clampi(found ? fidx : scount, 0, S - 1);
            bv::store(skeys + 8 * pos, a);
            bv::store(svals + 8 * pos, b);
            if (!found) scount += 1;
            store_dirty = true;
          }
        }
      }

      // ---- calldata: bytes past cd_size read zero
      if (op == OP_CALLDATALOAD) {
        bool hi;
        const uint32_t off_u = low32w(a, &hi);
        const int off = (hi || off_u >= BIG) ? C : (int)off_u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t v = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int idx = off + 28 - 4 * i + k;
            v = v << 8 | ((idx < cd_size && idx < C) ? __ldg(cd + clampi(idx, 0, C - 1)) : 0u);
          }
          res.l[i] = v;
        }
        cd_oob = off < cd_size && off + 32 > C;
      }

      // ---- the stack: push, or SWAPn
      const bool parked = !sup || mem_oob || cd_oob || storage_full || overflow;
      const int new_sp = sp - npop + npush;
      if (npush == 1 && !underflow && !parked) st_stack<LOCAL>(stk + 8 * clampi(new_sp - 1, 0, D - 1), res);
      if (is_swap && !underflow) {
        const W swap_val = ld_stack<LOCAL>(stk + 8 * clampi(sp - swap_n - 1, 0, D - 1));
        st_stack<LOCAL>(stk + 8 * clampi(sp - 1, 0, D - 1), swap_val);
        st_stack<LOCAL>(stk + 8 * clampi(sp - 1 - swap_n, 0, D - 1), a);
      }

      // ---- control flow
      const bool is_jump = op == OP_JUMP, is_jumpi = op == OP_JUMPI;
      const bool taken = is_jump || (is_jumpi && !bv::is_zero(b));
      int new_pc = next_pc;
      bool bad_jump = false;
      if (taken) {
        bool dest_hi;
        const uint32_t dest_u = low32w(a, &dest_hi);
        const bool dest_small = !dest_hi && dest_u < (uint32_t)code_size;
        const int dest = dest_small ? (int)dest_u : 0;
        const int dc = clampi(dest, 0, code_size);
        const bool jd = CODE_SH ? ((rows[dc].x >> 8) & 1u) != 0
                                : __ldg(code + (size_t)dc * CODE_COLS + 2) != 0;
        new_pc = dest;
        bad_jump = !(dest_small && jd);
      }

      // ---- RETURN / REVERT: a range past the buffer parks the lane
      bool ret_oob = false;
      if (op == OP_RETURN || op == OP_REVERT) {
        bool off_hi, len_hi;
        const uint32_t off_u = low32w(a, &off_hi), len_u = low32w(b, &len_hi);
        const bool big = off_hi || len_hi || off_u >= BIG || len_u >= BIG;
        const int off_i = big ? 0 : (int)off_u, len_i = big ? 0 : (int)len_u;
        ret_oob = !bv::is_zero(b) && (big || off_i + len_i > M) && !underflow;
        if (!ret_oob) {
          ret_offset = off_i;
          ret_len = len_i;
        }
      }

      // ---- status: later marks win
        const bool oog = gas_used + gas > gas_limit;
      int st = RUNNING;
      if (parked || ret_oob) st = NEEDS_HOST;
      if (underflow || bad_jump || op == OP_INVALID || oog) st = INVALID;
      if (op == OP_STOP) st = STOPPED;
      if (op == OP_RETURN && !ret_oob) st = RETURNED;
      if (op == OP_REVERT && !ret_oob) st = REVERTED;
      if (op == OP_SELFDESTRUCT) st = SELFDESTRUCT;
      if (!parked) gas_used += gas;
      if (st == RUNNING) {
        pc = new_pc;
        sp = new_sp;
      }
      status = st;
      steps += 1;
    }
    s.pc[lane] = pc;
    s.sp[lane] = sp;
    s.msize[lane] = msize;
    s.scount[lane] = scount;
    s.gas_used[lane] = gas_used;
    s.status[lane] = status;
    s.ret_offset[lane] = ret_offset;
    s.ret_len[lane] = ret_len;
    s.steps[lane] = steps;
  }
  const bool any_mem = __syncthreads_or(mem_dirty), any_store = __syncthreads_or(store_dirty);
  if (LOCAL) {
    block_rows<true>(stacks, p.stack_w, s.stack + l0 * D * 8, D * 8, nl, p.vec & VEC_STACK);
    if (any_store) {
      block_rows<true>(keys_sh, p.store_w, s.skeys + l0 * S * 8, S * 8, nl, false);
      block_rows<true>(vals_sh, p.store_w, s.svals + l0 * S * 8, S * 8, nl, false);
    }
    if (any_mem) block_bytes<true>(mem_sh, p.mem_b, s.memory + l0 * M, M, nl, p.vec & VEC_MEM);
  }
}

template <bool CODE_SH, bool LOCAL>
int launch(const Lanes& s, const int32_t* code, int code_size, const int32_t* optab,
           int max_steps, const int* plan, cudaStream_t stream) {
  const int smem = plan[P_SMEM];
  static int opted[MAX_DEVICES];  // a device's dynamic shared bytes this instance may take
  const cudaError_t rc = allow_smem((const void*)k_lane_run<CODE_SH, LOCAL>, smem, opted);
  if (rc != cudaSuccess) return (int)rc;
  Plan p;
  p.lpb = plan[P_LPB];
  p.stack_w = plan[P_STACK_W];
  p.store_w = plan[P_STORE_W];
  p.mem_b = plan[P_MEM_B];
  p.head_b = plan[P_HEAD_B];
  p.vec = plan[P_VEC];
  k_lane_run<CODE_SH, LOCAL><<<nblocks_for(s.n, p.lpb), p.lpb, smem, stream>>>(
      s, code, code_size, optab, max_steps, p);
  return (int)cudaGetLastError();
}

}  // namespace

// the field order the library was built with, checked by the wrapper
MTT_EXPORT const char* mtt_lane_fields() { return LANE_FIELDS(LANE_NAME); }

// the length of the plan array the library reads, checked by the wrapper
MTT_EXPORT int mtt_lane_plan_len() { return P_COUNT; }

// K10: every lane of the batch runs up to max_steps steps, in one
// launch shaped by plan (ops/stepper.lane_run_plan).
MTT_EXPORT int lane_run(void** planes, const int* dims, const void* code, int code_size,
                        const void* optab, int max_steps, const int* plan, void* stream) {
  Lanes s = make_lanes(planes, dims);
  if (s.n <= 0) return (int)cudaGetLastError();
  const int32_t* c = (const int32_t*)code;
  const int32_t* o = (const int32_t*)optab;
  cudaStream_t st = (cudaStream_t)stream;
  if (plan[P_CODE_SH]) {
    return plan[P_LOCAL] ? launch<true, true>(s, c, code_size, o, max_steps, plan, st)
                         : launch<true, false>(s, c, code_size, o, max_steps, plan, st);
  }
  return plan[P_LOCAL] ? launch<false, true>(s, c, code_size, o, max_steps, plan, st)
                       : launch<false, false>(s, c, code_size, o, max_steps, plan, st);
}
