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
// Bound: the bytes a run's data needs (each lane's scalars, the stack,
// memory, storage, calldata and env it reads, the code rows it
// executes, every element it changes written once) against the integer
// operations of the instructions retired; chip_smoke.py counts both
// from a traced run of its inputs. The state stays in global memory
// (stack, memory and storage log read through L1, the per-lane scalars
// in registers for the whole run); lanes of one warp run the same code
// in lockstep until their loop counts part.
#include "common.cuh"
#include "bv256.cuh"

using bv::W;

namespace {

constexpr int CODE_COLS = 14;
constexpr int OP_STOP = 0x00, OP_MUL = 0x02, OP_DIV = 0x04, OP_SDIV = 0x05,
              OP_MOD = 0x06, OP_SMOD = 0x07, OP_ADDMOD = 0x08, OP_MULMOD = 0x09,
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

// low 32 bits of a word, and whether any higher bit is set
__device__ __forceinline__ uint32_t low32(const W& w, bool* hi) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 1; i < bv::NL; ++i) acc |= w.l[i];
  *hi = acc != 0;
  return w.l[0];
}

// the big-endian word of 32 bytes
__device__ __forceinline__ W word_of_bytes(const uint8_t* b) {
  W w = bv::zero();
  for (int j = 0; j < 32; ++j) w.l[7 - (j >> 2)] |= (uint32_t)b[j] << (8 * (3 - (j & 3)));
  return w;
}

__global__ void __launch_bounds__(64)
k_lane_run(Lanes s, const int32_t* code, int code_size, const int32_t* optab,
           int max_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= s.n) return;
  int status = s.status[lane];
  if (status != RUNNING || max_steps <= 0) return;
  const int D = s.D, M = s.M, S = s.S, C = s.C;
  int pc = s.pc[lane], sp = s.sp[lane], msize = s.msize[lane];
  int scount = s.scount[lane];
  int ret_offset = s.ret_offset[lane], ret_len = s.ret_len[lane];
  int steps = s.steps[lane];
  uint32_t gas_used = s.gas_used[lane];
  const uint32_t gas_limit = s.gas_limit[lane];
  const int cd_size = s.cd_size[lane];
  uint32_t* stack = s.stack + (size_t)lane * D * 8;
  uint8_t* mem = s.memory + (size_t)lane * M;
  uint32_t* skeys = s.skeys + (size_t)lane * S * 8;
  uint32_t* svals = s.svals + (size_t)lane * S * 8;
  const uint8_t* cd = s.calldata + (size_t)lane * C;
  const uint32_t* env = s.env + (size_t)lane * s.NENV * 8;

  for (int it = 0; it < max_steps && status == RUNNING; ++it) {
    const int pc_c = clampi(pc, 0, code_size);
    const int32_t* row = code + (size_t)pc_c * CODE_COLS;
    const int op = row[0];
    const int32_t* t = optab + (size_t)op * T_COLS;
    const int npop = t[T_NPOP], npush = t[T_NPUSH];
    const bool is_dup = op >= 0x80 && op <= 0x8F, is_swap = op >= 0x90 && op <= 0x9F;
    const int dup_n = is_dup ? op - 0x7F : 1, swap_n = is_swap ? op - 0x8F : 1;
    const int eff_pop = is_dup ? dup_n : (is_swap ? swap_n + 1 : npop);
    const bool underflow = sp < eff_pop;
    const bool overflow = (sp - npop + npush) > D;
    const W a = bv::load(stack + 8 * clampi(sp - 1, 0, D - 1));
    const W b = bv::load(stack + 8 * clampi(sp - 2, 0, D - 1));
    bool mem_oob = false, cd_oob = false, storage_full = false;
    W res = bv::zero();

    switch (t[T_RCLASS]) {
      case RC_ADD: res = bv::add(a, b); break;
      case RC_MUL: res = bv::mul(a, b); break;
      case RC_SUB: res = bv::sub(a, b); break;
      case RC_DIV: res = bv::div(a, b); break;
      case RC_MOD: res = bv::mod(a, b); break;
      case RC_SDIV: case RC_SMOD: {
        W q, r;
        bv::sdivmod(a, b, q, r);
        res = op == OP_SDIV ? q : r;
        break;
      }
      case RC_ADDMOD: case RC_MULMOD: {
        const W c = bv::load(stack + 8 * clampi(sp - 3, 0, D - 1));
        res = op == OP_ADDMOD ? bv::addmod(a, b, c) : bv::mulmod(a, b, c);
        break;
      }
      case RC_EXP: res = bv::exp(a, b); break;
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
      case RC_ENV: res = bv::load(env + 8 * clampi(t[T_ENV], 0, s.NENV - 1)); break;
      case RC_PUSH:
#pragma unroll
        for (int i = 0; i < 8; ++i) res.l[i] = (uint32_t)row[4 + i];
        break;
      case RC_DUP: res = bv::load(stack + 8 * clampi(sp - dup_n, 0, D - 1)); break;
      default: break;  // MLOAD, SLOAD, CALLDATALOAD below; ZERO
    }

    // ---- memory
    if (op == OP_MLOAD || op == OP_MSTORE || op == OP_MSTORE8) {
      bool hi;
      const uint32_t off_u = low32(a, &hi);
      const bool big = hi || off_u >= BIG;
      const int off = big ? 0 : (int)off_u;
      const bool word = op != OP_MSTORE8;
      mem_oob = word ? (big || off + 32 > M) : (big || off >= M);
      if (op == OP_MLOAD) {
        for (int j = 0; j < 32; ++j)
          res.l[7 - (j >> 2)] |= (uint32_t)mem[clampi(off + j, 0, M - 1)] << (8 * (3 - (j & 3)));
      } else if (!mem_oob && !underflow) {
        if (op == OP_MSTORE) {
          for (int j = 0; j < 32; ++j)
            mem[off + j] = (uint8_t)(b.l[7 - (j >> 2)] >> (8 * (3 - (j & 3))));
        } else {
          mem[off] = (uint8_t)(b.l[0] & 0xFFu);
        }
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
      for (int k = 0; k < S; ++k)
        if (k < scount && bv::eq(bv::load(skeys + 8 * k), a)) best = k + 1;
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
        }
      }
    }

    // ---- calldata: bytes past cd_size read zero
    if (op == OP_CALLDATALOAD) {
      bool hi;
      const uint32_t off_u = low32(a, &hi);
      const int off = (hi || off_u >= BIG) ? C : (int)off_u;
      for (int j = 0; j < 32; ++j) {
        const int idx = off + j;
        const uint32_t byte = (idx < cd_size && idx < C) ? cd[clampi(idx, 0, C - 1)] : 0u;
        res.l[7 - (j >> 2)] |= byte << (8 * (3 - (j & 3)));
      }
      cd_oob = off < cd_size && off + 32 > C;
    }

    // ---- the stack: push, or SWAPn
    const bool parked = t[T_SUP] == 0 || mem_oob || cd_oob || storage_full || overflow;
    const int new_sp = sp - npop + npush;
    if (npush == 1 && !underflow && !parked)
      bv::store(stack + 8 * clampi(new_sp - 1, 0, D - 1), res);
    if (is_swap && !underflow) {
      const W swap_val = bv::load(stack + 8 * clampi(sp - swap_n - 1, 0, D - 1));
      bv::store(stack + 8 * clampi(sp - 1, 0, D - 1), swap_val);
      bv::store(stack + 8 * clampi(sp - 1 - swap_n, 0, D - 1), a);
    }

    // ---- control flow
    bool dest_hi;
    const uint32_t dest_u = low32(a, &dest_hi);
    const bool dest_small = !dest_hi && dest_u < (uint32_t)code_size;
    const int dest = dest_small ? (int)dest_u : 0;
    const bool dest_ok = dest_small && code[(size_t)clampi(dest, 0, code_size) * CODE_COLS + 2] != 0;
    const bool is_jump = op == OP_JUMP, is_jumpi = op == OP_JUMPI;
    const bool taken = is_jump || (is_jumpi && !bv::is_zero(b));
    const int new_pc = taken ? dest : row[1];
    const bool bad_jump = taken && !dest_ok;

    // ---- RETURN / REVERT: a range past the buffer parks the lane
    const bool is_ret = op == OP_RETURN || op == OP_REVERT;
    bool ret_oob = false;
    if (is_ret) {
      bool off_hi, len_hi;
      const uint32_t off_u = low32(a, &off_hi), len_u = low32(b, &len_hi);
      const bool big = off_hi || len_hi || off_u >= BIG || len_u >= BIG;
      const int off_i = big ? 0 : (int)off_u, len_i = big ? 0 : (int)len_u;
      ret_oob = !bv::is_zero(b) && (big || off_i + len_i > M) && !underflow;
      if (!ret_oob) {
        ret_offset = off_i;
        ret_len = len_i;
      }
    }

    // ---- status: later marks win
    const uint32_t gas = (uint32_t)t[T_GAS];
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

}  // namespace

// the field order the library was built with, checked by the wrapper
MTT_EXPORT const char* mtt_lane_fields() { return LANE_FIELDS(LANE_NAME); }

// K10: every lane of the batch runs up to max_steps steps.
MTT_EXPORT int lane_run(void** planes, const int* dims, const void* code, int code_size,
                        const void* optab, int max_steps, void* stream) {
  Lanes s = make_lanes(planes, dims);
  if (s.n > 0)
    k_lane_run<<<nblocks_for(s.n, 64), 64, 0, (cudaStream_t)stream>>>(
        s, (const int32_t*)code, code_size, (const int32_t*)optab, max_steps);
  return (int)cudaGetLastError();
}
