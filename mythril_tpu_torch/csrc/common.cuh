// Shared by the port's kernels: the lane-state view, the C-side error
// string, and the block-level prefix scan the ordered compactions use.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define MTT_EXPORT extern "C" __attribute__((visibility("default")))

MTT_EXPORT const char* mtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every plane of ops/symstep.SymLaneState, in its field order. Planes
// the JAX package holds as uint32 are uint32_t here (the port stores
// their bit patterns in int32 tensors); uint8 planes are uint8_t.
#define SYM_FIELDS(X)                                                  \
  X(int32_t, pc) X(int32_t, sp) X(int32_t, depth) X(int32_t, group)   \
  X(int32_t, fentry) X(int32_t, last_jump) X(uint32_t, stack)         \
  X(int32_t, ssid) X(uint8_t, memory) X(uint8_t, mkind)               \
  X(int32_t, msize) X(int32_t, mlog_off) X(int32_t, mlog_len)         \
  X(int32_t, mlog_sid) X(int32_t, mlog_count) X(uint32_t, skeys)      \
  X(uint32_t, svals) X(int32_t, sval_sid) X(int32_t, s_written)       \
  X(int32_t, s_read) X(int32_t, skey_sid) X(int32_t, s_wstep)         \
  X(int32_t, s_mode) X(int32_t, scount) X(int32_t, sbase)             \
  X(uint8_t, calldata) X(int32_t, cd_size) X(int32_t, cd_sym)         \
  X(int32_t, cd_size_sid) X(uint32_t, env) X(int32_t, env_sid)        \
  X(uint32_t, min_gas) X(uint32_t, max_gas) X(uint32_t, gas_limit)    \
  X(int32_t, status) X(int32_t, steps) X(int32_t, dlog_op)            \
  X(int32_t, dlog_pc) X(int32_t, dlog_step) X(int32_t, dlog_fentry)   \
  X(int32_t, dlog_sid) X(uint32_t, dlog_val) X(int32_t, dlog_count)   \
  X(int32_t, flog_parent) X(int32_t, flog_child) X(int32_t, flog_step) \
  X(int32_t, flog_pc) X(int32_t, flog_sid) X(uint32_t, flog_gmin)     \
  X(uint32_t, flog_gmax) X(int32_t, flog_fentry) X(int32_t, flog_dest) \
  X(int32_t, flog_count) X(int32_t, free_slots) X(int32_t, free_count) \
  X(int32_t, step_no)

#define SYM_DECL(T, name) T* name;
#define SYM_COUNT(T, name) +1
#define SYM_NAME(T, name) #name ","

constexpr int SYM_NFIELDS = 0 SYM_FIELDS(SYM_COUNT);

// dims order: n, D, M, MR, S, C, R, F, NENV
struct Sym {
  SYM_FIELDS(SYM_DECL)
  int n, D, M, MR, S, C, R, F, NENV;
};

inline Sym make_sym(void** p, const int* dims) {
  Sym s;
  int i = 0;
#define SYM_SET(T, name) s.name = (T*)p[i++];
  SYM_FIELDS(SYM_SET)
#undef SYM_SET
  s.n = dims[0];
  s.D = dims[1];
  s.M = dims[2];
  s.MR = dims[3];
  s.S = dims[4];
  s.C = dims[5];
  s.R = dims[6];
  s.F = dims[7];
  s.NENV = dims[8];
  return s;
}

// the field order the library was built with, checked by the wrapper
MTT_EXPORT const char* mtt_sym_fields() { return SYM_FIELDS(SYM_NAME); }

__host__ __device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

constexpr int SCAN_BLOCK = 256;

// Exclusive prefix of `flag` over the threads of a SCAN_BLOCK-thread
// block (thread order). Writes the block's total to *total. Every
// thread of the block must call it.
__device__ inline int block_exclusive_scan(int flag, int* total) {
  __shared__ int warp_sums[SCAN_BLOCK / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag != 0);
  int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < SCAN_BLOCK / 32; ++w) {
    if (w < warp) before += warp_sums[w];
    sum += warp_sums[w];
  }
  __syncthreads();
  *total = sum;
  return before + in_warp;
}

// Ordered compaction, in three launches (count, scan, write): the
// indices i < len with flag[i] != 0, in ascending order, into
// out[0..cap), the rest of out holding `pad`; *count gets the number
// of flags set. `block_off` needs ceil(len / SCAN_BLOCK) + 1 ints.
__global__ void compact_count(const int32_t* flag, long long len, int32_t* block_off) {
  long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  int f = i < len ? (flag[i] != 0) : 0;
  int total;
  block_exclusive_scan(f, &total);
  if (threadIdx.x == 0) block_off[blockIdx.x] = total;
}

__global__ void compact_scan(int32_t* block_off, int nblocks, int32_t* count) {
  // one block: running exclusive scan over the block totals
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
  if (threadIdx.x == 0) {
    block_off[nblocks] = carry;
    if (count) *count = carry;
  }
}

__global__ void compact_write(const int32_t* flag, long long len,
                              const int32_t* block_off, int32_t* out, int cap) {
  long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  int f = i < len ? (flag[i] != 0) : 0;
  int total;
  int rank = block_exclusive_scan(f, &total);
  if (f) {
    long long pos = (long long)block_off[blockIdx.x] + rank;
    if (pos < cap) out[pos] = (int32_t)i;
  }
}

__global__ void fill_i32(int32_t* p, long long len, int32_t v) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < len) p[i] = v;
}

inline unsigned nblocks_for(long long len, int block) {
  return (unsigned)((len + block - 1) / block);
}

// out[0..cap) = ascending indices with flag set, padded with `pad`
// (scratch: ceil(len/SCAN_BLOCK)+1 ints); *count (device) = flags set
inline void compact(const int32_t* flag, long long len, int32_t* out, int cap,
                    int32_t pad, int32_t* scratch, int32_t* count,
                    cudaStream_t st) {
  unsigned nb = nblocks_for(len, SCAN_BLOCK);
  if (cap > 0) fill_i32<<<nblocks_for(cap, 256), 256, 0, st>>>(out, cap, pad);
  if (nb == 0) {
    if (count) fill_i32<<<1, 1, 0, st>>>(count, 1, 0);
    return;
  }
  compact_count<<<nb, SCAN_BLOCK, 0, st>>>(flag, len, scratch);
  compact_scan<<<1, SCAN_BLOCK, 0, st>>>(scratch, (int)nb, count);
  if (cap > 0) compact_write<<<nb, SCAN_BLOCK, 0, st>>>(flag, len, scratch, out, cap);
}
