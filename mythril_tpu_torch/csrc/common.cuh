// Shared by the port's kernels: the lane-state view, the C-side error
// string, launch-shape helpers and the per-device shared-memory opt-in.
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

inline unsigned nblocks_for(long long len, int block) {
  return (unsigned)((len + block - 1) / block);
}

// The devices a process may hold for the per-device flags below.
constexpr int MAX_DEVICES = 64;

// Lets kernel `fn` take `smem` bytes of dynamic shared memory on the
// current device. cudaFuncSetAttribute holds only for the device current
// when it is called, so the limit is kept per device in `opted` (one entry
// a device, zero at first, one array a kernel): a process that launches on
// several cards opts in once on each.
inline cudaError_t allow_smem(const void* fn, int smem, int* opted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < MAX_DEVICES && opted[dev] >= smem) return cudaSuccess;
  rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess && dev < MAX_DEVICES) opted[dev] = smem;
  return rc;
}
