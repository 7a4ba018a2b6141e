// Kernel K9: the window-merge fingerprint (laser/lane_engine.py
// merge_fingerprint; the JAX _merge_fingerprint). For each lane, two
// 32-bit multilinear hashes over everything its future execution can
// read, plus its raw gas interval: out[n][4] = {h1, h2, min_gas,
// max_gas}.
//
// One block per lane. Each fold of the JAX function is one pass over
// its columns: thread t takes columns t, t+256, ..., the two column
// sums are wrapping uint32 sums (order-free mod 2^32, so the block
// reduction is exact), and thread 0 folds them into (h1, h2). Folds run
// in the JAX order and each bumps the seed that salts its column
// weights. Provisional (negative) sids resolve through a dense
// (lane, slot) table built from the sparse prov pairs first
// (fp_fill, fp_scatter), with the JAX gather's row clamp.
#include "common.cuh"

namespace {

constexpr int FP_BLOCK = 256;
constexpr int NLIMBS = 8;
constexpr uint8_t KIND_SYM_WORD = 3;

__device__ __forceinline__ uint32_t sm32(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// dense[i] = INT32_MIN, then dense[slot] = oid for each pair whose slot
// is in range (the JAX mode="drop" scatter: a negative slot counts from
// the end; pairs never repeat a slot)
__global__ void fp_fill(int32_t* dense, long long len) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < len) dense[i] = INT32_MIN;
}

__global__ void fp_scatter(const int32_t* pairs, int np, int32_t* dense,
                           long long len) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  long long slot = pairs[2 * i];
  if (slot < 0) slot += len;
  if (slot >= 0 && slot < len) dense[slot] = pairs[2 * i + 1];
}

// a sid plane value with provisional sids resolved (the JAX remap:
// prov_arr[idx // R, idx % R], the row clamped to the table)
__device__ __forceinline__ int32_t remap(int32_t v, const int32_t* dense,
                                         int n, int R) {
  if (v >= 0) return v;
  long long idx = -(long long)v - 1;
  long long row = idx / R;
  if (row > n - 1) row = n - 1;
  return dense[row * R + idx % R];
}

struct Fold {
  uint32_t h1, h2;  // live in thread 0
  uint32_t seed;
};

// The two column sums of one fold over the block: every thread passes
// its partial sums; thread 0 folds the totals into the hashes.
__device__ __forceinline__ void fold_reduce(Fold& f, uint32_t s1, uint32_t s2,
                                            uint32_t* red) {
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xFFFFFFFFu, s1, off);
    s2 += __shfl_down_sync(0xFFFFFFFFu, s2, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[2 * warp] = s1;
    red[2 * warp + 1] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t1 = 0, t2 = 0;
    for (int w = 0; w < FP_BLOCK / 32; ++w) {
      t1 += red[2 * w];
      t2 += red[2 * w + 1];
    }
    f.h1 = (f.h1 ^ t1) * 16777619u;
    uint32_t h2 = (f.h2 + t2) * 2654435761u;
    f.h2 = h2 ^ (h2 >> 15);
  }
  __syncthreads();
}

// the contribution of column c (value v, already masked to 0 where the
// JAX fold masks it) under the current seed
__device__ __forceinline__ void column(uint32_t seed, long long c, uint32_t v,
                                       uint32_t& s1, uint32_t& s2) {
  uint32_t idx = (uint32_t)c + seed * 0x632BE59Bu;
  uint32_t w1 = sm32(idx);
  uint32_t w2 = sm32(idx ^ 0x7F4A7C15u);
  s1 += v * w1;
  s2 += (v ^ w2) * w1;
}

// One fold over k columns; get(c, &v) returns the column's value with
// its mask applied.
template <typename Get>
__device__ __forceinline__ void fold(Fold& f, long long k, Get get,
                                     uint32_t* red) {
  f.seed += 1;
  uint32_t s1 = 0, s2 = 0;
  for (long long c = threadIdx.x; c < k; c += FP_BLOCK)
    column(f.seed, c, get(c), s1, s2);
  fold_reduce(f, s1, s2, red);
}

__global__ void __launch_bounds__(FP_BLOCK)
fp_lanes(Sym s, const int32_t* __restrict__ dense, uint32_t* __restrict__ out) {
  extern __shared__ int32_t sh[];
  __shared__ uint32_t red[2 * FP_BLOCK / 32];
  const int lane = blockIdx.x;
  const int n = s.n, D = s.D, M = s.M, MR = s.MR, S = s.S, R = s.R;
  int32_t* ssid_r = sh;            // D
  int32_t* skey_r = sh + D;        // S
  int32_t* sval_r = skey_r + S;    // S
  int32_t* ws = sval_r + S;        // S: write stamps, INT32_MAX unwritten
  int32_t* wr = ws + S;            // S: written (slot live and s_written)

  const int sp = s.sp[lane], mlog_count = s.mlog_count[lane];
  const int scount = s.scount[lane];
  for (int i = threadIdx.x; i < D; i += FP_BLOCK)
    ssid_r[i] = remap(s.ssid[(long long)lane * D + i], dense, n, R);
  for (int i = threadIdx.x; i < S; i += FP_BLOCK) {
    long long o = (long long)lane * S + i;
    skey_r[i] = remap(s.skey_sid[o], dense, n, R);
    sval_r[i] = remap(s.sval_sid[o], dense, n, R);
    int written = (i < scount) && (s.s_written[o] != 0);
    wr[i] = written;
    ws[i] = written ? s.s_wstep[o] : INT32_MAX;
  }
  __syncthreads();

  Fold f{2166136261u, 0x9E3779B9u, 0u};
  // the scalars: one column each, salted by its own seed
  const uint32_t scal[14] = {
      (uint32_t)s.pc[lane],        (uint32_t)sp,
      (uint32_t)s.depth[lane],     (uint32_t)s.group[lane],
      (uint32_t)s.fentry[lane],    (uint32_t)s.msize[lane],
      (uint32_t)mlog_count,        (uint32_t)scount,
      (uint32_t)s.s_mode[lane],    (uint32_t)s.sbase[lane],
      (uint32_t)s.cd_size[lane],   (uint32_t)s.cd_sym[lane],
      (uint32_t)s.cd_size_sid[lane], s.gas_limit[lane]};
  for (int j = 0; j < 14; ++j)
    fold(f, 1, [&](long long) { return scal[j]; }, red);

  // the live stack: canonical sids, then the concrete words' limbs
  fold(f, D, [&](long long c) {
    return c < sp ? (uint32_t)ssid_r[c] : 0u;
  }, red);
  const uint32_t* stack = s.stack + (long long)lane * D * NLIMBS;
  fold(f, (long long)D * NLIMBS, [&](long long c) {
    int slot = (int)(c / NLIMBS);
    return (slot < sp && ssid_r[slot] == 0) ? stack[c] : 0u;
  }, red);

  // memory: the kind plane in full, bytes where a concrete value lives,
  // the overlay records
  const uint8_t* mkind = s.mkind + (long long)lane * M;
  const uint8_t* mem = s.memory + (long long)lane * M;
  fold(f, M, [&](long long c) { return (uint32_t)mkind[c]; }, red);
  fold(f, M, [&](long long c) {
    uint8_t k = mkind[c];
    return (k != 0 && k != KIND_SYM_WORD) ? (uint32_t)mem[c] : 0u;
  }, red);
  const long long mo = (long long)lane * MR;
  fold(f, MR, [&](long long c) {
    return c < mlog_count ? (uint32_t)s.mlog_off[mo + c] : 0u;
  }, red);
  fold(f, MR, [&](long long c) {
    return c < mlog_count ? (uint32_t)s.mlog_len[mo + c] : 0u;
  }, red);
  fold(f, MR, [&](long long c) {
    return c < mlog_count ? (uint32_t)remap(s.mlog_sid[mo + c], dense, n, R)
                          : 0u;
  }, red);

  // the storage slot table
  const long long so = (long long)lane * S;
  fold(f, S, [&](long long c) {
    return c < scount ? (uint32_t)skey_r[c] : 0u;
  }, red);
  fold(f, S, [&](long long c) {
    return c < scount ? (uint32_t)sval_r[c] : 0u;
  }, red);
  fold(f, S, [&](long long c) {
    return c < scount ? (uint32_t)s.s_written[so + c] : 0u;
  }, red);
  fold(f, S, [&](long long c) {
    return c < scount ? (uint32_t)s.s_read[so + c] : 0u;
  }, red);
  const uint32_t* skeys = s.skeys + so * NLIMBS;
  const uint32_t* svals = s.svals + so * NLIMBS;
  fold(f, (long long)S * NLIMBS, [&](long long c) {
    int slot = (int)(c / NLIMBS);
    return (slot < scount && skey_r[slot] == 0) ? skeys[c] : 0u;
  }, red);
  fold(f, (long long)S * NLIMBS, [&](long long c) {
    int slot = (int)(c / NLIMBS);
    return (slot < scount && sval_r[slot] == 0) ? svals[c] : 0u;
  }, red);
  // write order: each written slot's rank among the lane's writes
  // (ties by slot index), -1 for the rest
  fold(f, S, [&](long long c) {
    int i = (int)c;
    if (!wr[i]) return 0xFFFFFFFFu;
    int rank = 0;
    for (int j = 0; j < S; ++j)
      rank += wr[j] && (ws[i] > ws[j] || (ws[i] == ws[j] && i > j));
    return (uint32_t)rank;
  }, red);

  if (threadIdx.x == 0) {
    uint32_t* o = out + (long long)lane * 4;
    o[0] = f.h1;
    o[1] = f.h2;
    o[2] = s.min_gas[lane];
    o[3] = s.max_gas[lane];
  }
}

}  // namespace

// planes/dims: ops/symstep.state_args; pairs: (np, 2) int32 prov pairs;
// dense: n * R int32 scratch; out: (n, 4) uint32 (int32 bit patterns)
MTT_EXPORT int merge_fingerprint(void** planes, const int* dims,
                                 const int32_t* pairs, int np, int32_t* dense,
                                 uint32_t* out, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  long long len = (long long)s.n * s.R;
  if (s.n == 0) return (int)cudaGetLastError();
  fp_fill<<<nblocks_for(len, 256), 256, 0, st>>>(dense, len);
  if (np > 0)
    fp_scatter<<<nblocks_for(np, 256), 256, 0, st>>>(pairs, np, dense, len);
  size_t shmem = sizeof(int32_t) * ((size_t)s.D + 4 * (size_t)s.S);
  fp_lanes<<<s.n, FP_BLOCK, shmem, st>>>(s, dense, out);
  return (int)cudaGetLastError();
}
