// Kernel K9: the window-merge fingerprint (laser/lane_engine.py
// merge_fingerprint; the JAX _merge_fingerprint). For each lane, two
// 32-bit multilinear hashes over everything its future execution can
// read, plus its raw gas interval: out[n][4] = {h1, h2, min_gas,
// max_gas}.
//
// The JAX function folds 28 arrays into (h1, h2) one after another:
// fold j adds two column sums, s1 = sum v * w1 and s2 = sum (v ^ w2) *
// w1, whose weights depend only on the fold's seed j and the column.
// The sums are wrapping uint32 sums, so their order does not matter:
// one pass over a lane's planes accumulates every fold's two sums at
// once (28 registers a thread), each warp reduces them by shuffles and
// the lane's warps through shared memory (one reduction a lane, not
// 28), 14 threads take the scalar folds (one column each, no
// reduction), and one thread applies the 28 folds in the JAX order.
// A lane is a team's: the whole block's 8 warps where the batch has
// few lanes (the corpus's 64: 64 blocks), one warp where it has many
// (8 lanes a block at a time, the grid one block an SM walking over
// the lanes; lane_engine.merge_fp_plan). A block builds its pair table
// once. mkind and memory are read together, 16
// bytes a thread where the wrapper found them aligned, and a memory
// chunk only where one of its kinds is concrete.
//
// Provisional (negative) sids resolve through the window's (slot, oid)
// pairs with the JAX gather's row clamp; where a slot comes twice the
// last pair wins, as the JAX scatter leaves it. Up to 4096 pairs
// they sit in an open-addressing hash in each block's shared memory
// (one launch a call); past that in a dense (lane, slot) table of pair
// indices in global memory, filled and scattered first (three launches,
// as before). A block's hash can pass 48 KB of shared memory; it opts
// in once a device (common.cuh allow_smem), so one process may merge on
// several cards.
//
// Bound: bytes (the planes a lane's fingerprint must read, the pairs,
// 16 bytes a lane written; chip_smoke.py merge_bytes).
#include "common.cuh"

namespace {

constexpr int FP_THREADS = 256;
constexpr int FP_WARPS = FP_THREADS / 32;
constexpr int NLIMBS = 8;
constexpr uint8_t KIND_SYM_WORD = 3;
constexpr int N_SCALAR = 14;
constexpr int N_COLUMN = 14;        // the column folds, seeds 15..28
constexpr int N_SUMS = 2 * N_COLUMN;
constexpr unsigned long long EMPTY = ~0ULL;
constexpr uint32_t HASH_MUL = 0x9E3779B1u;

// the shared bytes of a block: the pair hash (cap entries), each
// team's staged sid rows (D + 4 S ints), the warps' sums and each
// team's 56 fold sums (lane_engine.merge_fp_plan mirrors it)
__host__ __device__ inline size_t fp_smem(int cap, int W, int D, int S) {
  const size_t stage = ((size_t)D + 4 * (size_t)S + 3) / 4 * 4;
  const size_t teams = FP_WARPS / W;
  return 8 * (size_t)cap + 4 * (teams * stage + (size_t)FP_WARPS * N_SUMS + teams * 2 * N_SUMS);
}

__device__ __forceinline__ uint32_t sm32(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// the contribution of column c (value v, already masked to 0 where the
// JAX fold masks it) under fold seed `seed`
__device__ __forceinline__ void column(uint32_t seed, uint32_t c, uint32_t v,
                                       uint32_t& s1, uint32_t& s2) {
  const uint32_t idx = c + seed * 0x632BE59Bu;
  const uint32_t w1 = sm32(idx);
  const uint32_t w2 = sm32(idx ^ 0x7F4A7C15u);
  s1 += v * w1;
  s2 += (v ^ w2) * w1;
}

__device__ __forceinline__ uint32_t prov_bucket(long long key, int cap) {
  return ((uint32_t)key * HASH_MUL) & (uint32_t)(cap - 1);
}

// an entry is slot << 32 | pair index; of two pairs naming one slot the
// later (larger index) stays
__device__ void prov_insert(unsigned long long* hash, int cap, long long key, int j) {
  const unsigned long long want = ((unsigned long long)key << 32) | (uint32_t)j;
  for (uint32_t h = prov_bucket(key, cap);; h = (h + 1) & (uint32_t)(cap - 1)) {
    unsigned long long e = hash[h];
    if (e == EMPTY) {
      e = atomicCAS(hash + h, EMPTY, want);
      if (e == EMPTY) return;
    }
    if ((e >> 32) == (unsigned long long)key) {
      atomicMax(hash + h, want);
      return;
    }
  }
}

struct Prov {
  const int32_t* pairs;
  const int32_t* dense;  // the dense table's pair indices (-1: none), or null
  const unsigned long long* hash;
  int cap, n, R;
};

// a sid plane value with provisional sids resolved (the JAX remap:
// prov_arr[idx // R, idx % R], the row clamped to the table; int32 min
// where no pair names the slot)
__device__ __forceinline__ int32_t remap(const Prov& p, int32_t v) {
  if (v >= 0) return v;
  const long long idx = -(long long)v - 1;
  long long row = idx / p.R;
  if (row > p.n - 1) row = p.n - 1;
  const long long key = row * p.R + idx % p.R;
  int j = -1;
  if (p.dense) {
    j = p.dense[key];
  } else {
    for (uint32_t h = prov_bucket(key, p.cap);; h = (h + 1) & (uint32_t)(p.cap - 1)) {
      const unsigned long long e = p.hash[h];
      if (e == EMPTY) break;
      if ((e >> 32) == (unsigned long long)key) {
        j = (int)(uint32_t)e;
        break;
      }
    }
  }
  return j >= 0 ? p.pairs[2 * (size_t)j + 1] : INT32_MIN;
}

// the dense table: -1 everywhere, then each in-range pair's index at its
// slot (a negative slot counts from the end), the largest index winning
__global__ void fp_fill(int32_t* dense, long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < len) dense[i] = -1;
}

__global__ void fp_scatter(const int32_t* pairs, int np, int32_t* dense, long long len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  long long slot = pairs[2 * (size_t)i];
  if (slot < 0) slot += len;
  if (slot >= 0 && slot < len) atomicMax(dense + slot, i);
}

#ifndef MTT_DYN_SMEM
#define MTT_DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

// the fold of scalar j (seed j + 1) of lane L, one column
__device__ __forceinline__ uint32_t scalar_of(const Sym& s, long long L, int j) {
  switch (j) {
    case 0: return (uint32_t)s.pc[L];
    case 1: return (uint32_t)s.sp[L];
    case 2: return (uint32_t)s.depth[L];
    case 3: return (uint32_t)s.group[L];
    case 4: return (uint32_t)s.fentry[L];
    case 5: return (uint32_t)s.msize[L];
    case 6: return (uint32_t)s.mlog_count[L];
    case 7: return (uint32_t)s.scount[L];
    case 8: return (uint32_t)s.s_mode[L];
    case 9: return (uint32_t)s.sbase[L];
    case 10: return (uint32_t)s.cd_size[L];
    case 11: return (uint32_t)s.cd_sym[L];
    case 12: return (uint32_t)s.cd_size_sid[L];
    default: return s.gas_limit[L];
  }
}

// Each block: its pair hash, once; then teams of W warps (W = 8: the
// block, W = 1: a warp) walk over lanes, a team a lane at a time: the
// lane's sid rows resolved into the team's stage, one pass over its
// columns with 28 sums a thread, one reduction (warp shuffles, then the
// team's warps through shared memory), the 14 scalar folds by 14
// threads, and the 28 folds applied in the JAX order by one thread.
__global__ void __launch_bounds__(FP_THREADS)
fp_lanes(Sym s, const int32_t* __restrict__ pairs, int pv, const int32_t* __restrict__ dense,
         int cap, int W, int vec, int gn, uint32_t* __restrict__ out) {
  MTT_DYN_SMEM(fp_smem_buf);
  const int n = s.n, D = s.D, M = s.M, MR = s.MR, S = s.S, R = s.R;
  const int teams = FP_WARPS / W;
  const int stage_w = (D + 4 * S + 3) / 4 * 4;
  unsigned long long* const hash = reinterpret_cast<unsigned long long*>(fp_smem_buf);
  int32_t* const stage_all = reinterpret_cast<int32_t*>(hash + cap);
  uint32_t* const red = reinterpret_cast<uint32_t*>(stage_all + teams * stage_w);
  uint32_t* const fin_all = red + FP_WARPS * N_SUMS;
  const long long nr = (long long)gn * R;

  if (cap) {
    for (int i = threadIdx.x; i < cap; i += FP_THREADS) hash[i] = EMPTY;
    __syncthreads();
    // the slots a batch at a time, loaded before any insert, so a
    // thread waits on one round trip a batch, not one a pair
    constexpr int BATCH = 8;
    for (int j0 = threadIdx.x; j0 < pv; j0 += BATCH * FP_THREADS) {
      int32_t slots[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int j = j0 + b * FP_THREADS;
        slots[b] = j < pv ? pairs[2 * (size_t)j] : 0;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int j = j0 + b * FP_THREADS;
        long long slot = slots[b];
        if (slot < 0) slot += nr;
        if (j < pv && slot >= 0 && slot < nr) prov_insert(hash, cap, slot, j);
      }
    }
    __syncthreads();
  }
  const Prov pr{pairs, cap ? nullptr : dense, hash, cap, gn, R};
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int team = warp / W, TS = 32 * W, tt = (warp % W) * 32 + wl;
  int32_t* const ssid_r = stage_all + team * stage_w;  // D
  int32_t* const skey_r = ssid_r + D;                   // S
  int32_t* const sval_r = skey_r + S;                   // S
  int32_t* const ws = sval_r + S;  // S: write stamps, INT32_MAX unwritten
  int32_t* const wr = ws + S;      // S: written (slot live and s_written)
  uint32_t* const fin = fin_all + team * 2 * N_SUMS;

  for (int lane = blockIdx.x * teams + team; lane < n; lane += gridDim.x * teams) {
    const long long L = lane;
    const int sp = s.sp[L], mlog_count = s.mlog_count[L], scount = s.scount[L];
    for (int i = tt; i < D; i += TS) ssid_r[i] = remap(pr, s.ssid[L * D + i]);
    for (int i = tt; i < S; i += TS) {
      const long long o = L * S + i;
      skey_r[i] = remap(pr, s.skey_sid[o]);
      sval_r[i] = remap(pr, s.sval_sid[o]);
      const int written = (i < scount) && (s.s_written[o] != 0);
      wr[i] = written;
      ws[i] = written ? s.s_wstep[o] : INT32_MAX;
    }
    if (W == 1) __syncwarp(); else __syncthreads();

    uint32_t a[N_SUMS];
#pragma unroll
    for (int k = 0; k < N_SUMS; ++k) a[k] = 0;
    // fold k (seed 15 + k) keeps its sums in a[2k], a[2k + 1]
#define COL(k, c, v) column(15u + (k), (uint32_t)(c), (v), a[2 * (k)], a[2 * (k) + 1])

    // the live stack: canonical sids, then the concrete words' limbs
    for (int c = tt; c < D; c += TS) COL(0, c, c < sp ? (uint32_t)ssid_r[c] : 0u);
    const uint32_t* stack = s.stack + L * D * NLIMBS;
#pragma unroll 4
    for (int c = tt; c < D * NLIMBS; c += TS) {
      const int slot = c / NLIMBS;
      COL(1, c, (slot < sp && ssid_r[slot] == 0) ? stack[c] : 0u);
    }

    // memory: the kind plane in full, bytes where a concrete value lives
    const uint8_t* mkind = s.mkind + L * M;
    const uint8_t* mem = s.memory + L * M;
    if (vec) {
#pragma unroll 2
      for (int u = tt; u < M / 16; u += TS) {
        const uint4 kq = reinterpret_cast<const uint4*>(mkind)[u];
        const uint32_t kw[4] = {kq.x, kq.y, kq.z, kq.w};
        bool conc = false;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const uint32_t k = (kw[b >> 2] >> (8 * (b & 3))) & 0xFFu;
          conc |= k != 0 && k != KIND_SYM_WORD;
        }
        uint4 mq = make_uint4(0, 0, 0, 0);
        if (conc) mq = reinterpret_cast<const uint4*>(mem)[u];
        const uint32_t mw[4] = {mq.x, mq.y, mq.z, mq.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const uint32_t k = (kw[b >> 2] >> (8 * (b & 3))) & 0xFFu;
          const uint32_t m = (mw[b >> 2] >> (8 * (b & 3))) & 0xFFu;
          COL(2, 16 * u + b, k);
          COL(3, 16 * u + b, (k != 0 && k != KIND_SYM_WORD) ? m : 0u);
        }
      }
    } else {
#pragma unroll 4
      for (int c = tt; c < M; c += TS) {
        const uint32_t k = mkind[c];
        COL(2, c, k);
        COL(3, c, (k != 0 && k != KIND_SYM_WORD) ? (uint32_t)mem[c] : 0u);
      }
    }

    // the overlay records
    const long long mo = L * MR;
    for (int c = tt; c < MR; c += TS) {
      const bool live = c < mlog_count;
      COL(4, c, live ? (uint32_t)s.mlog_off[mo + c] : 0u);
      COL(5, c, live ? (uint32_t)s.mlog_len[mo + c] : 0u);
      COL(6, c, live ? (uint32_t)remap(pr, s.mlog_sid[mo + c]) : 0u);
    }

    // the storage slot table; write order: each written slot's rank among
    // the lane's writes (ties by slot index), -1 for the rest
    const long long so = L * S;
    for (int c = tt; c < S; c += TS) {
      const bool live = c < scount;
      COL(7, c, live ? (uint32_t)skey_r[c] : 0u);
      COL(8, c, live ? (uint32_t)sval_r[c] : 0u);
      COL(9, c, live ? (uint32_t)s.s_written[so + c] : 0u);
      COL(10, c, live ? (uint32_t)s.s_read[so + c] : 0u);
      uint32_t rank_c = 0xFFFFFFFFu;
      if (wr[c]) {
        int r = 0;
        for (int j = 0; j < S; ++j) r += wr[j] && (ws[c] > ws[j] || (ws[c] == ws[j] && c > j));
        rank_c = (uint32_t)r;
      }
      COL(13, c, rank_c);
    }
    const uint32_t* skeys = s.skeys + so * NLIMBS;
    const uint32_t* svals = s.svals + so * NLIMBS;
#pragma unroll 4
    for (int c = tt; c < S * NLIMBS; c += TS) {
      const int slot = c / NLIMBS;
      const bool live = slot < scount;
      COL(11, c, (live && skey_r[slot] == 0) ? skeys[c] : 0u);
      COL(12, c, (live && sval_r[slot] == 0) ? svals[c] : 0u);
    }
#undef COL

    // one reduction: the warps' shuffles, then the team's warps
#pragma unroll
    for (int k = 0; k < N_SUMS; ++k) {
      uint32_t v = a[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
      if (wl == 0) red[warp * N_SUMS + k] = v;
    }
    if (W == 1) __syncwarp(); else __syncthreads();
    // fin: the 14 scalar folds' sums, then the 14 column folds'
    if (tt < N_SCALAR) {
      uint32_t t1 = 0, t2 = 0;
      column((uint32_t)tt + 1, 0, scalar_of(s, L, tt), t1, t2);
      fin[2 * tt] = t1;
      fin[2 * tt + 1] = t2;
    }
    for (int k = tt; k < N_SUMS; k += TS) {
      uint32_t v = 0;
      for (int w = team * W; w < team * W + W; ++w) v += red[w * N_SUMS + k];
      fin[N_SUMS + k] = v;
    }
    if (W == 1) __syncwarp(); else __syncthreads();
    if (tt == 0) {
      uint32_t h1 = 2166136261u, h2 = 0x9E3779B9u;
      for (int j = 0; j < N_SCALAR + N_COLUMN; ++j) {
        h1 = (h1 ^ fin[2 * j]) * 16777619u;
        h2 = (h2 + fin[2 * j + 1]) * 2654435761u;
        h2 ^= h2 >> 15;
      }
      uint32_t* o = out + L * 4;
      o[0] = h1;
      o[1] = h2;
      o[2] = s.min_gas[L];
      o[3] = s.max_gas[L];
    }
    if (W == 1) __syncwarp(); else __syncthreads();
  }
}

}  // namespace

// K9's shared bytes a block for these sizes (lane_engine.merge_fp_plan
// checks its own against it)
MTT_EXPORT int merge_fp_smem(int cap, int W, int D, int S) { return (int)fp_smem(cap, W, D, S); }

// planes/dims: ops/symstep.state_args; pairs: (pv, 2) int32 prov pairs;
// plan: {blocks, warps a lane's team (1 or 8), hash entries (0: the
// dense table), mkind and memory 16-byte readable, the lanes of the
// batch the pairs' slots index (0: the state's n; a shard of a meshed
// batch: the whole batch's)}; dense: that many lanes x R int32 scratch
// (with no hash); out: (n, 4) uint32 (int32 bit patterns)
MTT_EXPORT int merge_fingerprint(void** planes, const int* dims, const int32_t* pairs, int pv,
                                 const int* plan, int32_t* dense, uint32_t* out, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  if (s.n == 0) return (int)cudaGetLastError();
  const int blocks = plan[0], W = plan[1], cap = plan[2], vec = plan[3];
  const int gn = plan[4] > 0 ? plan[4] : s.n;
  if (!cap) {
    const long long len = (long long)gn * s.R;
    fp_fill<<<nblocks_for(len, 256), 256, 0, st>>>(dense, len);
    if (pv > 0) fp_scatter<<<nblocks_for(pv, 256), 256, 0, st>>>(pairs, pv, dense, len);
  }
  const int smem = (int)fp_smem(cap, W, s.D, s.S);
  static int opted[MAX_DEVICES];  // a device's dynamic shared bytes fp_lanes may take
  const cudaError_t rc = allow_smem((const void*)fp_lanes, smem, opted);
  if (rc != cudaSuccess) return (int)rc;
  fp_lanes<<<blocks, FP_THREADS, smem, st>>>(s, pairs, pv, dense, cap, W, vec, gn, out);
  return (int)cudaGetLastError();
}
