// K2-K4: the window prologue, record dedup and epilogue around K1.
//
// K2 window_prologue replaces, inside mythril_tpu/laser/lane_engine.py
// _window_exec (:1118), _remap_reset_core (:859), the kill and SHA3
// resume scatters (:1165-1184) and _prologue_core (:471), in one launch
// that never waits on the host: one block up to 2048 lanes, a
// cooperative grid past it (window_prologue_shape). The sparse (slot,
// oid) pairs stay sparse: a hash the size of the pairs in each block's
// shared memory (a dense table in global memory past PROV_LOCAL pairs),
// which the sid planes' provisional sids look up. Each word of the state
// has one writer, so the phases need two barriers (k_prologue). Bound:
// bytes (the four sid planes read and their provisional sids written,
// the packed sections, and the real seed, kill and resume rows).
//
// K3 window_dedup replaces _dedup_canon (:689) and _canon_remap (:771).
// JAX runs a round per step of the window's records, in global step
// order: each round hashes every lane's record of that step into a
// 4096-cell table where the lowest lane wins, and each lane compares
// itself with its cell's winner. Here every round runs inside one launch
// that never waits on the host. Up to DEDUP_ONE_BLOCK lanes (the
// corpus' 64) it is one block of up to 1024 threads: the tables live in
// shared memory (two, a round each in turn, so one is emptied while the
// other is read), a round costs two __syncthreads, and where they fit
// the canon and the round's candidates live there too. A wider batch
// (the symbolic path's 4096, the k=17 loop's 131072) is a cooperative
// grid of resident blocks (window_dedup_shape; a card without
// cooperative launch is refused): a warp's and then a block's lowest
// lane of a bucket bid for it in the grid's table, and a round costs two
// grid barriers. A thread holds up to 8 lanes in registers, their loads
// in flight together. A lane's records are appended in step order, at
// most one a step (csrc/symstep.cu, the record append; a fork's child
// starts with none), so each lane keeps a cursor to its next record and
// loads it a round ahead instead of rescanning its slots (a lane whose
// records are out of order, which no path writes, scans them), and the
// next round is the least next step over the lanes: steps where no lane
// has a record cost nothing. The hash is linear in the three sids, so a
// record's static share is hashed once, before the rounds; a bid is
// lane * R + slot, so the winner's record loads with its candidate row.
// The remap of the five sid planes is one more launch over all of them.
// Bound: bytes (each live record read once for its hash and once for
// the compare, the canon written, the sid planes read and their
// provisional sids rewritten). What holds it back is latency: a round
// waits on two global loads in turn (the canon of its sids; the
// winner's record) and two barriers.
//
// K4 window_epilogue replaces the hold/retire selection (:1196-1226),
// _resume_gather_core (:594), _retire_gather_core (:547), _counts_core
// (:670), _unique_table (:792) and _fork_table (:823), in one launch that
// never waits on the host: one block up to 2048 lanes, a cooperative
// grid past it (window_epilogue_shape). Its selections are prefix scans
// over the lanes in thread order (the order of JAX's sort of where(sel,
// arange, n)), the floors are arguments, and its 12 outputs are sections
// of one allocation. Its gathers also serve _retire_rows (:580, one
// launch) and, its unique phase alone, _unique_table_big (:839); its fork
// words _gather_full_flog (:855). Bound: bytes (N x R canonical flags
// plus the gathered rows). What holds it back is latency: two scans and
// a barrier (grid barriers past one block), then dependent row loads.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RUNNING = 0, NEEDS_HOST = 5, DEAD = 7;
constexpr int OP_SHA3 = 0x20, OP_SSTORE = 0x55, REC_SLOAD_RW = 0x154;
constexpr int DEDUP_H = 4096;
constexpr int CODE_COLS = 14;
constexpr int RESUME_MEM = 256, RESUME_MLOG = 8;
constexpr int I32_MIN = -2147483647 - 1, I32_MAX = 2147483647;
constexpr uint32_t HASH_MUL = 0x9E3779B1u;
// K3's launch shapes (window_dedup_shape, placed by measurement: PERF.md
// §6, tools/prof_torch_port.py --dedup): the most threads of a block, the
// widest batch of one block, threads of a grid's block; and the most
// shared memory one block takes for its canon and candidate rows (beside
// its 33 KB of tables)
constexpr int DEDUP_THREADS = 1024;
constexpr int DEDUP_ONE_BLOCK = 2048;
constexpr int DEDUP_GRID_THREADS = 256;
constexpr size_t DEDUP_LOCAL_BYTES = 160 * 1024;

__device__ __forceinline__ long long gid() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// a provisional sid (< 0) through table[(lane, slot)], the row clamped
// as the JAX gather clamps it; other sids unchanged
__device__ __forceinline__ int lookup(const int32_t* table, int v, int n, int R) {
  if (v >= 0) return v;
  long long idx = -(long long)v - 1;
  long long row = idx / R;
  if (row > n - 1) row = n - 1;
  return table[row * R + idx % R];
}

// K2's, K3's and K4's launch modes: one block; a cooperative grid of
// resident blocks, whose barriers are grid barriers
enum LaunchMode { ONE = 0, GRID = 1 };

template <int MODE>
__device__ __forceinline__ void launch_sync() {
  if constexpr (MODE == GRID) cg::this_grid().sync();
  else __syncthreads();
}

// a load of what other threads of the launch write during it: from L2
// across blocks (no stale L1 line of another SM), plain in one block
template <int MODE, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (MODE != ONE) return __ldcg(p);
  else return *p;
}

// K2's and K4's launch shapes (window_prologue_shape,
// window_epilogue_shape): one block of WIN_THREADS threads up to
// WIN_ONE_BLOCK lanes, past it a cooperative grid of K2_GRID_THREADS- or
// K4_GRID_THREADS-thread blocks. K2 takes the grid below WIN_ONE_BLOCK
// lanes too where its sid planes and seed rows are more than
// K2_ONE_BYTES, which one SM would move alone (at 512 lanes of the k=9
// device loop one block is slower than a grid, PERF.md §6).
constexpr int WIN_THREADS = 1024;
constexpr int WIN_ONE_BLOCK = 2048;
constexpr int K2_GRID_THREADS = 512;
constexpr int K4_GRID_THREADS = 256;
constexpr int K2_ONE_BYTES = 512 << 10;
// K2's remap: 16-byte loads a thread keeps in flight; K4's gathers:
// words a thread keeps in flight
constexpr int REMAP_LOADS = 4;
constexpr int GATHER_WORDS = 4;

// a scatter's row as JAX's mode="drop" takes it: a negative index counts
// from the end, one out of range either way is dropped (-1)
__device__ __forceinline__ int drop_row(long long i, long long n) {
  if (i < 0) i += n;
  return i >= 0 && i < n ? (int)i : -1;
}

// dst[c] = word(c) for c = t, t + step, ... below count, B words' loads
// in flight before their stores (a store may alias a later load, so a
// plain loop waits on each load in turn)
template <int B, class T, class F>
__device__ __forceinline__ void gather_words(T* dst, int count, int t, int step, F word) {
  for (int c0 = t; c0 < count; c0 += B * step) {
    T v[B];
#pragma unroll
    for (int q = 0; q < B; ++q)
      if (c0 + q * step < count) v[q] = word(c0 + q * step);
#pragma unroll
    for (int q = 0; q < B; ++q)
      if (c0 + q * step < count) dst[c0 + q * step] = v[q];
  }
}

// ---------------------------------------------------------------- K2

// K2's provisional table: the window's (slot, oid) pairs, a slot naming
// record r of lane l as l * R + r. Where a slot comes twice the last pair
// wins, as JAX's scatter leaves it. Up to PROV_LOCAL pairs the table is
// an open-addressing hash in shared memory, which every block builds for
// itself: an entry is slot << 32 | pair index (EMPTY: none). Past that
// (a window after a _unique_table_big escalation) it is a dense table of
// n * R entries in global memory, an entry epoch << 32 | pair index + 1,
// so that no call has to clear it.
constexpr int PROV_LOCAL = 4096;
constexpr unsigned long long EMPTY = ~0ULL;

// the hash's entries for pv pairs: a power of two, at most half full
__host__ __device__ inline int prov_cap(int pv) {
  int c = 32;
  while (c < 2 * pv) c *= 2;
  return c;
}

constexpr int PROV_LOCAL_BYTES = 8 * 2 * PROV_LOCAL;

__device__ __forceinline__ uint32_t prov_bucket(long long key, int cap) {
  return ((uint32_t)key * HASH_MUL) & (uint32_t)(cap - 1);
}

__device__ void prov_insert(unsigned long long* hash, int cap, long long key, int j) {
  const unsigned long long want = ((unsigned long long)key << 32) | (uint32_t)j;
  for (uint32_t h = prov_bucket(key, cap);; h = (h + 1) & (uint32_t)(cap - 1)) {
    unsigned long long e = hash[h];
    if (e == EMPTY) {
      e = atomicCAS(hash + h, EMPTY, want);
      if (e == EMPTY) return;
    }
    if ((e >> 32) == (unsigned long long)key) {  // the same slot: the last pair wins
      atomicMax(hash + h, want);
      return;
    }
  }
}

// K2's inputs: the packed sections of the seed buffers
// (_seed_sections), the provisional table, and on a grid each lane's
// winning seed and resume (own: epoch << 32 | index + 1, n each) and the
// epoch of its kill (killed)
struct Pro {
  const int32_t *idx, *i32p, *fs, *fcount, *pairs, *kill, *stack_s, *r_idx, *r_i32;
  const uint32_t *u32p, *stack_v, *r_limbs;
  const uint8_t *u8p, *mem_v, *mem_k;
  int k, pv, sd, mc, ccw;
  // the lanes of the batch the provisional slots index: the state's n,
  // or on a shard of a meshed batch the whole batch's
  int gn;
  int cap;  // the shared hash's entries; 0: the dense table
  uint32_t epoch;
  unsigned long long* dense;
  unsigned long long* own;
  uint32_t* killed;
};

// the oid of provisional sid v (< 0), I32_MIN where no pair resolves it:
// the row is clamped as the JAX gather clamps it
__device__ int prov_lookup(const Pro& a, const unsigned long long* hash, int v, int n, int R) {
  const long long idx = -(long long)v - 1;
  long long row = idx / R;
  if (row > n - 1) row = n - 1;
  const long long key = row * R + idx % R;
  int j = -1;
  if (a.cap) {
    for (uint32_t h = prov_bucket(key, a.cap);; h = (h + 1) & (uint32_t)(a.cap - 1)) {
      const unsigned long long e = hash[h];
      if (e == EMPTY) break;
      if ((e >> 32) == (unsigned long long)key) {
        j = (int)(uint32_t)e;
        break;
      }
    }
  } else {
    const unsigned long long e = __ldcg(a.dense + key);
    if ((uint32_t)(e >> 32) == a.epoch) j = (int)(uint32_t)e - 1;
  }
  return j >= 0 ? a.pairs[2 * (size_t)j + 1] : I32_MIN;
}

// dst[0..w) = src[0..sw) then zeros, by threads t, t + step, ...
template <class T>
__device__ __forceinline__ void put_row(T* dst, int w, const T* src, int sw, int t, int step) {
  for (int c = t; c < w; c += step) dst[c] = c < sw ? src[c] : (T)0;
}

// put_row of bytes, four a store where the row is 4-byte aligned
__device__ void put_bytes(uint8_t* dst, int w, const uint8_t* src, int sw, int t, int step) {
  if (((uintptr_t)dst & 3) == 0 && (w & 3) == 0) {
    for (int c = 4 * t; c < w; c += 4 * step) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) x |= (uint32_t)(c + b < sw ? src[c + b] : 0) << (8 * b);
      *reinterpret_cast<uint32_t*>(dst + c) = x;
    }
  } else {
    put_row(dst, w, src, sw, t, step);
  }
}

// seed j's rows of lane l (_prologue_core's row writes), split over
// threads t, t + step, ...
__device__ void seed_rows(const Sym& s, const Pro& a, int j, int l, int t, int step) {
  const size_t L = (size_t)l;
  put_row(s.ssid + L * s.D, s.D, a.stack_s + (size_t)j * a.sd, a.sd, t, step);
  put_row(s.stack + L * s.D * 8, s.D * 8, a.stack_v + (size_t)j * a.sd * 8, a.sd * 8, t, step);
  put_bytes(s.memory + L * s.M, s.M, a.mem_v + (size_t)j * a.mc, a.mc, t, step);
  put_bytes(s.mkind + L * s.M, s.M, a.mem_k + (size_t)j * a.mc, a.mc, t, step);
  put_bytes(s.calldata + L * s.C, s.C, a.u8p + (size_t)j * a.ccw, a.ccw, t, step);
  put_row(s.env + L * s.NENV * 8, s.NENV * 8, a.u32p + (size_t)j * (1 + s.NENV * 8) + 1,
          s.NENV * 8, t, step);
  put_row(s.env_sid + L * s.NENV, s.NENV, a.i32p + (size_t)j * (8 + s.NENV) + 8, s.NENV, t, step);
  int32_t* const zero32[5] = {s.sval_sid, s.s_written, s.s_read, s.skey_sid, s.s_wstep};
#pragma unroll
  for (int q = 0; q < 5; ++q) put_row<int32_t>(zero32[q] + L * s.S, s.S, nullptr, 0, t, step);
  put_row<uint32_t>(s.skeys + L * s.S * 8, s.S * 8, nullptr, 0, t, step);
  put_row<uint32_t>(s.svals + L * s.S * 8, s.S * 8, nullptr, 0, t, step);
}

// K2: the window prologue in one launch, in launch mode MODE. JAX runs
// its phases in order over the whole batch: the remap of the four sid
// planes and the log reset, the kills, the resumes, the seeds, the
// free-slot stack. Here A fills the provisional table and each lane's
// winning seed and resume (its last entry) and kill flag; after a
// barrier B remaps the sid planes; after another C writes each lane's
// scalars as its last phase leaves them (seed, else resume, else kill),
// each resume entry of a lane without a seed its pushed slot (unless a
// later entry of the lane names the same slot: JAX's scatter keeps the
// last write of an element), and D a warp a winning seed its rows.
template <int MODE>
__global__ void __launch_bounds__(WIN_THREADS)
k_prologue(const __grid_constant__ Sym s, const __grid_constant__ Pro a) {
  extern __shared__ unsigned long long psm[];
  const int n = s.n, R = s.R;
  const long long nr = (long long)a.gn * R;
  const long long G = (long long)gridDim.x * blockDim.x;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long* const hash = psm;
  // one block: each lane's winning seed and resume (-1 none) and its
  // kill flag, after the hash
  int* const s_seed = reinterpret_cast<int*>(psm + a.cap);
  int* const s_res = s_seed + n;
  int* const s_kill = s_res + n;

  // A: the tables
  for (int i = threadIdx.x; i < a.cap; i += blockDim.x) hash[i] = EMPTY;
  if constexpr (MODE == ONE) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_seed[i] = -1;
      s_res[i] = -1;
      s_kill[i] = 0;
    }
  }
  __syncthreads();
  const unsigned long long tag = (unsigned long long)a.epoch << 32;
  if (a.cap) {  // every block its own copy
    for (int j = threadIdx.x; j < a.pv; j += blockDim.x) {
      long long slot = a.pairs[2 * (size_t)j];
      if (slot < 0) slot += nr;
      if (slot >= 0 && slot < nr) prov_insert(hash, a.cap, slot, j);
    }
  } else {
    for (long long j = g; j < a.pv; j += G) {
      long long slot = a.pairs[2 * j];
      if (slot < 0) slot += nr;
      if (slot >= 0 && slot < nr) atomicMax(a.dense + slot, tag | (uint32_t)(j + 1));
    }
  }
  for (long long j = g; j < a.k; j += G) {
    const int ls = drop_row(a.idx[j], n), lr = drop_row(a.r_idx[j], n);
    if constexpr (MODE == ONE) {
      if (ls >= 0) atomicMax(s_seed + ls, (int)j);
      if (lr >= 0) atomicMax(s_res + lr, (int)j);
    } else {
      if (ls >= 0) atomicMax(a.own + ls, tag | (uint32_t)(j + 1));
      if (lr >= 0) atomicMax(a.own + n + lr, tag | (uint32_t)(j + 1));
    }
  }
  for (long long i = g; i < n; i += G) {
    const int l = drop_row(a.kill[i], n);
    if (l < 0) continue;
    if constexpr (MODE == ONE) s_kill[l] = 1;
    else a.killed[l] = a.epoch;
  }
  launch_sync<MODE>();

  auto winner = [&](const int* local, int off, int l) -> int {
    if constexpr (MODE == ONE) return local[l];
    const unsigned long long e = __ldcg(a.own + off + l);
    return (uint32_t)(e >> 32) == a.epoch ? (int)(uint32_t)e - 1 : -1;
  };
  auto seed_of = [&](int l) { return winner(s_seed, 0, l); };
  auto resume_of = [&](int l) { return winner(s_res, n, l); };

  // B: the sid planes through the table, four words a load and
  // REMAP_LOADS loads a thread in flight
  {
    int32_t* const planes[4] = {s.ssid, s.sval_sid, s.skey_sid, s.mlog_sid};
    const int widths[4] = {s.D, s.S, s.S, s.MR};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int32_t* const p = planes[q];
      const long long len = (long long)n * widths[q];
      const long long n4 = ((uintptr_t)p & 15) ? 0 : len / 4;
      int4* const p4 = reinterpret_cast<int4*>(p);
      for (long long j0 = g; j0 < n4; j0 += REMAP_LOADS * G) {
        int4 v[REMAP_LOADS];
#pragma unroll
        for (int u = 0; u < REMAP_LOADS; ++u)
          if (j0 + u * G < n4) v[u] = p4[j0 + u * G];
#pragma unroll
        for (int u = 0; u < REMAP_LOADS; ++u) {
          const long long j = j0 + u * G;
          if (j >= n4) continue;
          int* w = &v[u].x;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (w[c] < 0) p[4 * j + c] = prov_lookup(a, hash, w[c], a.gn, R);
        }
      }
      for (long long i = 4 * n4 + g; i < len; i += G) {
        const int v = p[i];
        if (v < 0) p[i] = prov_lookup(a, hash, v, a.gn, R);
      }
    }
  }
  launch_sync<MODE>();

  // C: each lane's scalars, the log reset and the free-slot stack
  for (long long li = g; li < n; li += G) {
    const int l = (int)li;
    s.dlog_count[l] = 0;
    s.free_slots[l] = a.fs[l];
    const int sj = seed_of(l);
    if (sj >= 0) {
      const int32_t* ip = a.i32p + (size_t)sj * (8 + s.NENV);
      s.sbase[l] = ip[0];
      s.cd_size[l] = ip[1];
      s.cd_sym[l] = ip[2];
      s.cd_size_sid[l] = ip[3];
      s.pc[l] = ip[4];
      s.sp[l] = ip[5];
      s.msize[l] = ip[6];
      s.group[l] = ip[7];
      s.depth[l] = 0;
      s.mlog_count[l] = 0;
      s.s_mode[l] = 0;
      s.scount[l] = 0;
      s.min_gas[l] = 0;
      s.max_gas[l] = 0;
      s.steps[l] = 0;
      s.fentry[l] = -1;
      s.last_jump[l] = -1;
      s.status[l] = RUNNING;
      s.gas_limit[l] = a.u32p[(size_t)sj * (1 + s.NENV * 8)];
      continue;
    }
    const int rj = resume_of(l);
    if (rj >= 0) {
      const int32_t* ri = a.r_i32 + 6 * (size_t)rj;
      s.pc[l] = ri[0];
      s.sp[l] = ri[1];
      s.msize[l] = ri[2];
      s.min_gas[l] = (uint32_t)ri[3];
      s.max_gas[l] = (uint32_t)ri[4];
      s.status[l] = RUNNING;
    } else {
      bool killed;
      if constexpr (MODE == ONE) killed = s_kill[l];
      else killed = __ldcg(a.killed + l) == a.epoch;
      if (killed) s.status[l] = DEAD;
    }
  }
  // the resumes' pushed slots (a lane's entries before its last are
  // checked against the later ones: no path writes two a lane)
  for (long long j = g; j < a.k; j += G) {
    const int l = drop_row(a.r_idx[j], n);
    if (l < 0 || seed_of(l) >= 0) continue;
    const int slot = clampi(a.r_i32[6 * j + 1] - 1, 0, s.D - 1);
    bool last = resume_of(l) == (int)j;
    if (!last) {
      last = true;
      for (long long q = j + 1; q < a.k && last; ++q)
        last = !(drop_row(a.r_idx[q], n) == l &&
                 clampi(a.r_i32[6 * q + 1] - 1, 0, s.D - 1) == slot);
    }
    if (!last) continue;
    const size_t e = (size_t)l * s.D + slot;
    s.ssid[e] = a.r_i32[6 * j + 5];
#pragma unroll
    for (int i = 0; i < 8; ++i) s.stack[e * 8 + i] = a.r_limbs[8 * j + i];
  }
  if (g == 0) {
    *s.flog_count = 0;
    *s.free_count = *a.fcount;
  }

  // D: the winning seeds' rows, a warp a seed
  const int wl = threadIdx.x & 31;
  for (long long j = g >> 5; j < a.k; j += G >> 5) {
    const int l = drop_row(a.idx[j], n);
    if (l >= 0 && seed_of(l) == (int)j) seed_rows(s, a, (int)j, l, wl, 32);
  }
}

// ---------------------------------------------------------------- K3

// The planes K3 reads and writes, in the wrapper's order
// (laser/lane_engine.py _DEDUP_PLANES), and their widths.
struct DedupPlanes {
  const int32_t *dlog_count, *dlog_step, *dlog_op, *dlog_pc, *dlog_fentry, *group;
  int32_t* dlog_sid;
  const uint32_t* dlog_val;
  int32_t *ssid, *sval_sid, *skey_sid, *mlog_sid, *flog_sid;
  int n, R, D, S, MR, F;
};

// K3's scratch: a grid's bucket winners (two tables, a round each in
// turn) and its ring of next steps; per lane the round's candidate (its
// three canonical sids and its record's static hash); per record slot
// its static hash (hpart).
struct DedupScratch {
  int32_t *canon, *gtab, *ring;
  int4* cand;
  uint32_t* hpart;
  int write;
  // one block only: the canon and the candidate rows live in the block's
  // dynamic shared memory during the rounds (the canon is copied out at
  // the end)
  int local;
  // null, or 8 int64 the phases' SM cycles of thread 0 of block 0 are
  // added to: set-up, A, A's barrier, B's winners, B's compare, B's
  // cursors, the next-step barrier; and the rounds run
  long long* phase;
};

__host__ __device__ constexpr uint32_t mul_pow(int e) {
  uint32_t r = 1;
  for (int i = 0; i < e; ++i) r *= HASH_MUL;
  return r;
}

// The record hash h = h * HASH_MUL + x over group, op, pc, fentry, sid0,
// sid1, sid2 and the 24 value limbs is linear: h = hpart + sid0 * M^26 +
// sid1 * M^25 + sid2 * M^24, with hpart the static fields' share, which
// needs no canon (computed once a record, before the rounds).
constexpr uint32_t M24 = mul_pow(24), M25 = mul_pow(25), M26 = mul_pow(26);
constexpr uint32_t M27 = mul_pow(27);

// a record's 24 value limbs as six 16-byte loads (the wrapper's planes
// start 16-byte aligned, and a record's limbs are 96 bytes)
__device__ __forceinline__ void record_vals(const DedupPlanes& p, size_t rp, uint4 (&v)[6]) {
  const uint4* q = reinterpret_cast<const uint4*>(p.dlog_val + rp * 24);
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = q[k];
}

__device__ __forceinline__ uint32_t static_hash(const DedupPlanes& p, long long lane, size_t rp) {
  uint4 q[6];
  record_vals(p, rp, q);
  uint32_t x = (uint32_t)p.group[lane];
  x = x * HASH_MUL + (uint32_t)p.dlog_op[rp];
  x = x * HASH_MUL + (uint32_t)p.dlog_pc[rp];
  x = x * HASH_MUL + (uint32_t)p.dlog_fentry[rp];
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) v = (((v * HASH_MUL + q[k].x) * HASH_MUL + q[k].y) * HASH_MUL + q[k].z) * HASH_MUL + q[k].w;
  return x * M27 + v;
}

// records a and b (of lanes la, lb) equal but for their sids; every
// word loaded at once (no short-circuit: a chain of 28 loads otherwise)
__device__ __forceinline__ bool same_static(const DedupPlanes& p, long long la, size_t a, long long lb,
                                            size_t b) {
  uint4 va[6], vb[6];
  record_vals(p, a, va);
  record_vals(p, b, vb);
  uint32_t diff = (uint32_t)(p.dlog_op[a] ^ p.dlog_op[b]) | (uint32_t)(p.dlog_pc[a] ^ p.dlog_pc[b]) |
                  (uint32_t)(p.dlog_fentry[a] ^ p.dlog_fentry[b]) |
                  (uint32_t)(p.group[la] ^ p.group[lb]);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    diff |= (va[k].x ^ vb[k].x) | (va[k].y ^ vb[k].y) | (va[k].z ^ vb[k].z) | (va[k].w ^ vb[k].w);
  return diff == 0;
}

template <int MODE>
__device__ __forceinline__ int canon_of(const int32_t* canon, int v, int n, int R) {
  if (v >= 0) return v;
  long long idx = -(long long)v - 1;
  long long row = idx / R;
  if (row > n - 1) row = n - 1;
  return ld<MODE>(canon + row * R + idx % R);
}

// A lane's registers across rounds: its cursor c (the slot of its next
// record, in a round the slot of that round's record), the step of that
// record (nx, I32_MAX none), the step loaded for the slot after it (sn,
// valid below the count), its live records (cnt, with OUT_OF_ORDER for a
// lane whose records are not in step order, which scans them), and the
// next record's raw sids, static hash and op, loaded a round ahead and
// first used in the next round; in a round, its bucket (b: -1 no record
// this round, DEDUP_H not a candidate, PUSHED set where it bid for the
// grid) and its canonical sids.
struct DLane {
  int c, nx, sn, cnt, b, s0, s1, s2, op;
  uint32_t hp;
};

constexpr int PUSHED = 1 << 16;
constexpr int OUT_OF_ORDER = 1 << 30, COUNT = OUT_OF_ORDER - 1;

// an L2 prefetch of the line at p (no wait)
#define DEDUP_PREFETCH(p) asm volatile("prefetch.global.L2 [%0];" ::"l"(p))

// the loads of the lane's record at slot c, none of them waited on here
__device__ __forceinline__ void load_record(const DedupPlanes& p, const DedupScratch& d, DLane& L,
                                            long long lane) {
  const size_t rp = (size_t)lane * p.R + L.c;
  L.s0 = p.dlog_sid[rp * 3];
  L.s1 = p.dlog_sid[rp * 3 + 1];
  L.s2 = p.dlog_sid[rp * 3 + 2];
  L.hp = d.hpart[rp];
  L.op = p.dlog_op[rp];
  L.sn = p.dlog_step[(size_t)lane * p.R + min(L.c + 1, p.R - 1)];
}

// K3: every round of the window's records in one launch (the module
// comment has the design), in launch mode MODE; a thread holds NL lanes,
// me + j * G * T, in registers.
template <int NL, int MODE>
__global__ void __launch_bounds__(DEDUP_THREADS)
k_dedup(const __grid_constant__ DedupPlanes p, const __grid_constant__ DedupScratch d) {
  // the block's two bucket tables (a round each in turn) and its warps'
  // least next steps (a ring of three rounds)
  __shared__ int32_t stab[2 * DEDUP_H];
  __shared__ int32_t swarp[3][32];
  extern __shared__ int4 dsm[];
  const int T = blockDim.x, n = p.n, R = p.R;
  const long long GT = (long long)gridDim.x * T;
  const long long me = (long long)blockIdx.x * T + threadIdx.x;
  const bool local = MODE == ONE && d.local;
  int32_t* const canon = local ? reinterpret_cast<int32_t*>(dsm) : d.canon;
  int4* const cand_rows = local ? dsm + ((long long)n * R + 3) / 4 : d.cand;
  const bool timed = d.phase && me == 0;
  long long mark = timed ? clock64() : 0;
  auto stamp = [&](int k) {
    if (timed) {
      const long long now = clock64();
      d.phase[k] += now - mark;
      mark = now;
    }
  };
  auto barrier = [&]() {
    if constexpr (MODE == GRID) cg::this_grid().sync();
    else __syncthreads();
  };
  // the least v over the launch (ring slot q); every thread gets it. A
  // block's warps leave theirs in swarp, its first warp takes their least
  const int nw = (T + 31) / 32, wl = threadIdx.x & 31;
  auto least = [&](int v, int q) {
    v = __reduce_min_sync(0xFFFFFFFFu, v);
    if (wl == 0) swarp[q][threadIdx.x >> 5] = v;
    __syncthreads();
    const int m = __reduce_min_sync(0xFFFFFFFFu, wl < nw ? swarp[q][wl] : I32_MAX);
    if constexpr (MODE == ONE) return m;
    if (threadIdx.x == 0 && m != I32_MAX) atomicMin(d.ring + q, m);
    barrier();
    return __ldcg(d.ring + q);
  };

  // zero the canon, empty the tables and rings; each record's static
  // hash and its sids toward L2; each lane's order, first step and first
  // record
  const long long nr = (long long)n * R;
  if ((nr & 3) == 0) {
    for (long long i = me; i < nr / 4; i += GT) reinterpret_cast<int4*>(canon)[i] = make_int4(0, 0, 0, 0);
  } else {
    for (long long i = me; i < nr; i += GT) canon[i] = 0;
  }
  for (int i = threadIdx.x; i < 2 * DEDUP_H; i += T) stab[i] = I32_MAX;
  if constexpr (MODE == GRID) {
    for (long long i = me; i < 2 * DEDUP_H; i += GT) d.gtab[i] = I32_MAX;
    if (me < 3) d.ring[me] = I32_MAX;
  }
  DLane L[NL];
  int lo = I32_MAX;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const long long lane = j * GT + me;
    L[j].c = 0;
    L[j].nx = I32_MAX;
    L[j].cnt = 0;
    L[j].b = -1;
    if (lane < n) {
      const int32_t* stp = p.dlog_step + lane * R;
      const int cnt = clampi(p.dlog_count[lane], 0, R);
      int first = I32_MAX, prev = I32_MIN;
      bool ordered = true;
      for (int r = 0; r < cnt; ++r) {
        const size_t rp = (size_t)lane * R + r;
        const int v = stp[r];
        ordered = ordered && v >= prev;
        prev = v;
        first = min(first, v);
        d.hpart[rp] = static_hash(p, lane, rp);
        DEDUP_PREFETCH(p.dlog_sid + rp * 3);
      }
      L[j].cnt = cnt | (ordered ? 0 : OUT_OF_ORDER);
      L[j].nx = first;
      if (ordered && cnt > 0) load_record(p, d, L[j], lane);
    }
    lo = min(lo, L[j].nx);
  }
  barrier();

  int step = least(lo, 0);
  stamp(0);
  int rounds = 0;
  for (int r = 0; step != I32_MAX; ++r) {
    ++rounds;
    int32_t* tab = stab + (r & 1) * DEDUP_H;
    int32_t* old = stab + ((r + 1) & 1) * DEDUP_H;
    int32_t* gtab = d.gtab + (r & 1) * DEDUP_H;
    int32_t* gold = d.gtab + ((r + 1) & 1) * DEDUP_H;
    // A: empty the cells the last round bid for (read before the last
    // barrier) and the ring slot two rounds ahead; map each lane's
    // record of `step` through the canon, hash it, and let the lowest
    // lane of each bucket win it (a warp's lowest lane of a bucket bids
    // for the warp: lanes rise with the thread index)
    if (MODE == GRID && me == 0) d.ring[(r + 2) % 3] = I32_MAX;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int b = L[j].b & (PUSHED - 1);
      if (L[j].b >= 0 && b < DEDUP_H) {
        old[b] = I32_MAX;
        if (MODE == GRID && (L[j].b & PUSHED)) gold[b] = I32_MAX;
      }
      L[j].b = -1;
    }
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long lane = j * GT + me;
      if (lane < n && L[j].nx == step) {
        if (L[j].cnt & OUT_OF_ORDER) {  // the first slot of the step
          const int32_t* stp = p.dlog_step + lane * R;
          int slot = 0;
          while (slot < (L[j].cnt & COUNT) && stp[slot] != step) ++slot;
          L[j].c = slot;
          load_record(p, d, L[j], lane);
        }
        L[j].s0 = canon_of<MODE>(canon, L[j].s0, n, R);
        L[j].s1 = canon_of<MODE>(canon, L[j].s1, n, R);
        L[j].s2 = canon_of<MODE>(canon, L[j].s2, n, R);
      }
    }
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long lane = j * GT + me;
      int bucket = -1;
      if (lane < n && L[j].nx == step) {
        const size_t rp = (size_t)lane * R + L[j].c;
        if (d.write) {
          p.dlog_sid[rp * 3] = L[j].s0;
          p.dlog_sid[rp * 3 + 1] = L[j].s1;
          p.dlog_sid[rp * 3 + 2] = L[j].s2;
        }
        const uint32_t h = L[j].hp + (uint32_t)L[j].s0 * M26 + (uint32_t)L[j].s1 * M25 +
                           (uint32_t)L[j].s2 * M24;
        const bool cand = L[j].op != OP_SSTORE && L[j].op != REC_SLOAD_RW;
        bucket = cand ? (int)(h % DEDUP_H) : DEDUP_H;
        if (cand) cand_rows[lane] = make_int4(L[j].s0, L[j].s1, L[j].s2, (int)L[j].hp);
      }
      L[j].b = bucket;
      // a bid is lane * R + slot: the lowest lane wins, and its record's
      // address comes with it
      const unsigned same = __match_any_sync(0xFFFFFFFFu, bucket);
      if (bucket >= 0 && bucket < DEDUP_H && (int)(threadIdx.x & 31) == __ffs(same) - 1)
        atomicMin(tab + bucket, (int)(lane * R + L[j].c));
    }
    stamp(1);
    if constexpr (MODE == GRID) {  // the block's winners bid for the grid
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const long long lane = j * GT + me;
        const int b = L[j].b;
        const int bid = (int)(lane * R + L[j].c);
        if (b >= 0 && b < DEDUP_H && tab[b] == bid) {
          atomicMin(gtab + b, bid);
          L[j].b |= PUSHED;
        }
      }
    }
    barrier();
    stamp(2);
    // B: each lane against its bucket's winner w (the lowest bid of the
    // launch: its record and its candidate row load together); its
    // canonical pid; its cursor past `step`
    // and its next record's loads; the next round is the least next step
    // over the lanes
    long long w[NL];
    int ws[NL];
    int4 wc[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long lane = j * GT + me;
      const int b = L[j].b & (PUSHED - 1);
      w[j] = lane;
      if (L[j].b >= 0 && b < DEDUP_H) {
        const int win = MODE == GRID ? __ldcg(gtab + b) : tab[b];
        w[j] = win / R;
        ws[j] = win % R;
        if (w[j] != lane) wc[j] = ld<MODE>(cand_rows + w[j]);
      }
    }
    stamp(3);
    int pid[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long lane = j * GT + me;
      if (L[j].b < 0) continue;
      long long cl = lane;
      int cs = L[j].c;
      if (w[j] != lane &&
          same_static(p, lane, (size_t)lane * R + L[j].c, w[j], (size_t)w[j] * R + ws[j]) &&
          wc[j].x == L[j].s0 && wc[j].y == L[j].s1 && wc[j].z == L[j].s2 &&
          (uint32_t)wc[j].w == L[j].hp) {
        cl = w[j];
        cs = ws[j];
      }
      pid[j] = -(int)((uint32_t)cl * (uint32_t)R + (uint32_t)cs + 1u);
    }
    stamp(4);
    lo = I32_MAX;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long lane = j * GT + me;
      if (L[j].b >= 0) {
        canon[(size_t)lane * R + L[j].c] = pid[j];
        const int32_t* stp = p.dlog_step + lane * R;
        const int cnt = L[j].cnt & COUNT;
        if (!(L[j].cnt & OUT_OF_ORDER)) {
          int c = L[j].c + 1, nx = L[j].sn;
          if (c < cnt && nx <= step) {  // a step's later records: skipped
            while (c < cnt && stp[c] <= step) ++c;
            nx = c < cnt ? stp[c] : I32_MAX;
          }
          L[j].c = c;
          L[j].nx = c < cnt ? nx : I32_MAX;
          if (c < cnt) load_record(p, d, L[j], lane);
        } else {
          int nx = I32_MAX;
          for (int k = 0; k < cnt; ++k)
            if (stp[k] > step) nx = min(nx, stp[k]);
          L[j].nx = nx;
        }
      }
      lo = min(lo, L[j].nx);
    }
    stamp(5);
    step = least(lo, (r + 1) % 3);
    stamp(6);
  }
  if (timed) d.phase[7] += rounds;
  if (local) {  // the canon out of shared memory
    __syncthreads();
    if ((nr & 3) == 0) {
      for (long long i = threadIdx.x; i < nr / 4; i += T)
        reinterpret_cast<int4*>(d.canon)[i] = reinterpret_cast<const int4*>(canon)[i];
    } else {
      for (long long i = threadIdx.x; i < nr; i += T) d.canon[i] = canon[i];
    }
  }
}

// the canonical remap of the five persistent sid planes (provisional
// sids through the finished canon), one pass over their concatenation
struct RemapPlanes {
  int32_t* p[5];
  long long len[5];
};

__global__ void k_canon_remap(const __grid_constant__ RemapPlanes rp, long long total,
                              const int32_t* canon, int n, int R) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = gid(); i < total; i += stride) {
    long long off = i;
    int k = 0;
    while (off >= rp.len[k]) off -= rp.len[k++];
    const int v = rp.p[k][off];
    if (v < 0) rp.p[k][off] = lookup(canon, v, n, R);
  }
}

// ---------------------------------------------------------------- K4

// K4's phases: the selections, row gathers and counts; the
// unique-record table; the fork table (the escalation's unique_table
// runs the second alone)
constexpr int EPI_SELECT = 1, EPI_UNIQUE = 2, EPI_FORK = 4;
// one block keeps the unique rows' indices in shared memory up to this
// many rows
constexpr int EPI_LOCAL_ROWS = 11 * 1024;
constexpr int RCAP = 16, HOLD_CAP = 64;

struct Rows {
  int32_t* i32;
  uint32_t* u32;
  uint8_t* u8;
  int ws, wm, wl, wk;  // stack slots, memory bytes, overlay records, storage slots
};

// A set of gathered rows: rows 0..count) of lanes sel[...] (clamped to
// the batch, as the JAX gather clamps), packed as _retire_gather_core's
// rows (resume false) or as _resume_gather_core's slim rows. A row is ci
// int32 words, cu uint32 words and its 2 * wm bytes of memory and kinds,
// four a word where every row is 4-byte aligned (u8w of them).
struct RowSet {
  const int32_t* sel;
  int count, ci, cu, u8w;
  bool resume, words, cg;  // cg: sel is written by other blocks
  Rows o;
};

__host__ __device__ inline RowSet row_set(const Sym& s, const int32_t* sel, int count, bool resume,
                                          const Rows& o) {
  RowSet r;
  r.sel = sel;
  r.count = count;
  r.resume = resume;
  r.cg = false;
  r.o = o;
  r.ci = resume ? 7 + 3 * o.wl : 10 + 3 * o.wl + o.ws + 5 * o.wk;
  r.cu = resume ? 16 : 8 * (o.ws + 2 * o.wk);
  r.words = (o.wm & 3) == 0 && (s.M & 3) == 0;
  r.u8w = r.words ? o.wm / 2 : 2 * o.wm;
  return r;
}

// word c of a row of set r for lane l (top, sub: a resume row's two
// stack slots)
__device__ uint32_t row_word(const Sym& s, const RowSet& r, size_t L, size_t top, size_t sub,
                             int c) {
  const Rows& o = r.o;
  if (c >= r.ci + r.cu) {  // memory, then kinds
    const int k = c - r.ci - r.cu;
    if (r.words) {
      const int h = o.wm / 4;
      return k < h ? reinterpret_cast<const uint32_t*>(s.memory + L * s.M)[k]
                   : reinterpret_cast<const uint32_t*>(s.mkind + L * s.M)[k - h];
    }
    return k < o.wm ? s.memory[L * s.M + k] : s.mkind[L * s.M + k - o.wm];
  }
  if (r.resume) {
    if (c >= r.ci) return s.stack[((c - r.ci < 8 ? top : sub)) * 8 + ((c - r.ci) & 7)];
    switch (c) {
      case 0: return s.msize[L];
      case 1: return s.min_gas[L];
      case 2: return s.max_gas[L];
      case 3: return s.gas_limit[L];
      case 4: return s.mlog_count[L];
      case 5: return s.ssid[top];
      case 6: return s.ssid[sub];
      default: {
        const int q = (c - 7) / o.wl;
        const size_t p = L * s.MR + (c - 7) % o.wl;
        return q == 0 ? s.mlog_off[p] : q == 1 ? s.mlog_len[p] : s.mlog_sid[p];
      }
    }
  }
  if (c >= r.ci) {
    const int d = c - r.ci;
    return d < 8 * o.ws ? s.stack[L * s.D * 8 + d]
         : d < 8 * (o.ws + o.wk) ? s.skeys[L * s.S * 8 + d - 8 * o.ws]
         : s.svals[L * s.S * 8 + d - 8 * (o.ws + o.wk)];
  }
  switch (c) {
    case 0: return s.pc[L];
    case 1: return s.sp[L];
    case 2: return s.depth[L];
    case 3: return s.fentry[L];
    case 4: return s.last_jump[L];
    case 5: return s.msize[L];
    case 6: return s.mlog_count[L];
    case 7: return s.scount[L];
    case 8: return s.min_gas[L];
    case 9: return s.max_gas[L];
    default: break;
  }
  if (c < 10 + 3 * o.wl) {
    const int q = (c - 10) / o.wl;
    const size_t p = L * s.MR + (c - 10) % o.wl;
    return q == 0 ? s.mlog_off[p] : q == 1 ? s.mlog_len[p] : s.mlog_sid[p];
  }
  if (c < 10 + 3 * o.wl + o.ws) return s.ssid[L * s.D + c - 10 - 3 * o.wl];
  const int d = c - 10 - 3 * o.wl - o.ws, q = d / o.wk;
  const size_t p = L * s.S + d % o.wk;
  return q == 0 ? s.sval_sid[p] : q == 1 ? s.s_written[p] : q == 2 ? s.s_read[p]
       : q == 3 ? s.skey_sid[p] : s.s_wstep[p];
}

__device__ __forceinline__ void row_store(const RowSet& r, int j, int c, uint32_t v) {
  if (c < r.ci) {
    r.o.i32[(size_t)j * r.ci + c] = (int32_t)v;
  } else if (c < r.ci + r.cu) {
    r.o.u32[(size_t)j * r.cu + c - r.ci] = v;
  } else {
    uint8_t* row = r.o.u8 + (size_t)j * 2 * r.o.wm;
    const int k = c - r.ci - r.cu;
    if (r.words) reinterpret_cast<uint32_t*>(row)[k] = v;
    else row[k] = (uint8_t)v;
  }
}

// row j of set r, from the state's lane l, by the 32 threads of a warp
// (lane: this thread's), GATHER_WORDS words' loads a thread in flight
// before their stores
__device__ void gather_lane(const Sym& s, const RowSet& r, int j, int l, int lane) {
  const size_t L = (size_t)l;
  size_t top = 0, sub = 0;
  if (r.resume) {
    const int sp = s.sp[l];
    top = L * s.D + clampi(sp - 1, 0, s.D - 1);
    sub = L * s.D + clampi(sp - 2, 0, s.D - 1);
  }
  const int w = r.ci + r.cu + r.u8w;
  for (int c0 = lane; c0 < w; c0 += 32 * GATHER_WORDS) {
    uint32_t v[GATHER_WORDS];
#pragma unroll
    for (int q = 0; q < GATHER_WORDS; ++q)
      if (c0 + 32 * q < w) v[q] = row_word(s, r, L, top, sub, c0 + 32 * q);
#pragma unroll
    for (int q = 0; q < GATHER_WORDS; ++q)
      if (c0 + 32 * q < w) row_store(r, j, c0 + 32 * q, v[q]);
  }
}

// row j of set r from its lane sel[j], clamped
__device__ void gather_row(const Sym& s, const RowSet& r, int j, int lane) {
  const int l = clampi(r.cg ? __ldcg(r.sel + j) : r.sel[j], 0, s.n - 1);
  gather_lane(s, r, j, l, lane);
}

// the fork table's nine columns, in its column order (_fork_table)
struct Flog {
  const int32_t* col[9];
};

inline Flog flog_of(const Sym& s) {
  return Flog{{s.flog_parent, s.flog_child, s.flog_step, s.flog_pc, s.flog_sid,
               (const int32_t*)s.flog_gmin, (const int32_t*)s.flog_gmax, s.flog_fentry,
               s.flog_dest}};
}

// output word i of the fork table: row i / 9, column i % 9
__device__ __forceinline__ int32_t fork_word(const Flog& f, int i) {
  return f.col[(unsigned)i % 9u][(unsigned)i / 9u];
}

// a thread an output word (coalesced stores)
__global__ void k_fork_gather(const __grid_constant__ Flog f, int fb, int32_t* tab) {
  const long long i = gid();
  if (i < 9LL * fb) tab[i] = fork_word(f, (int)i);
}

// word c of unique row `row` ([lane, slot, op, pc, step, fentry,
// sid0..2, vals]), the row's record at flat index flat = lane * R + slot
__device__ __forceinline__ int32_t unique_word(const Sym& s, int flat, int c) {
  const size_t rp = (size_t)flat;
  switch (c) {
    case 0: return flat / s.R;
    case 1: return flat % s.R;
    case 2: return s.dlog_op[rp];
    case 3: return s.dlog_pc[rp];
    case 4: return s.dlog_step[rp];
    case 5: return s.dlog_fentry[rp];
    default: return c < 9 ? s.dlog_sid[rp * 3 + c - 6] : (int32_t)s.dlog_val[rp * 24 + c - 9];
  }
}

// f(e) for each canonical record e (flat lane * R + slot) in [lo, hi),
// ascending: live (its slot below the lane's count) and its own canon.
// The canon is read 16 bytes a load, CANON_LOADS loads in flight.
constexpr int CANON_LOADS = 4;

template <class F>
__device__ __forceinline__ void canon_records(const Sym& s, const int32_t* canon, int lo, int hi,
                                              F f) {
  const int R = s.R, nr = s.n * R;
  int lane = lo / R, r = lo - lane * R;
  int live = lo < hi ? clampi(s.dlog_count[lane], 0, R) : 0;
  for (int i0 = lo; i0 < hi; i0 += 4 * CANON_LOADS) {
    int4 c[CANON_LOADS];
#pragma unroll
    for (int q = 0; q < CANON_LOADS; ++q) {
      const int i = i0 + 4 * q;
      if (i + 4 <= nr) {
        c[q] = *reinterpret_cast<const int4*>(canon + i);
      } else if (i < nr) {
        int* w = &c[q].x;
        for (int u = 0; u < 4; ++u) w[u] = i + u < nr ? canon[i + u] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < CANON_LOADS; ++q) {
      const int* w = &c[q].x;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = i0 + 4 * q + u;
        if (e >= hi) continue;
        if (r < live && w[u] == -e - 1) f(e);
        if (++r == R && e + 1 < hi) {
          r = 0;
          live = clampi(s.dlog_count[++lane], 0, R);
        }
      }
    }
  }
}

// K4's arguments besides the state
struct Epi {
  const int32_t* code;
  int code_rows, budget, resume_on;
  int floors[4];  // the retire column floors: stack, memory, overlay, slots
  const int32_t* canon;
  int32_t *misc, *scal, *ucount, *utab, *ftab, *ridx, *hidx;
  Rows r, h;  // the retire and the resume rows
  int urb, fb, rcap, hcap, phases;
  int32_t* part;   // a grid's scan sums: 4 x gridDim
  int32_t* urows;  // the unique rows' indices in global memory; null: in shared memory
  Flog flog;
};

// exclusive prefix of (a, b) over the launch's threads in thread order
// (a block's after the blocks before it); *tot gets the launch's sums.
// Every thread of the launch calls it; a grid's scans each take their
// own 2 x gridDim ints of `part`. ws: 68 ints of shared memory.
template <int MODE>
__device__ int2 launch_scan(int a, int b, int* ws, int32_t* part, int2* tot) {
  const unsigned FULL = 0xFFFFFFFFu;
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int xa = a, xb = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(FULL, xa, o), yb = __shfl_up_sync(FULL, xb, o);
    if (wl >= o) {
      xa += ya;
      xb += yb;
    }
  }
  if (wl == 31) {
    ws[w] = xa;
    ws[32 + w] = xb;
  }
  __syncthreads();
  if (w == 0) {  // the warps' sums, inclusive (from lane nw on: the block's)
    int sa = wl < nw ? ws[wl] : 0, sb = wl < nw ? ws[32 + wl] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(FULL, sa, o), yb = __shfl_up_sync(FULL, sb, o);
      if (wl >= o) {
        sa += ya;
        sb += yb;
      }
    }
    ws[wl] = sa;
    ws[32 + wl] = sb;
  }
  __syncthreads();
  int2 pre = make_int2((w ? ws[w - 1] : 0) + xa - a, (w ? ws[32 + w - 1] : 0) + xb - b);
  int2 sum = make_int2(ws[31], ws[63]);
  __syncthreads();
  if constexpr (MODE == GRID) {
    if (threadIdx.x == 0) {
      part[blockIdx.x] = sum.x;
      part[gridDim.x + blockIdx.x] = sum.y;
    }
    cg::this_grid().sync();
    if (w == 0) {
      int ba = 0, bb = 0, ta = 0, tb = 0;
      for (int q = wl; q < (int)gridDim.x; q += 32) {
        const int va = __ldcg(part + q), vb = __ldcg(part + gridDim.x + q);
        ta += va;
        tb += vb;
        if (q < (int)blockIdx.x) {
          ba += va;
          bb += vb;
        }
      }
      ba = __reduce_add_sync(FULL, ba);
      bb = __reduce_add_sync(FULL, bb);
      ta = __reduce_add_sync(FULL, ta);
      tb = __reduce_add_sync(FULL, tb);
      if (wl == 0) {
        ws[64] = ba;
        ws[65] = bb;
        ws[66] = ta;
        ws[67] = tb;
      }
    }
    __syncthreads();
    pre.x += ws[64];
    pre.y += ws[65];
    sum = make_int2(ws[66], ws[67]);
    __syncthreads();
  }
  *tot = sum;
  return pre;
}

// K4: the window epilogue in one launch, in launch mode MODE; a thread
// holds lanes g * NL .. g * NL + NL - 1 (lane order is thread order, so
// prefix scans over the threads select in ascending lane order, as JAX's
// sort of where(sel, arange, n) does). S reads each lane's planes once
// and computes its hold flag, and counts the canonical records in the
// thread's chunk of the flat (lane, slot) index (chunks in thread order,
// read 16 bytes a load); one scan places the first hcap holds and the
// first urb unique rows; a
// second places the first rcap retire-eligible lanes (parked, fitting
// the floors, not held), whose owner marks them DEAD and writes each
// lane's counts with its final status: no gather reads the status, so
// JAX's order (gathers, then DEAD, then the counts) holds. After one
// barrier G gathers the resume and retire rows (a warp a row), the
// unique rows and the fork table (a thread a word).
template <int NL, int MODE>
__global__ void __launch_bounds__(WIN_THREADS)
k_epilogue(const __grid_constant__ Sym s, const __grid_constant__ Epi e) {
  __shared__ int ws[68];
  __shared__ int32_t s_sel[HOLD_CAP + RCAP];  // one block: hidx, then ridx
  extern __shared__ int32_t s_rows[];          // one block: the unique rows' indices
  const int n = s.n, R = s.R;
  const long long G = (long long)gridDim.x * blockDim.x;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool sel = e.phases & EPI_SELECT, uniq = e.phases & EPI_UNIQUE;
  int32_t* const urows = e.urows ? e.urows : s_rows;

  // S: the lanes' planes, hold flags and canonical records
  int pcv[NL], spv[NL], msv[NL], mcv[NL], scv[NL], stv[NL], stepv[NL], dcv[NL];
  bool hf[NL];
  int nh = 0, nu = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const long long l = g * NL + j;
    hf[j] = false;
    dcv[j] = 0;
    if (l >= n) continue;
    dcv[j] = s.dlog_count[l];
    if (sel) {
      pcv[j] = s.pc[l];
      spv[j] = s.sp[l];
      msv[j] = s.msize[l];
      mcv[j] = s.mlog_count[l];
      scv[j] = s.scount[l];
      stv[j] = s.status[l];
      stepv[j] = s.steps[l];
      const int op = e.code[(size_t)clampi(pcv[j], 0, e.code_rows - 1) * CODE_COLS];
      hf[j] = e.resume_on != 0 && stv[j] == NEEDS_HOST && op == OP_SHA3 && spv[j] >= 2 &&
              msv[j] <= RESUME_MEM && mcv[j] <= RESUME_MLOG;
      nh += hf[j];
    }
  }
  // the thread's records: a chunk of the flat (lane, slot) index, a
  // multiple of 4 long, in thread order
  const long long nr = (long long)n * R;
  const long long chunk = ((nr + G - 1) / G + 3) & ~3LL;
  const int rlo = (int)min(nr, g * chunk), rhi = (int)min(nr, rlo + chunk);
  if (uniq) canon_records(s, e.canon, rlo, rhi, [&](int) { ++nu; });
  int2 tot;
  const int2 pre = launch_scan<MODE>(nh, nu, ws, e.part, &tot);
  bool held[NL];
  int rk = pre.x;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    held[j] = hf[j] && rk < e.hcap;
    if (held[j]) {
      e.hidx[rk] = (int)(g * NL + j);
      if (MODE == ONE) s_sel[rk] = (int)(g * NL + j);
    }
    rk += hf[j];
  }
  if (sel) {
    for (long long i = g; i < e.hcap; i += G) {
      if (i < tot.x) continue;
      e.hidx[i] = n;
      if (MODE == ONE) s_sel[i] = n;
    }
  }
  if (uniq) {
    int u = pre.y;
    if (u < e.urb)
      canon_records(s, e.canon, rlo, rhi, [&](int r) {
        if (u < e.urb) urows[u] = r;
        ++u;
      });
    for (long long i = g; i < e.urb; i += G)
      if (i >= tot.y) urows[i] = 0;
    if (g == 0) *e.ucount = tot.y;
  }
  if (sel) {
    bool el[NL];
    int ne = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      el[j] = false;
      if (g * NL + j >= n) continue;
      const bool parked = stv[j] == NEEDS_HOST || (stv[j] == RUNNING && stepv[j] >= e.budget);
      const bool fits = spv[j] <= e.floors[0] && msv[j] <= e.floors[1] &&
                        mcv[j] <= e.floors[2] && scv[j] <= e.floors[3];
      el[j] = parked && fits && !held[j];
      ne += el[j];
    }
    int2 t2;
    const int2 p2 = launch_scan<MODE>(ne, 0, ws, e.part + 2 * gridDim.x, &t2);
    int rr = p2.x;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long l = g * NL + j;
      if (l >= n) continue;
      const bool ret = el[j] && rr < e.rcap;
      if (ret) {
        e.ridx[rr] = (int)l;
        if (MODE == ONE) s_sel[HOLD_CAP + rr] = (int)l;
        s.status[l] = DEAD;
      }
      rr += el[j];
      int4* m = reinterpret_cast<int4*>(e.misc + l * 8);
      m[0] = make_int4(dcv[j], ret ? DEAD : stv[j], stepv[j], spv[j]);
      m[1] = make_int4(scv[j], mcv[j], msv[j], pcv[j]);
    }
    for (long long i = g; i < e.rcap; i += G) {
      if (i < t2.x) continue;
      e.ridx[i] = n;
      if (MODE == ONE) s_sel[HOLD_CAP + i] = n;
    }
    if (g == 0) {
      e.scal[0] = *s.flog_count;
      e.scal[1] = *s.free_count;
    }
  }
  if (sel || uniq) launch_sync<MODE>();

  // G: the retire and resume rows (a warp a row), the unique rows and
  // the fork table (a thread a word), GATHER_WORDS words' loads in
  // flight before their stores
  if (sel) {  // the retire rows (the longer) first
    RowSet ret = row_set(s, MODE == ONE ? s_sel + HOLD_CAP : e.ridx, e.rcap, false, e.r);
    RowSet res = row_set(s, MODE == ONE ? s_sel : e.hidx, e.hcap, true, e.h);
    ret.cg = res.cg = MODE == GRID;
    const int lane = threadIdx.x & 31;
    for (long long t = g >> 5; t < e.rcap + e.hcap; t += G >> 5) {
      if (t < e.rcap) gather_row(s, ret, (int)t, lane);
      else gather_row(s, res, (int)(t - e.rcap), lane);
    }
  }
  if (uniq)
    gather_words<GATHER_WORDS>(e.utab, 33 * e.urb, (int)g, (int)G, [&](int i) {
      const unsigned row = (unsigned)i / 33u;
      return unique_word(s, e.urows ? __ldcg(urows + row) : urows[row], (int)((unsigned)i % 33u));
    });
  if (e.phases & EPI_FORK)
    gather_words<GATHER_WORDS>(e.ftab, 9 * e.fb, (int)g, (int)G,
                               [&](int i) { return fork_word(e.flog, i); });
}

// the retire rows' widths under the floors, clipped to the planes
inline Rows retire_rows_of(const Sym& s, const int* floors, void* i32, void* u32, void* u8) {
  Rows o;
  o.i32 = (int32_t*)i32;
  o.u32 = (uint32_t*)u32;
  o.u8 = (uint8_t*)u8;
  o.ws = min(floors[0], s.D);
  o.wm = min(floors[1], s.M);
  o.wl = min(floors[2], s.MR);
  o.wk = min(floors[3], s.S);
  return o;
}

// K4's rows over a meshed batch (laser/lane_engine.mesh_rows), one launch
// a device: tab holds a Sym for each of the d shards of m lanes (null
// planes for a shard this device does not hold), the batch n = d * m
// lanes. Warp w takes row w of r (the retire rows), then of h (the
// resume rows): the shard that holds its lane at JAX's clip (a negative
// index lane 0, one past the batch lane n - 1) gathers it where this
// device holds that shard, its lane clamped into the shard as K4 clamps;
// a retire row's lane, wrapped and dropped by JAX's rule (drop_row), is
// marked DEAD by the device that holds it, after the row (no gather
// reads the status). Each row is gathered once over all devices.
// row j of set r over a meshed batch: gathered where this device holds
// the shard of its lane at JAX's clip
__device__ __forceinline__ void mesh_row(const Sym* tab, const RowSet& r, int j, int d, int m,
                                         int lane) {
  const int idx = r.sel[j];
  const int o = idx < 0 ? 0 : min(idx / m, d - 1);
  const Sym& s = tab[o];
  if (s.pc) gather_lane(s, r, j, clampi(idx - o * m, 0, m - 1), lane);
}

__global__ void k_mesh_rows(const Sym* __restrict__ tab, const __grid_constant__ RowSet r,
                            const __grid_constant__ RowSet h, int d, int m, int n) {
  const long long w = gid() >> 5;
  const int lane = threadIdx.x & 31;
  if (w < r.count) {
    mesh_row(tab, r, (int)w, d, m, lane);
    const int l = drop_row(r.sel[w], n);
    if (lane == 0 && l >= 0 && tab[l / m].status) tab[l / m].status[l % m] = DEAD;
  } else if (w < r.count + h.count) {
    mesh_row(tab, h, (int)(w - r.count), d, m, lane);
  }
}

// K3's remap over a meshed batch (laser/lane_engine.mesh_remap): the
// four persistent sid planes (ssid, sval_sid, skey_sid, mlog_sid) of
// every shard this device holds through the batch's canon, one launch a
// device. Block b takes shard held[b / first[4]] and, by the prefix
// first[], plane k and tile t of it: REMAP_TILE 16-byte words, REMAP_VEC
// a thread, their loads issued together before any lookup; the plane's
// last tile also takes its 1-3 words past its last whole 16-byte word,
// one a thread. A 16-byte word is stored back whole where one of its words is
// provisional, and not at all otherwise: it was just read, so its sector
// is in L2 and the store merges there without a read from HBM, and a
// sector with no provisional sid stays clean. The table's planes are
// 16-byte aligned (the wrapper checks it); the canon lookup clamps the
// row as JAX's gather does (lookup).
constexpr int REMAP_THREADS = 256;
constexpr int REMAP_VEC = 4;
constexpr int REMAP_TILE = REMAP_THREADS * REMAP_VEC;
constexpr int MAX_REMAP_SHARDS = 64;

struct MeshRemap {
  int held[MAX_REMAP_SHARDS];
  int first[5];  // each plane's first block in a shard's run; first[4]: a shard's blocks
  long long len[4];  // each plane's words a shard
};

__device__ __forceinline__ int32_t* remap_plane(const Sym& s, int k) {
  switch (k) {
    case 0: return s.ssid;
    case 1: return s.sval_sid;
    case 2: return s.skey_sid;
    default: return s.mlog_sid;
  }
}

__global__ void __launch_bounds__(REMAP_THREADS)
    k_mesh_remap(const Sym* __restrict__ tab, const __grid_constant__ MeshRemap a,
                 const int32_t* __restrict__ canon, int gn, int R) {
  const int per = a.first[4];
  const int j = blockIdx.x / per;
  const int r = blockIdx.x - j * per;
  const int k = r < a.first[1] ? 0 : r < a.first[2] ? 1 : r < a.first[3] ? 2 : 3;
  const long long t = r - a.first[k];
  int32_t* p = remap_plane(tab[a.held[j]], k);
  const long long len = a.len[k], nv = len / 4;
  int4* pv = reinterpret_cast<int4*>(p);
  const long long base = t * REMAP_TILE + threadIdx.x;
  int4 w[REMAP_VEC];
#pragma unroll
  for (int u = 0; u < REMAP_VEC; ++u) {
    const long long i = base + (long long)u * REMAP_THREADS;
    if (i < nv) w[u] = pv[i];
  }
#pragma unroll
  for (int u = 0; u < REMAP_VEC; ++u) {
    const long long i = base + (long long)u * REMAP_THREADS;
    if (i < nv && (w[u].x | w[u].y | w[u].z | w[u].w) < 0) {
      w[u].x = lookup(canon, w[u].x, gn, R);
      w[u].y = lookup(canon, w[u].y, gn, R);
      w[u].z = lookup(canon, w[u].z, gn, R);
      w[u].w = lookup(canon, w[u].w, gn, R);
      pv[i] = w[u];
    }
  }
  // the plane's 1-3 words past its last whole 16-byte word: its last tile's
  if (r == a.first[k + 1] - 1 && threadIdx.x < len - 4 * nv) {
    const long long i = 4 * nv + threadIdx.x;
    const int v = p[i];
    if (v < 0) p[i] = lookup(canon, v, gn, R);
  }
}

// _retire_rows: a warp a row; each row's lane marked DEAD by its warp
// after the row (no gather reads the status)
__global__ void k_retire_rows(const __grid_constant__ Sym s, const __grid_constant__ RowSet r) {
  const long long w = gid() >> 5;
  if (w >= r.count) return;
  gather_row(s, r, (int)w, threadIdx.x & 31);
  const int l = drop_row(r.sel[w], s.n);
  if ((threadIdx.x & 31) == 0 && l >= 0) s.status[l] = DEAD;
}

}  // namespace

// the SMs and the cooperative-launch attribute of the current device
inline cudaError_t card_of(int* sms, int* coop) {
  int dev;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return rc;
}

// K2's shared memory: its hash (PROV_LOCAL pairs at most), and in one
// block three ints a lane
constexpr int K2_ONE_SMEM = PROV_LOCAL_BYTES + 12 * WIN_ONE_BLOCK;

inline const void* prologue_kernel_of(int mode) {
  return mode == GRID ? (const void*)k_prologue<GRID> : (const void*)k_prologue<ONE>;
}

// K2's dynamic shared-memory limits (past the default 48 KB), set once a
// device: the attribute call costs more than the launch
inline cudaError_t prologue_smem_limits() {
  static bool set[64];
  int dev;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < 64 && set[dev])) return rc;
  rc = cudaFuncSetAttribute(prologue_kernel_of(ONE), cudaFuncAttributeMaxDynamicSharedMemorySize,
                            K2_ONE_SMEM);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(prologue_kernel_of(GRID),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, PROV_LOCAL_BYTES);
  if (rc == cudaSuccess && dev < 64) set[dev] = true;
  return rc;
}

// K2's launch shape over n lanes whose sid planes and seed rows are
// `bytes`: out = {blocks, threads a block, mode}. One block up to
// WIN_ONE_BLOCK lanes and K2_ONE_BYTES, else a cooperative grid of the
// K2_GRID_THREADS-thread blocks that fit on the card at once. Refuses a
// card without cooperative launch where the batch needs it.
MTT_EXPORT int window_prologue_shape(int n, int bytes, int* out) {
  cudaError_t rc = prologue_smem_limits();
  if (rc != cudaSuccess) return (int)rc;
  if (n <= WIN_ONE_BLOCK && bytes <= K2_ONE_BYTES) {
    out[0] = 1;
    out[1] = WIN_THREADS;
    out[2] = ONE;
    return 0;
  }
  int sms = 0, coop = 0, occ = 0;
  rc = card_of(&sms, &coop);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, prologue_kernel_of(GRID),
                                                       K2_GRID_THREADS, PROV_LOCAL_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  if (!coop) return (int)cudaErrorNotSupported;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = occ * sms;
  out[1] = K2_GRID_THREADS;
  out[2] = GRID;
  return 0;
}

// K2: one launch, no host wait. args: blocks, threads, mode (from
// window_prologue_shape, or a grid no larger than fits), k, pv, sd, mc,
// ccw, then the element offsets in i32buf of the _seed_sections in order
// (idx, i32p, u32p, fs, fcount, prov, kill, stack_v, stack_s, r_idx,
// r_i32, r_limbs); u8buf holds u8p, mem_v, mem_k. scratch, zeroed once
// when it is allocated: past PROV_LOCAL pairs the dense table (n * R
// uint64), then on a grid 2n uint64 and n uint32. epoch: above every
// earlier call's on the same scratch.
MTT_EXPORT int window_prologue(void** planes, const int* dims, const void* i32buf,
                               const void* u8buf, const int* args, unsigned epoch, void* scratch,
                               void* stream) {
  const Sym s = make_sym(planes, dims);
  if (s.n == 0) return 0;
  const int blocks = args[0], threads = args[1], mode = args[2];
  if (blocks < 1 || threads < 32 || threads > WIN_THREADS || threads % 32 ||
      (mode != ONE && mode != GRID) || (mode == ONE && (blocks != 1 || s.n > WIN_ONE_BLOCK)) ||
      (long long)s.n * s.R > I32_MAX || epoch == 0)
    return (int)cudaErrorInvalidValue;
  Pro a;
  const int32_t* b = (const int32_t*)i32buf;
  const int* off = args + 8;
  a.k = args[3];
  a.pv = args[4];
  a.sd = args[5];
  a.mc = args[6];
  a.ccw = args[7];
  a.gn = args[20] > 0 ? args[20] : s.n;
  if ((long long)a.gn * s.R > I32_MAX) return (int)cudaErrorInvalidValue;
  a.idx = b + off[0];
  a.i32p = b + off[1];
  a.u32p = (const uint32_t*)(b + off[2]);
  a.fs = b + off[3];
  a.fcount = b + off[4];
  a.pairs = b + off[5];
  a.kill = b + off[6];
  a.stack_v = (const uint32_t*)(b + off[7]);
  a.stack_s = b + off[8];
  a.r_idx = b + off[9];
  a.r_i32 = b + off[10];
  a.r_limbs = (const uint32_t*)(b + off[11]);
  a.u8p = (const uint8_t*)u8buf;
  a.mem_v = a.u8p + (size_t)a.k * a.ccw;
  a.mem_k = a.u8p + (size_t)a.k * (a.ccw + a.mc);
  a.cap = a.pv <= PROV_LOCAL ? prov_cap(a.pv) : 0;
  a.epoch = epoch;
  unsigned long long* sc = (unsigned long long*)scratch;
  a.dense = a.cap ? nullptr : sc;
  if (!a.cap) sc += (size_t)a.gn * s.R;
  a.own = sc;
  a.killed = (uint32_t*)(sc + 2 * (size_t)s.n);
  const size_t smem = 8 * (size_t)a.cap + (mode == ONE ? 12 * (size_t)s.n : 0);
  void* kargs[] = {(void*)&s, &a};
  const void* fn = prologue_kernel_of(mode);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t rc = prologue_smem_limits();
  if (rc != cudaSuccess) return (int)rc;
  return (int)(mode == GRID
                   ? cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), kargs, smem, st)
                   : cudaLaunchKernel(fn, dim3(1), dim3(threads), kargs, smem, st));
}

// K3's kernel holding nl lanes a thread (1, 2, 4 or 8) in launch mode
// `mode`; null past 8
template <int MODE>
inline const void* dedup_kernel_in(int nl) {
  switch (nl) {
    case 1: return (const void*)k_dedup<1, MODE>;
    case 2: return (const void*)k_dedup<2, MODE>;
    case 4: return (const void*)k_dedup<4, MODE>;
    case 8: return (const void*)k_dedup<8, MODE>;
    default: return nullptr;
  }
}

inline const void* dedup_kernel_of(int nl, int mode) {
  return mode == GRID ? dedup_kernel_in<GRID>(nl) : dedup_kernel_in<ONE>(nl);
}

// lanes a thread of a blocks x threads launch over n lanes, rounded up to
// a kernel's (0: more than 8)
inline int dedup_lanes_a_thread(long long n, int blocks, int threads) {
  const long long per = (n + (long long)blocks * threads - 1) / ((long long)blocks * threads);
  for (int nl = 1; nl <= 8; nl *= 2)
    if (per <= nl) return nl;
  return 0;
}

// K3's launch shape over n lanes: out = {blocks, threads a block, mode}.
// One block of up to DEDUP_THREADS threads up to DEDUP_ONE_BLOCK lanes
// (two lanes a thread past its threads); past that a cooperative grid of
// DEDUP_GRID_THREADS-thread blocks, a block a DEDUP_GRID_THREADS lanes up
// to the blocks that fit on the card at once. Refuses a card without
// cooperative launch where the batch needs it, and a batch that would
// need more than 8 lanes a thread.
MTT_EXPORT int window_dedup_shape(int n, int* out) {
  if (n <= DEDUP_ONE_BLOCK) {
    out[0] = 1;
    out[1] = clampi((std::max(n, 1) + 31) / 32 * 32, 32, DEDUP_THREADS);
    out[2] = ONE;
    return 0;
  }
  int dev, ok = 0, sms = 0, occ = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&ok, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int nl = 1; nl <= 8 && rc == cudaSuccess; nl *= 2) {
    int o = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, dedup_kernel_of(nl, GRID),
                                                       DEDUP_GRID_THREADS, 0);
    occ = nl == 1 ? o : std::min(occ, o);
  }
  if (rc != cudaSuccess) return (int)rc;
  if (!ok) return (int)cudaErrorNotSupported;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = (int)std::min((long long)occ * sms,
                         ((long long)n + DEDUP_GRID_THREADS - 1) / DEDUP_GRID_THREADS);
  out[1] = DEDUP_GRID_THREADS;
  out[2] = GRID;
  if (!dedup_lanes_a_thread(n, out[0], out[1])) return (int)cudaErrorInvalidValue;
  return 0;
}

// K3. planes: _DEDUP_PLANES; dims: n, R, D, S, MR, F. canon: n*R ints
// (out); scratch: 2*DEDUP_H + 4 + 4*n + n*R ints. blocks x threads in
// launch mode `mode` from window_dedup_shape (one block, or a
// cooperative grid), at most 8 lanes a thread. phase: null, or 8 int64 (DedupScratch::phase). At most two
// launches, none waiting on the host: the rounds, then (write_sids) the
// remap of the five sid planes.
MTT_EXPORT int window_dedup(void** planes, const int* dims, void* canon, void* scratch,
                            int write_sids, int blocks, int threads, int mode, void* phase,
                            void* stream) {
  DedupPlanes p;
  p.dlog_count = (const int32_t*)planes[0];
  p.dlog_step = (const int32_t*)planes[1];
  p.dlog_op = (const int32_t*)planes[2];
  p.dlog_pc = (const int32_t*)planes[3];
  p.dlog_fentry = (const int32_t*)planes[4];
  p.group = (const int32_t*)planes[5];
  p.dlog_sid = (int32_t*)planes[6];
  p.dlog_val = (const uint32_t*)planes[7];
  p.ssid = (int32_t*)planes[8];
  p.sval_sid = (int32_t*)planes[9];
  p.skey_sid = (int32_t*)planes[10];
  p.mlog_sid = (int32_t*)planes[11];
  p.flog_sid = (int32_t*)planes[12];
  p.n = dims[0];
  p.R = dims[1];
  p.D = dims[2];
  p.S = dims[3];
  p.MR = dims[4];
  p.F = dims[5];
  if (p.n <= 0 || p.R <= 0) return 0;
  if (blocks < 1 || threads < 32 || threads > DEDUP_THREADS || threads % 32 ||
      (mode != ONE && mode != GRID) || (mode == ONE && blocks != 1))
    return (int)cudaErrorInvalidValue;
  const int nl = dedup_lanes_a_thread(p.n, blocks, threads);
  if (!nl || (long long)p.n * p.R > I32_MAX) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)p.dlog_val % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  DedupScratch d;
  d.canon = (int32_t*)canon;
  d.gtab = (int32_t*)scratch;
  d.ring = d.gtab + 2 * DEDUP_H;
  d.cand = (int4*)(d.ring + 4);
  d.hpart = (uint32_t*)(d.cand + p.n);
  d.write = write_sids;
  d.phase = (long long*)phase;
  const size_t local_bytes = ((size_t)p.n * p.R + 3) / 4 * 16 + (size_t)p.n * 16;
  d.local = mode == ONE && local_bytes <= DEDUP_LOCAL_BYTES;
  void* args[] = {&p, &d};
  const void* fn = dedup_kernel_of(nl, mode);
  cudaError_t rc;
  if (mode == GRID) {
    rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, 0, st);
  } else {
    const size_t dyn = d.local ? local_bytes : 0;
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)DEDUP_LOCAL_BYTES);
    if (rc == cudaSuccess) rc = cudaLaunchKernel(fn, dim3(1), dim3(threads), args, dyn, st);
  }
  if (rc != cudaSuccess || !write_sids) return (int)rc;
  RemapPlanes rp;
  int32_t* ps[5] = {p.ssid, p.sval_sid, p.skey_sid, p.mlog_sid, p.flog_sid};
  long long lens[5] = {(long long)p.n * p.D, (long long)p.n * p.S, (long long)p.n * p.S,
                       (long long)p.n * p.MR, (long long)p.F};
  long long total = 0;
  for (int k = 0; k < 5; ++k) {
    rp.p[k] = ps[k];
    rp.len[k] = lens[k];
    total += lens[k];
  }
  if (total > 0)
    k_canon_remap<<<std::min(nblocks_for(total, 256), 8192u), 256, 0, st>>>(rp, total, d.canon,
                                                                            p.n, p.R);
  return (int)cudaGetLastError();
}

// K4's kernel holding nl lanes a thread (1, 2, 4 or 8) in launch mode
// `mode`; null past 8
template <int MODE>
inline const void* epilogue_kernel_in(int nl) {
  switch (nl) {
    case 1: return (const void*)k_epilogue<1, MODE>;
    case 2: return (const void*)k_epilogue<2, MODE>;
    case 4: return (const void*)k_epilogue<4, MODE>;
    case 8: return (const void*)k_epilogue<8, MODE>;
    default: return nullptr;
  }
}

inline const void* epilogue_kernel_of(int nl, int mode) {
  return mode == GRID ? epilogue_kernel_in<GRID>(nl) : epilogue_kernel_in<ONE>(nl);
}

// K4's launch shape over n lanes: out = {blocks, threads a block, mode,
// lanes a thread}. One block of WIN_THREADS threads up to WIN_ONE_BLOCK
// lanes; past that a cooperative grid of K4_GRID_THREADS-thread blocks, a
// block a K4_GRID_THREADS lanes up to the blocks that fit on the card at
// once. Refuses a card without cooperative launch where the batch needs
// it, and a batch that would need more than 8 lanes a thread.
MTT_EXPORT int window_epilogue_shape(int n, int* out) {
  if (n <= WIN_ONE_BLOCK) {
    out[0] = 1;
    out[1] = WIN_THREADS;
    out[2] = ONE;
    out[3] = n <= WIN_THREADS ? 1 : 2;
    return 0;
  }
  int sms = 0, coop = 0, occ = 0;
  cudaError_t rc = card_of(&sms, &coop);
  for (int nl = 1; nl <= 8 && rc == cudaSuccess; nl *= 2) {
    int o = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, epilogue_kernel_of(nl, GRID),
                                                       K4_GRID_THREADS, 0);
    occ = nl == 1 ? o : std::min(occ, o);
  }
  if (rc != cudaSuccess) return (int)rc;
  if (!coop) return (int)cudaErrorNotSupported;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = (int)std::min((long long)occ * sms,
                         ((long long)n + K4_GRID_THREADS - 1) / K4_GRID_THREADS);
  out[1] = K4_GRID_THREADS;
  out[2] = GRID;
  out[3] = dedup_lanes_a_thread(n, out[0], out[1]);
  return out[3] ? 0 : (int)cudaErrorInvalidValue;
}

// K4's launch (and the unique-table escalation's): shape = {blocks,
// threads, mode, lanes a thread}; scratch: on a grid 4 x blocks ints,
// then urb ints where the unique rows' indices do not stay in the
// block's shared memory (on a grid, or past EPI_LOCAL_ROWS)
inline int epilogue_launch(const Sym& s, Epi& e, const int* shape, void* scratch, void* stream) {
  const int blocks = shape[0], threads = shape[1], mode = shape[2], nl = shape[3];
  const void* fn = epilogue_kernel_of(nl, mode);
  if (!fn || blocks < 1 || threads < 32 || threads > WIN_THREADS || threads % 32 ||
      (mode != ONE && mode != GRID) || (mode == ONE && blocks != 1) ||
      (long long)blocks * threads * nl < s.n || (long long)s.n * s.R > I32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)e.canon % 16) return (int)cudaErrorMisalignedAddress;
  int32_t* sc = (int32_t*)scratch;
  e.part = sc;
  const bool local = mode == ONE && e.urb <= EPI_LOCAL_ROWS;
  e.urows = local ? nullptr : sc + 4 * blocks;
  void* kargs[] = {(void*)&s, &e};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(mode == GRID
                   ? cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), kargs, 0, st)
                   : cudaLaunchKernel(fn, dim3(1), dim3(threads), kargs,
                                      local ? 4 * (size_t)e.urb : 0, st));
}

// K4: one launch, no host wait. lay: the launch shape (blocks, threads,
// mode, lanes a thread: window_epilogue_shape), urb, fb, the four retire
// floors, then the byte offsets in `out` of misc, scal, utab, ftab,
// ridx, r_i32, r_u32, r_u8, hidx, h_i32, h_u32, h_u8 (each 16-byte
// aligned); scratch as epilogue_launch's.
MTT_EXPORT int window_epilogue(void** planes, const int* dims, const void* code, int code_rows,
                               int budget, int resume_on, const void* canon, void* out,
                               const int* lay, void* scratch, void* stream) {
  const Sym s = make_sym(planes, dims);
  if (s.n == 0) return 0;
  uint8_t* o = (uint8_t*)out;
  const int* off = lay + 10;
  Epi e;
  e.code = (const int32_t*)code;
  e.code_rows = code_rows;
  e.budget = budget;
  e.resume_on = resume_on;
  for (int i = 0; i < 4; ++i) e.floors[i] = lay[6 + i];
  e.canon = (const int32_t*)canon;
  e.misc = (int32_t*)(o + off[0]);
  e.scal = (int32_t*)(o + off[1]);
  e.ucount = e.scal + 2;
  e.utab = (int32_t*)(o + off[2]);
  e.ftab = (int32_t*)(o + off[3]);
  e.ridx = (int32_t*)(o + off[4]);
  e.r = retire_rows_of(s, e.floors, o + off[5], o + off[6], o + off[7]);
  e.hidx = (int32_t*)(o + off[8]);
  e.h.i32 = (int32_t*)(o + off[9]);
  e.h.u32 = (uint32_t*)(o + off[10]);
  e.h.u8 = o + off[11];
  e.h.ws = 0;
  e.h.wk = 0;
  e.h.wl = min(RESUME_MLOG, s.MR);
  e.h.wm = min(RESUME_MEM, s.M);
  e.urb = lay[4];
  e.fb = lay[5];
  e.rcap = min(RCAP, s.n);
  e.hcap = min(HOLD_CAP, s.n);
  e.phases = EPI_SELECT | EPI_UNIQUE | EPI_FORK;
  e.flog = flog_of(s);
  return epilogue_launch(s, e, lay, scratch, stream);
}

// _retire_rows: gather the rows of idx[0..k) and mark their lanes DEAD,
// one launch
MTT_EXPORT int retire_rows(void** planes, const int* dims, const void* idx, int k,
                           const int* floors, void* i32, void* u32, void* u8, void* stream) {
  const Sym s = make_sym(planes, dims);
  if (k > 0 && s.n > 0) {
    const RowSet r = row_set(s, (const int32_t*)idx, k, false,
                             retire_rows_of(s, floors, i32, u32, u8));
    k_retire_rows<<<nblocks_for(32LL * k, 256), 256, 0, (cudaStream_t)stream>>>(s, r);
  }
  return (int)cudaGetLastError();
}

// _unique_table_big's table (after window_dedup without writes): K4's
// unique phase alone, in shape {blocks, threads, mode, lanes a thread}
// (window_epilogue_shape); scratch as epilogue_launch's.
MTT_EXPORT int unique_table(void** planes, const int* dims, const void* canon, int urb, void* tab,
                            void* count, const int* shape, void* scratch, void* stream) {
  const Sym s = make_sym(planes, dims);
  if (s.n == 0) return 0;
  Epi e = {};
  e.canon = (const int32_t*)canon;
  e.utab = (int32_t*)tab;
  e.ucount = (int32_t*)count;
  e.urb = urb;
  e.phases = EPI_UNIQUE;
  return epilogue_launch(s, e, shape, scratch, stream);
}

// the first fb fork-table rows (fb = F: _gather_full_flog). flog: the
// nine fork-log planes in the table's column order.
MTT_EXPORT int fork_table(void** flog, int fb, void* tab, void* stream) {
  Flog f;
  for (int k = 0; k < 9; ++k) f.col[k] = (const int32_t*)flog[k];
  if (fb > 0)
    k_fork_gather<<<nblocks_for(9LL * fb, 256), 256, 0, (cudaStream_t)stream>>>(f, fb,
                                                                              (int32_t*)tab);
  return (int)cudaGetLastError();
}

// K3's remap over a meshed batch (laser/lane_engine.mesh_remap), one
// launch a device: tab, window_mesh_table's table on the current device;
// held[0..nheld), the shards this device holds; dims, a shard's; canon,
// the batch's (gn lanes x R), on this device or read over peer access.
MTT_EXPORT int window_mesh_remap(const void* tab, const int* held, int nheld, const int* dims,
                                 const void* canon, int gn, void* stream) {
  if (nheld < 0 || nheld > MAX_REMAP_SHARDS) return (int)cudaErrorInvalidValue;
  void* none[SYM_NFIELDS] = {};
  const Sym s = make_sym(none, dims);
  if (nheld == 0 || s.n <= 0 || gn <= 0 || s.R <= 0) return 0;
  MeshRemap a;
  for (int j = 0; j < nheld; ++j) a.held[j] = held[j];
  const long long len[4] = {(long long)s.n * s.D, (long long)s.n * s.S, (long long)s.n * s.S,
                            (long long)s.n * s.MR};
  a.first[0] = 0;
  for (int k = 0; k < 4; ++k) {
    a.len[k] = len[k];
    const long long tiles = (len[k] / 4 + REMAP_TILE - 1) / REMAP_TILE;
    a.first[k + 1] = a.first[k] + (int)(len[k] > 0 ? std::max(tiles, 1LL) : 0);
  }
  if (a.first[4] == 0) return 0;
  k_mesh_remap<<<(unsigned)nheld * a.first[4], REMAP_THREADS, 0, (cudaStream_t)stream>>>(
      (const Sym*)tab, a, (const int32_t*)canon, gn, s.R);
  return (int)cudaGetLastError();
}

// the table of a meshed batch's d shards for window_mesh_rows into host
// (d Syms): planes, d x SYM_NFIELDS plane pointers, null for a shard
// the table's device does not hold; dims, the shards' (n: lanes a shard)
MTT_EXPORT int window_mesh_table(void* const* planes, int d, const int* dims, void* host) {
  Sym* t = (Sym*)host;
  for (int q = 0; q < d; ++q) t[q] = make_sym((void**)planes + (size_t)q * SYM_NFIELDS, dims);
  return 0;
}

MTT_EXPORT int window_sym_bytes() { return (int)sizeof(Sym); }

// K4's rows over a meshed batch of d shards (tab: window_mesh_table's,
// on the current device) and n lanes: the retire rows of ridx[0..rk)
// under the floors, the lanes this device holds marked DEAD, and the
// resume rows of hidx[0..hk), the indices global; out: r_i32, r_u32,
// r_u8, h_i32, h_u32, h_u8 as K4 packs them, written at the rows whose
// lanes this device holds. One launch.
MTT_EXPORT int window_mesh_rows(const void* tab, int d, int n, const int* dims, const void* ridx,
                                int rk, const int* floors, const void* hidx, int hk, void** out,
                                void* stream) {
  void* none[SYM_NFIELDS] = {};
  const Sym s = make_sym(none, dims);
  if (s.n <= 0 || d <= 0 || rk + hk == 0) return 0;
  RowSet r = row_set(s, (const int32_t*)ridx, rk, false,
                     retire_rows_of(s, floors, out[0], out[1], out[2]));
  Rows ho;
  ho.i32 = (int32_t*)out[3];
  ho.u32 = (uint32_t*)out[4];
  ho.u8 = (uint8_t*)out[5];
  ho.ws = 0;
  ho.wk = 0;
  ho.wl = min(RESUME_MLOG, s.MR);
  ho.wm = min(RESUME_MEM, s.M);
  RowSet h = row_set(s, (const int32_t*)hidx, hk, true, ho);
  k_mesh_rows<<<nblocks_for(32LL * (rk + hk), 256), 256, 0, (cudaStream_t)stream>>>(
      (const Sym*)tab, r, h, d, s.n, n);
  return (int)cudaGetLastError();
}
