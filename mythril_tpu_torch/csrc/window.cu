// K2-K4: the window prologue, record dedup and epilogue around K1.
//
// K2 window_prologue replaces, inside mythril_tpu/laser/lane_engine.py
// _window_exec (:1118), _remap_reset_core (:859), the kill and SHA3
// resume scatters (:1165-1184) and _prologue_core (:471): the sparse
// (slot, oid) pairs become a dense table (int32 min where unresolved),
// the sid planes are remapped through it, the logs reset, and k seed
// rows written from the packed buffers. Bound: bytes (it touches the
// four sid planes of every lane and k seed rows).
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
// (:670), _unique_table (:792) and _fork_table (:823); its gathers also
// serve _retire_rows (:580), _unique_table_big (:839) and
// _gather_full_flog (:855). Selections are ascending-index compactions
// (a prefix scan, the order of JAX's sort of where(sel, arange, n)).
// Bound: bytes (N x R canonical flags plus the gathered rows).
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

// ---------------------------------------------------------------- K2

__global__ void k_scatter_prov(int32_t* dense, long long len, const int32_t* pairs, int pv) {
  long long j = gid();
  if (j >= pv) return;
  long long slot = pairs[2 * j];
  if (slot < 0) slot += len;  // the JAX scatter counts a negative slot from the end
  if (slot >= 0 && slot < len) dense[slot] = pairs[2 * j + 1];
}

__global__ void k_remap(int32_t* plane, long long len, const int32_t* table, int n, int R) {
  long long i = gid();
  if (i < len) plane[i] = lookup(table, plane[i], n, R);
}

__global__ void k_reset_logs(Sym s) {
  long long lane = gid();
  if (lane < s.n) s.dlog_count[lane] = 0;
  if (lane == 0) *s.flog_count = 0;
}

__global__ void k_kill(Sym s, const int32_t* kill) {
  long long i = gid();
  if (i >= s.n) return;
  int l = kill[i];
  if (l >= 0 && l < s.n) s.status[l] = DEAD;
}

__global__ void k_resume(Sym s, const int32_t* r_idx, const int32_t* r_i32,
                         const uint32_t* r_limbs, int k) {
  long long j = gid();
  if (j >= k) return;
  int r = r_idx[j];
  if (r < 0 || r >= s.n) return;
  const int32_t* ri = r_i32 + 6 * j;
  s.pc[r] = ri[0];
  s.sp[r] = ri[1];
  s.msize[r] = ri[2];
  s.min_gas[r] = (uint32_t)ri[3];
  s.max_gas[r] = (uint32_t)ri[4];
  int slot = clampi(ri[1] - 1, 0, s.D - 1);
  s.ssid[(size_t)r * s.D + slot] = ri[5];
  for (int i = 0; i < 8; ++i) s.stack[((size_t)r * s.D + slot) * 8 + i] = r_limbs[8 * j + i];
  s.status[r] = RUNNING;
}

template <typename T>
__device__ __forceinline__ void fill_row(T* p, size_t width, int lane, T v) {
  for (size_t i = threadIdx.x; i < width; i += blockDim.x) p[(size_t)lane * width + i] = v;
}

struct Seeds {
  const int32_t *idx, *i32p, *stack_s;
  const uint32_t *u32p, *stack_v;
  const uint8_t *u8p, *mem_v, *mem_k;
  int k, sd, mc, ccw;
};

// one block per seed row: zero the row's planes, then write the prefix
__global__ void k_seed(Sym s, Seeds z) {
  int j = blockIdx.x;
  int lane = z.idx[j];
  if (lane < 0 || lane >= s.n) return;
  const int32_t* ip = z.i32p + (size_t)j * (8 + s.NENV);
  const uint32_t* up = z.u32p + (size_t)j * (1 + s.NENV * 8);
  if (threadIdx.x == 0) {
    s.sbase[lane] = ip[0];
    s.cd_size[lane] = ip[1];
    s.cd_sym[lane] = ip[2];
    s.cd_size_sid[lane] = ip[3];
    s.pc[lane] = ip[4];
    s.sp[lane] = ip[5];
    s.msize[lane] = ip[6];
    s.group[lane] = ip[7];
    s.depth[lane] = 0;
    s.mlog_count[lane] = 0;
    s.s_mode[lane] = 0;
    s.scount[lane] = 0;
    s.min_gas[lane] = 0;
    s.max_gas[lane] = 0;
    s.steps[lane] = 0;
    s.dlog_count[lane] = 0;
    s.fentry[lane] = -1;
    s.last_jump[lane] = -1;
    s.status[lane] = RUNNING;
    s.gas_limit[lane] = up[0];
  }
  for (int i = threadIdx.x; i < s.D; i += blockDim.x)
    s.ssid[(size_t)lane * s.D + i] = i < z.sd ? z.stack_s[(size_t)j * z.sd + i] : 0;
  for (int i = threadIdx.x; i < s.D * 8; i += blockDim.x)
    s.stack[(size_t)lane * s.D * 8 + i] = i < z.sd * 8 ? z.stack_v[(size_t)j * z.sd * 8 + i] : 0u;
  for (int i = threadIdx.x; i < s.M; i += blockDim.x) {
    s.memory[(size_t)lane * s.M + i] = i < z.mc ? z.mem_v[(size_t)j * z.mc + i] : 0;
    s.mkind[(size_t)lane * s.M + i] = i < z.mc ? z.mem_k[(size_t)j * z.mc + i] : 0;
  }
  for (int i = threadIdx.x; i < s.C; i += blockDim.x)
    s.calldata[(size_t)lane * s.C + i] = i < z.ccw ? z.u8p[(size_t)j * z.ccw + i] : 0;
  for (int i = threadIdx.x; i < s.NENV * 8; i += blockDim.x)
    s.env[(size_t)lane * s.NENV * 8 + i] = up[1 + i];
  for (int i = threadIdx.x; i < s.NENV; i += blockDim.x)
    s.env_sid[(size_t)lane * s.NENV + i] = ip[8 + i];
  fill_row(s.sval_sid, s.S, lane, 0);
  fill_row(s.s_written, s.S, lane, 0);
  fill_row(s.s_read, s.S, lane, 0);
  fill_row(s.skey_sid, s.S, lane, 0);
  fill_row(s.s_wstep, s.S, lane, 0);
  fill_row(s.skeys, (size_t)s.S * 8, lane, 0u);
  fill_row(s.svals, (size_t)s.S * 8, lane, 0u);
}

__global__ void k_free_slots(Sym s, const int32_t* fs, const int32_t* fcount) {
  long long i = gid();
  if (i < s.n) s.free_slots[i] = fs[i];
  if (i == 0) *s.free_count = *fcount;
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

// K3's launch modes: one block; a cooperative grid (a block's winners bid
// for a table in global memory, a grid barrier a phase)
enum DedupMode { ONE = 0, GRID = 1 };

// a load of what other threads of the launch write during it: from L2
// across blocks (no stale L1 line of another SM), plain in one block
template <int MODE, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (MODE != ONE) return __ldcg(p);
  else return *p;
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

inline void remap_plane(int32_t* plane, long long len, const int32_t* table, int n, int R,
                        cudaStream_t st) {
  if (len > 0) k_remap<<<nblocks_for(len, 256), 256, 0, st>>>(plane, len, table, n, R);
}

// ---------------------------------------------------------------- K4

__global__ void k_hold_flags(Sym s, const int32_t* code, int code_rows, int resume_on,
                             int32_t* flag) {
  long long lane = gid();
  if (lane >= s.n) return;
  int pc = clampi(s.pc[lane], 0, code_rows - 1);
  int op = code[(size_t)pc * CODE_COLS];
  flag[lane] = resume_on != 0 && s.status[lane] == NEEDS_HOST && op == OP_SHA3 &&
               s.sp[lane] >= 2 && s.msize[lane] <= RESUME_MEM &&
               s.mlog_count[lane] <= RESUME_MLOG;
}

__global__ void k_mark(int32_t* flag, const int32_t* idx, int cap, int n, int32_t v) {
  long long j = gid();
  if (j >= cap) return;
  int l = idx[j];
  if (l >= 0 && l < n) flag[l] = v;
}

__global__ void k_elig_flags(Sym s, int budget, const int* floors, const int32_t* held,
                             int32_t* flag) {
  long long lane = gid();
  if (lane >= s.n) return;
  int st = s.status[lane];
  bool parked = st == NEEDS_HOST || (st == RUNNING && s.steps[lane] >= budget);
  bool fits = s.sp[lane] <= floors[0] && s.msize[lane] <= floors[1] &&
              s.mlog_count[lane] <= floors[2] && s.scount[lane] <= floors[3];
  flag[lane] = parked && fits && !held[lane];
}

__global__ void k_mark_dead(Sym s, const int32_t* idx, int cap) {
  long long j = gid();
  if (j >= cap) return;
  int l = idx[j];
  if (l >= 0 && l < s.n) s.status[l] = DEAD;
}

struct Rows {
  int32_t* i32;
  uint32_t* u32;
  uint8_t* u8;
  int ws, wm, wl, wk;  // stack slots, memory bytes, overlay records, storage slots
};

// one block per row: the lane's row packed as _retire_gather_core packs it
__global__ void k_retire_gather(Sym s, const int32_t* idx, Rows o) {
  int j = blockIdx.x;
  int lane = clampi(idx[j], 0, s.n - 1);
  const int ci = 10 + 3 * o.wl + o.ws + 5 * o.wk;
  const int cu = 8 * (o.ws + 2 * o.wk);
  int32_t* ri = o.i32 + (size_t)j * ci;
  uint32_t* ru = o.u32 + (size_t)j * cu;
  uint8_t* rb = o.u8 + (size_t)j * 2 * o.wm;
  if (threadIdx.x == 0) {
    ri[0] = s.pc[lane];
    ri[1] = s.sp[lane];
    ri[2] = s.depth[lane];
    ri[3] = s.fentry[lane];
    ri[4] = s.last_jump[lane];
    ri[5] = s.msize[lane];
    ri[6] = s.mlog_count[lane];
    ri[7] = s.scount[lane];
    ri[8] = (int32_t)s.min_gas[lane];
    ri[9] = (int32_t)s.max_gas[lane];
  }
  for (int i = threadIdx.x; i < o.wl; i += blockDim.x) {
    size_t p = (size_t)lane * s.MR + i;
    ri[10 + i] = s.mlog_off[p];
    ri[10 + o.wl + i] = s.mlog_len[p];
    ri[10 + 2 * o.wl + i] = s.mlog_sid[p];
  }
  int base = 10 + 3 * o.wl;
  for (int i = threadIdx.x; i < o.ws; i += blockDim.x) ri[base + i] = s.ssid[(size_t)lane * s.D + i];
  base += o.ws;
  for (int i = threadIdx.x; i < o.wk; i += blockDim.x) {
    size_t p = (size_t)lane * s.S + i;
    ri[base + i] = s.sval_sid[p];
    ri[base + o.wk + i] = s.s_written[p];
    ri[base + 2 * o.wk + i] = s.s_read[p];
    ri[base + 3 * o.wk + i] = s.skey_sid[p];
    ri[base + 4 * o.wk + i] = s.s_wstep[p];
  }
  for (int i = threadIdx.x; i < o.ws * 8; i += blockDim.x) ru[i] = s.stack[(size_t)lane * s.D * 8 + i];
  for (int i = threadIdx.x; i < o.wk * 8; i += blockDim.x) {
    ru[o.ws * 8 + i] = s.skeys[(size_t)lane * s.S * 8 + i];
    ru[(o.ws + o.wk) * 8 + i] = s.svals[(size_t)lane * s.S * 8 + i];
  }
  for (int i = threadIdx.x; i < o.wm; i += blockDim.x) {
    rb[i] = s.memory[(size_t)lane * s.M + i];
    rb[o.wm + i] = s.mkind[(size_t)lane * s.M + i];
  }
}

// one block per held lane: _resume_gather_core's slim row
__global__ void k_resume_gather(Sym s, const int32_t* idx, Rows o) {
  int j = blockIdx.x;
  int lane = clampi(idx[j], 0, s.n - 1);
  const int ci = 7 + 3 * o.wl;
  int32_t* ri = o.i32 + (size_t)j * ci;
  uint32_t* ru = o.u32 + (size_t)j * 16;
  uint8_t* rb = o.u8 + (size_t)j * 2 * o.wm;
  int sp = s.sp[lane];
  int top = clampi(sp - 1, 0, s.D - 1), sub = clampi(sp - 2, 0, s.D - 1);
  if (threadIdx.x == 0) {
    ri[0] = s.msize[lane];
    ri[1] = (int32_t)s.min_gas[lane];
    ri[2] = (int32_t)s.max_gas[lane];
    ri[3] = (int32_t)s.gas_limit[lane];
    ri[4] = s.mlog_count[lane];
    ri[5] = s.ssid[(size_t)lane * s.D + top];
    ri[6] = s.ssid[(size_t)lane * s.D + sub];
  }
  for (int i = threadIdx.x; i < o.wl; i += blockDim.x) {
    size_t p = (size_t)lane * s.MR + i;
    ri[7 + i] = s.mlog_off[p];
    ri[7 + o.wl + i] = s.mlog_len[p];
    ri[7 + 2 * o.wl + i] = s.mlog_sid[p];
  }
  for (int i = threadIdx.x; i < 8; i += blockDim.x) {
    ru[i] = s.stack[((size_t)lane * s.D + top) * 8 + i];
    ru[8 + i] = s.stack[((size_t)lane * s.D + sub) * 8 + i];
  }
  for (int i = threadIdx.x; i < o.wm; i += blockDim.x) {
    rb[i] = s.memory[(size_t)lane * s.M + i];
    rb[o.wm + i] = s.mkind[(size_t)lane * s.M + i];
  }
}

__global__ void k_counts(Sym s, int32_t* misc, int32_t* scal) {
  long long lane = gid();
  if (lane < s.n) {
    int32_t* m = misc + lane * 8;
    m[0] = s.dlog_count[lane];
    m[1] = s.status[lane];
    m[2] = s.steps[lane];
    m[3] = s.sp[lane];
    m[4] = s.scount[lane];
    m[5] = s.mlog_count[lane];
    m[6] = s.msize[lane];
    m[7] = s.pc[lane];
  }
  if (lane == 0) {
    scal[0] = *s.flog_count;
    scal[1] = *s.free_count;
  }
}

__global__ void k_canon_flags(Sym s, const int32_t* canon, int32_t* flag) {
  long long i = gid();
  long long len = (long long)s.n * s.R;
  if (i >= len) return;
  long long lane = i / s.R, r = i % s.R;
  flag[i] = r < s.dlog_count[lane] && canon[i] == (int32_t)(-(lane * s.R + r + 1));
}

// one thread per row: [lane, slot, op, pc, step, fentry, sid0..2, vals]
__global__ void k_unique_gather(Sym s, const int32_t* rows, int urb, int32_t* tab) {
  long long j = gid();
  if (j >= urb) return;
  long long flat = rows[j];
  int l = (int)(flat / s.R), sl = (int)(flat % s.R);
  size_t rp = (size_t)l * s.R + sl;
  int32_t* t = tab + j * 33;
  t[0] = l;
  t[1] = sl;
  t[2] = s.dlog_op[rp];
  t[3] = s.dlog_pc[rp];
  t[4] = s.dlog_step[rp];
  t[5] = s.dlog_fentry[rp];
  for (int c = 0; c < 3; ++c) t[6 + c] = s.dlog_sid[rp * 3 + c];
  for (int c = 0; c < 24; ++c) t[9 + c] = (int32_t)s.dlog_val[rp * 24 + c];
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

// a thread an output word: row i / 9, column i % 9 (coalesced stores)
__global__ void k_fork_gather(const __grid_constant__ Flog f, int fb, int32_t* tab) {
  long long i = gid();
  if (i >= 9LL * fb) return;
  tab[i] = f.col[i % 9][i / 9];
}

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

// unique-record table: canonical flags over N x R, ascending compaction
// into urb rows (padding row 0), the count into *count
inline void unique_table_launch(const Sym& s, const int32_t* canon, int urb, int32_t* tab,
                                int32_t* count, int32_t* scratch, cudaStream_t st) {
  long long len = (long long)s.n * s.R;
  int32_t* flag = scratch;
  int32_t* rows = flag + len;
  int32_t* block_off = rows + urb;
  if (len > 0) k_canon_flags<<<nblocks_for(len, 256), 256, 0, st>>>(s, canon, flag);
  compact(flag, len, rows, urb, 0, block_off, count, st);
  if (urb > 0) k_unique_gather<<<nblocks_for(urb, 128), 128, 0, st>>>(s, rows, urb, tab);
}

}  // namespace

// K2. offs: element offsets in i32buf of the _seed_sections, in order
// (idx, i32p, u32p, fs, fcount, prov, kill, stack_v, stack_s, r_idx,
// r_i32, r_limbs); u8buf holds u8p, mem_v, mem_k. dense: n*R ints.
MTT_EXPORT int window_prologue(void** planes, const int* dims, const void* i32buf,
                               const void* u8buf, const int* offs, int k, int pv, int sd,
                               int mc, int ccw, void* dense, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* b = (const int32_t*)i32buf;
  const uint8_t* u8 = (const uint8_t*)u8buf;
  int32_t* table = (int32_t*)dense;
  long long nr = (long long)s.n * s.R;
  if (s.n == 0) return (int)cudaGetLastError();
  fill_i32<<<nblocks_for(nr, 256), 256, 0, st>>>(table, nr, I32_MIN);
  if (pv > 0) k_scatter_prov<<<nblocks_for(pv, 256), 256, 0, st>>>(table, nr, b + offs[5], pv);
  remap_plane(s.ssid, (long long)s.n * s.D, table, s.n, s.R, st);
  remap_plane(s.sval_sid, (long long)s.n * s.S, table, s.n, s.R, st);
  remap_plane(s.skey_sid, (long long)s.n * s.S, table, s.n, s.R, st);
  remap_plane(s.mlog_sid, (long long)s.n * s.MR, table, s.n, s.R, st);
  k_reset_logs<<<nblocks_for(s.n, 256), 256, 0, st>>>(s);
  k_kill<<<nblocks_for(s.n, 256), 256, 0, st>>>(s, b + offs[6]);
  if (k > 0) {
    k_resume<<<nblocks_for(k, 128), 128, 0, st>>>(s, b + offs[9], b + offs[10],
                                                  (const uint32_t*)(b + offs[11]), k);
    Seeds z;
    z.idx = b + offs[0];
    z.i32p = b + offs[1];
    z.u32p = (const uint32_t*)(b + offs[2]);
    z.stack_v = (const uint32_t*)(b + offs[7]);
    z.stack_s = b + offs[8];
    z.u8p = u8;
    z.mem_v = u8 + (size_t)k * ccw;
    z.mem_k = u8 + (size_t)k * (ccw + mc);
    z.k = k;
    z.sd = sd;
    z.mc = mc;
    z.ccw = ccw;
    k_seed<<<k, 256, 0, st>>>(s, z);
  }
  k_free_slots<<<nblocks_for(s.n, 256), 256, 0, st>>>(s, b + offs[3], b + offs[4]);
  return (int)cudaGetLastError();
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

// K4. floors: the retire column floors (stack, memory, overlay, slots).
// scratch: 3*n + n*R + urb + ceil(n*R/256) + 8 ints.
MTT_EXPORT int window_epilogue(void** planes, const int* dims, const void* code, int code_rows,
                               int budget, int resume_on, const void* canon, void* misc,
                               void* scal, void* utab, void* ftab, void* ridx, void* r_i32,
                               void* r_u32, void* r_u8, void* hidx, void* h_i32, void* h_u32,
                               void* h_u8, const int* floors, int urb, int fb, void* scratch,
                               void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  int n = s.n;
  if (n == 0) return (int)cudaGetLastError();
  int rcap = min(16, n), hcap = min(64, n);
  int32_t* sc = (int32_t*)scratch;
  int32_t* hflag = sc;
  int32_t* held = hflag + n;
  int32_t* eflag = held + n;
  int32_t* rest = eflag + n;  // unique-table scratch
  // floors live on the host; the flag kernel reads them from the device
  int32_t* dfloors = rest;
  cudaMemcpyAsync(dfloors, floors, 4 * sizeof(int), cudaMemcpyHostToDevice, st);
  unsigned nb = nblocks_for(n, 256);
  int32_t* block_off = rest + 8;
  k_hold_flags<<<nb, 256, 0, st>>>(s, (const int32_t*)code, code_rows, resume_on, hflag);
  compact(hflag, n, (int32_t*)hidx, hcap, n, block_off, nullptr, st);
  fill_i32<<<nb, 256, 0, st>>>(held, n, 0);
  k_mark<<<nblocks_for(hcap, 64), 64, 0, st>>>(held, (const int32_t*)hidx, hcap, n, 1);
  k_elig_flags<<<nb, 256, 0, st>>>(s, budget, dfloors, held, eflag);
  compact(eflag, n, (int32_t*)ridx, rcap, n, block_off, nullptr, st);
  Rows h;
  h.i32 = (int32_t*)h_i32;
  h.u32 = (uint32_t*)h_u32;
  h.u8 = (uint8_t*)h_u8;
  h.ws = 0;
  h.wk = 0;
  h.wl = min(RESUME_MLOG, s.MR);
  h.wm = min(RESUME_MEM, s.M);
  k_resume_gather<<<hcap, 128, 0, st>>>(s, (const int32_t*)hidx, h);
  k_retire_gather<<<rcap, 256, 0, st>>>(s, (const int32_t*)ridx,
                                        retire_rows_of(s, floors, r_i32, r_u32, r_u8));
  k_mark_dead<<<1, 64, 0, st>>>(s, (const int32_t*)ridx, rcap);
  k_counts<<<nb, 256, 0, st>>>(s, (int32_t*)misc, (int32_t*)scal);
  unique_table_launch(s, (const int32_t*)canon, urb, (int32_t*)utab, (int32_t*)scal + 2,
                      rest + 8, st);
  if (fb > 0) k_fork_gather<<<nblocks_for(9LL * fb, 256), 256, 0, st>>>(flog_of(s), fb, (int32_t*)ftab);
  return (int)cudaGetLastError();
}

// _retire_rows: gather the rows of idx[0..k) and mark them DEAD
MTT_EXPORT int retire_rows(void** planes, const int* dims, const void* idx, int k,
                           const int* floors, void* i32, void* u32, void* u8, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  if (k > 0 && s.n > 0) {
    k_retire_gather<<<k, 256, 0, st>>>(s, (const int32_t*)idx,
                                       retire_rows_of(s, floors, i32, u32, u8));
    k_mark_dead<<<nblocks_for(k, 256), 256, 0, st>>>(s, (const int32_t*)idx, k);
  }
  return (int)cudaGetLastError();
}

// _unique_table_big's table (after window_dedup without writes).
// scratch: n*R + urb + ceil(n*R/256) + 8 ints.
MTT_EXPORT int unique_table(void** planes, const int* dims, const void* canon, int urb,
                            void* tab, void* count, void* scratch, void* stream) {
  Sym s = make_sym(planes, dims);
  unique_table_launch(s, (const int32_t*)canon, urb, (int32_t*)tab, (int32_t*)count,
                      (int32_t*)scratch, (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
