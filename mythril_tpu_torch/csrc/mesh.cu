// K12 lane_live, K13 lane_order, K14 lane_gather: the lane accounting,
// the compaction order and the lane gather of the sharded batch.
//
// Replace mythril_tpu/parallel/mesh.py (kernel row 14):
//  - K12: :110 live_lane_counts, a shard_map'd jnp.sum(status == RUNNING)
//    per device and its psum. One block a shard counts its own lanes;
//    the total is the wrapper's sum of the n_dev counts in the process
//    (the psum is over the devices of one process, not between ranks).
//  - K13: :138 compact_lanes' and :150 steal_balance's
//    jnp.argsort(-running, stable=True), with steal_balance's deal
//    (:152-155, reshape (n/n_dev, n_dev), transpose, flatten) applied in
//    the same launch. A stable sort on a 0/1 key is a stable partition:
//    lane i goes to sorted position q = (running lanes before i) if it
//    runs, else R + (lanes before i that do not run), R the running
//    total. The count before i is a prefix scan (block ranks by ballot,
//    block offsets by one scan block), so no two lanes race for a slot
//    and the order is JAX's bit for bit at every n. The deal sends
//    sorted position q = s * n_dev + d to output position
//    d * (n / n_dev) + s.
//  - K14: :139 `x[order]` and :156 `x[dealt]` over every plane of the
//    LaneState (17 planes of their own row widths, int32 and uint8),
//    with JAX's index rule: a negative index wraps once (i + n), then an index out
//    of range clamps to [0, n).
//
// Bounds on this card: all three move bytes and do almost no
// arithmetic. K12 and K13 read the status plane (4 bytes a lane) and
// K13 writes the order (4 bytes a lane): under 1.1 MB at 131072 lanes,
// so their time is launch latency and the scan's dependent steps, not
// bandwidth. K14 reads every byte of the gathered rows once and writes
// it once: at 131072 default lanes (11212 bytes) 2.94 GB, 0.88 ms at
// 3.35 TB/s. Its design aims at that bound: one launch over every
// plane, each block a run of one plane's output rows; each plane copies
// with the widest word (16, 8, 4, 2 or 1 bytes) that divides its row and
// both base addresses, indexed by (row, word) with shifts only: a row
// takes the smallest power-of-two group of a warp's lanes that covers
// its words (at most 32), so a 4-byte plane copies 32 rows a warp and a
// 4 KB row a warp's 32 lanes. Every thread keeps four copies in flight:
// four rows of a small plane, or four 16-byte words of a large row.
// Plain unrolled 16-byte loads, not TMA bulk copies: each row comes from
// its own gathered source address and most rows are a few words, so a
// bulk copy through shared memory would add a hop and a barrier a row
// without adding bytes in flight, which four loads a thread already
// give (8 warps a block, ~16-32 KB a block). The wrapper allocates the
// output batch once, every plane a view of it (parallel/mesh.py
// gather_outputs).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int RUNNING = 0;
constexpr int LIVE_BLOCK = 256;
constexpr int MAX_PLANES = 32;
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WARPS = GATHER_THREADS / 32;
constexpr int UNROLL = 4;
// bytes a block of K14 copies (at least a step of rows)
constexpr long long GATHER_BLOCK_BYTES = 32768;

// one plane of K14: its rows and how its blocks copy them
struct GPlane {
  const uint8_t* src;
  uint8_t* dst;
  long long row;   // bytes a lane
  int words;       // row / vec
  int vec;         // copy width in bytes
  int lg;          // log2 of the warp lanes a row takes
  int rows;        // output rows a block
  int first;       // the plane's first block
};

struct Planes {
  GPlane p[MAX_PLANES];
  int n;
};

// K12: block b counts the RUNNING lanes of shard b (lanes
// [b * per, (b + 1) * per)).
__global__ void __launch_bounds__(LIVE_BLOCK)
k_lane_live(const int32_t* status, long long per, int32_t* out) {
  const int32_t* s = status + (long long)blockIdx.x * per;
  int c = 0;
  for (long long i = threadIdx.x; i < per; i += LIVE_BLOCK) c += s[i] == RUNNING;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  __shared__ int warp_sums[LIVE_BLOCK / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < LIVE_BLOCK / 32; ++w) total += warp_sums[w];
    out[blockIdx.x] = total;
  }
}

// K13, pass 1: each block's count of RUNNING lanes
__global__ void k_order_count(const int32_t* status, long long n, int32_t* block_off) {
  long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  int f = i < n ? status[i] == RUNNING : 0;
  int total;
  block_exclusive_scan(f, &total);
  if (threadIdx.x == 0) block_off[blockIdx.x] = total;
}

// K13, pass 3 (after compact_scan turned the counts into exclusive
// offsets and block_off[nblocks] into the total): each lane's sorted
// position, dealt over n_dev shards.
__global__ void k_order_write(const int32_t* status, long long n, int n_dev,
                              const int32_t* block_off, int32_t* out) {
  long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  int f = i < n ? status[i] == RUNNING : 0;
  int total;
  int rank = block_exclusive_scan(f, &total);
  if (i >= n) return;
  long long before = (long long)block_off[blockIdx.x] + rank;
  long long running = block_off[gridDim.x];
  long long q = f ? before : running + (i - before);
  long long per = n / n_dev;
  out[(q % n_dev) * per + q / n_dev] = (int32_t)i;
}

// JAX's gather index rule: a negative index wraps once, then clamps
__device__ __forceinline__ long long source_row(const int32_t* order, long long r,
                                                long long n_src) {
  long long i = order[r];
  if (i < 0) i += n_src;
  return i < 0 ? 0 : (i >= n_src ? n_src - 1 : i);
}

// rows [r0, r1) of plane g, words of type V
template <typename V>
__device__ __forceinline__ void gather_rows(const GPlane& g, const int32_t* order, long long n_src,
                                            long long r0, long long r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = 1 << g.lg;            // lanes a row
  const int sub = lane & (lpr - 1);     // this lane's first word
  const int rpw = 32 >> g.lg;           // rows a warp at once
  const int step = GATHER_WARPS * rpw;  // rows the block at once
  long long r = r0 + warp * rpw + (lane >> g.lg);
  if (g.words <= lpr) {
    // a word a row a lane: four rows in flight
    if (sub >= g.words) return;
    for (; r < r1; r += UNROLL * step) {
      V v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        long long rk = r + k * step;
        if (rk < r1) v[k] = ((const V*)(g.src + source_row(order, rk, n_src) * g.row))[sub];
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        long long rk = r + k * step;
        if (rk < r1) ((V*)(g.dst + rk * g.row))[sub] = v[k];
      }
    }
    return;
  }
  // a row a warp (lpr 32): four words in flight a lane
  for (; r < r1; r += step) {
    const V* a = (const V*)(g.src + source_row(order, r, n_src) * g.row);
    V* b = (V*)(g.dst + r * g.row);
    int w = sub;
    for (; w + (UNROLL - 1) * 32 < g.words; w += UNROLL * 32) {
      V v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) v[k] = a[w + k * 32];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) b[w + k * 32] = v[k];
    }
    for (; w < g.words; w += 32) b[w] = a[w];
  }
}

// K14: block b copies rows [rows * (b - first), +rows) of the plane
// whose blocks hold b
__global__ void __launch_bounds__(GATHER_THREADS)
k_lane_gather(const __grid_constant__ Planes ps, const int32_t* order, long long n_src,
              long long n_out) {
  int k = 0;
  while (k + 1 < ps.n && ps.p[k + 1].first <= (int)blockIdx.x) ++k;
  const GPlane& g = ps.p[k];
  const long long r0 = (long long)(blockIdx.x - g.first) * g.rows;
  const long long r1 = min(r0 + g.rows, n_out);
  switch (g.vec) {
    case 16: gather_rows<int4>(g, order, n_src, r0, r1); break;
    case 8: gather_rows<int2>(g, order, n_src, r0, r1); break;
    case 4: gather_rows<int>(g, order, n_src, r0, r1); break;
    case 2: gather_rows<short>(g, order, n_src, r0, r1); break;
    default: gather_rows<char>(g, order, n_src, r0, r1); break;
  }
}

}  // namespace

// K12: out[b] = RUNNING lanes of shard b, for n_dev shards of n / n_dev
// lanes (n % n_dev == 0, checked by the wrapper).
MTT_EXPORT int lane_live(const void* status, long long n, int n_dev, void* out,
                         void* stream) {
  if (n_dev > 0)
    k_lane_live<<<n_dev, LIVE_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t*)status, n / n_dev, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K13: out = the stable "running first" order of the n lanes, dealt
// round-robin over n_dev shards (n_dev 1: compact_lanes' order).
// scratch holds ceil(n / SCAN_BLOCK) + 1 ints.
MTT_EXPORT int lane_order(const void* status, long long n, int n_dev, void* scratch,
                          void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned nb = nblocks_for(n, SCAN_BLOCK);
  if (nb > 0 && n_dev > 0) {
    int32_t* off = (int32_t*)scratch;
    k_order_count<<<nb, SCAN_BLOCK, 0, st>>>((const int32_t*)status, n, off);
    compact_scan<<<1, SCAN_BLOCK, 0, st>>>(off, (int)nb, nullptr);
    k_order_write<<<nb, SCAN_BLOCK, 0, st>>>((const int32_t*)status, n, n_dev, off,
                                             (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// K14's layout of an output batch, prepared once by the wrapper for a
// batch shape: the planes' row bytes and their offsets (16-byte aligned)
// in the one output allocation.
struct GatherLayout {
  int n_planes;
  long long n_out;
  long long row[MAX_PLANES];
  long long offset[MAX_PLANES];
};

// K14: plane k of the output (at dst + offset[k]) gets, as its row j,
// row order[j] of src[k] (JAX's index rule). One launch over every
// plane; nothing launched for n_out or n_src 0.
MTT_EXPORT int lane_gather(const GatherLayout* lay, void** src, void* dst, const void* order,
                           long long n_src, void* stream) {
  const int np = lay->n_planes;
  if (np < 1 || np > MAX_PLANES) return (int)cudaErrorInvalidValue;
  const long long n_out = lay->n_out;
  if (n_out <= 0 || n_src <= 0) return 0;
  Planes ps;
  ps.n = np;
  long long blocks = 0;
  for (int k = 0; k < np; ++k) {
    GPlane& g = ps.p[k];
    g.src = (const uint8_t*)src[k];
    g.dst = (uint8_t*)dst + lay->offset[k];
    g.row = lay->row[k];
    int v = 16;
    while (v > 1 && (g.row % v || (uintptr_t)g.src % v || (uintptr_t)g.dst % v)) v >>= 1;
    g.vec = v;
    g.words = (int)(g.row / v);
    g.lg = 0;
    while ((1 << g.lg) < g.words && g.lg < 5) ++g.lg;
    // a block copies whole steps of rows, about GATHER_BLOCK_BYTES
    long long step = GATHER_WARPS * (32 >> g.lg);
    long long unit = g.words <= (1 << g.lg) ? UNROLL * step : step;
    long long want = GATHER_BLOCK_BYTES / (g.row > 0 ? g.row : 1);
    long long rows = std::max(unit, want / unit * unit);
    rows = std::min(rows, (n_out + step - 1) / step * step);
    g.rows = (int)rows;
    g.first = (int)blocks;
    blocks += g.row > 0 ? (n_out + rows - 1) / rows : 0;
  }
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    k_lane_gather<<<(unsigned)blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
        ps, (const int32_t*)order, n_src, n_out);
  return (int)cudaGetLastError();
}
