// K12 lane_live, K13 lane_order, K14 lane_gather: the lane accounting,
// the compaction order and the lane gather of the sharded batch.
//
// Replace mythril_tpu/parallel/mesh.py (kernel row 14):
//  - K12: :110 live_lane_counts, a shard_map'd jnp.sum(status == RUNNING)
//    per device and its psum. One launch a device over every shard on
//    it (16 lanes a thread from four 16-byte loads, each a warp's 512
//    contiguous bytes; block sums): a block a shard where a shard is a
//    whole number of a warp's 512 lanes (up to a bound), else
//    a grid sized to the card whose shards' counts meet in the same
//    launch (64-bit atomic adds that also count themselves: the add that
//    completes a shard writes its total and clears it); the counts also
//    go into a pinned host buffer mapped into the card's address space;
//    the total is the wrapper's sum of the n_dev counts in the process
//    (the psum is over the devices of one process, not between ranks).
//  - K13: :138 compact_lanes' and :150 steal_balance's
//    jnp.argsort(-running, stable=True), with steal_balance's deal
//    (:152-155, reshape (n/n_dev, n_dev), transpose, flatten) applied in
//    the same launch. A stable sort on a 0/1 key is a stable partition:
//    lane i goes to sorted position q = (running lanes before i) if it
//    runs, else R + (lanes before i that do not run), R the running
//    total. The count before i is a prefix scan (warp scans over the
//    threads, 16 lanes a thread as a bit mask from four 16-byte loads;
//    on a grid the blocks' sums through one grid barrier), so no two
//    lanes race for a slot and the order is JAX's bit for bit at every n.
//    The deal sends sorted position q = s * n_dev + d to output position
//    d * (n / n_dev) + s. One launch a call (were three): a cooperative
//    grid of 256-thread blocks, one block for up to 4096 lanes
//    (parallel/mesh.py lane_order_shape); the blocks' sums in the output
//    allocation's tail.
//  - K14: :139 `x[order]` and :156 `x[dealt]` over every plane of the
//    LaneState (17 planes of their own row widths, int32 and uint8),
//    with JAX's index rule: a negative index wraps once (i + n), then an index out
//    of range clamps to [0, n).
//
// Bounds on this card: all three move bytes and do almost no
// arithmetic. K12 and K13 read the status plane (4 bytes a lane) and
// K13 writes the order (4 bytes a lane): under 1.1 MB at 131072 lanes,
// so their time is launch latency and the scan's dependent steps, not
// bandwidth: K12's bound at 131072 lanes is 0.16 us, far below a
// launch's own floor (an empty kernel, empty_launch), so its design
// aims at one launch that every SM takes part in and no copy after it.
// K13's stores scatter (a thread's lanes go to two runs of
// sorted positions), so they are spread over a grid of blocks: one
// block of them took 0.035 ms at 32768 lanes, a grid of 8 blocks 0.0116
// (PERF.md §6). K14 reads every byte of the gathered rows once and writes
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

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RUNNING = 0;
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

// K13: lanes a thread holds in a tile, read as four 16-byte loads, and
// the threads of a block
constexpr int ORDER_VEC = 16;
constexpr int ORDER_THREADS = 256;

// the RUNNING flags of lanes [i, i + ORDER_VEC) as bits (lanes past n: 0)
__device__ __forceinline__ unsigned order_flags(const int32_t* status, long long i, long long n,
                                                bool vec) {
  unsigned m = 0;
  if (vec && i + ORDER_VEC <= n) {
    const int4* p = reinterpret_cast<const int4*>(status + i);
#pragma unroll
    for (int k = 0; k < ORDER_VEC / 4; ++k) {
      const int4 v = p[k];
      m |= (unsigned)(v.x == RUNNING) << (4 * k) | (unsigned)(v.y == RUNNING) << (4 * k + 1) |
           (unsigned)(v.z == RUNNING) << (4 * k + 2) | (unsigned)(v.w == RUNNING) << (4 * k + 3);
    }
  } else {
    for (int k = 0; k < ORDER_VEC && i + k < n; ++k) m |= (unsigned)(status[i + k] == RUNNING) << k;
  }
  return m;
}

// K12: the RUNNING lanes of each shard of one device, in one launch. The
// device's shards lie in `arrays` status arrays (mesh order) of `spp`
// shards of `per` lanes each: one array of every shard where the shards
// are views of one batch, an array a shard where each is its own copy.
// The lanes are cut into warp tiles of LIVE_TILE lanes, array by array
// (warp tile w: array w / tiles, lanes from (w % tiles) * LIVE_TILE):
// thread t of a warp holds the 16 lanes from 4 t + 128 k (k < 4) of its
// tile, as live_flags' bit mask from four 16-byte loads, each a warp's
// 512 contiguous bytes. A block's warps take a chunk of as many tiles:
// block b chunk b, then the chunks a grid further on. For each shard its
// chunk holds lanes of (a block-uniform loop: one shard, or several
// where a shard boundary falls inside the chunk, per no multiple of
// LIVE_TILE), the block sums its running lanes (warp sums, then the
// warps' in shared memory). A shard that lies in one chunk is written out
// by the block; otherwise its chunks' sums meet in the shard's counter,
// a 64-bit atomic add that also counts the adds (high word), and the add
// that completes it (its chunks, known from the geometry) writes the
// total and clears the counter for the next launch: no grid-wide ticket,
// no fence, no memset launch. Integer adds are exact in any order. The
// block (parallel/mesh.lane_live_threads) is a shard's warp tiles where
// it is a whole number of them, a warp each, up to mesh.py's
// LIVE_SHARD_THREADS, so a shard is one chunk and takes no atomic; else
// LIVE_THREADS, a grid sized to the card. The counts go to out and host
// (either may be null); a launch of no lanes writes zeros.
constexpr int LIVE_TILE = 32 * ORDER_VEC;
constexpr int LIVE_THREADS = 64;
constexpr int LIVE_MAX_THREADS = 1024;
constexpr int MAX_LIVE_ARRAYS = 64;

// the RUNNING flags of a thread's lanes base + 128 k + r (k, r < 4; lanes
// past n: 0) as bits 4 k + r: four 16-byte loads issued together where
// the thread's lanes are all inside the array, else 4-byte loads
__device__ __forceinline__ unsigned live_flags(const int32_t* status, unsigned base, unsigned n,
                                               bool vec) {
  unsigned m = 0;
  if (vec && base + 128 * 3 + 4 <= n) {
    int4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const int4*>(status + base + 128 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m |= ((unsigned)(v[k].x == RUNNING) | (unsigned)(v[k].y == RUNNING) << 1 |
            (unsigned)(v[k].z == RUNNING) << 2 | (unsigned)(v[k].w == RUNNING) << 3)
           << (4 * k);
    return m;
  }
  for (unsigned k = 0; k < 4; ++k)
    for (unsigned r = 0; r < 4 && base + 128 * k + r < n; ++r)
      m |= (unsigned)(status[base + 128 * k + r] == RUNNING) << (4 * k + r);
  return m;
}

// the status arrays of a launch: NA 1 (the shards are views of one batch:
// a launch's parameters stay small, and every tile is the one array's) or
// MAX_LIVE_ARRAYS
template <int NA>
struct LiveArrays {
  const int32_t* status[NA];
};

template <int NA>
__global__ void __launch_bounds__(LIVE_MAX_THREADS)
k_lane_live(const __grid_constant__ LiveArrays<NA> a, unsigned arrays, unsigned spp,
            unsigned per, int vec, unsigned long long* counters, int32_t* out, int32_t* host) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  __shared__ unsigned warp_sums[LIVE_MAX_THREADS / 32];
  const unsigned lanes = per * spp, tiles = (lanes + LIVE_TILE - 1) / LIVE_TILE;
  const unsigned total = tiles * arrays, shards = arrays * spp;
  const unsigned W = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lanes == 0) {
    for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < shards;
         k += gridDim.x * blockDim.x) {
      if (out) out[k] = 0;
      if (host) host[k] = 0;
    }
    return;
  }
  // the chunks over shard k's tiles: the sums that complete it
  auto chunks_over = [&](unsigned k) {
    const unsigned j = k / spp, q = k - j * spp;
    const unsigned t0 = j * tiles + q * per / LIVE_TILE;
    const unsigned t1 = j * tiles + ((q + 1) * per - 1) / LIVE_TILE;
    return t1 / W - t0 / W + 1;
  };
  // c0: the chunk's first warp tile, the same in the whole block
  for (unsigned c0 = blockIdx.x * W; c0 < total; c0 += gridDim.x * W) {
    // the chunk's first and last shards
    const unsigned c1 = min(c0 + W, total) - 1;
    const unsigned a0 = NA > 1 ? c0 / tiles : 0, a1 = NA > 1 ? c1 / tiles : 0;
    const unsigned k0 = a0 * spp + (c0 - a0 * tiles) * LIVE_TILE / per;
    const unsigned k1 = a1 * spp + (min((c1 - a1 * tiles + 1) * LIVE_TILE, lanes) - 1) / per;
    const unsigned g = c0 + warp;
    const bool has = g < total;
    const unsigned arr = NA > 1 && has ? g / tiles : 0;
    const unsigned base = (g - arr * tiles) * LIVE_TILE + 4 * lane;
    unsigned want = threadIdx.x == 0 ? chunks_over(k0) : 0;  // ahead of the loads
    const unsigned m = has ? live_flags(a.status[arr], base, lanes, vec) : 0u;
    for (unsigned k = k0; k <= k1; ++k) {
      if (k != k0 && threadIdx.x == 0) want = chunks_over(k);
      unsigned c = 0;
      if (k0 == k1) {
        c = __popc(m);
      } else if (has && k / spp == arr) {  // this thread's lanes of shard k
        const unsigned q = k - arr * spp, lo = q * per, hi = lo + per;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned i = base + 128 * j, x = max(i, lo), y = min(i + 4, hi);
          if (x < y) c += __popc((m >> (4 * j + x - i)) & ((1u << (y - x)) - 1u));
        }
      }
      c = __reduce_add_sync(FULL, c);
      if (lane == 0) warp_sums[warp] = c;
      __syncthreads();
      if (warp == 0) c = __reduce_add_sync(FULL, lane < W ? warp_sums[lane] : 0u);
      if (threadIdx.x == 0) {
        int n = (int)c;
        bool done = want == 1;
        if (!done) {
          const unsigned long long old = atomicAdd(counters + k, (1ull << 32) | c);
          done = (old >> 32) + 1 == want;
          n = (int)((unsigned)old + c);
          if (done) counters[k] = 0;
        }
        if (done) {
          if (out) out[k] = n;
          if (host) host[k] = n;
        }
      }
      __syncthreads();  // warp_sums is the next pass's
    }
  }
}

// an empty kernel: the launch floor that K12's time is judged against
__global__ void k_empty() {}

// exclusive prefix of c over the block's threads (thread order); *total
// gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ int order_scan(int c, int* total) {
  __shared__ int sums[ORDER_THREADS / 32];
  constexpr int nw = ORDER_THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nw) sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = (warp ? sums[warp - 1] : 0) + x - c;
  *total = sums[nw - 1];
  __syncthreads();  // sums is reused by the next call
  return before;
}

// K13: the stable "running first" order of n lanes, dealt over n_dev
// shards, in one cooperative launch. The lanes are cut into tiles of
// ORDER_VEC lanes a thread (thread t of a tile holds lanes tile *
// ORDER_VEC * ORDER_THREADS + t * ORDER_VEC onward); block b takes tiles
// [b * tiles, (b + 1) * tiles). Pass 1: each thread counts its running
// lanes (keeping its first tile's flags), the block sums them into
// buf[b]; one grid barrier, and every block reads its offset (the sums
// of the blocks before it) and the total R. Pass 2, tile by tile: a
// thread's running lanes before it in the block come from a scan over
// the threads; lane i that runs goes to sorted position q = (running
// lanes before i), one that does not to R + (lanes before i that do not
// run); then the deal (q = s * n_dev + d to d * (n / n_dev) + s).
__global__ void __launch_bounds__(ORDER_THREADS)
k_order(const int32_t* status, long long n, int n_dev, int tiles, int vec, int32_t* buf,
        int32_t* out) {
  const long long tile_lanes = (long long)ORDER_VEC * ORDER_THREADS;
  const long long first = (long long)blockIdx.x * tiles;
  unsigned m0 = 0;
  int c = 0;
  for (int k = 0; k < tiles; ++k) {
    const long long i = (first + k) * tile_lanes + (long long)threadIdx.x * ORDER_VEC;
    const unsigned m = i < n ? order_flags(status, i, n, vec) : 0u;
    if (k == 0) m0 = m;
    c += __popc(m);
  }
  __shared__ long long head[2];  // the block's offset, the running total
  int block_total;
  order_scan(c, &block_total);
  if (threadIdx.x == 0) buf[blockIdx.x] = block_total;
  cg::this_grid().sync();
  if (threadIdx.x < 32) {
    long long before = 0, all = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) {
      const long long v = buf[b];
      all += v;
      if (b < (int)blockIdx.x) before += v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      before += __shfl_down_sync(0xFFFFFFFFu, before, off);
      all += __shfl_down_sync(0xFFFFFFFFu, all, off);
    }
    if (threadIdx.x == 0) {
      head[0] = before;
      head[1] = all;
    }
  }
  __syncthreads();
  long long carry = head[0];
  const unsigned running = (unsigned)head[1], nd = (unsigned)n_dev;
  const unsigned per = (unsigned)(n / n_dev);
  for (int k = 0; k < tiles; ++k) {
    const long long i = (first + k) * tile_lanes + (long long)threadIdx.x * ORDER_VEC;
    const unsigned m = k == 0 ? m0 : (i < n ? order_flags(status, i, n, vec) : 0u);
    int tile_total;
    const unsigned before = (unsigned)(carry + order_scan(__popc(m), &tile_total));
    carry += tile_total;
    if (i >= n) continue;
    // the sorted positions of this thread's running lanes count up from
    // before, of the others from running + (i - before): each kept as
    // (shard, slot) of the deal, so no lane divides
    const unsigned q1 = before, q0 = running + (unsigned)i - before;
    unsigned d1 = q1 % nd, s1 = q1 / nd, d0 = q0 % nd, s0 = q0 / nd;
    for (int j = 0; j < ORDER_VEC && i + j < n; ++j) {
      if ((m >> j) & 1u) {
        out[d1 * per + s1] = (int32_t)(i + j);
        if (++d1 == nd) d1 = 0, ++s1;
      } else {
        out[d0 * per + s0] = (int32_t)(i + j);
        if (++d0 == nd) d0 = 0, ++s0;
      }
    }
  }
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

// K12: the RUNNING lanes of each shard on one device: status, a host
// array of `arrays` device pointers (mesh order, at most
// MAX_LIVE_ARRAYS), each of spp shards of per lanes, shard k of array j
// counted as shard j * spp + k (fewer than 2^31 lanes in all); one
// launch of `blocks` blocks of `threads` threads (a multiple of 32, at
// most LIVE_MAX_THREADS: parallel/mesh.lane_live_threads and
// lane_live_shape; a block's chunk is a warp tile a warp). counters:
// arrays * spp 64-bit words, zero before the first call (every call
// leaves them so); out (device) and host (pinned and mapped,
// live_host_alloc) get the counts, either may be null. vec: every array
// 16-byte aligned (16-byte loads). sync: wait for the launch
// before returning (the counts are then in host).
MTT_EXPORT int lane_live(void* const* status, int arrays, int spp, long long per, int blocks,
                         int threads, int vec, void* counters, void* out, void* host, int sync,
                         void* stream) {
  if (arrays < 1 || arrays > MAX_LIVE_ARRAYS || spp < 1 || per < 0 || blocks < 1 ||
      threads < 32 || threads > LIVE_MAX_THREADS || threads % 32 ||
      per * spp * arrays >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (arrays == 1) {
    const LiveArrays<1> a{{(const int32_t*)status[0]}};
    k_lane_live<1><<<blocks, threads, 0, st>>>(a, 1, spp, (unsigned)per, vec,
                                               (unsigned long long*)counters, (int32_t*)out,
                                               (int32_t*)host);
  } else {
    LiveArrays<MAX_LIVE_ARRAYS> a;
    for (int j = 0; j < arrays; ++j) a.status[j] = (const int32_t*)status[j];
    k_lane_live<MAX_LIVE_ARRAYS><<<blocks, threads, 0, st>>>(
        a, arrays, spp, (unsigned)per, vec, (unsigned long long*)counters, (int32_t*)out,
        (int32_t*)host);
  }
  cudaError_t rc = cudaGetLastError();
  if (rc == cudaSuccess && sync) rc = cudaStreamSynchronize(st);
  return (int)rc;
}

// blocks of K12 of `threads` threads resident at once on the current
// device (the most its grid takes)
MTT_EXPORT int lane_live_blocks(int threads) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k_lane_live<MAX_LIVE_ARRAYS>, threads, 0);
  return sms * (per > 0 ? per : 1);
}

// K12's host buffer: n ints of pinned host memory mapped into the
// address space of every device (*dev: its device address, which with
// unified addressing is *host); K12's last block writes the counts there
MTT_EXPORT int live_host_alloc(int n, void** host, void** dev) {
  cudaError_t rc = cudaHostAlloc(host, sizeof(int32_t) * (size_t)(n > 0 ? n : 1),
                                 cudaHostAllocMapped | cudaHostAllocPortable);
  if (rc == cudaSuccess) rc = cudaHostGetDevicePointer(dev, *host, 0);
  return (int)rc;
}

// an empty kernel of one thread on the stream: the launch floor
// (chip_smoke.py times it beside K12)
MTT_EXPORT int empty_launch(void* stream) {
  k_empty<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// K13: out = the stable "running first" order of the n lanes, dealt
// round-robin over n_dev shards (n_dev 1: compact_lanes' order), in one
// cooperative launch of blocks blocks of ORDER_THREADS threads, each
// taking tiles tiles (parallel/mesh.lane_order_shape); buf holds the
// blocks' sums (blocks ints: the output allocation's tail). vec: status
// is 16-byte aligned (four 16-byte loads a thread).
MTT_EXPORT int lane_order(const void* status, long long n, int n_dev, int blocks, int tiles,
                          int vec, void* buf, void* out, void* stream) {
  if (n <= 0 || n_dev <= 0 || blocks <= 0 || tiles <= 0) return 0;
  const int32_t* s = (const int32_t*)status;
  int32_t* b = (int32_t*)buf;
  int32_t* o = (int32_t*)out;
  void* args[] = {(void*)&s, (void*)&n, (void*)&n_dev, (void*)&tiles, (void*)&vec,
                  (void*)&b, (void*)&o};
  cudaError_t rc = cudaLaunchCooperativeKernel((const void*)k_order, dim3(blocks),
                                               dim3(ORDER_THREADS), args, 0,
                                               (cudaStream_t)stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// blocks of K13 resident at once on the current device (the most its
// cooperative launch may take)
MTT_EXPORT int lane_order_blocks() {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k_order, ORDER_THREADS, 0);
  return sms * per;
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
