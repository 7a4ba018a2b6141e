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
//    block offsets by one scan block, as every ordered compaction of
//    the port), so no two lanes race for a slot and the order is JAX's
//    bit for bit at every n. The deal sends sorted position
//    q = s * n_dev + d to output position d * (n / n_dev) + s.
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
// 3.35 TB/s; its design aims at that: a block copies one plane's rows
// for 32 output lanes with the widest aligned word the row allows
// (16, 8, 4, 2 or 1 bytes, chosen by the wrapper from the row width
// and both base addresses), neighbouring threads on neighbouring words.
#include "common.cuh"

namespace {

constexpr int RUNNING = 0;
constexpr int LIVE_BLOCK = 256;
constexpr int MAX_PLANES = 32;
constexpr int GATHER_LANES = 32;
constexpr int GATHER_THREADS = 256;

// every plane's source and destination base, row bytes and copy width
struct Planes {
  const uint8_t* src[MAX_PLANES];
  uint8_t* dst[MAX_PLANES];
  long long row[MAX_PLANES];
  int vec[MAX_PLANES];
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

// K14: block (x, y) copies plane y's rows of output lanes
// [32x, 32x + 32) from the source lanes order names.
__global__ void __launch_bounds__(GATHER_THREADS)
k_lane_gather(Planes p, const int32_t* order, long long n_src, long long n_out) {
  __shared__ long long src_lane[GATHER_LANES];
  const int plane = blockIdx.y;
  const long long lane0 = (long long)blockIdx.x * GATHER_LANES;
  const long long left = n_out - lane0;
  const int lanes = left < GATHER_LANES ? (int)left : GATHER_LANES;
  if (threadIdx.x < lanes) {
    long long i = order[lane0 + threadIdx.x];
    if (i < 0) i += n_src;
    src_lane[threadIdx.x] = i < 0 ? 0 : (i >= n_src ? n_src - 1 : i);
  }
  __syncthreads();
  const long long row = p.row[plane];
  const int vec = p.vec[plane];
  const long long words = row / vec;
  const uint8_t* src = p.src[plane];
  uint8_t* dst = p.dst[plane] + lane0 * row;
  const long long total = lanes * words;
  for (long long k = threadIdx.x; k < total; k += GATHER_THREADS) {
    const long long l = k / words;
    const long long off = (k - l * words) * vec;
    const uint8_t* s = src + src_lane[l] * row + off;
    uint8_t* d = dst + l * row + off;
    switch (vec) {
      case 16: *(int4*)d = *(const int4*)s; break;
      case 8: *(int2*)d = *(const int2*)s; break;
      case 4: *(int*)d = *(const int*)s; break;
      case 2: *(short*)d = *(const short*)s; break;
      default: *d = *s; break;
    }
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

// K14: for each of n_planes planes, dst row j = src row order[j] (JAX's
// index rule), rows of row_bytes[k] bytes copied vec[k] bytes at a time.
MTT_EXPORT int lane_gather(void** src, void** dst, const long long* row_bytes,
                           const int* vec, int n_planes, const void* order,
                           long long n_src, long long n_out, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  Planes p;
  for (int k = 0; k < n_planes; ++k) {
    p.src[k] = (const uint8_t*)src[k];
    p.dst[k] = (uint8_t*)dst[k];
    p.row[k] = row_bytes[k];
    p.vec[k] = vec[k];
  }
  if (n_out > 0 && n_src > 0) {
    dim3 grid(nblocks_for(n_out, GATHER_LANES), n_planes);
    k_lane_gather<<<grid, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
        p, (const int32_t*)order, n_src, n_out);
  }
  return (int)cudaGetLastError();
}
