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
// K3 window_dedup replaces _dedup_canon (:689) and _canon_remap (:771):
// one pair of launches per step round, in global step order; each
// round hashes every lane's record of that step into a 4096-cell table
// where the lowest lane wins (atomicMin: order-free, so deterministic),
// then each lane compares itself with its cell's winner. Bound: bytes
// (each live record is read once for its hash and once for the
// compare), with one launch pair per step of the window.
//
// K4 window_epilogue replaces the hold/retire selection (:1196-1226),
// _resume_gather_core (:594), _retire_gather_core (:547), _counts_core
// (:670), _unique_table (:792) and _fork_table (:823); its gathers also
// serve _retire_rows (:580), _unique_table_big (:839) and
// _gather_full_flog (:855). Selections are ascending-index compactions
// (a prefix scan, the order of JAX's sort of where(sel, arange, n)).
// Bound: bytes (N x R canonical flags plus the gathered rows).
#include "common.cuh"

namespace {

constexpr int RUNNING = 0, NEEDS_HOST = 5, DEAD = 7;
constexpr int OP_SHA3 = 0x20, OP_SSTORE = 0x55, REC_SLOAD_RW = 0x154;
constexpr int DEDUP_H = 4096;
constexpr int CODE_COLS = 14;
constexpr int RESUME_MEM = 256, RESUME_MLOG = 8;
constexpr int I32_MIN = -2147483647 - 1, I32_MAX = 2147483647;
constexpr uint32_t HASH_MUL = 0x9E3779B1u;

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

__global__ void k_step_range(Sym s, int32_t* mm) {
  long long lane = gid();
  if (lane >= s.n) return;
  int cnt = min(s.dlog_count[lane], s.R);
  int lo = I32_MAX, hi = -1;
  for (int r = 0; r < cnt; ++r) {
    int st = s.dlog_step[lane * s.R + r];
    lo = min(lo, st);
    hi = max(hi, st);
  }
  if (cnt > 0) {
    atomicMin(mm, lo);
    atomicMax(mm + 1, hi);
  }
}

struct Round {
  int32_t *tab, *tab_next, *slot, *bucket, *rsid;
};

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t f) { return h * HASH_MUL + f; }

__global__ void k_dedup_a(Sym s, int step, const int32_t* canon, Round rd, int write) {
  long long lane = gid();
  if (lane >= s.n) return;
  const int R = s.R;
  int cnt = s.dlog_count[lane];
  int slot = -1;
  for (int r = 0; r < R; ++r) {
    if (r < cnt && s.dlog_step[lane * R + r] == step) {
      slot = r;
      break;
    }
  }
  rd.slot[lane] = slot;
  if (slot < 0) {
    rd.bucket[lane] = DEDUP_H;
    return;
  }
  size_t rp = (size_t)lane * R + slot;
  int sids[3];
  for (int j = 0; j < 3; ++j) {
    sids[j] = lookup(canon, s.dlog_sid[rp * 3 + j], s.n, R);
    rd.rsid[lane * 3 + j] = sids[j];
    if (write) s.dlog_sid[rp * 3 + j] = sids[j];
  }
  int op = s.dlog_op[rp];
  uint32_t h = 0;
  h = mix(h, (uint32_t)s.group[lane]);
  h = mix(h, (uint32_t)op);
  h = mix(h, (uint32_t)s.dlog_pc[rp]);
  h = mix(h, (uint32_t)s.dlog_fentry[rp]);
  for (int j = 0; j < 3; ++j) h = mix(h, (uint32_t)sids[j]);
  for (int c = 0; c < 24; ++c) h = mix(h, s.dlog_val[rp * 24 + c]);
  bool cand = op != OP_SSTORE && op != REC_SLOAD_RW;
  int bucket = cand ? (int)(h % DEDUP_H) : DEDUP_H;
  rd.bucket[lane] = bucket;
  if (cand) atomicMin(rd.tab + bucket, (int)lane);
}

__global__ void k_dedup_b(Sym s, int32_t* canon, Round rd) {
  long long g = gid();
  long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long i = g; i < DEDUP_H; i += nthreads) rd.tab_next[i] = I32_MAX;
  if (g >= s.n) return;
  const int R = s.R;
  int lane = (int)g;
  int slot = rd.slot[lane];
  if (slot < 0) return;
  int bucket = rd.bucket[lane];
  bool cand = bucket < DEDUP_H;
  int w = clampi(rd.tab[clampi(bucket, 0, DEDUP_H - 1)], 0, s.n - 1);
  int ws = rd.slot[w];
  bool eq = false;
  if (cand && ws >= 0) {
    size_t a = (size_t)lane * R + slot, b = (size_t)w * R + ws;
    eq = s.dlog_op[a] == s.dlog_op[b] && s.dlog_pc[a] == s.dlog_pc[b] &&
         s.dlog_fentry[a] == s.dlog_fentry[b] && s.group[lane] == s.group[w];
    for (int j = 0; j < 3 && eq; ++j) eq = rd.rsid[lane * 3 + j] == rd.rsid[w * 3 + j];
    for (int c = 0; c < 24 && eq; ++c) eq = s.dlog_val[a * 24 + c] == s.dlog_val[b * 24 + c];
  }
  int cl = eq ? w : lane, cs = eq ? ws : slot;
  canon[(size_t)lane * R + slot] = -(cl * R + cs + 1);
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

__global__ void k_fork_gather(Sym s, int fb, int32_t* tab) {
  long long r = gid();
  if (r >= fb) return;
  int32_t* t = tab + r * 9;
  t[0] = s.flog_parent[r];
  t[1] = s.flog_child[r];
  t[2] = s.flog_step[r];
  t[3] = s.flog_pc[r];
  t[4] = s.flog_sid[r];
  t[5] = (int32_t)s.flog_gmin[r];
  t[6] = (int32_t)s.flog_gmax[r];
  t[7] = s.flog_fentry[r];
  t[8] = s.flog_dest[r];
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

// K3. canon: n*R ints (out); scratch: 2*H + 5*n + 2 ints. Reads the
// window's step range back (one synchronisation) to size the rounds.
MTT_EXPORT int window_dedup(void** planes, const int* dims, void* canon, void* scratch,
                            int write_sids, void* stream) {
  Sym s = make_sym(planes, dims);
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* cp = (int32_t*)canon;
  int32_t* sc = (int32_t*)scratch;
  long long nr = (long long)s.n * s.R;
  if (s.n == 0) return (int)cudaGetLastError();
  int32_t* tabs = sc;
  int32_t* slot = tabs + 2 * DEDUP_H;
  int32_t* bucket = slot + s.n;
  int32_t* rsid = bucket + s.n;
  int32_t* mm = rsid + 3 * s.n;
  fill_i32<<<nblocks_for(nr, 256), 256, 0, st>>>(cp, nr, 0);
  fill_i32<<<nblocks_for(2 * DEDUP_H, 256), 256, 0, st>>>(tabs, 2 * DEDUP_H, I32_MAX);
  fill_i32<<<1, 1, 0, st>>>(mm, 1, I32_MAX);
  fill_i32<<<1, 1, 0, st>>>(mm + 1, 1, -1);
  k_step_range<<<nblocks_for(s.n, 256), 256, 0, st>>>(s, mm);
  int range[2];
  cudaMemcpyAsync(range, mm, sizeof(range), cudaMemcpyDeviceToHost, st);
  cudaError_t err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return (int)err;
  int p = 0;
  unsigned gb = nblocks_for(max(s.n, DEDUP_H), 256);
  for (int step = range[0]; step <= range[1]; ++step) {
    Round rd{tabs + p * DEDUP_H, tabs + (1 - p) * DEDUP_H, slot, bucket, rsid};
    k_dedup_a<<<nblocks_for(s.n, 256), 256, 0, st>>>(s, step, cp, rd, write_sids);
    k_dedup_b<<<gb, 256, 0, st>>>(s, cp, rd);
    p = 1 - p;
  }
  if (write_sids) {
    remap_plane(s.ssid, (long long)s.n * s.D, cp, s.n, s.R, st);
    remap_plane(s.sval_sid, (long long)s.n * s.S, cp, s.n, s.R, st);
    remap_plane(s.skey_sid, (long long)s.n * s.S, cp, s.n, s.R, st);
    remap_plane(s.mlog_sid, (long long)s.n * s.MR, cp, s.n, s.R, st);
    remap_plane(s.flog_sid, s.F, cp, s.n, s.R, st);
  }
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
  if (fb > 0) k_fork_gather<<<nblocks_for(fb, 256), 256, 0, st>>>(s, fb, (int32_t*)ftab);
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

// the first fb fork-table rows (fb = F: _gather_full_flog)
MTT_EXPORT int fork_table(void** planes, const int* dims, int fb, void* tab, void* stream) {
  Sym s = make_sym(planes, dims);
  if (fb > 0)
    k_fork_gather<<<nblocks_for(fb, 256), 256, 0, (cudaStream_t)stream>>>(s, fb, (int32_t*)tab);
  return (int)cudaGetLastError();
}
