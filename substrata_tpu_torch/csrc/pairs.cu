// Kernel KS: the broadphase pair finder (K2).
//
// Replaces substrata_tpu/physics/broadphase.py:find_pairs (:115) and the
// margins of _pairs_rebuild (:364); plain twin:
// substrata_tpu_torch/kernels/pairs.py:find_pairs_plain.  It reads KP's
// flagged cell table (csrc/cell_table.cu) and hashes with KP's own device
// function (sbt::cell_hash).
//
// Launches, in order:
// 1. margins (one block): each body's speed (the reference's norm: fma
//    chain, correctly rounded sqrt) and their max, the reuse window and
//    the per-body margins 0.08 + speed * window * dt (contracted as the
//    reference's jit contracts it), or the constant margin; the first
//    MAX_OVERSIZE oversize bodies in index order.
// 2. candidates (one thread per body): the 14-bucket half stencil of the
//    cell table, the filters, the tight test, the proximity top-ppb kept
//    by insertion (a later column passes an earlier one only with a
//    strictly higher score: the stable descending sort's order), the dedup
//    of the kept slots and the row overflow.
// 3-4. compaction: the rows are the ppb * N selected slots, slot-major,
//    then MAX_OVERSIZE * N oversize rows (recomputed where read); a tile
//    count, then each tile sums the tiles before it and scans its rows, so
//    the first max_pairs masked rows keep their places; each kept key
//    counts into its body a's histogram.
// 5. one block: the exclusive scan of the histogram.
// 6-7. placement of each kept key into its a-segment (atomic cursor), then
//    each key's rank in its segment by b (and by place among equal keys,
//    which are identical): the sorted buffer, bit for bit, at any size.
// 8. dedup: pair_a / pair_b (-1 on invalid rows), pair_valid, num_pairs,
//    the overflow (cell table + rows + oversize + pairs) and steps_left.
//
// What bounds it: latency and the gathers of launch 2 (84 flagged table
// entries and as many 12-byte positions per body at the bench shapes);
// the oversize rows are recomputed arithmetic, no memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kTile = 1024;
constexpr int kMaxOversize = 64;
constexpr int kMaxPpb = 16;
constexpr int kIdxMask = 0xFFFF;
constexpr int kTblMoving = 1 << 16, kTblStatic = 1 << 17, kTblSmall = 1 << 18;
constexpr int kStatic = 0;
constexpr int kBox = 1, kHull = 3;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

// ctrl[] slots.
enum Ctrl {
  kWindow = 0,      // reuse window (rebuild mode)
  kOsCount,         // oversize bodies found (all of them)
  kRowOver,         // tight candidates dropped by the top-ppb
  kPairOver,        // tight rows past max_pairs
  kTotal,           // masked rows
  kCtrlSlots
};

struct Bodies {
  const float* pos;
  const float* linvel;
  const bool* alive;
  const bool* awake;
  const bool* collidable;
  const int* motion;
  const float* bound_radius;
  const int* shape_type;
  const float* shape_params;
  int sp_stride;
  int n;
};

__device__ __forceinline__ bool collidable_of(const Bodies& b, int i) {
  return b.alive[i] && b.collidable[i];
}
__device__ __forceinline__ bool moving_of(const Bodies& b, int i) {
  return b.awake[i] && b.motion[i] != kStatic;
}
__device__ __forceinline__ bool static_of(const Bodies& b, int i) {
  return b.motion[i] == kStatic;
}
__device__ __forceinline__ bool oversize_of(const Bodies& b, int i, float cell_size) {
  return b.alive[i] && (2.0f * b.bound_radius[i] > cell_size);
}
__device__ __forceinline__ float infl_of(const Bodies& b, const float* margin, int i) {
  return b.bound_radius[i] + 0.5f * margin[i];
}
__device__ __forceinline__ float inner_of(const Bodies& b, int i) {
  const float* sp = b.shape_params + static_cast<size_t>(i) * b.sp_stride;
  const int st = b.shape_type[i];
  if (st == kBox) return fminf(fminf(sp[0], sp[1]), sp[2]);
  if (st == kHull) return 0.5f * b.bound_radius[i];
  return sp[0];
}
__device__ __forceinline__ float dist2(const float* pos, int i, int j) {
  const float d0 = pos[i * 3] - pos[j * 3], d1 = pos[i * 3 + 1] - pos[j * 3 + 1],
              d2 = pos[i * 3 + 2] - pos[j * 3 + 2];
  return (d0 * d0 + d1 * d1) + d2 * d2;
}

// ---------------------------------------------------------------------------
// 1. margins and the oversize list
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
pairs_margins_kernel(Bodies b, int rebuild, float const_margin, float dt, float margin_cap,
                     int interval, float cell_size, float* __restrict__ margin,
                     int* __restrict__ os_idx, int* __restrict__ ctrl) {
  __shared__ int warp_i[32];
  __shared__ float warp_f[32];
  __shared__ float s_wf;
  const int n = b.n;
  float vmax = 0.0f;
  int any_nan = 0;
  if (rebuild) {
    for (int i = threadIdx.x; i < n; i += kScanThreads) {
      const float* v = b.linvel + i * 3;
      // fma(v2, v2, fma(v1, v1, v0 v0)), then sqrt: jnp.linalg.norm as
      // XLA computes it on the CPU.
      float s = sqrtf(__fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], v[0] * v[0])));
      s = (b.alive[i] && b.awake[i]) ? s : 0.0f;
      margin[i] = s;                           // the speed, until the window is known
      if (s != s) any_nan = 1;
      else vmax = fmaxf(vmax, s);
    }
    // Block max (speeds are >= 0, so 0 is the identity).
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
      any_nan |= __shfl_xor_sync(0xffffffffu, any_nan, o);
    }
    if ((threadIdx.x & 31) == 0) {
      warp_f[threadIdx.x >> 5] = vmax;
      warp_i[threadIdx.x >> 5] = any_nan;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = 0.0f;
      bool nan = false;
      for (int w = 0; w < kScanThreads / 32; ++w) {
        m = fmaxf(m, warp_f[w]);
        nan = nan || warp_i[w];
      }
      if (nan) m = __int_as_float(0x7fc00000);
      float d = m * dt;
      d = d < 1e-6f ? 1e-6f : d;
      float w = floorf(margin_cap / d);
      w = w < 1.0f ? 1.0f : (w > static_cast<float>(interval) ? static_cast<float>(interval) : w);
      const int wi = static_cast<int>(w);
      ctrl[kWindow] = wi;
      s_wf = static_cast<float>(wi);
    }
    __syncthreads();
    const float wf = s_wf;
    for (int i = threadIdx.x; i < n; i += kScanThreads)
      margin[i] = __fmaf_rn(margin[i] * wf, dt, 0.08f);
  } else {
    for (int i = threadIdx.x; i < n; i += kScanThreads) margin[i] = const_margin;
  }
  // The oversize bodies, in index order, the first kMaxOversize listed.
  int base = 0;
  for (int start = 0; start < n; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int f = (i < n && oversize_of(b, i, cell_size)) ? 1 : 0;
    int total;
    const int before = sbt::block_exclusive_scan(f, warp_i, &total);
    if (f && base + before < kMaxOversize) os_idx[base + before] = i;
    base += total;
  }
  if (threadIdx.x == 0) ctrl[kOsCount] = base;
}

// ---------------------------------------------------------------------------
// 2. candidates
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pairs_candidates_kernel(Bodies b, const float* __restrict__ margin, const int* __restrict__ table,
                        const int* __restrict__ cells, int nb, int cap, int ppb, float cell_size,
                        uint32_t* __restrict__ sel_key, uint8_t* __restrict__ sel_bits,
                        int* __restrict__ ctrl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.n) return;
  const int n = b.n;
  const bool coll_i = collidable_of(b, i), mov_i = moving_of(b, i), stat_i = static_of(b, i);
  const bool small_i = 2.0f * b.bound_radius[i] <= cell_size;
  const float infl_i = infl_of(b, margin, i), inner_i = inner_of(b, i);
  float sc[kMaxPpb];
  int sj[kMaxPpb];
  uint8_t sm[kMaxPpb];      // bit 0 mask, bit 1 tight
  int filled = 0, n_tight = 0;
  const int c0 = cells[i * 3], c1 = cells[i * 3 + 1], c2 = cells[i * 3 + 2];
  for (int o = 13; o < 27; ++o) {
    const int hb = sbt::cell_hash(c0 + (o % 3 - 1), c1 + ((o / 3) % 3 - 1), c2 + (o / 9 - 1), nb);
    const bool own = o == 13;
    for (int c = 0; c < cap; ++c) {
      const int e = table[hb * cap + c];
      const int jj = e >= 0 ? (e & kIdxMask) : -1;
      const int js = max(jj, 0);
      bool mask = own ? jj > i : (jj >= 0 && jj != i);
      mask = mask && coll_i;
      mask = mask && (mov_i || (e & kTblMoving) != 0);
      mask = mask && !(stat_i && (e & kTblStatic) != 0);
      mask = mask && (small_i && (e & kTblSmall) != 0);
      const float d2 = dist2(b.pos, i, js);
      const float r = infl_i + infl_of(b, margin, js);
      const float rr = r * r;
      mask = mask && d2 <= rr;
      const float rt = inner_i + inner_of(b, js);
      const bool tight = mask && d2 <= rt * rt;
      n_tight += tight;
      const float score = mask ? rr - d2 : -1e9f;
      // Insertion after every kept entry with a score >= this one.
      int at = filled;
      while (at > 0 && sc[at - 1] < score) --at;
      if (at < ppb) {
        const int last = filled < ppb ? filled : ppb - 1;
        for (int k = last; k > at; --k) {
          sc[k] = sc[k - 1];
          sj[k] = sj[k - 1];
          sm[k] = sm[k - 1];
        }
        sc[at] = score;
        sj[at] = js;
        sm[at] = static_cast<uint8_t>(mask | (tight << 1));
        if (filled < ppb) ++filled;
      }
    }
  }
  // Hash collisions can bring one neighbour in twice: dedup the selection
  // in slot order against the earlier slots still kept.
  int sel_tight = 0;
  for (int k = 0; k < ppb; ++k) {
    bool m = sm[k] & 1;
    for (int q = 0; q < k && m; ++q)
      if ((sm[q] & 1) && sj[q] == sj[k]) m = false;
    sm[k] = static_cast<uint8_t>(m ? sm[k] : (sm[k] & 2));
    const bool t = m && (sm[k] & 2);
    sel_tight += t;
    const int a = min(i, sj[k]), bb = max(i, sj[k]);
    sel_key[static_cast<size_t>(k) * n + i] =
        (static_cast<uint32_t>(a) << 16) | static_cast<uint32_t>(bb);
    sel_bits[static_cast<size_t>(k) * n + i] = static_cast<uint8_t>(m | (t << 1));
  }
  const int over = n_tight - sel_tight;
  if (over > 0) atomicAdd(&ctrl[kRowOver], over);
}

// ---------------------------------------------------------------------------
// 3-4. compaction
// ---------------------------------------------------------------------------

struct RowArgs {
  Bodies b;
  const float* margin;
  const uint32_t* sel_key;
  const uint8_t* sel_bits;
  const int* os_idx;
  const int* ctrl;
  int n_sel;            // ppb * N
  int n_rows;           // n_sel + (has_oversize ? kMaxOversize * N : 0)
  float cell_size;
};

// Row r: its mask, tight flag and key.
__device__ __forceinline__ void row_of(const RowArgs& ra, int r, bool& mask, bool& tight,
                                       uint32_t& key) {
  mask = tight = false;
  key = kEmpty;
  if (r >= ra.n_rows) return;
  if (r < ra.n_sel) {
    const uint8_t bits = ra.sel_bits[r];
    mask = bits & 1;
    tight = (bits & 2) != 0;
    key = ra.sel_key[r];
    return;
  }
  const int n = ra.b.n;
  const int q = r - ra.n_sel;
  const int orow = q / n, j = q - orow * n;
  if (orow >= min(ra.ctrl[kOsCount], kMaxOversize)) return;
  const int oi = ra.os_idx[orow];
  const Bodies& b = ra.b;
  bool ok = collidable_of(b, oi) && collidable_of(b, j) && j != oi;
  ok = ok && (moving_of(b, oi) || moving_of(b, j));
  ok = ok && !(static_of(b, oi) && static_of(b, j));
  const float rr = infl_of(b, ra.margin, oi) + infl_of(b, ra.margin, j);
  ok = ok && dist2(b.pos, oi, j) <= rr * rr;
  ok = ok && !(oversize_of(b, j, ra.cell_size) && j < oi);
  mask = tight = ok;
  key = (static_cast<uint32_t>(min(oi, j)) << 16) | static_cast<uint32_t>(max(oi, j));
}

__global__ void __launch_bounds__(kThreads)
pairs_count_kernel(RowArgs ra, int* __restrict__ tile_cnt) {
  __shared__ int warp_tot[32];
  int cnt = 0;
  const int base = blockIdx.x * kTile;
  for (int r = base + threadIdx.x; r < min(base + kTile, ra.n_rows); r += kThreads) {
    bool m, t;
    uint32_t k;
    row_of(ra, r, m, t, k);
    cnt += m;
  }
  cnt = sbt::block_sum(cnt, warp_tot);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = cnt;
}

__global__ void __launch_bounds__(kThreads)
pairs_write_kernel(RowArgs ra, const int* __restrict__ tile_cnt, int n_tiles, int max_pairs,
                   uint32_t* __restrict__ buf, int* __restrict__ hist, int* __restrict__ ctrl) {
  __shared__ int warp_tot[32];
  int before_tiles = 0, all = 0;
  for (int k = threadIdx.x; k < n_tiles; k += kThreads) {
    const int v = tile_cnt[k];
    all += v;
    if (k < blockIdx.x) before_tiles += v;
  }
  before_tiles = sbt::block_sum(before_tiles, warp_tot);
  all = sbt::block_sum(all, warp_tot);
  constexpr int kPer = kTile / kThreads;
  const int base = blockIdx.x * kTile + threadIdx.x * kPer;
  bool m[kPer], t[kPer];
  uint32_t key[kPer];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    row_of(ra, base + k, m[k], t[k], key[k]);
    mine += m[k];
  }
  int tot;
  int at = before_tiles + sbt::block_exclusive_scan(mine, warp_tot, &tot);
  int lost = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!m[k]) continue;
    const int dst = at++;
    if (dst < max_pairs) {
      buf[dst] = key[k];
      atomicAdd(&hist[key[k] >> 16], 1);
    } else if (t[k]) {
      ++lost;
    }
  }
  lost = sbt::block_sum(lost, warp_tot);
  if (threadIdx.x == 0) {
    if (lost) atomicAdd(&ctrl[kPairOver], lost);
    if (blockIdx.x == 0) ctrl[kTotal] = all;
  }
}

// ---------------------------------------------------------------------------
// 5-8. sort by (a, b) and dedup
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
pairs_scan_kernel(const int* __restrict__ hist, int n, int* __restrict__ offs,
                  int* __restrict__ cursor) {
  __shared__ int warp_tot[32];
  int base = 0;
  for (int start = 0; start < n; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int v = i < n ? hist[i] : 0;
    int total;
    const int before = sbt::block_exclusive_scan(v, warp_tot, &total);
    if (i < n) {
      offs[i] = base + before;
      cursor[i] = base + before;
    }
    base += total;
  }
}

__global__ void pairs_place_kernel(const uint32_t* __restrict__ buf, const int* __restrict__ ctrl,
                                   int max_pairs, int* __restrict__ cursor,
                                   uint32_t* __restrict__ tmp) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= min(ctrl[kTotal], max_pairs)) return;
  const uint32_t key = buf[k];
  tmp[atomicAdd(&cursor[key >> 16], 1)] = key;
}

__global__ void pairs_rank_kernel(const uint32_t* __restrict__ tmp, const int* __restrict__ ctrl,
                                  int max_pairs, const int* __restrict__ offs,
                                  const int* __restrict__ hist, uint32_t* __restrict__ sorted) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= min(ctrl[kTotal], max_pairs)) return;
  const uint32_t key = tmp[p];
  const int a = key >> 16;
  const int s = offs[a], e = s + hist[a];
  int rank = 0;
  for (int q = s; q < e; ++q) {
    const uint32_t o = tmp[q];
    rank += (o < key) || (o == key && q < p);
  }
  sorted[s + rank] = key;
}

__global__ void pairs_final_kernel(const uint32_t* __restrict__ sorted,
                                   const int* __restrict__ ctrl,
                                   int max_pairs, int rebuild, int has_oversize,
                                   const int* __restrict__ cell_over, int* __restrict__ pa,
                                   int* __restrict__ pb, bool* __restrict__ pv,
                                   int* __restrict__ num_pairs, int* __restrict__ overflow,
                                   int* __restrict__ steps_left) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int kept = min(ctrl[kTotal], max_pairs);
  if (i < max_pairs) {
    const uint32_t key = i < kept ? sorted[i] : kEmpty;
    const bool dup = i > 0 && i - 1 < kept && sorted[i - 1] == key;
    const bool valid = key != kEmpty && !dup;
    pa[i] = valid ? static_cast<int>(key >> 16) : -1;
    pb[i] = valid ? static_cast<int>(key & 0xFFFFu) : -1;
    pv[i] = valid;
  }
  if (i == 0) {
    const int os = ctrl[kOsCount];
    const int os_over = has_oversize ? os - min(os, kMaxOversize) : os;
    *num_pairs = ctrl[kTotal];
    *overflow = *cell_over + ctrl[kRowOver] + os_over + ctrl[kPairOver];
    if (rebuild) *steps_left = ctrl[kWindow] - 1;
  }
}

}  // namespace

// Bodies: pos, linvel, alive, awake, collidable, motion, bound_radius,
// shape_type, shape_params (row stride sp_stride), N.  Cell table: table,
// cells, cell overflow (KP's outputs).  margin_in: rebuild (margins from
// speeds, dt, margin_cap, interval) or the constant const_margin.
// scratch_i: int32 scratch of pairs_scratch_ints(N, ppb, max_pairs,
// has_oversize) ints (kernels/pairs.py).
extern "C" int find_pairs(const float* pos, const float* linvel, const bool* alive,
                          const bool* awake, const bool* collidable, const int* motion,
                          const float* bound_radius, const int* shape_type,
                          const float* shape_params, int sp_stride, int n, const int* table,
                          const int* cells, const int* cell_over, int nb, int cap, int ppb,
                          int max_pairs, int has_oversize, int rebuild, float const_margin,
                          float dt, float margin_cap, int interval, float cell_size,
                          float* margin, int* scratch_i, int* pa, int* pb, bool* pv,
                          int* num_pairs, int* overflow, int* steps_left, void* stream) {
  if (ppb > kMaxPpb || ppb < 1 || n > 65536) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Bodies b{pos, linvel, alive, awake, collidable, motion, bound_radius, shape_type,
           shape_params, sp_stride, n};
  const int n_sel = ppb * n;
  const int n_rows = n_sel + (has_oversize ? kMaxOversize * n : 0);
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  // Scratch layout (ints): ctrl, os_idx, hist[n], offs[n], cursor[n],
  // tile_cnt, sel_key, buf, tmp, sorted (uint32), sel_bits (bytes).
  int* ctrl = scratch_i;
  int* os_idx = ctrl + kCtrlSlots;
  int* hist = os_idx + kMaxOversize;
  int* offs = hist + n;
  int* cursor = offs + n;
  int* tile_cnt = cursor + n;
  uint32_t* sel_key = reinterpret_cast<uint32_t*>(tile_cnt + n_tiles);
  uint32_t* buf = sel_key + n_sel;
  uint32_t* tmp = buf + max_pairs;
  uint32_t* sorted = tmp + max_pairs;
  uint8_t* sel_bits = reinterpret_cast<uint8_t*>(sorted + max_pairs);

  cudaError_t err = cudaMemsetAsync(ctrl, 0, kCtrlSlots * sizeof(int), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(hist, 0, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_margins_kernel<<<1, kScanThreads, 0, s>>>(b, rebuild, const_margin, dt, margin_cap,
                                                  interval, cell_size, margin, os_idx, ctrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_candidates_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      b, margin, table, cells, nb, cap, ppb, cell_size, sel_key, sel_bits, ctrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  RowArgs ra{b, margin, sel_key, sel_bits, os_idx, ctrl, n_sel, n_rows, cell_size};
  pairs_count_kernel<<<n_tiles, kThreads, 0, s>>>(ra, tile_cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_write_kernel<<<n_tiles, kThreads, 0, s>>>(ra, tile_cnt, n_tiles, max_pairs, buf, hist,
                                                  ctrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_scan_kernel<<<1, kScanThreads, 0, s>>>(hist, n, offs, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int mp_blocks = (max_pairs + kThreads - 1) / kThreads;
  pairs_place_kernel<<<mp_blocks, kThreads, 0, s>>>(buf, ctrl, max_pairs, cursor, tmp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_rank_kernel<<<mp_blocks, kThreads, 0, s>>>(tmp, ctrl, max_pairs, offs, hist, sorted);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_final_kernel<<<mp_blocks, kThreads, 0, s>>>(sorted, ctrl, max_pairs, rebuild, has_oversize,
                                              cell_over, pa, pb, pv, num_pairs, overflow,
                                              steps_left);
  return static_cast<int>(cudaGetLastError());
}
