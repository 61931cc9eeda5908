// Kernel KT: the compacted contact layout's chain — combo grouping (K3),
// contact compaction and the incidence table (K5).
//
// Replaces substrata_tpu/physics/narrowphase.py:pair_contacts :666-720
// (the argsort grouping) and :792-796 (the touching scatter),
// narrowphase.py:compact_contacts :1054 and solver.py:build_incidence :96;
// plain twins: substrata_tpu_torch/kernels/layout.py:*_plain.
//
// Grouping, one block of 1024 threads: a stable counting sort of the pair
// list by combo code (16 codes, 16 for an invalid pair).  Thread t owns a
// contiguous run of pairs and counts its codes into column t of a [17,
// 1024] shared table; one exclusive scan of that table in code-major order
// gives every (code, thread) its first place in the sorted order, so a
// second walk places each pair where torch.argsort(stable=True) puts it.
// The same block then writes each active code's slice [min(start, P - cap),
// + cap) of the sorted order (src = -1 outside the code's run, as the
// reference masks a slice that spans a neighbour's run) with its bodies and
// occupancy, each pair's slot in the concatenated buckets, and the bucket
// overflow.  Touching: one thread per pair gathers its slot's flag from the
// bucket kernels' outputs (KA/KK/KO), so no scatter needs a cleared buffer.
//
// Compaction, two launches over tiles of 1024 rows: count the touching and
// the speculative rows of each tile; then each tile sums the counts of the
// tiles before it and scans its own rows, so touching rows land first and
// speculative rows after them, each class in row order, into
// max_active_contacts rows; the rows past the valid ones get the twin's
// fills.  Incidence: each (entry, side) key appends itself to its body's
// list (atomicAdd, any order); one thread per body then picks the cpb
// lowest keys of its list (ascending (entry, side), the twin's sorted
// order, which decides the order of the sums in KC and KU).  A body whose
// list overflowed its 64 slots scans all keys in order instead, so the kept
// set is always the cpb lowest.
//
// What bounds it: latency.  At the serving world's shapes (16,384 pairs,
// ~100k contact rows, 36,864 compacted rows) each pass moves a few MB; the
// grouping is one block, the rest are single passes with one atomic per
// key.
#include "common.cuh"

namespace {

constexpr int kCodes = 16;
constexpr int kSortKeys = kCodes + 1;       // code 16: invalid pairs
constexpr int kGroupThreads = 1024;
constexpr int kTile = 1024;                 // compaction rows per block
constexpr int kTileThreads = 256;
constexpr int kIncList = 64;                // per-body key slots before the slow path
constexpr int kMaxBuckets = 16;

__device__ __forceinline__ bool same_type(int code) {
  return code == 0 || code == 5 || code == 10 || code == 15;
}

// narrowphase.py: max_pairs for the same-type codes, max(64, max_pairs / 4)
// for the others, never more than the pair list.
__device__ __forceinline__ int bucket_cap(int code, int max_pairs, int p) {
  const int cap = same_type(code) ? max_pairs : max(64, max_pairs / 4);
  return min(cap, p);
}

__device__ __forceinline__ int pair_code(const int* pa, const int* pb, const bool* pv,
                                         const int* shape_type, int i) {
  if (!pv[i]) return kCodes;
  const int a = max(pa[i], 0), b = max(pb[i], 0);
  return min(max(shape_type[a] * 4 + shape_type[b], 0), kCodes - 1);
}

__global__ void __launch_bounds__(kGroupThreads)
layout_group_kernel(const int* __restrict__ pa, const int* __restrict__ pb,
                    const bool* __restrict__ pv,
                    const int* __restrict__ shape_type, int p, int max_pairs, int active_mask,
                    int* __restrict__ order, int* __restrict__ src, int* __restrict__ ba,
                    int* __restrict__ bb, bool* __restrict__ bvalid, int* __restrict__ slot_of_pair,
                    int* __restrict__ overflow) {
  extern __shared__ int cnt[];              // [kSortKeys][kGroupThreads]
  __shared__ int warp_tot[32];
  __shared__ int starts[kSortKeys + 1];
  __shared__ int slice_start[kCodes], slice_off[kCodes + 1];
  const int t = threadIdx.x;
  const int seg = (p + kGroupThreads - 1) / kGroupThreads;
  const int lo = min(t * seg, p), hi = min(lo + seg, p);
  for (int c = 0; c < kSortKeys; ++c) cnt[c * kGroupThreads + t] = 0;
  for (int i = lo; i < hi; ++i) ++cnt[pair_code(pa, pb, pv, shape_type, i) * kGroupThreads + t];
  __syncthreads();
  // Exclusive scan of the flattened [code][thread] table: thread t takes
  // the kSortKeys consecutive cells [t * kSortKeys, + kSortKeys).
  int local[kSortKeys];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kSortKeys; ++k) {
    local[k] = cnt[t * kSortKeys + k];
    sum += local[k];
  }
  int total;
  int run = sbt::block_exclusive_scan(sum, warp_tot, &total);
#pragma unroll
  for (int k = 0; k < kSortKeys; ++k) {
    cnt[t * kSortKeys + k] = run;
    run += local[k];
  }
  __syncthreads();
  if (t < kSortKeys) starts[t] = cnt[t * kGroupThreads];
  if (t == 0) {
    starts[kSortKeys] = p;
    int off = 0, over = 0;
    for (int c = 0; c < kCodes; ++c) {
      slice_off[c] = off;
      const int n_run = cnt[(c + 1) * kGroupThreads] - cnt[c * kGroupThreads];
      if ((active_mask >> c) & 1) {
        const int cap = bucket_cap(c, max_pairs, p);
        slice_start[c] = min(cnt[c * kGroupThreads], p - cap);
        off += cap;
        over += max(n_run - cap, 0);
      } else {
        over += n_run;
      }
    }
    slice_off[kCodes] = off;
    *overflow = over;
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const int c = pair_code(pa, pb, pv, shape_type, i);
    const int dst = cnt[c * kGroupThreads + t]++;
    order[dst] = i;
    int slot = -1;
    if (c < kCodes && ((active_mask >> c) & 1)) {
      const int j = dst - slice_start[c];
      if (j < bucket_cap(c, max_pairs, p)) slot = slice_off[c] + j;
    }
    slot_of_pair[i] = slot;
  }
  __syncthreads();
  for (int c = 0; c < kCodes; ++c) {
    if (!((active_mask >> c) & 1)) continue;
    const int cap = bucket_cap(c, max_pairs, p);
    for (int j = t; j < cap; j += kGroupThreads) {
      const int idx = slice_start[c] + j;
      const int s = (idx >= starts[c] && idx < starts[c + 1]) ? order[idx] : -1;
      const int ss = max(s, 0);
      const int o = slice_off[c] + j;
      src[o] = s;
      ba[o] = max(pa[ss], 0);
      bb[o] = max(pb[ss], 0);
      bvalid[o] = s >= 0;
    }
  }
}

struct TouchRows {
  const bool* rows[kMaxBuckets];
  int off[kMaxBuckets + 1];
  int n;
};

__global__ void layout_touching_kernel(const int* __restrict__ slot_of_pair, TouchRows tr, int p,
                                       bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int s = slot_of_pair[i];
  bool touch = false;
  if (s >= 0) {
    for (int k = 0; k < tr.n; ++k)
      if (s < tr.off[k + 1]) {
        touch = tr.rows[k][s - tr.off[k]];
        break;
      }
  }
  out[i] = touch;
}

// ---------------------------------------------------------------------------
// Compaction
// ---------------------------------------------------------------------------

__device__ __forceinline__ void row_class(const bool* valid, const float* pen, int r, int c,
                                          int& touch, int& spec) {
  const bool v = r < c && valid[r];
  touch = v && pen[r] > 0.0f;
  spec = v && !touch;
}

__global__ void __launch_bounds__(kTileThreads)
layout_compact_count_kernel(const bool* __restrict__ valid, const float* __restrict__ pen, int c,
                            int2* __restrict__ tile_cnt) {
  __shared__ int warp_tot[32];
  int nt = 0, ns = 0;
  const int base = blockIdx.x * kTile;
  for (int r = base + threadIdx.x; r < min(base + kTile, c); r += kTileThreads) {
    int t, s;
    row_class(valid, pen, r, c, t, s);
    nt += t;
    ns += s;
  }
  nt = sbt::block_sum(nt, warp_tot);
  ns = sbt::block_sum(ns, warp_tot);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = make_int2(nt, ns);
}

__global__ void __launch_bounds__(kTileThreads)
layout_compact_write_kernel(const int* __restrict__ a, const int* __restrict__ b,
                            const float* __restrict__ point, const float* __restrict__ normal,
                            const float* __restrict__ pen, const bool* __restrict__ valid,
                            const float* __restrict__ fric, const float* __restrict__ rest,
                            const int* __restrict__ key, int c, int m,
                            const int2* __restrict__ tile_cnt,
                            int n_tiles, int* __restrict__ o_a, int* __restrict__ o_b,
                            float* __restrict__ o_point, float* __restrict__ o_normal,
                            float* __restrict__ o_pen, bool* __restrict__ o_valid,
                            float* __restrict__ o_fric, float* __restrict__ o_rest,
                            int* __restrict__ o_key, int* __restrict__ overflow) {
  __shared__ int warp_tot[32];
  __shared__ long long warp_tot64[32];
  // Rows of the tiles before this one, and of all tiles.
  int bt = 0, bs = 0, at = 0, as = 0;
  for (int k = threadIdx.x; k < n_tiles; k += kTileThreads) {
    const int2 v = tile_cnt[k];
    at += v.x;
    as += v.y;
    if (k < blockIdx.x) {
      bt += v.x;
      bs += v.y;
    }
  }
  bt = sbt::block_sum(bt, warp_tot);
  bs = sbt::block_sum(bs, warp_tot);
  const int n_touch = sbt::block_sum(at, warp_tot);
  const int n_valid = n_touch + sbt::block_sum(as, warp_tot);
  constexpr int kPer = kTile / kTileThreads;
  const int base = blockIdx.x * kTile + threadIdx.x * kPer;
  int ct[kPer], cs[kPer];
  long long mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    row_class(valid, pen, base + k, c, ct[k], cs[k]);
    mine += (static_cast<long long>(ct[k]) << 32) + cs[k];
  }
  long long tot64;
  long long before = sbt::block_exclusive_scan(mine, warp_tot64, &tot64);
  int rt = bt + static_cast<int>(before >> 32);
  int rs = bs + static_cast<int>(before & 0xffffffffLL);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = base + k;
    int dst = -1;
    if (ct[k]) dst = rt++;
    if (cs[k]) dst = n_touch + rs++;
    if (dst < 0 || dst >= m) continue;
    const int ia = a[r];
    const bool cv = ia >= 0;
    o_a[dst] = cv ? ia : 0;
    o_b[dst] = cv ? b[r] : -1;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      o_point[dst * 3 + q] = point[r * 3 + q];
      o_normal[dst * 3 + q] = normal[r * 3 + q];
    }
    o_pen[dst] = pen[r];
    o_valid[dst] = cv;
    o_fric[dst] = fric[r];
    o_rest[dst] = rest[r];
    o_key[dst] = cv ? key[r] : 0;
  }
  // The twin's fills on the rows no valid contact reaches.
  for (int d = blockIdx.x * kTileThreads + threadIdx.x; d < m; d += gridDim.x * kTileThreads) {
    if (d < n_valid) continue;
    o_a[d] = 0;
    o_b[d] = -1;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      o_point[d * 3 + q] = 0.0f;
      o_normal[d * 3 + q] = 0.0f;
    }
    o_pen[d] = 0.0f;
    o_valid[d] = false;
    o_fric[d] = 0.0f;
    o_rest[d] = 0.0f;
    o_key[d] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = max(n_touch - m, 0);
}

// ---------------------------------------------------------------------------
// Incidence
// ---------------------------------------------------------------------------

// Key k = 2 * entry + side (side 1 = the body is the entry's a): the
// twin's (entry, side) order.  Returns the key's body, or n for none.
// ea and eb are read with stride st (an entry's first row of wm).
__device__ __forceinline__ int key_body(const int* ea, const int* eb, int st, const bool* occ,
                                        int k, int n) {
  const int e = k >> 1;
  if (!occ[e]) return n;
  if (k & 1) return ea[static_cast<size_t>(e) * st];
  const int b = eb[static_cast<size_t>(e) * st];
  return b < 0 ? n : b;
}

__global__ void layout_inc_append_kernel(const int* __restrict__ ea, const int* __restrict__ eb,
                                         int st, const bool* __restrict__ occ, int c, int n,
                                         int* __restrict__ cnt, int* __restrict__ list) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * c) return;
  const int body = key_body(ea, eb, st, occ, k, n);
  if (body < 0 || body >= n) return;
  const int at = atomicAdd(&cnt[body], 1);
  if (at < kIncList) list[body * kIncList + at] = k;
}

__global__ void layout_inc_select_kernel(const int* __restrict__ ea, const int* __restrict__ eb,
                                         int st, const bool* __restrict__ occ, int c, int n,
                                         int cpb,
                                         const int* __restrict__ cnt, const int* __restrict__ list,
                                         int* __restrict__ table, float* __restrict__ sign,
                                         float* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int total = cnt[i];
  const int kept = min(total, cpb);
  int* trow = table + static_cast<size_t>(i) * cpb;
  float* srow = sign + static_cast<size_t>(i) * cpb;
  if (total <= kIncList) {
    // Selection of the cpb lowest keys of the list, in ascending order.
    const int* l = list + static_cast<size_t>(i) * kIncList;
    int prev = -1;
    for (int r = 0; r < kept; ++r) {
      int best = 0x7fffffff;
      for (int q = 0; q < total; ++q) {
        const int k = l[q];
        if (k > prev && k < best) best = k;
      }
      trow[r] = best >> 1;
      srow[r] = (best & 1) ? 1.0f : -1.0f;
      prev = best;
    }
  } else {
    // The list overflowed: the first cpb keys of this body, in key order.
    int r = 0;
    for (int k = 0; k < 2 * c && r < cpb; ++k)
      if (key_body(ea, eb, st, occ, k, n) == i) {
        trow[r] = k >> 1;
        srow[r] = (k & 1) ? 1.0f : -1.0f;
        ++r;
      }
  }
  for (int r = kept; r < cpb; ++r) {
    trow[r] = -1;
    srow[r] = 0.0f;
  }
  counts[i] = static_cast<float>(kept);
}

int set_smem(const void* fn, size_t bytes, size_t* done) {
  if (bytes <= *done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = bytes;
  return 0;
}

}  // namespace

extern "C" int layout_group(const int* pa, const int* pb, const bool* pv, const int* shape_type,
                            int p, int max_pairs, int active_mask, int* order, int* src, int* ba,
                            int* bb, bool* bvalid, int* slot_of_pair, int* overflow,
                            void* stream) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = static_cast<size_t>(kSortKeys) * kGroupThreads * sizeof(int);
  const int err = set_smem(reinterpret_cast<const void*>(layout_group_kernel), smem, &smem_set);
  if (err) return err;
  layout_group_kernel<<<1, kGroupThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pa, pb, pv, shape_type, p, max_pairs, active_mask, order, src, ba, bb, bvalid,
      slot_of_pair, overflow);
  return static_cast<int>(cudaGetLastError());
}

// rows: a host array of n_buckets device pointers (each bucket's
// touching flags); offs: a host array of n_buckets + 1 slot offsets.
extern "C" int layout_touching(const int* slot_of_pair, const void* const* rows, const int* offs,
                               int n_buckets, int p, bool* out, void* stream) {
  if (n_buckets > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  TouchRows tr;
  tr.n = n_buckets;
  for (int k = 0; k < n_buckets; ++k) tr.rows[k] = static_cast<const bool*>(rows[k]);
  for (int k = 0; k <= n_buckets; ++k) tr.off[k] = offs[k];
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  layout_touching_kernel<<<(p + threads - 1) / threads, threads, 0, s>>>(slot_of_pair, tr, p,
                                                                        out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int layout_compact(const int* a, const int* b, const float* point, const float* normal,
                              const float* pen, const bool* valid, const float* fric,
                              const float* rest, const int* key, int c, int m, int* tile_cnt,
                              int* o_a, int* o_b, float* o_point, float* o_normal, float* o_pen,
                              bool* o_valid, float* o_fric, float* o_rest, int* o_key,
                              int* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = max((c + kTile - 1) / kTile, 1);
  int2* tc = reinterpret_cast<int2*>(tile_cnt);
  layout_compact_count_kernel<<<n_tiles, kTileThreads, 0, s>>>(valid, pen, c, tc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Enough blocks to cover the fills of the m output rows as well.
  const int fill_tiles = (m + kTileThreads - 1) / kTileThreads;
  layout_compact_write_kernel<<<max(n_tiles, fill_tiles), kTileThreads, 0, s>>>(
      a, b, point, normal, pen, valid, fric, rest, key, c, m, tc, n_tiles, o_a, o_b, o_point,
      o_normal, o_pen, o_valid, o_fric, o_rest, o_key, overflow);
  return static_cast<int>(cudaGetLastError());
}

// ea, eb: entry ids at stride st; scratch: n counters, then n * 64 list
// slots.
extern "C" int layout_incidence(const int* ea, const int* eb, int st, const bool* occ, int c,
                                int n, int cpb, int* scratch, int* table, float* sign,
                                float* counts,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  if (c > 0) {
    layout_inc_append_kernel<<<(2 * c + threads - 1) / threads, threads, 0, s>>>(
        ea, eb, st, occ, c, n, scratch, scratch + n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layout_inc_select_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      ea, eb, st, occ, c, n, cpb, scratch, scratch + n, table, sign, counts);
  return static_cast<int>(cudaGetLastError());
}
