// Kernel KT: the compacted contact layout's chain — combo grouping (K3),
// contact compaction and the incidence table (K5).
//
// Replaces substrata_tpu/physics/narrowphase.py:pair_contacts :666-720
// (the argsort grouping) and :792-796 (the touching scatter),
// narrowphase.py:compact_contacts :1054 and solver.py:build_incidence :96;
// plain twins: substrata_tpu_torch/kernels/layout.py:*_plain.
//
// Grouping: a stable counting sort of the pair list by combo code (16
// codes, 16 for an invalid pair), two launches over tiles of 512 pairs,
// one pair a thread with coalesced loads.  The first ranks each pair among
// its tile's pairs of its code (a warp match and a popcount, a scan of the
// per-warp counts) and writes the tile's 17 counts; the second reads the
// [tiles, 17] table in every block, so a pair's place in the sorted order
// is its code's run start + the code's counts in earlier tiles + its rank,
// which is where torch.argsort(stable=True) puts it.  A pair inside its
// code's slice [min(start, P - cap), + cap) writes its slot's source,
// bodies and occupancy and its slot_of_pair; the first launch pre-fills
// every slot as empty, so a slice that spans a neighbour's run keeps src =
// -1 there, as the reference masks it.  Block 0 writes the bucket
// overflow.  Touching: one thread per pair gathers its slot's flag from the
// bucket kernels' outputs (KA/KK/KO), so no scatter needs a cleared buffer.
//
// Compaction, two launches over tiles of 1024 rows: count the touching and
// the speculative rows of each tile; then each tile sums the counts of the
// tiles before it and scans its own rows, so touching rows land first and
// speculative rows after them, each class in row order, into
// max_active_contacts rows; the rows past the valid ones get the twin's
// fills.  Incidence, two launches and no memset: each (entry, side) key
// appends itself to its body's list (atomicAdd, any order; the counters
// live in the wrapper's plan and are 0 between calls); then a warp takes 4
// bodies, ranks the keys of each body's list across its lanes and keeps
// the cpb lowest (ascending (entry, side), the twin's sorted order, which
// decides the order of the sums in KC and KU), and sets the counters back
// to 0.  A body
// whose list overflowed its 64 slots walks all keys in order, 32 at a time,
// so the kept set is always the cpb lowest.
//
// What bounds it: latency.  At the serving world's shapes (16,384 pairs,
// ~100k contact rows, 36,864 compacted rows) each pass moves a few MB.  No
// step runs in one block: the grouping's serial pieces are a tile's 16 warp
// counts per code and 17 column sums of the tile table (P / 512 rows, 32 a
// lane), the rest are single passes with one atomic per key.
#include "common.cuh"

namespace {

constexpr int kCodes = 16;
constexpr int kSortKeys = kCodes + 1;       // code 16: invalid pairs
constexpr int kGroupTile = 512;              // grouping: pairs per block
constexpr int kGroupWarps = kGroupTile / 32;
constexpr int kTile = 1024;                 // compaction rows per block
constexpr int kTileThreads = 256;
constexpr int kIncList = 64;                // per-body key slots before the slow path
constexpr int kMaxBuckets = 16;

__host__ __device__ __forceinline__ bool same_type(int code) {
  return code == 0 || code == 5 || code == 10 || code == 15;
}

// narrowphase.py: max_pairs for the same-type codes, max(64, max_pairs / 4)
// for the others, never more than the pair list.
__host__ __device__ __forceinline__ int bucket_cap(int code, int max_pairs, int p) {
  const int cap = same_type(code) ? max_pairs : max(64, max_pairs / 4);
  return min(cap, p);
}

__device__ __forceinline__ int pair_code(const int* pa, const int* pb, const bool* pv,
                                         const int* shape_type, int i) {
  if (!pv[i]) return kCodes;
  const int a = max(pa[i], 0), b = max(pb[i], 0);
  return min(max(shape_type[a] * 4 + shape_type[b], 0), kCodes - 1);
}

// Launch 1, one tile of kGroupTile pairs per block, one pair a thread:
// each pair's code and its stable rank among the tile's pairs of that code
// (__match_any_sync groups a warp's lanes by code, the popcount of the
// lower peers ranks them, and an exclusive scan of the per-warp counts over
// the tile's warps puts the warps in order), packed as rank << 5 | code;
// the tile's 17 counts; and the slot arrays' pre-fill (the twin's empty
// slot: src -1, the bodies of pair 0, not valid).
__global__ void __launch_bounds__(kGroupTile)
layout_group_count_kernel(const int* __restrict__ pa, const int* __restrict__ pb,
                          const bool* __restrict__ pv, const int* __restrict__ shape_type, int p,
                          int total_slots, int* __restrict__ packed, int* __restrict__ tile_cnt,
                          int* __restrict__ src, int* __restrict__ ba, int* __restrict__ bb,
                          bool* __restrict__ bvalid) {
  __shared__ int wcnt[kGroupWarps][kSortKeys];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * blockDim.x;
  if (total_slots > 0) {
    const int a0 = max(pa[0], 0), b0 = max(pb[0], 0);
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < total_slots; k += stride) {
      src[k] = -1;
      ba[k] = a0;
      bb[k] = b0;
      bvalid[k] = false;
    }
  }
  for (int k = threadIdx.x; k < kGroupWarps * kSortKeys; k += blockDim.x) (&wcnt[0][0])[k] = 0;
  __syncthreads();
  const int i = blockIdx.x * kGroupTile + threadIdx.x;
  const int code = i < p ? pair_code(pa, pb, pv, shape_type, i) : kSortKeys;
  const unsigned peers = __match_any_sync(0xffffffffu, code);
  const int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (code < kSortKeys && in_warp == 0) wcnt[warp][code] = __popc(peers);
  __syncthreads();
  if (threadIdx.x < kSortKeys) {
    int run = 0;
    for (int w = 0; w < kGroupWarps; ++w) {
      const int x = wcnt[w][threadIdx.x];
      wcnt[w][threadIdx.x] = run;
      run += x;
    }
    tile_cnt[blockIdx.x * kSortKeys + threadIdx.x] = run;
  }
  __syncthreads();
  if (i < p) packed[i] = (wcnt[warp][code] + in_warp) << 5 | code;
}

// Launch 2, the same tiles: every block reads the [tiles, 17] count table
// (a warp per code sums its column over all tiles and over the tiles
// before its own), warp 0 scans the 17 totals into the runs' starts, each
// active code's slice start min(start, P - cap) and offset, and the
// overflow (block 0 writes it); then each pair's place in the sorted order
// is its run's start + the counts of its code in earlier tiles + its rank
// in the tile, and a pair inside its code's slice writes its slot.  Slots
// of a slice outside its code's run keep the pre-fill, as the reference
// masks a slice that spans a neighbour's run.
__global__ void __launch_bounds__(kGroupTile)
layout_group_place_kernel(const int* __restrict__ pa, const int* __restrict__ pb, int p,
                          int max_pairs, int active_mask, int n_tiles,
                          const int* __restrict__ packed, const int* __restrict__ tile_cnt,
                          int* __restrict__ src, int* __restrict__ ba, int* __restrict__ bb,
                          bool* __restrict__ bvalid, int* __restrict__ slot_of_pair,
                          int* __restrict__ overflow) {
  __shared__ int col_all[kSortKeys], col_before[kSortKeys];
  __shared__ int base[kSortKeys], slice_start[kCodes], slice_off[kCodes], caps[kCodes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  for (int c = warp; c < kSortKeys; c += kGroupWarps) {
    int all = 0, before = 0;
    for (int t = lane; t < n_tiles; t += 32) {
      const int x = tile_cnt[t * kSortKeys + c];
      all += x;
      before += t < tile ? x : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      all += __shfl_xor_sync(0xffffffffu, all, o);
      before += __shfl_xor_sync(0xffffffffu, before, o);
    }
    if (lane == 0) {
      col_all[c] = all;
      col_before[c] = before;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane;
    const int tot = c < kSortKeys ? col_all[c] : 0;
    const bool act = c < kCodes && ((active_mask >> c) & 1);
    const int cap = act ? bucket_cap(c, max_pairs, p) : 0;
    int start = tot, off = cap;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, start, o);
      const int y = __shfl_up_sync(0xffffffffu, off, o);
      if (lane >= o) {
        start += x;
        off += y;
      }
    }
    start -= tot;
    off -= cap;
    int over = c < kCodes ? (act ? max(tot - cap, 0) : tot) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(0xffffffffu, over, o);
    if (c < kSortKeys) base[c] = start + col_before[c];
    if (c < kCodes) {
      slice_start[c] = min(start, p - cap);
      slice_off[c] = off;
      caps[c] = cap;
    }
    if (tile == 0 && lane == 0) *overflow = over;
  }
  __syncthreads();
  const int i = tile * kGroupTile + threadIdx.x;
  if (i >= p) return;
  const int v = packed[i];
  const int code = v & 31;
  int slot = -1;
  if (code < kCodes && ((active_mask >> code) & 1)) {
    const int j = base[code] + (v >> 5) - slice_start[code];
    if (j < caps[code]) {
      slot = slice_off[code] + j;
      src[slot] = i;
      ba[slot] = max(pa[i], 0);
      bb[slot] = max(pb[i], 0);
      bvalid[slot] = true;
    }
  }
  slot_of_pair[i] = slot;
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

constexpr int kIncWarps = 8;              // warps a select block
constexpr int kIncBodies = 4;             // bodies a warp

// A warp takes 4 bodies.  Lanes 0-3 read their counts in one load and set
// them back to 0 for the next call; the warp loads the first 32 keys of
// each body that has keys as one 128-byte row, all rows issued before any
// use, and writes the empty slots of the 4 bodies' rows (-1, 0) in
// coalesced stores.  Then each body with keys is ranked across the warp:
// a key's rank is the number of smaller keys in the row, counted by
// shuffles (the keys are distinct: each (entry, side) belongs to one
// body), and a key ranked below cpb goes to its slot.  A warp a body spent
// ~80 instructions on each body, empty or not; 4 bodies share them.  A
// body past its 64 list slots walks the 2c keys 32 at a time instead: a
// ballot of the keys that are its own, ranked by the bits below each lane,
// until cpb are placed: the first cpb in key order.
__global__ void __launch_bounds__(kIncWarps * 32) layout_inc_select_kernel(
    const int* __restrict__ ea, const int* __restrict__ eb, int st, const bool* __restrict__ occ,
    int c, int n, int cpb, int* __restrict__ cnt, const int* __restrict__ list,
    int* __restrict__ table, float* __restrict__ sign, float* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int i0 = (blockIdx.x * kIncWarps + (threadIdx.x >> 5)) * kIncBodies;
  if (i0 >= n) return;
  const int nb = min(kIncBodies, n - i0);
  int tot = 0;
  if (lane < nb) {
    tot = cnt[i0 + lane];
    cnt[i0 + lane] = 0;
  }
  const unsigned has_keys = __ballot_sync(0xffffffffu, tot > 0);
  int first[kIncBodies];
#pragma unroll
  for (int j = 0; j < kIncBodies; ++j)
    first[j] = ((has_keys >> j) & 1u) ? list[static_cast<size_t>(i0 + j) * kIncList + lane]
                                      : 0x7fffffff;
  const int kept = min(tot, cpb);
  const int len = nb * cpb;
  int* tchunk = table + static_cast<size_t>(i0) * cpb;
  float* schunk = sign + static_cast<size_t>(i0) * cpb;
  for (int f0 = 0; f0 < len; f0 += 32) {
    const int f = f0 + lane;
    const int j = min(f / cpb, 31);
    const int kj = __shfl_sync(0xffffffffu, kept, j);
    if (f < len && f - j * cpb >= kj) {
      tchunk[f] = -1;
      schunk[f] = 0.0f;
    }
  }
  if (lane < nb) counts[i0 + lane] = static_cast<float>(kept);
#pragma unroll
  for (int j = 0; j < kIncBodies; ++j) {
    if (!((has_keys >> j) & 1u)) continue;
    const int i = i0 + j;
    const int total = __shfl_sync(0xffffffffu, tot, j);
    int* trow = table + static_cast<size_t>(i) * cpb;
    float* srow = sign + static_cast<size_t>(i) * cpb;
    if (total <= kIncList) {
      const int k0 = lane < total ? first[j] : 0x7fffffff;
      int k1 = 0x7fffffff;
      if (32 + lane < total) k1 = list[static_cast<size_t>(i) * kIncList + 32 + lane];
      int r0 = 0, r1 = 0;
      const int lo = min(total, 32), hi = total - 32;
      for (int q = 0; q < lo; ++q) {
        const int y = __shfl_sync(0xffffffffu, k0, q);
        r0 += y < k0;
        r1 += y < k1;
      }
      for (int q = 0; q < hi; ++q) {
        const int y = __shfl_sync(0xffffffffu, k1, q);
        r0 += y < k0;
        r1 += y < k1;
      }
      if (lane < total && r0 < cpb) {
        trow[r0] = k0 >> 1;
        srow[r0] = (k0 & 1) ? 1.0f : -1.0f;
      }
      if (32 + lane < total && r1 < cpb) {
        trow[r1] = k1 >> 1;
        srow[r1] = (k1 & 1) ? 1.0f : -1.0f;
      }
    } else {
      int r = 0;
      for (int base = 0; base < 2 * c && r < cpb; base += 32) {
        const int k = base + lane;
        const bool mine = k < 2 * c && key_body(ea, eb, st, occ, k, n) == i;
        const unsigned bits = __ballot_sync(0xffffffffu, mine);
        const int rank = r + __popc(bits & ((1u << lane) - 1u));
        if (mine && rank < cpb) {
          trow[rank] = k >> 1;
          srow[rank] = (k & 1) ? 1.0f : -1.0f;
        }
        r += __popc(bits);
      }
    }
  }
}

}  // namespace

// scratch (kernels/layout.py:group): packed [p], then the tile counts
// [max(ceil(p / kGroupTile), 1), 17].
extern "C" int layout_group(const int* pa, const int* pb, const bool* pv, const int* shape_type,
                            int p, int max_pairs, int active_mask, int* scratch, int* src, int* ba,
                            int* bb, bool* bvalid, int* slot_of_pair, int* overflow,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = max((p + kGroupTile - 1) / kGroupTile, 1);
  int total_slots = 0;
  for (int c = 0; c < kCodes; ++c)
    if ((active_mask >> c) & 1) total_slots += bucket_cap(c, max_pairs, p);
  int* packed = scratch;
  int* tile_cnt = scratch + p;
  layout_group_count_kernel<<<n_tiles, kGroupTile, 0, s>>>(pa, pb, pv, shape_type, p,
                                                           total_slots, packed, tile_cnt, src,
                                                           ba, bb, bvalid);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layout_group_place_kernel<<<n_tiles, kGroupTile, 0, s>>>(pa, pb, p, max_pairs, active_mask,
                                                           n_tiles, packed, tile_cnt, src, ba,
                                                           bb, bvalid, slot_of_pair, overflow);
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

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/layout.py:_INC_PACK): entry a, b (at stride st), occupancy,
// scratch (n counters, 0 between calls, then n * 64 list slots: the plan's),
// out table, sign, counts, st, C, N, CPB.  Two launches: the append pass
// counts each body's keys into its list, the select pass (a warp per 4
// bodies) places them and sets the counters back to 0.
extern "C" int layout_incidence(const long long* v, void* stream) {
  auto ptr = [v](int k) { return reinterpret_cast<void*>(v[k]); };
  const int* ea = static_cast<const int*>(ptr(0));
  const int* eb = static_cast<const int*>(ptr(1));
  const bool* occ = static_cast<const bool*>(ptr(2));
  int* scratch = static_cast<int*>(ptr(3));
  int* table = static_cast<int*>(ptr(4));
  float* sign = static_cast<float*>(ptr(5));
  float* counts = static_cast<float*>(ptr(6));
  const int st = static_cast<int>(v[7]), c = static_cast<int>(v[8]), n = static_cast<int>(v[9]),
            cpb = static_cast<int>(v[10]);
  if (st < 1 || c < 0 || n < 0 || cpb < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (c > 0) {
    layout_inc_append_kernel<<<(2 * c + threads - 1) / threads, threads, 0, s>>>(
        ea, eb, st, occ, c, n, scratch, scratch + n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0) {
    const int per_block = kIncWarps * kIncBodies;
    layout_inc_select_kernel<<<(n + per_block - 1) / per_block, kIncWarps * 32, 0, s>>>(
        ea, eb, st, occ, c, n, cpb, scratch, scratch + n, table, sign, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
