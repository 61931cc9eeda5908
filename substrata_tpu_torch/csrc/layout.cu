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
// Compaction, one cooperative launch (cudaLaunchCooperativeKernel, so
// the runtime refuses a grid that cannot be resident at once, and
// grid.sync() cannot wait on a block that never starts) of up to the
// card's resident blocks, each taking a run of 32-row groups, a warp a
// group at a time, lanes on consecutive rows: each row's valid and
// penetration are read once, the group's touching and speculative rows
// kept as two ballot words in shared memory and its penetrations in
// registers; a block scan of the groups' popcounts gives each group's
// place in its block, and the block's two counts go to the plan's
// scratch.  After the grid barrier every block sums the counts of the
// blocks before it and of all blocks, so a lane's destination is its
// class's start (0, or the grid-wide n_touch) + the rows of its class in
// earlier blocks and groups + the popcount of the lower lanes' bits.
// Only rows that land (dst < max_active_contacts) read their payload;
// each field is one coalesced pass (a group's rows of one class land in
// one run), point and normal as the group's 96 words with lanes on
// words; the rows past the valid ones get the twin's fills, spread over
// every block.
//
// Incidence, two launches and no memset: each (entry, side) key appends
// itself to its body's list (atomicAdd, any order; the counters live in
// the wrapper's plan and are 0 between calls); then a warp takes 4
// bodies, ranks the keys of each body's list across its lanes and keeps
// the cpb lowest (ascending (entry, side), the twin's sorted order, which
// decides the order of the sums in KC and KU), and sets the counters back
// to 0.  A body whose list overflowed its 64 slots walks all keys in
// order, 32 at a time, so the kept set is always the cpb lowest.
//
// What bounds it: latency.  At the serving world's shapes (16,384 pairs,
// ~100k contact rows, 36,864 compacted rows) each pass moves a few MB.  No
// step runs in one block: the grouping's serial pieces are a tile's 16 warp
// counts per code and 17 column sums of the tile table (P / 512 rows, 32 a
// lane), the compaction's a scan of a block's groups and a sum over the
// blocks' counts, the rest are single passes with one atomic per key.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kCodes = 16;
constexpr int kSortKeys = kCodes + 1;       // code 16: invalid pairs
constexpr int kGroupTile = 512;              // grouping: pairs per block
constexpr int kGroupWarps = kGroupTile / 32;
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

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactGroups = kCompactThreads;   // 32-row groups a block at most
// The most blocks a launch takes (a group of 32 rows a warp below it):
// every block sums every block's count after the barrier, so the blocks'
// reads grow as their square, and the cap (under three blocks an SM of
// the H100's 132) keeps that square below what the card could hold.
constexpr int kCompactMaxBlocks = 384;
constexpr int kCompactHeld = 4;                   // a warp's groups whose pen stays in registers

// The compaction's arguments (csrc/layout.cu:layout_compact).  ``blocks``
// is the plan's scratch: each block's (touching << 32 | speculative)
// count, written before the grid barrier in every launch.  ``out`` is the
// wrapper's one buffer: a, b, key [m] i32, the overflow, point, normal
// [m, 3], pen, friction, restitution [m] f32, then valid [m] bytes.
struct CompactArgs {
  const int *a, *b;
  const float *point, *normal, *pen;
  const bool* valid;
  const float *fric, *rest;
  const int* key;
  long long* blocks;
  int* out;
  int c, m, gpb;
};

// The smallest normal float: the jitted reference's pen > 0 reads a
// denormal as 0 (XLA's CPU compares with denormals-are-zero, as the TPU
// does), so touching is pen >= this.
constexpr float kSmallestNormal = 1.17549435e-38f;

// One 32-row group's class words: bit l of *touch is row 32 k + l valid
// with pen >= kSmallestNormal, of *spec valid otherwise (NaN, -0.0 and
// the denormals included).
__device__ __forceinline__ void group_class(bool v, float p, unsigned* touch, unsigned* spec) {
  const bool t = v && p >= kSmallestNormal;
  *touch = __ballot_sync(0xffffffffu, t);
  *spec = __ballot_sync(0xffffffffu, v && !t);
}

// Group j of the block (its first row r0): each landing lane's row to
// its destination, every field one pass.  ``p`` is the lane's pen.
__device__ __forceinline__ void place_group(const CompactArgs& g, int r0, unsigned touch,
                                            unsigned spec, int t0, int s0, float p) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int dst = -1;
  if ((touch >> lane) & 1u) dst = t0 + __popc(touch & below);
  if ((spec >> lane) & 1u) dst = s0 + __popc(spec & below);
  if (dst >= g.m) dst = -1;
  const long long m = g.m;
  const int r = r0 + lane;
  // Every load first: the lane's row, then the group's point and normal
  // words (word w is row w / 3's component w % 3).
  int ia = 0, ib = 0, ik = 0;
  float fr = 0.0f, re = 0.0f;
  if (dst >= 0) {
    ia = g.a[r];
    ib = g.b[r];
    ik = g.key[r];
    fr = g.fric[r];
    re = g.rest[r];
  }
  int wd[3];
  float pt[3], nm[3];
  const long long w0 = 3LL * r0;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int w = 32 * q + lane;
    wd[q] = __shfl_sync(0xffffffffu, dst, w / 3);
    pt[q] = nm[q] = 0.0f;
    if (wd[q] >= 0) {
      pt[q] = g.point[w0 + w];
      nm[q] = g.normal[w0 + w];
    }
  }
  int* o_a = g.out;
  float* f = reinterpret_cast<float*>(o_a + 3 * m + 1);
  if (dst >= 0) {
    const bool cv = ia >= 0;
    o_a[dst] = cv ? ia : 0;
    o_a[m + dst] = cv ? ib : -1;
    o_a[2 * m + dst] = cv ? ik : 0;
    f[6 * m + dst] = p;
    f[7 * m + dst] = fr;
    f[8 * m + dst] = re;
    reinterpret_cast<bool*>(f + 9 * m)[dst] = cv;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (wd[q] >= 0) {
      const long long o = 3LL * wd[q] + (32 * q + lane) % 3;
      f[o] = pt[q];
      f[3 * m + o] = nm[q];
    }
  }
}

__global__ void __launch_bounds__(kCompactThreads) layout_compact_kernel(const CompactArgs g) {
  __shared__ unsigned s_touch[kCompactGroups], s_spec[kCompactGroups];
  __shared__ long long s_before[kCompactGroups];
  __shared__ long long s_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = g.c;
  const int n_groups = (c + 31) >> 5;
  const int first = blockIdx.x * g.gpb;
  const int ng = max(min(g.gpb, n_groups - first), 0);

  // 1. Each group's class words; the first kCompactHeld groups of a warp
  // keep their lanes' pen in registers across the barrier.
  bool hv[kCompactHeld];
  float hp[kCompactHeld];
#pragma unroll
  for (int k = 0; k < kCompactHeld; ++k) {
    const int r = (first + warp + k * kCompactWarps) * 32 + lane;
    const bool in = warp + k * kCompactWarps < ng && r < c;
    hv[k] = in && g.valid[r];
    hp[k] = in ? g.pen[r] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kCompactHeld; ++k) {
    const int j = warp + k * kCompactWarps;
    if (j < ng) {
      unsigned t, s;
      group_class(hv[k], hp[k], &t, &s);
      if (lane == 0) {
        s_touch[j] = t;
        s_spec[j] = s;
      }
    }
  }
  for (int j = warp + kCompactHeld * kCompactWarps; j < ng; j += kCompactWarps) {
    const int r = (first + j) * 32 + lane;
    unsigned t, s;
    group_class(r < c && g.valid[r], r < c ? g.pen[r] : 0.0f, &t, &s);
    if (lane == 0) {
      s_touch[j] = t;
      s_spec[j] = s;
    }
  }
  __syncthreads();
  // A thread a group: the rows of each class in the block's earlier groups.
  long long mine = 0;
  if (threadIdx.x < ng)
    mine = (static_cast<long long>(__popc(s_touch[threadIdx.x])) << 32) +
           __popc(s_spec[threadIdx.x]);
  long long block_tot;
  const long long before_group = sbt::block_exclusive_scan(mine, s_tot, &block_tot);
  if (threadIdx.x < ng) s_before[threadIdx.x] = before_group;
  if (threadIdx.x == 0) g.blocks[blockIdx.x] = block_tot;

  cooperative_groups::this_grid().sync();

  // 2. The rows of each class in earlier blocks and in all of them (the
  // counts pack touching << 32 | speculative, each below 2^31): warp 0
  // sums the blocks' counts by shuffles, one barrier hands them on.
  if (warp == 0) {
    long long all = 0, before = 0;
    for (int k = lane; k < static_cast<int>(gridDim.x); k += 32) {
      const long long v = __ldcg(g.blocks + k);
      all += v;
      before += k < static_cast<int>(blockIdx.x) ? v : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      all += __shfl_xor_sync(0xffffffffu, all, o);
      before += __shfl_xor_sync(0xffffffffu, before, o);
    }
    if (lane == 0) {
      s_tot[0] = all;
      s_tot[1] = before;
    }
  }
  __syncthreads();
  const long long all = s_tot[0], before = s_tot[1];
  const int n_touch = static_cast<int>(all >> 32);
  const int n_valid = n_touch + static_cast<int>(all & 0xffffffffLL);
  const int bt = static_cast<int>(before >> 32);
  const int bs = n_touch + static_cast<int>(before & 0xffffffffLL);

  // 3. The rows that land.  A group whose two classes both start at or
  // past max_active has none.
#pragma unroll
  for (int k = 0; k < kCompactHeld; ++k) {
    const int j = warp + k * kCompactWarps;
    if (j < ng) {
      const long long pre = s_before[j];
      const int t0 = bt + static_cast<int>(pre >> 32);
      const int s0 = bs + static_cast<int>(pre & 0xffffffffLL);
      const unsigned t = s_touch[j], s = s_spec[j];
      if ((t && t0 < g.m) || (s && s0 < g.m)) place_group(g, (first + j) * 32, t, s, t0, s0, hp[k]);
    }
  }
  for (int j = warp + kCompactHeld * kCompactWarps; j < ng; j += kCompactWarps) {
    const long long pre = s_before[j];
    const int t0 = bt + static_cast<int>(pre >> 32);
    const int s0 = bs + static_cast<int>(pre & 0xffffffffLL);
    const unsigned t = s_touch[j], s = s_spec[j];
    const int r = (first + j) * 32 + lane;
    if ((t && t0 < g.m) || (s && s0 < g.m))
      place_group(g, (first + j) * 32, t, s, t0, s0, ((t | s) >> lane) & 1u ? g.pen[r] : 0.0f);
  }

  // 4. The twin's fills on the rows no valid contact reaches, every block.
  const long long m = g.m;
  const long long stride = static_cast<long long>(gridDim.x) * kCompactThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kCompactThreads + threadIdx.x;
  int* o_a = g.out;
  float* f = reinterpret_cast<float*>(o_a + 3 * m + 1);
  for (long long d = n_valid + tid; d < m; d += stride) {
    o_a[d] = 0;
    o_a[m + d] = -1;
    o_a[2 * m + d] = 0;
    f[6 * m + d] = 0.0f;
    f[7 * m + d] = 0.0f;
    f[8 * m + d] = 0.0f;
    reinterpret_cast<bool*>(f + 9 * m)[d] = false;
  }
  for (long long w = 3LL * n_valid + tid; w < 3 * m; w += stride) {
    f[w] = 0.0f;
    f[3 * m + w] = 0.0f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) o_a[3 * m] = max(n_touch - g.m, 0);
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

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/layout.py:_COMPACT_PACK): the 9 contact fields, the plan's
// block scratch (at least ceil(ceil(C / 32) / 8) words), the output
// buffer, C and max_active.  One cooperative launch: a group of 32 rows
// a warp, up to kCompactMaxBlocks blocks and the card's resident ones; a
// C past 256 groups a block raises (cudaErrorInvalidValue).
extern "C" int layout_compact(const long long* v, void* stream) {
  CompactArgs g;
  g.a = reinterpret_cast<const int*>(v[0]);
  g.b = reinterpret_cast<const int*>(v[1]);
  g.point = reinterpret_cast<const float*>(v[2]);
  g.normal = reinterpret_cast<const float*>(v[3]);
  g.pen = reinterpret_cast<const float*>(v[4]);
  g.valid = reinterpret_cast<const bool*>(v[5]);
  g.fric = reinterpret_cast<const float*>(v[6]);
  g.rest = reinterpret_cast<const float*>(v[7]);
  g.key = reinterpret_cast<const int*>(v[8]);
  g.blocks = reinterpret_cast<long long*>(v[9]);
  g.out = reinterpret_cast<int*>(v[10]);
  const long long c = v[11], m = v[12];
  if (c < 0 || c > 0x7fffffe0LL || m < 0 || 12 * m + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // The card's resident blocks of this kernel, once a device.
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layout_compact_kernel,
                                                        kCompactThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = std::max(per_sm * sms, 1);
  }
  const long long n_groups = (c + 31) / 32;
  const int grid = static_cast<int>(std::min<long long>(
      std::max<long long>((n_groups + kCompactWarps - 1) / kCompactWarps, 1),
      std::min(kCompactMaxBlocks, resident[dev])));
  const long long gpb = std::max<long long>((n_groups + grid - 1) / grid, 1);
  if (gpb > kCompactGroups) return static_cast<int>(cudaErrorInvalidValue);
  g.c = static_cast<int>(c);
  g.m = static_cast<int>(m);
  g.gpb = static_cast<int>(gpb);
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layout_compact_kernel), dim3(grid),
                                    dim3(kCompactThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
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
