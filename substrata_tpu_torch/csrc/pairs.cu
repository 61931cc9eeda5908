// Kernel KS: the broadphase pair finder (K2).
//
// Replaces substrata_tpu/physics/broadphase.py:find_pairs (:115) and the
// margins of _pairs_rebuild (:364); plain twin:
// substrata_tpu_torch/kernels/pairs.py:find_pairs_plain.  It reads KP's
// flagged cell table (csrc/cell_table.cu) and hashes with KP's own device
// function (sbt::cell_hash).
//
// Six launches, none of them one block over all N bodies:
// 1. prep (a thread per body): each body's speed (the reference's norm: an
//    fma chain and a correctly rounded sqrt), each block's largest speed
//    and NaN flag, each warp's oversize bodies as a bit word and each
//    block's count; it zeroes the histogram, the look-back states and the
//    counters the later launches add into.
// 2. candidates (a warp per body, 8 bodies a block): each block folds the
//    block maxima into the reuse window (the same max at any launch order)
//    and every margin is recomputed where it is read, 0.08 + speed *
//    window * dt as one fma (the reference's contraction).  The body's 14
//    x cap stencil entries are spread over the lanes (3 a lane at cap 6),
//    so every table load and neighbour gather of a body is in flight at
//    once; each lane applies the filters, the tight test and the score with
//    the twin's expressions.  The top-ppb is a rank, not an insertion: the
//    masked entries are listed in column order in shared memory, and an
//    entry's slot is the number of entries with a higher score plus those
//    with an equal score in a lower column (the stable descending sort's
//    order, which lax.top_k keeps); no per-thread array is indexed at run
//    time.  The dedup keeps a slot's neighbour unless an earlier slot holds
//    it, lane k for slot k.  The block writes its 8 bodies' slots
//    slot-major through shared memory (32 contiguous bytes a slot).  Warp
//    0 of block 0 also lists the first 64 oversize bodies in index order
//    from launch 1's words and counts.
// 3. rows (1,024 rows a block, taken in ticket order): the ppb * N
//    slot-major rows, then 64 * N oversize rows (recomputed where read);
//    each tile's masked rows are counted, its offset found by a decoupled
//    look-back over the tiles before it, and the first max_pairs masked
//    rows keep their places; each kept key counts into its body a's
//    histogram, whose returned count is the key's place in its segment.
// 4. the histogram's exclusive scan, 1,024 bodies a block, the same
//    look-back.
// 5. placement: each kept key to its a-segment at its counted place.
// 6. final: each key's rank in its segment by b (equal keys are identical;
//    the first placed is the one kept), written to its sorted place with
//    pair_a / pair_b (-1 on a duplicate or past the kept count), pair_valid,
//    num_pairs, the overflow (cell table + rows + oversize + pairs) and
//    steps_left.
//
// What bounds it: latency.  At the bench shapes the work is 84 table
// entries and as many 12-byte positions per body (~0.25 us of operations,
// ~1 MB of bytes); each launch's chain of dependent loads is a few hundred
// ns, so six launches of 1-2 us each remain.  The look-backs spin only on
// tiles whose tickets were handed out earlier, so they always finish.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // bodies per candidates block
constexpr int kTile = 1024;             // rows (or bodies) per look-back tile
constexpr int kPer = kTile / kThreads;
constexpr int kMaxOversize = 64;
constexpr int kMaxPpb = 16;
constexpr int kStencil = 14;
constexpr int kMaxEntries = 8;          // stencil entries a lane: cap <= 18 (3 at cap <= 6)
constexpr int kListCap = 32 * kMaxEntries;
constexpr int kIdxMask = 0xFFFF;
constexpr int kTblMoving = 1 << 16, kTblStatic = 1 << 17, kTblSmall = 1 << 18;
constexpr int kStatic = 0;
constexpr int kBox = 1, kHull = 3;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

// ctrl[] slots (zeroed by launch 1).
enum Ctrl {
  kWindow = 0,      // reuse window (rebuild mode)
  kOsCount,         // oversize bodies found (all of them)
  kRowOver,         // tight candidates dropped by the top-ppb
  kPairOver,        // tight rows past max_pairs
  kTotal,           // masked rows
  kTicketRows,      // launch 3's tile tickets
  kTicketHist,      // launch 4's tile tickets
  kCtrlSlots = 8
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

// Launch 1's outputs, read by the later launches.
struct Prep {
  const float* speed;
  const float* blk_max;
  const int* blk_os;
  const uint32_t* os_bits;
  int n_blocks;
};

// The margins: kernels/pairs.py:rebuild_margins_plain's fma(speed *
// window, dt, 0.08) at a rebuild, else the one margin.
struct Margins {
  const float* speed;
  float wf;             // the window as a float (rebuild)
  float dt;
  float const_margin;
  int rebuild;
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
__device__ __forceinline__ float inner_of(const Bodies& b, int i) {
  const float* sp = b.shape_params + static_cast<size_t>(i) * b.sp_stride;
  const int st = b.shape_type[i];
  const float s0 = sp[0], s1 = sp[1], s2 = sp[2];
  if (st == kBox) return fminf(fminf(s0, s1), s2);
  if (st == kHull) return 0.5f * b.bound_radius[i];
  return s0;
}
__device__ __forceinline__ float dist2(const float* pos, int i, int j) {
  const float d0 = pos[i * 3] - pos[j * 3], d1 = pos[i * 3 + 1] - pos[j * 3 + 1],
              d2 = pos[i * 3 + 2] - pos[j * 3 + 2];
  return (d0 * d0 + d1 * d1) + d2 * d2;
}
__device__ __forceinline__ uint32_t pack_key(int i, int j) {
  return (static_cast<uint32_t>(min(i, j)) << 16) | static_cast<uint32_t>(max(i, j));
}

// The exclusive prefix of tile ``tile`` over the tiles before it, by one
// warp (every lane gets it).  A state word holds a flag (1: the tile's own
// count, 2: its inclusive prefix) over a 32-bit value; the warp reads 32
// predecessors at a time and stops at the nearest that holds its prefix.
// Tiles come from a ticket, so every tile looked at has been taken by a
// block that is running or done.
__device__ int lookback(unsigned long long* status, int tile, int agg, int lane) {
  constexpr unsigned long long kAgg = 1ull << 62, kPre = 2ull << 62;
  volatile unsigned long long* st = status;
  if (tile == 0) {
    if (lane == 0) st[0] = kPre | static_cast<uint32_t>(agg);
    return 0;
  }
  if (lane == 0) st[tile] = kAgg | static_cast<uint32_t>(agg);
  int excl = 0;
  int p = tile - 1;
  long long spins = 0;
  while (true) {
    const int q = p - lane;
    const unsigned long long s = q >= 0 ? st[q] : kPre;
    const unsigned flag = static_cast<unsigned>(s >> 62);
    if (__ballot_sync(0xffffffffu, flag == 0) != 0u) {
      // Every earlier tile is taken by a running block; one that never
      // reports is a fault, which aborts the launch instead of hanging it.
      if (++spins > (1ll << 24)) __trap();
      continue;
    }
    const uint32_t pre = __ballot_sync(0xffffffffu, flag == 2);
    const int stop = pre != 0u ? __ffs(pre) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<uint32_t>(s)) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (pre != 0u) break;
    p -= 32;
  }
  if (lane == 0) st[tile] = kPre | static_cast<uint32_t>(excl + agg);
  return excl;
}

// ---------------------------------------------------------------------------
// 1. prep
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pairs_prep_kernel(Bodies b, int rebuild, float cell_size, float* __restrict__ speed,
                  float* __restrict__ blk_max, int* __restrict__ blk_os,
                  uint32_t* __restrict__ os_bits, int* __restrict__ hist,
                  unsigned long long* __restrict__ status, int n_status, int* __restrict__ ctrl) {
  __shared__ float s_max[kWarps];
  __shared__ int s_nan[kWarps], s_os[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = b.n;
  float vmax = 0.0f;
  int nan = 0;
  if (rebuild && i < n) {
    const float* v = b.linvel + i * 3;
    // fma(v2, v2, fma(v1, v1, v0 v0)), then sqrt: jnp.linalg.norm as
    // XLA computes it on the CPU.
    float s = sqrtf(__fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], v[0] * v[0])));
    s = (b.alive[i] && b.awake[i]) ? s : 0.0f;
    speed[i] = s;
    if (s != s) nan = 1;
    else vmax = s;
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, i < n && oversize_of(b, i, cell_size));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
  }
  if (lane == 0) {
    s_max[warp] = vmax;
    s_nan[warp] = nan;
    s_os[warp] = __popc(bits);
    if (i < n) os_bits[i >> 5] = bits;
  }
  if (i < n) hist[i] = 0;
  for (int k = i; k < n_status; k += gridDim.x * kThreads) status[k] = 0ull;
  if (i < kCtrlSlots) ctrl[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    // Speeds are >= 0, so 0 is the identity; a NaN speed makes the max NaN.
    float m = 0.0f;
    int any_nan = 0, count = 0;
    for (int w = 0; w < kWarps; ++w) {
      m = fmaxf(m, s_max[w]);
      any_nan |= s_nan[w];
      count += s_os[w];
    }
    blk_max[blockIdx.x] = any_nan ? __int_as_float(0x7fc00000) : m;
    blk_os[blockIdx.x] = count;
  }
}

// ---------------------------------------------------------------------------
// 2. candidates
// ---------------------------------------------------------------------------

struct CandArgs {
  Bodies b;
  Prep prep;
  Margins mg;
  const int* table;
  const int* cells;
  int nb, cap, ppb, has_oversize, interval;
  float cell_size, margin_cap;
  float* margin;
  uint32_t* sel_key;
  uint8_t* sel_bits;
  int* os_idx;
  int* ctrl;
};

// The first kMaxOversize oversize bodies in index order, from launch 1's
// per-block counts and per-warp words (one warp), and their total.
__device__ void list_oversize(const CandArgs& a, int lane) {
  const int nw = (a.b.n + 31) >> 5;
  int total = 0;
  for (int base = 0; base < a.prep.n_blocks; base += 32) {
    const int blk = base + lane;
    const int c = blk < a.prep.n_blocks ? a.prep.blk_os[blk] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int at = total + incl - c;
    if (a.has_oversize && c > 0 && at < kMaxOversize) {
      for (int w = blk * kWarps; w < min(blk * kWarps + kWarps, nw) && at < kMaxOversize; ++w) {
        uint32_t bits = a.prep.os_bits[w];
        while (bits != 0u && at < kMaxOversize) {
          a.os_idx[at++] = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
        }
      }
    }
    total += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) a.ctrl[kOsCount] = total;
}

template <int PER>
__global__ void __launch_bounds__(kThreads) pairs_candidates_kernel(CandArgs a) {
  __shared__ float s_score[kWarps][kListCap];
  __shared__ int s_jt[kWarps][kListCap];       // neighbour | tight << 16
  __shared__ int s_slot[kWarps][kMaxPpb];
  __shared__ uint32_t s_key[kMaxPpb][kWarps];
  __shared__ uint8_t s_bits[kMaxPpb][kWarps];
  __shared__ float s_wf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Bodies& b = a.b;
  const int n = b.n;
  Margins mg = a.mg;
  if (mg.rebuild) {
    // The reuse window from launch 1's block maxima, by warp 0 (max is
    // exact, so the same at any order).
    if (warp == 0) {
      float m = 0.0f;
      int nan = 0;
      for (int k = lane; k < a.prep.n_blocks; k += 32) {
        const float v = a.prep.blk_max[k];
        if (v != v) nan = 1;
        else m = fmaxf(m, v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        nan |= __shfl_xor_sync(0xffffffffu, nan, o);
      }
      if (lane == 0) {
        if (nan) m = __int_as_float(0x7fc00000);
        float d = m * mg.dt;
        d = d < 1e-6f ? 1e-6f : d;
        float w = floorf(a.margin_cap / d);
        w = w < 1.0f ? 1.0f
                     : (w > static_cast<float>(a.interval) ? static_cast<float>(a.interval) : w);
        const int wi = static_cast<int>(w);
        if (blockIdx.x == 0) a.ctrl[kWindow] = wi;
        s_wf = static_cast<float>(wi);
      }
    }
  }
  if (blockIdx.x == 0 && warp == 0) list_oversize(a, lane);

  // The warp's body (a warp past N works on body N - 1 and writes nothing).
  // Its loads and gathers start before the block waits for the window.
  const bool live = static_cast<int>(blockIdx.x) * kWarps + warp < n;
  const int i = live ? blockIdx.x * kWarps + warp : n - 1;
  {
    const int cap = a.cap, ppb = a.ppb;
    const bool coll_i = collidable_of(b, i), mov_i = moving_of(b, i), stat_i = static_of(b, i);
    const bool small_i = 2.0f * b.bound_radius[i] <= a.cell_size;
    const float br_i = b.bound_radius[i], inner_i = inner_of(b, i);
    const float spd_i = mg.rebuild ? mg.speed[i] : 0.0f;
    const int c0 = a.cells[i * 3], c1 = a.cells[i * 3 + 1], c2 = a.cells[i * 3 + 2];
    const int n_entries = kStencil * cap;
    // Pass 1: each lane's table entries (column c = lane + 32 m: bucket
    // c / cap of the stencil, slot c % cap), the 14 bucket hashes taken
    // once, by lanes 0-13.
    int hb_lane = 0;
    if (lane < kStencil) {
      const int o = 13 + lane;
      hb_lane = sbt::cell_hash(c0 + (o % 3 - 1), c1 + ((o / 3) % 3 - 1), c2 + (o / 9 - 1), a.nb);
    }
    int ent[PER];
    int bq = lane / cap, br_ = lane - bq * cap;
    const int step_q = 32 / cap, step_r = 32 - step_q * cap;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int hb = __shfl_sync(0xffffffffu, hb_lane, min(bq, kStencil - 1));
      ent[m] = lane + 32 * m < n_entries ? a.table[hb * cap + br_] : -1;
      bq += step_q;
      br_ += step_r;
      if (br_ >= cap) {
        br_ -= cap;
        ++bq;
      }
    }
    // Pass 2: the filters from the entry's flags.
    bool mk[PER], tt[PER];
    int js[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = ent[m];
      const int jj = e >= 0 ? (e & kIdxMask) : -1;
      js[m] = max(jj, 0);
      bool mask = lane + 32 * m < cap ? jj > i : (jj >= 0 && jj != i);
      mask = mask && coll_i;
      mask = mask && (mov_i || (e & kTblMoving) != 0);
      mask = mask && !(stat_i && (e & kTblStatic) != 0);
      mk[m] = mask && (small_i && (e & kTblSmall) != 0);
    }
    // Pass 3: the gathers of the entries still in, all started before any
    // is used.
    float px[PER], py[PER], pz[PER], br[PER], sp0[PER], sp1[PER], sp2[PER], spd[PER];
    int st[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      if (mk[m]) {
        const int j = js[m];
        px[m] = b.pos[j * 3];
        py[m] = b.pos[j * 3 + 1];
        pz[m] = b.pos[j * 3 + 2];
        br[m] = b.bound_radius[j];
        st[m] = b.shape_type[j];
        const float* sp = b.shape_params + static_cast<size_t>(j) * b.sp_stride;
        sp0[m] = sp[0];
        sp1[m] = sp[1];
        sp2[m] = sp[2];
        spd[m] = mg.rebuild ? mg.speed[j] : 0.0f;
      }
    }
    if (mg.rebuild) {
      __syncthreads();
      mg.wf = s_wf;
    }
    const float m_i = mg.rebuild ? __fmaf_rn(spd_i * mg.wf, mg.dt, 0.08f) : mg.const_margin;
    const float infl_i = br_i + 0.5f * m_i;
    // Pass 4: the distance, tight and score of each, as the twin computes them.
    const float xi = b.pos[i * 3], yi = b.pos[i * 3 + 1], zi = b.pos[i * 3 + 2];
    float score[PER];
    int jt[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      bool mask = mk[m], tight = false;
      float sc = -1e9f;
      if (mask) {
        const float d0 = xi - px[m], d1 = yi - py[m], dz = zi - pz[m];
        const float d2 = (d0 * d0 + d1 * d1) + dz * dz;
        const float mj = mg.rebuild ? __fmaf_rn(spd[m] * mg.wf, mg.dt, 0.08f) : mg.const_margin;
        const float r = infl_i + (br[m] + 0.5f * mj);
        const float rr = r * r;
        mask = d2 <= rr;
        const float inner_j = st[m] == kBox ? fminf(fminf(sp0[m], sp1[m]), sp2[m])
                                            : (st[m] == kHull ? 0.5f * br[m] : sp0[m]);
        const float rt = inner_i + inner_j;
        tight = mask && d2 <= rt * rt;
        sc = mask ? rr - d2 : -1e9f;
      }
      mk[m] = mask;
      tt[m] = tight;
      score[m] = sc;
      jt[m] = js[m] | (tight ? 1 << 16 : 0);
    }
    // The masked entries in column order, then each one's rank.
    const uint32_t lt = (1u << lane) - 1u;
    int n_masked = 0, n_tight = 0;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const uint32_t bal = __ballot_sync(0xffffffffu, mk[m]);
      n_tight += __popc(__ballot_sync(0xffffffffu, tt[m]));
      if (mk[m]) {
        const int at = n_masked + __popc(bal & lt);
        s_score[warp][at] = score[m];
        s_jt[warp][at] = jt[m];
      }
      n_masked += __popc(bal);
    }
    __syncwarp();
    for (int q = lane; q < n_masked; q += 32) {
      const float s = s_score[warp][q];
      int rank = 0;
      for (int p = 0; p < n_masked; ++p) {
        const float t = s_score[warp][p];
        rank += (t > s) || (t == s && p < q);
      }
      if (rank < ppb) s_slot[warp][rank] = s_jt[warp][q];
    }
    __syncwarp();
    // Slot k on lane k: a hash collision can list one neighbour twice; a
    // slot is kept unless an earlier slot holds the same neighbour.
    const int filled = min(n_masked, ppb);
    bool kept = false, tight = false;
    int j = 0;
    if (lane < filled) {
      const int v = s_slot[warp][lane];
      j = v & kIdxMask;
      tight = (v >> 16) & 1;
      kept = true;
      for (int q = 0; q < lane; ++q)
        if ((s_slot[warp][q] & kIdxMask) == j) kept = false;
    }
    const int sel_tight = __popc(__ballot_sync(0xffffffffu, kept && tight));
    if (live && lane < ppb) {
      s_key[lane][warp] = lane < filled ? pack_key(i, j) : kEmpty;
      s_bits[lane][warp] = static_cast<uint8_t>((kept ? 1 : 0) | (kept && tight ? 2 : 0));
    }
    if (live && lane == 0) {
      a.margin[i] = m_i;
      const int over = n_tight - sel_tight;
      if (over > 0) atomicAdd(&a.ctrl[kRowOver], over);
    }
  }
  __syncthreads();
  // Slot-major rows: slot k of body i is row k * N + i.
  for (int t = threadIdx.x; t < a.ppb * kWarps; t += kThreads) {
    const int k = t / kWarps, w = t - k * kWarps;
    const int ii = blockIdx.x * kWarps + w;
    if (ii < n) {
      a.sel_key[static_cast<size_t>(k) * n + ii] = s_key[k][w];
      a.sel_bits[static_cast<size_t>(k) * n + ii] = s_bits[k][w];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. rows: compaction into max_pairs keys
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
  const float rr = (b.bound_radius[oi] + 0.5f * ra.margin[oi]) +
                   (b.bound_radius[j] + 0.5f * ra.margin[j]);
  ok = ok && dist2(b.pos, oi, j) <= rr * rr;
  ok = ok && !(oversize_of(b, j, ra.cell_size) && j < oi);
  mask = tight = ok;
  key = pack_key(oi, j);
}

__global__ void __launch_bounds__(kThreads)
pairs_rows_kernel(RowArgs ra, int n_tiles, int max_pairs, uint32_t* __restrict__ buf,
                  int* __restrict__ lidx, int* __restrict__ hist,
                  unsigned long long* __restrict__ status, int* __restrict__ ctrl) {
  __shared__ int warp_tot[32];
  __shared__ int s_tile, s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(&ctrl[kTicketRows], 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile + threadIdx.x * kPer;
  bool m[kPer], t[kPer];
  uint32_t key[kPer];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    row_of(ra, base + k, m[k], t[k], key[k]);
    mine += m[k];
  }
  int tot;
  const int before = sbt::block_exclusive_scan(mine, warp_tot, &tot);
  if (threadIdx.x < 32) {
    const int x = lookback(status, tile, tot, threadIdx.x);
    if (threadIdx.x == 0) s_prefix = x;
  }
  __syncthreads();
  int at = s_prefix + before;
  int lost = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!m[k]) continue;
    const int dst = at++;
    if (dst < max_pairs) {
      buf[dst] = key[k];
      lidx[dst] = atomicAdd(&hist[key[k] >> 16], 1);
    } else if (t[k]) {
      ++lost;
    }
  }
  lost = sbt::block_sum(lost, warp_tot);
  if (threadIdx.x == 0) {
    if (lost) atomicAdd(&ctrl[kPairOver], lost);
    if (tile == n_tiles - 1) ctrl[kTotal] = s_prefix + tot;
  }
}

// ---------------------------------------------------------------------------
// 4-6. sort by (a, b) and dedup
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pairs_hist_scan_kernel(const int* __restrict__ hist, int n, int* __restrict__ offs,
                       unsigned long long* __restrict__ status, int* __restrict__ ctrl) {
  __shared__ int warp_tot[32];
  __shared__ int s_tile, s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(&ctrl[kTicketHist], 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile + threadIdx.x * kPer;
  int v[kPer];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = base + k < n ? hist[base + k] : 0;
    mine += v[k];
  }
  int tot;
  const int before = sbt::block_exclusive_scan(mine, warp_tot, &tot);
  if (threadIdx.x < 32) {
    const int x = lookback(status, tile, tot, threadIdx.x);
    if (threadIdx.x == 0) s_prefix = x;
  }
  __syncthreads();
  int at = s_prefix + before;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (base + k < n) offs[base + k] = at;
    at += v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
pairs_place_kernel(const uint32_t* __restrict__ buf, const int* __restrict__ lidx,
                   const int* __restrict__ offs, const int* __restrict__ ctrl, int max_pairs,
                   uint32_t* __restrict__ tmp) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= min(ctrl[kTotal], max_pairs)) return;
  const uint32_t key = buf[k];
  tmp[offs[key >> 16] + lidx[k]] = key;
}

__global__ void __launch_bounds__(kThreads)
pairs_final_kernel(const uint32_t* __restrict__ tmp, const int* __restrict__ ctrl,
                   const int* __restrict__ offs, const int* __restrict__ hist, int max_pairs,
                   int rebuild, int has_oversize, const int* __restrict__ cell_over,
                   int* __restrict__ pa, int* __restrict__ pb, bool* __restrict__ pv,
                   int* __restrict__ num_pairs, int* __restrict__ overflow,
                   int* __restrict__ steps_left) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int kept = min(ctrl[kTotal], max_pairs);
  if (p < kept) {
    const uint32_t key = tmp[p];
    const int a = key >> 16;
    const int s = offs[a], e = s + hist[a];
    int rank = 0;
    bool dup = false;
    for (int q = s; q < e; ++q) {
      const uint32_t o = tmp[q];
      rank += (o < key) || (o == key && q < p);
      dup = dup || (o == key && q < p);
    }
    const int dst = s + rank;
    pa[dst] = dup ? -1 : a;
    pb[dst] = dup ? -1 : static_cast<int>(key & 0xFFFFu);
    pv[dst] = !dup;
  } else if (p < max_pairs) {
    pa[p] = -1;
    pb[p] = -1;
    pv[p] = false;
  }
  if (p == 0) {
    const int os = ctrl[kOsCount];
    const int os_over = has_oversize ? os - min(os, kMaxOversize) : os;
    *num_pairs = ctrl[kTotal];
    *overflow = *cell_over + ctrl[kRowOver] + os_over + ctrl[kPairOver];
    if (rebuild) *steps_left = ctrl[kWindow] - 1;
  }
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/pairs.py:_PACK): 0-8 the bodies' pos, linvel, alive, awake,
// collidable, motion_type, bound_radius, shape_type, shape_params; 9-11
// KP's table, cells and cell overflow; 12 the int32 scratch
// (pairs_scratch_words' layout, kernels/pairs.py:scratch_ints); 13-19 out
// margin, pair_a, pair_b, pair_valid, num_pairs, overflow, steps_left;
// 20-28 the shape_params row stride, N, buckets, cell cap, ppb,
// max_pairs, has_oversize, rebuild, interval; 29-32 as doubles the
// constant margin, dt, the margin cap and cell_size.
extern "C" int find_pairs(const long long* a, void* stream) {
  auto v = [a](int k) { return static_cast<int>(a[k]); };
  auto f = [a](int k) {
    double d;
    memcpy(&d, a + k, sizeof(double));
    return static_cast<float>(d);
  };
  const int n = v(21), nb = v(22), cap = v(23), ppb = v(24), max_pairs = v(25);
  const int has_oversize = v(26), rebuild = v(27), interval = v(28);
  if (ppb > kMaxPpb || ppb < 1 || n < 1 || n > 65536 || cap < 1 || kStencil * cap > kListCap ||
      max_pairs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Bodies b{reinterpret_cast<const float*>(a[0]), reinterpret_cast<const float*>(a[1]),
           reinterpret_cast<const bool*>(a[2]), reinterpret_cast<const bool*>(a[3]),
           reinterpret_cast<const bool*>(a[4]), reinterpret_cast<const int*>(a[5]),
           reinterpret_cast<const float*>(a[6]), reinterpret_cast<const int*>(a[7]),
           reinterpret_cast<const float*>(a[8]), v(20), n};
  const int* table = reinterpret_cast<const int*>(a[9]);
  const int* cells = reinterpret_cast<const int*>(a[10]);
  const int* cell_over = reinterpret_cast<const int*>(a[11]);
  int* scratch = reinterpret_cast<int*>(a[12]);
  float* margin = reinterpret_cast<float*>(a[13]);
  int* pa = reinterpret_cast<int*>(a[14]);
  int* pb = reinterpret_cast<int*>(a[15]);
  bool* pv = reinterpret_cast<bool*>(a[16]);
  int* num_pairs = reinterpret_cast<int*>(a[17]);
  int* overflow = reinterpret_cast<int*>(a[18]);
  int* steps_left = reinterpret_cast<int*>(a[19]);
  const float const_margin = f(29), dt = f(30), margin_cap = f(31), cell_size = f(32);

  const int n_sel = ppb * n;
  const int n_rows = n_sel + (has_oversize ? kMaxOversize * n : 0);
  const int n_blocks = cdiv(n, kThreads);
  const int row_tiles = cdiv(n_rows, kTile), hist_tiles = cdiv(n, kTile);
  // Scratch layout (int32 words; kernels/pairs.py:scratch_ints): ctrl,
  // os_idx, hist[N], offs[N], speed[N], blk_max, blk_os, os_bits, sel_key,
  // buf, lidx, tmp, (8-byte aligned) the look-back states of launches 3
  // and 4, sel_bits (bytes).
  int* ctrl = scratch;
  int* os_idx = ctrl + kCtrlSlots;
  int* hist = os_idx + kMaxOversize;
  int* offs = hist + n;
  float* speed = reinterpret_cast<float*>(offs + n);
  float* blk_max = speed + n;
  int* blk_os = reinterpret_cast<int*>(blk_max + n_blocks);
  uint32_t* os_bits = reinterpret_cast<uint32_t*>(blk_os + n_blocks);
  uint32_t* sel_key = os_bits + cdiv(n, 32);
  uint32_t* buf = sel_key + n_sel;
  int* lidx = reinterpret_cast<int*>(buf + max_pairs);
  uint32_t* tmp = reinterpret_cast<uint32_t*>(lidx + max_pairs);
  const size_t words = static_cast<size_t>(reinterpret_cast<int*>(tmp + max_pairs) - scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + words + (words & 1));
  uint8_t* sel_bits = reinterpret_cast<uint8_t*>(status + row_tiles + hist_tiles);

  pairs_prep_kernel<<<n_blocks, kThreads, 0, s>>>(b, rebuild, cell_size, speed, blk_max, blk_os,
                                                  os_bits, hist, status, row_tiles + hist_tiles,
                                                  ctrl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CandArgs ca{b, Prep{speed, blk_max, blk_os, os_bits, n_blocks},
              Margins{speed, 0.0f, dt, const_margin, rebuild}, table, cells, nb, cap, ppb,
              has_oversize, interval, cell_size, margin_cap, margin, sel_key, sel_bits, os_idx,
              ctrl};
  const int per = cdiv(kStencil * cap, 32);
  if (per <= 3) pairs_candidates_kernel<3><<<cdiv(n, kWarps), kThreads, 0, s>>>(ca);
  else if (per <= 5) pairs_candidates_kernel<5><<<cdiv(n, kWarps), kThreads, 0, s>>>(ca);
  else pairs_candidates_kernel<kMaxEntries><<<cdiv(n, kWarps), kThreads, 0, s>>>(ca);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  RowArgs ra{b, margin, sel_key, sel_bits, os_idx, ctrl, n_sel, n_rows, cell_size};
  pairs_rows_kernel<<<row_tiles, kThreads, 0, s>>>(ra, row_tiles, max_pairs, buf, lidx, hist,
                                                   status, ctrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_hist_scan_kernel<<<hist_tiles, kThreads, 0, s>>>(hist, n, offs, status + row_tiles, ctrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int mp_blocks = cdiv(max_pairs, kThreads);
  pairs_place_kernel<<<mp_blocks, kThreads, 0, s>>>(buf, lidx, offs, ctrl, max_pairs, tmp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pairs_final_kernel<<<mp_blocks, kThreads, 0, s>>>(tmp, ctrl, offs, hist, max_pairs, rebuild,
                                                    has_oversize, cell_over, pa, pb, pv,
                                                    num_pairs, overflow, steps_left);
  return static_cast<int>(cudaGetLastError());
}
