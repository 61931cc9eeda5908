// Kernel KAD: one halo exchange phase of the spatially sharded step, every
// shard of a leading shard axis on one card, in one launch (K20c).
//
// Replaces substrata_tpu/parallel/spatial.py:halo_exchange (:97) with
// _pack_halo (:86), and _axis_exchange (:238) for the 2-D tiles; plain
// twin: substrata_tpu_torch/kernels/halo.py:exchange_plain.  The mesh axis
// of the reference becomes the shard index d; ppermute becomes a write into
// the neighbour's ghost block of the combined buffer.
//
// Layout: every BodyState field is a contiguous [S * rows_in] array of rows
// (``src``); the output is one buffer holding each field's [S * (rows_in +
// 2H)] rows at a fixed offset: shard d's rows first (copied), then H rows
// received from its low neighbour, then H from its high one.  A field is
// moved as bytes, so one table of (src, offset, bytes per row) carries all
// 23 fields and their mixed types.
//
// Two kinds of block in one grid, the ghost blocks first:
//
// - Ghost blocks: P blocks a shard d, each owning the places [H p / P, H
//   (p + 1) / P) of both directions' H ghost rows (0: the high boundary,
//   sent up; 1: the low one, sent down).  Every one computes the shard's
//   two masks itself, alive & (c > hi_thr[a]) and alive & (c < lo_thr[a])
//   on the coordinate ``axis`` with the thresholds taken at the shard's
//   position along the axis: one __ballot_sync a 32-row word and mask
//   (every load of the pass in flight before the first ballot).  Warp e
//   then ranks direction e's places: a scan of the words' popcounts, a run
//   of words a lane, and a lane a place selecting its source row in the
//   stable order that argsort(~mask) gives (masked rows first, then the
//   rest, each in index order): a binary search over the runs by shuffles,
//   a walk of the run's words, __fns for the bit.  The P blocks of a shard
//   read the same inputs in the same order, so they agree without waiting
//   on each other; the first writes overflow[d, :] = max(M - H, 0).  The
//   block then copies its places as the plan's item map lays them out,
//   field-major: consecutive threads take consecutive units (32-bit words
//   where a field's row is whole words, else bytes) of consecutive places,
//   every unit of a thread's batch loaded before the first store (the
//   batch's map entries load at the block's start); alive and awake are
//   cleared at places at or past the masked count M.  A shard at the end of its axis line has no receiver on
//   that side (ppermute's missing link); its blocks write zeros instead, split
//   the same way, into the ghost block that nothing reaches: that of the
//   shard at the other end of the line.
// - Copy blocks: shard d's own rows of each field, one contiguous run of
//   bytes a (field, shard), in the same unit batches (16 bytes where a
//   field's runs and both ends allow), spread over the card's SMs.
//
// No atomics: every output byte has one writer, so the result equals the
// twin's bit for bit.  The launch's parameters hold only the pointers and
// the shape; the plan's table in device memory holds each field's output
// offset and bytes a row and the thresholds, read with one coalesced load
// (a kernel parameter is read through the constant cache, and a warp
// reading many of them waits on each line it misses).
//
// What bounds it: bytes (each row read once or twice and written once or
// twice: 133 bytes a body row), 3.81 MB a 4-slab phase of 3,072 rows and
// H = 512, ~1.1 us at 3.35 TB/s; each ghost block also reads its shard's
// coordinate and alive flag (~40 KB a 3,072-row shard, from L2).
#include "common.cuh"

namespace {

constexpr int kMaxFields = 24;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 6;          // units a thread holds in flight
constexpr int kMaskBatch = 9;      // a warp's words loaded before its ballots (4,608 rows: 9)
constexpr int kMaxChunk = 256;     // ghost places a block and direction
constexpr int kMaxWords = 12288;   // both masks' words: 96 KB, rows_in <= 393,216
constexpr int kSharedDefault = 48 * 1024;
constexpr int kTableWarp = 1;      // the warp that stages the field table
constexpr unsigned kFull = 0xffffffffu;

// The parameters: per call the pointers, per plan the shape and the
// plan's two device arrays.
struct HaloArgs {
  const float* pos;                // src[pos_f], src[alive_f]
  const bool* alive;
  // The plan's table: each field's output offset in ``dst`` and bytes a
  // row; then a word a position along the axis: its low threshold's bits,
  // and its high one's << 32.
  const long long* table;
  // The plan's item map: a ghost block's units, both directions' C places
  // (C = ceil(H / P)) field-major, each (place, unit in its row, field,
  // direction, byte unit) packed as pl | w << 8 | k << 12 | e << 17 | byte << 18.
  const int* map;
  int rows_in, halo, axis, stride, n_axis;
  int parts;                       // P: ghost blocks a shard
  int ghost_blocks;                // S P
  int items;                       // 2 C (units a row)
  char* dst;                       // the output buffer
  int* overflow;                   // [S, 2]
  int n_fields, alive_f, awake_f, n_shards, copy_blocks;
  const char* src[kMaxFields];
};

// log2 of the unit an own-row run moves in: 16 bytes, 4 or 1, the largest
// that divides both strides a unit steps by and both ends' addresses.
__device__ __forceinline__ int unit_shift(long long s_step, long long d_step, uintptr_t s,
                                          uintptr_t d) {
  const unsigned long long all = static_cast<unsigned long long>(s_step | d_step) | s | d;
  return all % 16 == 0 ? 4 : all % 4 == 0 ? 2 : 0;
}

__device__ __forceinline__ uint4 load_unit(const char* p, int s) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (s == 4) v = *reinterpret_cast<const uint4*>(p);
  else if (s == 2) v.x = *reinterpret_cast<const uint32_t*>(p);
  else v.x = *reinterpret_cast<const uint8_t*>(p);
  return v;
}

__device__ __forceinline__ void store_unit(char* p, int s, uint4 v) {
  if (s == 4) *reinterpret_cast<uint4*>(p) = v;
  else if (s == 2) *reinterpret_cast<uint32_t*>(p) = v.x;
  else *reinterpret_cast<uint8_t*>(p) = static_cast<uint8_t>(v.x);
}

struct Table {
  const char* src[kMaxFields];
  char* dst[kMaxFields];
  int bytes[kMaxFields], shift[kMaxFields];   // shift: the own-row copy's unit
  int pre[kMaxFields + 1];         // the own-row copy's units before each field
};

// The source pointers, from the parameters into shared memory: every warp
// its share at a warp-uniform index (one constant-cache access a pointer,
// the warps' in parallel; a lane indexing them by its own number would
// serialise its warp on them).
__device__ __forceinline__ void stage_sources(const HaloArgs& a, Table& t) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int f = warp; f < a.n_fields; f += kWarps) t.src[f] = a.src[f];
}

__global__ void __launch_bounds__(kThreads) halo_kernel(const __grid_constant__ HaloArgs a) {
  __shared__ Table t;
  __shared__ int s_row[2][kMaxChunk];
  __shared__ int s_count[2];
  extern __shared__ unsigned s_word[];   // ghost blocks: both masks' words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nf = a.n_fields, rows_in = a.rows_in, halo = a.halo;
  const long long rows_out = rows_in + 2LL * halo;
  // The table warp's lane k: field k's entries of the plan's table.
  const bool tl = warp == kTableWarp && lane < nf;
  const long long* tab = a.table;
  const long long t_off = tl ? tab[lane] : 0, t_b = tl ? tab[nf + lane] : 0;

  if (static_cast<int>(blockIdx.x) >= a.ghost_blocks) {
    // Shard d's own rows: per field, S runs of rows_in rows, as the runs'
    // lengths and both ends' addresses allow.
    stage_sources(a, t);
    __syncthreads();
    if (warp == kTableWarp) {
      int units = 0;
      if (tl) {
        const char* s = t.src[lane];
        char* d = a.dst + t_off;
        const long long run = rows_in * t_b;
        const int sh = unit_shift(run, rows_out * t_b, reinterpret_cast<uintptr_t>(s),
                                  reinterpret_cast<uintptr_t>(d));
        units = a.n_shards * static_cast<int>(run >> sh);
        t.dst[lane] = d;
        t.bytes[lane] = static_cast<int>(t_b);
        t.shift[lane] = sh;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, units, o);
        if (lane >= o) units += y;
      }
      if (lane == 0) t.pre[0] = 0;
      if (tl) t.pre[lane + 1] = units;
    }
    __syncthreads();
    const int total = t.pre[nf];
    const int stride = a.copy_blocks * kThreads;
    int k = 0;
    for (int g0 = (blockIdx.x - a.ghost_blocks) * kThreads + tid; g0 < total;
         g0 += stride * kItems) {
      uint4 v[kItems];
      char* dp[kItems];
      int sh[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int g = g0 + j * stride;
        dp[j] = nullptr;
        sh[j] = 0;
        if (g < total) {
          while (g >= t.pre[k + 1]) ++k;
          const int s = t.shift[k];
          const long long b = t.bytes[k];
          const int per = static_cast<int>((rows_in * b) >> s);
          const int local = g - t.pre[k];
          const int d = local / per, w = local - d * per;
          v[j] = load_unit(t.src[k] + d * rows_in * b + (static_cast<long long>(w) << s), s);
          dp[j] = t.dst[k] + d * rows_out * b + (static_cast<long long>(w) << s);
          sh[j] = s;
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (dp[j] != nullptr) store_unit(dp[j], sh[j], v[j]);
    }
    return;
  }

  // A ghost block: shard d's part p, both directions.  Its first batch of
  // item-map entries loads now, with the masks' loads.
  int ent[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int g = tid + j * kThreads;
    ent[j] = g < a.items ? a.map[g] : -1;
  }
  const int P = a.parts;
  const int p = blockIdx.x % P;
  const int d = blockIdx.x / P;
  const long long base = static_cast<long long>(d) * rows_in;
  const int words = (rows_in + 31) >> 5;
  unsigned* s_up = s_word;
  unsigned* s_down = s_word + words;
  {
    // The masks: a ballot a 32-row word and mask, each warp's loads in
    // flight first, the thresholds' word loaded behind them.
    float lo = 0.0f, hi = 0.0f;
    for (int w0 = warp; w0 < words; w0 += kWarps * kMaskBatch) {
      float x[kMaskBatch];
      bool al[kMaskBatch];
#pragma unroll
      for (int u = 0; u < kMaskBatch; ++u) {
        const int i = (w0 + u * kWarps) * 32 + lane;
        const bool in = i < rows_in;
        al[u] = in ? a.alive[base + i] : false;
        x[u] = in ? a.pos[(base + i) * 3 + a.axis] : 0.0f;
      }
      if (w0 == warp) {
        const long long tw = tab[2 * nf + (d / a.stride) % a.n_axis];
        lo = __int_as_float(static_cast<int>(tw & 0xffffffffLL));
        hi = __int_as_float(static_cast<int>(tw >> 32));
      }
#pragma unroll
      for (int u = 0; u < kMaskBatch; ++u) {
        const int w = w0 + u * kWarps;
        const unsigned wu = __ballot_sync(kFull, al[u] && x[u] > hi);
        const unsigned wd = __ballot_sync(kFull, al[u] && x[u] < lo);
        if (lane == 0 && w < words) {
          s_up[w] = wu;
          s_down[w] = wd;
        }
      }
    }
  }
  const int ap = (d / a.stride) % a.n_axis;   // position along the axis
  const bool up = ap < a.n_axis - 1, down = ap > 0;   // linked
  // The receivers' ghost blocks; an unlinked direction writes zeros into
  // the block at the other end of the line, which nothing reaches.
  const long long dst_up = (up ? d + a.stride : d - (a.n_axis - 1) * a.stride) * rows_out
                           + rows_in;
  const long long dst_down = (down ? d - a.stride : d + (a.n_axis - 1) * a.stride) * rows_out
                             + rows_in + halo;
  // 32-bit products: H P <= 393,216 x 1,536 < 2^31 (P is at most
  // ceil(H / 256) or the SMs over 2 S).
  const int h0 = halo * p / P;
  const int c = halo * (p + 1) / P - h0;
  if (tl) {
    t.dst[lane] = a.dst + t_off;
    t.bytes[lane] = static_cast<int>(t_b);
  }
  stage_sources(a, t);   // needed only by the copy below
  {
    __syncthreads();
    // Warp e ranks direction e's places: a scan of the mask's word
    // popcounts, a run of words a lane; then a lane a place finds its source
    // row, the q-th masked row where q < M, else the (q - M)-th unmasked
    // one: a binary search over the lanes' runs by shuffles, a walk of the
    // run's words, __fns for the bit.  No barrier between the two.
    if (warp < 2) {
      const int e = warp;
      const unsigned* wd = e ? s_down : s_up;
      const int per = (words + 31) / 32;
      const int w_lo = min(lane * per, words), w_hi = min(w_lo + per, words);
      int cnt = 0;
      for (int w = w_lo; w < w_hi; ++w) cnt += __popc(wd[w]);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int run_pre = incl - cnt;   // masked rows before this lane's run
      const int m = __shfl_sync(kFull, incl, 31);
      if (lane == 0) {
        s_count[e] = m;
        if (p == 0) a.overflow[d * 2 + e] = max(m - halo, 0);
      }
      if (e ? down : up) {
        for (int q0 = 0; q0 < c; q0 += 32) {
          const int q = q0 + lane;
          const int place = h0 + (q < c ? q : 0);
          const bool masked = place < m;
          const int rank = masked ? place : place - m;
          int lo_l = 0, hi_l = 31;
#pragma unroll
          for (int step = 0; step < 5; ++step) {
            const int mid = (lo_l + hi_l + 1) >> 1;
            const int rp = __shfl_sync(kFull, run_pre, mid);
            const int before = masked ? rp : min(mid * per, words) * 32 - rp;
            if (before <= rank) lo_l = mid;
            else hi_l = mid - 1;
          }
          const int rp = __shfl_sync(kFull, run_pre, lo_l);
          int w = min(lo_l * per, words);
          int before = masked ? rp : w * 32 - rp;
          unsigned bits = masked ? wd[w] : ~wd[w];
          while (before + __popc(bits) <= rank) {
            before += __popc(bits);
            ++w;
            bits = masked ? wd[w] : ~wd[w];
          }
          if (q < c) s_row[e][q] = w * 32 + static_cast<int>(__fns(bits, 0, rank - before + 1));
        }
      }
    }
  }
  __syncthreads();

  // The block's places of both directions, as the item map lays them out:
  // zeros where the direction is unlinked, nothing past the block's c places.
  const int m_up = s_count[0], m_down = s_count[1];
  for (int g0 = 0; g0 < a.items; g0 += kThreads * kItems) {
    if (g0 > 0) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int g = g0 + tid + j * kThreads;
        ent[j] = g < a.items ? a.map[g] : -1;
      }
    }
    unsigned v[kItems];
    char* dp[kItems];
    bool byte[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int x = ent[j], pl = x & 0xff, w = (x >> 8) & 0xf, k = (x >> 12) & 0x1f;
      const int e = (x >> 17) & 1;
      byte[j] = (x >> 18) & 1;
      dp[j] = nullptr;
      v[j] = 0u;
      if (x >= 0 && pl < c) {
        const long long b = t.bytes[k], place = h0 + pl;
        const long long wb = byte[j] ? w : 4 * w;
        if ((e ? down : up) && !((k == a.alive_f || k == a.awake_f) && place >= (e ? m_down
                                                                                 : m_up))) {
          const char* sp = t.src[k] + (base + s_row[e][pl]) * b + wb;
          v[j] = byte[j] ? *reinterpret_cast<const uint8_t*>(sp)
                         : *reinterpret_cast<const uint32_t*>(sp);
        }
        dp[j] = t.dst[k] + ((e ? dst_down : dst_up) + place) * b + wb;
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (dp[j] == nullptr) continue;
      if (byte[j]) *reinterpret_cast<uint8_t*>(dp[j]) = static_cast<uint8_t>(v[j]);
      else *reinterpret_cast<uint32_t*>(dp[j]) = v[j];
    }
  }
}

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/halo.py:_HEAD and _Plan): the output buffer, overflow [S, 2];
// the plan's table (device memory, HaloArgs::table); n_fields, pos, alive
// and awake field indices, S, rows_in, H, axis, stride, n_axis, P, copy
// blocks; the plan's item map (device memory) and its length; then
// n_fields source pointers.
extern "C" int halo_exchange(const long long* v, void* stream) {
  HaloArgs a;
  a.dst = reinterpret_cast<char*>(v[0]);
  a.overflow = reinterpret_cast<int*>(v[1]);
  a.table = reinterpret_cast<const long long*>(v[2]);
  a.n_fields = static_cast<int>(v[3]);
  const int pos_f = static_cast<int>(v[4]);
  a.alive_f = static_cast<int>(v[5]);
  a.awake_f = static_cast<int>(v[6]);
  a.n_shards = static_cast<int>(v[7]);
  a.rows_in = static_cast<int>(v[8]);
  a.halo = static_cast<int>(v[9]);
  a.axis = static_cast<int>(v[10]);
  a.stride = static_cast<int>(v[11]);
  a.n_axis = static_cast<int>(v[12]);
  a.parts = static_cast<int>(v[13]);
  a.copy_blocks = static_cast<int>(v[14]);
  a.map = reinterpret_cast<const int*>(v[15]);
  a.items = static_cast<int>(v[16]);
  const int nf = a.n_fields;
  const int words = (a.rows_in + 31) / 32;
  if (nf < 1 || nf > kMaxFields || pos_f < 0 || pos_f >= nf || a.alive_f < 0 ||
      a.alive_f >= nf || a.n_axis < 1 || a.halo < 0 || a.halo > a.rows_in ||
      words > kMaxWords || a.parts < 1 || a.copy_blocks < 1 ||
      (a.halo + a.parts - 1) / a.parts > kMaxChunk || a.n_shards < 1 || a.stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kMaxFields; ++k)
    a.src[k] = k < nf ? reinterpret_cast<const char*>(v[17 + k]) : nullptr;
  a.pos = reinterpret_cast<const float*>(a.src[pos_f]);
  a.alive = reinterpret_cast<const bool*>(a.src[a.alive_f]);
  const int shared = words * 2 * static_cast<int>(sizeof(unsigned));
  if (shared > kSharedDefault) {
    static bool raised = false;   // the opt-in above 48 KB, once a process
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxWords * 8);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised = true;
    }
  }
  a.ghost_blocks = a.n_shards * a.parts;
  halo_kernel<<<a.ghost_blocks + a.copy_blocks, kThreads, shared,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
