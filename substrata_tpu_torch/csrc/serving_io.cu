// KM and KN: the serving tick's input apply, and its event digest and
// transform block.
//
// KM (apply_tick_in) replaces substrata_tpu/physics/world.py:
// _apply_transforms_wake (:305-325); plain twin:
// substrata_tpu_torch/kernels/serving_io.py:apply_tick_in_plain.  A block
// takes a tile of 64 consecutive bodies, four lanes a body.  Every global
// load is issued first, together: the 64 wake regions (their centres and
// radii, 256 words, one a lane, into shared memory), the 128 slot ids (one
// a lane), the tile's contiguous runs of pos, quat, linvel and angvel
// (lane k of the block takes word k of each run), and each body's flags,
// timer and bound radius.  The lanes holding the slot ids then map the
// tile in O(1): an id that lands in the tile (a negative one counted from
// the end, as the reference's scatter counts it) records its row in a
// shared table by atomicMax, so where two rows name one slot the last row
// wins, as a serial scan of the rows would have it.  Only a written body's
// lanes then read its row's pose and velocities, from global memory (a
// serving tick writes a few bodies; staging the whole 8.7 KB input in
// every block cost more than it saved).  Each body's four lanes test 16
// of the 64 wake regions each, on the new position, with the squared
// distance rounded as the jitted reference contracts it
// (fma(d2, d2, fma(d1, d1, d0 d0))); the hit is an OR over the regions, so
// their order is immaterial: a lane tests them four at a time, with no
// branch between the four, and a warp stops once every lane has hit (a
// padded region, radius -1e9, hits every finite body within 1e9 m, so a
// serving tick's padded input ends the loop at once; a NaN or a 1e9 m
// position still tests every region).  The pose and velocities go out as
// the tile's contiguous runs again, each word taken from its write row or
// from the loaded state; the outputs are one buffer [pos 3N | quat 4N |
// linvel 3N | angvel 3N | sleep_timer N | awake N bytes].  What bounds it
// on the card: bytes (~112 bytes a body read and written); 64 region tests
// are ~700 operations a body.
//
// KN (digest_tblock) replaces _digest_core (:258-275) and _tblock_core
// (:202-206); plain twin: serving_io.py:digest_tblock_plain.  One launch, a
// grid of tiles of 256 slots over max(N, P): each block takes its tile of
// all four event masks (newly awake, newly asleep, entered water over N;
// touching over P).  A warp's ballot over 32 consecutive slots is their bit
// word: the body masks' words go straight to the digest's tail, the
// touching mask's to the plan's scratch, and each block writes its tile's
// four counts there too.  The same blocks stage their 256 transform rows
// in shared memory from coalesced reads of each field and write the
// [N, 14] block as one contiguous run.  The last block to finish (a fence,
// then an atomic ticket it resets for the next launch, so no call needs a
// memset) selects in order, one warp a class (select_class): a warp scan
// of the tile counts gives each tile's first rank, the set bits of the
// tiles holding ranks below 64 (128) are placed in parallel, and the
// touching pairs' (a, b) are gathered with every load in flight at once.
// No thread walks a mask serially: the selection reads the 4 x T tile
// counts and only the words that hold the first ranks.  What bounds it on
// the card: bytes (the masks and pair ids in, 56 bytes a body out with the
// block); its latency floor is one wave of tiles, then the last block's
// selection.
#include "common.cuh"

namespace {

constexpr int kTinK = 128, kTinR = 64, kTinScal = 8;
constexpr int kOIdx = kTinScal;
constexpr int kOPos = kOIdx + kTinK;
constexpr int kORot = kOPos + 3 * kTinK;
constexpr int kOLv = kORot + 4 * kTinK;
constexpr int kOAv = kOLv + 3 * kTinK;
constexpr int kOVok = kOAv + 3 * kTinK;
constexpr int kOCtr = kOVok + kTinK;
constexpr int kORad = kOCtr + 3 * kTinR;
constexpr int kEvk = 64, kEvt = 128, kHead = 200 + 2 * kEvt + 1;
constexpr int kDynamic = 2;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// KM's arguments (kernels/serving_io.py:_TICK_PACK, one 8-byte slot each).
struct TickArgs {
  const float *pos, *quat, *linvel, *angvel;
  const bool* awake;
  const float* sleep_timer;
  const bool* alive;
  const int* motion_type;
  const float *bound_radius, *tin;
  float* out;
  int n;
};

constexpr int kTickBodies = 64;                         // bodies a block
constexpr int kTickLanes = 4;                           // lanes a body's region tests
constexpr int kTickThreads = kTickBodies * kTickLanes;  // 256
constexpr int kRegWords = kORad + kTinR - kOCtr;        // centres [64, 3], then radii
constexpr int kTickRound = 4;                           // region tests between votes
static_assert(kRegWords == kTickThreads, "a lane a word of the regions");
static_assert(kTinK <= kTickThreads, "a lane a slot id");
static_assert(4 * kTickBodies <= kTickThreads, "a lane a word of the tile's quat run");

__global__ void __launch_bounds__(kTickThreads) apply_tick_in_kernel(const TickArgs a) {
  __shared__ float s_reg[kRegWords];
  __shared__ float s_pos[3 * kTickBodies];
  __shared__ int s_row[kTickBodies];
  const int tid = threadIdx.x;
  const int n = a.n, b0 = blockIdx.x * kTickBodies;
  const int rows = min(kTickBodies, n - b0);
  const int b = tid / kTickLanes, q = tid % kTickLanes;
  const bool body = b < rows;
  // Every global load first, all in flight together.
  const float rv = a.tin[kOCtr + tid];
  const int id = tid < kTinK ? __float_as_int(a.tin[kOIdx + tid]) : 0;
  const bool in3 = tid < 3 * rows, in4 = tid < 4 * rows;
  const float vp = in3 ? a.pos[3 * b0 + tid] : 0.0f;
  const float vl = in3 ? a.linvel[3 * b0 + tid] : 0.0f;
  const float va = in3 ? a.angvel[3 * b0 + tid] : 0.0f;
  const float vq = in4 ? a.quat[4 * b0 + tid] : 0.0f;
  const int i = b0 + b;
  const bool dyn = body && a.alive[i] && a.motion_type[i] == kDynamic;
  const float br = body ? a.bound_radius[i] : 0.0f;
  const bool aw0 = body && q == 0 && a.awake[i];
  const float st0 = body && q == 0 ? a.sleep_timer[i] : 0.0f;
  if (tid < kTickBodies) s_row[tid] = -1;
  __syncthreads();
  s_reg[tid] = rv;
  // Lane j holds slot id j; a negative id counts from the end, as the
  // reference's scatter takes it (-1 is slot N - 1).
  if (tid < kTinK) {
    const unsigned rel = static_cast<unsigned>(id < 0 ? id + n : id) - static_cast<unsigned>(b0);
    if (rel < static_cast<unsigned>(rows)) atomicMax(&s_row[rel], tid);
  }
  __syncthreads();

  // The tile's runs of pose and velocities, word k of each by lane k; a
  // written body's words from its row (its loads together), the new
  // position also into shared memory for the region tests.
  if (in3) {
    const int r = s_row[tid / 3], c = tid % 3;
    float np = vp, nl = vl, na = va;
    if (r >= 0) {
      const float wp = a.tin[kOPos + 3 * r + c], vok = a.tin[kOVok + r];
      const float wl = a.tin[kOLv + 3 * r + c], wa = a.tin[kOAv + 3 * r + c];
      np = wp;
      if (vok > 0.0f) {
        nl = wl;
        na = wa;
      }
    }
    s_pos[tid] = np;
    float* o = a.out;
    const long long w = 3LL * b0 + tid;
    o[w] = np;
    o[7LL * n + w] = nl;
    o[10LL * n + w] = na;
  }
  if (in4) {
    const int r = s_row[tid >> 2];
    a.out[3LL * n + 4LL * b0 + tid] = r >= 0 ? a.tin[kORot + 4 * r + (tid & 3)] : vq;
  }
  __syncthreads();

  // The region wake on the new position: lane q of a body tests regions
  // q, q + 4, ...; lanes with nothing to test count as hit, so they never
  // hold their warp in the loop.
  const int row = body ? s_row[b] : -1;
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = body ? s_pos[3 * b + k] : 0.0f;
  const float* ctr = s_reg;
  const float* rad = s_reg + 3 * kTinR;
  bool hit = !dyn;
#pragma unroll 1
  for (int k = 0; k < kTinR / kTickLanes; k += kTickRound) {
    if (!hit) {
      // A round of independent tests (no branch or vote between them).
#pragma unroll
      for (int j = 0; j < kTickRound; ++j) {
        const int r = q + kTickLanes * (k + j);
        const float d0 = p[0] - ctr[3 * r + 0];
        const float d1 = p[1] - ctr[3 * r + 1];
        const float d2 = p[2] - ctr[3 * r + 2];
        const float dd = __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, d0 * d0));
        const float rr = (rad[r] + br) + 0.3f;
        hit |= dd <= rr * rr;
      }
    }
    if (__all_sync(kFull, hit)) break;
  }
  // Every lane shuffles (no short circuit: a lane that skips a shuffle
  // leaves its partner reading an undefined value).
  const bool h1 = __shfl_xor_sync(kFull, hit, 1);
  hit = hit || h1;
  const bool h2 = __shfl_xor_sync(kFull, hit, 2);
  hit = (hit || h2) && dyn;
  if (body && q == 0) {
    reinterpret_cast<bool*>(a.out + 14LL * n)[i] = row >= 0 || aw0 || hit;
    a.out[13LL * n + i] = (hit || row >= 0) ? 0.0f : st0;
  }
}

// KN's arguments (kernels/serving_io.py:_DIGEST_PACK, one 8-byte slot each).
struct DigestArgs {
  const bool *up, *down, *wet, *touch;
  const int *pa, *pb, *num_pairs, *overflow, *num_contacts, *num_awake, *steps_left;
  const float *pos, *quat, *linvel, *angvel;
  const bool* underwater;
  int* out;
  float* block;   // null: no transform block
  int* scratch;   // [ticket | tile counts 4 x T | touching words], the plan's
  int n, p;
};

constexpr int kWarps = kThreads / 32;   // a tile: kThreads slots, kWarps words
constexpr int kRow = 14;                // the transform block's floats a body

// The last block's ordered selection of one class, by one warp.  The
// class's total is a warp sum over its tile counts.  Then chunks of 32
// tiles, lane = tile: a warp scan of the counts gives each tile's first
// rank; a tile is active if it holds a set entry and its first rank is
// below `size` (64, or 128 touching pairs).  Each active lane loads its
// tile's 8 words together.  Where some tile holds more ranks to place than
// 8 x the active tiles, the warp walks the active tiles in order: for each
// word (broadcast by a shuffle), lane j takes bit j, its rank the tile's
// first rank plus the set bits below it, so 32 slots are placed at once;
// otherwise each active lane places its own tile's bits.  The chunks stop
// once `size` ranks are placed.  Touching ranks keep their slot in shared
// memory, and the warp gathers their (a, b) with all the loads in flight
// at once; then the -1 padding and the count.
__device__ void select_class(const DigestArgs& a, int c, int tiles, int wn, int lane,
                             int* s_sel) {
  const int size = c == 3 ? kEvt : kEvk;
  const int* cnt = a.scratch + 1 + c * tiles;
  const int* words = c == 3 ? a.scratch + 1 + 4 * tiles : a.out + kHead + c * wn;
  const int n_words = c == 3 ? (a.p + 31) / 32 : wn;
  int* slots = c == 3 ? a.out + 200 : a.out + c * kEvk;
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int t = lane; t < tiles; t += 32) total += __ldcg(cnt + t);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
  int base = 0;
  for (int c0 = 0; c0 < tiles && base < size; c0 += 32) {
    const int t = c0 + lane;
    const int ct = t < tiles ? __ldcg(cnt + t) : 0;
    int incl = ct;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int first = base + incl - ct;
    const bool active = ct > 0 && first < size;
    unsigned wv[kWarps];
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int w = t * kWarps + k;
      wv[k] = active && w < n_words ? static_cast<unsigned>(__ldcg(words + w)) : 0u;
    }
    const unsigned act = __ballot_sync(kFull, active);
    int most = active ? min(ct, size - first) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) most = max(most, __shfl_xor_sync(kFull, most, o));
    if (most <= kWarps * __popc(act)) {
      // Sparse tiles: each active lane places its own tile's set bits.
      if (active) {
        int rank = first;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          for (unsigned bits = wv[k]; bits != 0u && rank < size; bits &= bits - 1u, ++rank) {
            const int slot = 32 * (t * kWarps + k) + __ffs(bits) - 1;
            if (c == 3) {
              s_sel[rank] = slot;
            } else {
              slots[rank] = slot;
            }
          }
        }
      }
    } else {
      // Dense tiles: the warp places a word's 32 bits at once, tile by tile.
      for (unsigned left = act; left != 0u; left &= left - 1u) {
        const int tt = __ffs(left) - 1;
        int r = __shfl_sync(kFull, first, tt);
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          const unsigned word = __shfl_sync(kFull, wv[k], tt);
          const int rank = r + __popc(word & below);
          if (((word >> lane) & 1u) != 0u && rank < size) {
            const int slot = 32 * ((c0 + tt) * kWarps + k) + lane;
            if (c == 3) {
              s_sel[rank] = slot;
            } else {
              slots[rank] = slot;
            }
          }
          r += __popc(word);
        }
      }
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  const int placed = min(total, size);
  if (c == 3) {
    __syncwarp();
    int va[kEvt / 32], vb[kEvt / 32];
#pragma unroll
    for (int q = 0; q < kEvt / 32; ++q) {
      const int r = lane + 32 * q;
      const int slot = r < placed ? s_sel[r] : 0;
      va[q] = r < placed ? a.pa[slot] : -1;
      vb[q] = r < placed ? a.pb[slot] : -1;
    }
#pragma unroll
    for (int q = 0; q < kEvt / 32; ++q) {
      slots[2 * (lane + 32 * q)] = va[q];
      slots[2 * (lane + 32 * q) + 1] = vb[q];
    }
  } else {
    for (int r = placed + lane; r < size; r += 32) slots[r] = -1;
  }
  if (lane == 0) a.out[192 + c] = total;
}

__global__ void __launch_bounds__(kThreads) digest_tblock_kernel(const DigestArgs a) {
  __shared__ int s_cnt[4][kWarps];
  __shared__ float s_rows[kThreads * kRow];
  __shared__ int s_last;
  __shared__ int s_sel[kEvt];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = gridDim.x, n = a.n, p = a.p;
  const int wn = (n + 31) / 32;
  const int j = blockIdx.x * kThreads + tid;
  const int word = blockIdx.x * kWarps + warp;
  const int row0 = blockIdx.x * kThreads;
  const int rows = a.block != nullptr ? min(kThreads, n - row0) : 0;
  // Every global load first, all in flight together: the four masks'
  // flags and the tile's transform fields (coalesced reads of each).
  const bool in_n = j < n, in_p = j < p;
  const bool f_up = in_n && a.up[j], f_down = in_n && a.down[j];
  const bool f_wet = in_n && a.wet[j], f_touch = in_p && a.touch[j];
  float pv[3], lv[3], av[3], qv[4];
  bool uw = false;
  if (rows > 0) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int k = tid + kThreads * m;
      const bool ok = k < 3 * rows;
      pv[m] = ok ? a.pos[3 * row0 + k] : 0.0f;
      lv[m] = ok ? a.linvel[3 * row0 + k] : 0.0f;
      av[m] = ok ? a.angvel[3 * row0 + k] : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = tid + kThreads * m;
      qv[m] = k < 4 * rows ? a.quat[4 * row0 + k] : 0.0f;
    }
    uw = tid < rows && a.underwater[row0 + tid];
  }
  // Each warp's ballot over its 32 slots is that slot range's bit word.
  const unsigned b_up = __ballot_sync(kFull, f_up);
  const unsigned b_down = __ballot_sync(kFull, f_down);
  const unsigned b_wet = __ballot_sync(kFull, f_wet);
  const unsigned b_touch = __ballot_sync(kFull, f_touch);
  if (lane == 0) {
    if (word < wn) {
      a.out[kHead + word] = static_cast<int>(b_up);
      a.out[kHead + wn + word] = static_cast<int>(b_down);
      a.out[kHead + 2 * wn + word] = static_cast<int>(b_wet);
    }
    if (word < (p + 31) / 32) a.scratch[1 + 4 * tiles + word] = static_cast<int>(b_touch);
    s_cnt[0][warp] = __popc(b_up);
    s_cnt[1][warp] = __popc(b_down);
    s_cnt[2][warp] = __popc(b_wet);
    s_cnt[3][warp] = __popc(b_touch);
  }
  // The tile's transform rows, staged in shared memory and written out as
  // one contiguous run of floats.
  if (rows > 0) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int k = tid + kThreads * m;
      if (k < 3 * rows) {
        const int r = k / 3, c = k - 3 * r;
        s_rows[kRow * r + c] = pv[m];
        s_rows[kRow * r + 7 + c] = lv[m];
        s_rows[kRow * r + 10 + c] = av[m];
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = tid + kThreads * m;
      if (k < 4 * rows) s_rows[kRow * (k >> 2) + 3 + (k & 3)] = qv[m];
    }
    if (tid < rows) s_rows[kRow * tid + 13] = uw ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (rows > 0) {
    float* dst = a.block + static_cast<long long>(kRow) * row0;
    for (int k = tid; k < kRow * rows; k += kThreads) dst[k] = s_rows[k];
  }
  if (tid < 4) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += s_cnt[tid][w];
    a.scratch[1 + tid * tiles + blockIdx.x] = c;
  }
  // The last block to finish selects; it resets the ticket for the next
  // launch, so no call needs a memset.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.scratch, 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (warp < 4) {
    select_class(a, warp, tiles, wn, lane, s_sel);
  } else if (tid == 4 * 32) {
    a.out[196] = *a.num_pairs;
    a.out[197] = *a.overflow;
    a.out[198] = *a.num_contacts;
    a.out[199] = *a.num_awake;
    a.out[kHead - 1] = *a.steps_left;
    a.scratch[0] = 0;
  }
}

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/serving_io.py:_TICK_PACK): pos, quat, linvel, angvel, awake,
// sleep_timer, alive, motion_type, bound_radius, tick_in, out, N.
extern "C" int apply_tick_in(const long long* v, void* stream) {
  TickArgs a;
  a.pos = reinterpret_cast<const float*>(v[0]);
  a.quat = reinterpret_cast<const float*>(v[1]);
  a.linvel = reinterpret_cast<const float*>(v[2]);
  a.angvel = reinterpret_cast<const float*>(v[3]);
  a.awake = reinterpret_cast<const bool*>(v[4]);
  a.sleep_timer = reinterpret_cast<const float*>(v[5]);
  a.alive = reinterpret_cast<const bool*>(v[6]);
  a.motion_type = reinterpret_cast<const int*>(v[7]);
  a.bound_radius = reinterpret_cast<const float*>(v[8]);
  a.tin = reinterpret_cast<const float*>(v[9]);
  a.out = reinterpret_cast<float*>(v[10]);
  a.n = static_cast<int>(v[11]);
  if (a.n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n > 0) {
    apply_tick_in_kernel<<<(a.n + kTickBodies - 1) / kTickBodies, kTickThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/serving_io.py:_DIGEST_PACK): newly_awake, newly_asleep,
// entered_water, touching, pair_a, pair_b, num_pairs, overflow,
// num_contacts, num_awake, steps_left, pos, quat, linvel, angvel,
// underwater, out digest, block (0: none), scratch, N, P.
extern "C" int digest_tblock(const long long* v, void* stream) {
  auto ptr = [v](int k) { return reinterpret_cast<void*>(v[k]); };
  DigestArgs a;
  a.up = static_cast<const bool*>(ptr(0));
  a.down = static_cast<const bool*>(ptr(1));
  a.wet = static_cast<const bool*>(ptr(2));
  a.touch = static_cast<const bool*>(ptr(3));
  a.pa = static_cast<const int*>(ptr(4));
  a.pb = static_cast<const int*>(ptr(5));
  a.num_pairs = static_cast<const int*>(ptr(6));
  a.overflow = static_cast<const int*>(ptr(7));
  a.num_contacts = static_cast<const int*>(ptr(8));
  a.num_awake = static_cast<const int*>(ptr(9));
  a.steps_left = static_cast<const int*>(ptr(10));
  a.pos = static_cast<const float*>(ptr(11));
  a.quat = static_cast<const float*>(ptr(12));
  a.linvel = static_cast<const float*>(ptr(13));
  a.angvel = static_cast<const float*>(ptr(14));
  a.underwater = static_cast<const bool*>(ptr(15));
  a.out = static_cast<int*>(ptr(16));
  a.block = static_cast<float*>(ptr(17));
  a.scratch = static_cast<int*>(ptr(18));
  a.n = static_cast<int>(v[19]);
  a.p = static_cast<int>(v[20]);
  if (a.n < 0 || a.p < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int len = a.n > a.p ? a.n : a.p;
  const int tiles = len > 0 ? (len + kThreads - 1) / kThreads : 1;
  digest_tblock_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
