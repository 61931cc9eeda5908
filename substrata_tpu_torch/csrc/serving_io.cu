// KM and KN: the serving tick's input apply, and its event digest and
// transform block.
//
// KM (apply_tick_in) replaces substrata_tpu/physics/world.py:
// _apply_transforms_wake (:305-325); plain twin:
// substrata_tpu_torch/kernels/serving_io.py:apply_tick_in_plain.  One thread
// per body.  Each block first stages the tick input's 128 slot ids and 64
// wake regions in shared memory; a thread then finds its body among the
// written rows (the host writes each slot at most once), applies the write,
// and tests the regions on the new position.  What bounds it on the card:
// bytes — it reads and writes the body's pose, velocities, awake flag and
// sleep timer (~70 bytes a body); the 64 region tests are ~600 operations a
// body against 10,240 x 70 = 0.7 MB.
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

__global__ void apply_tick_in_kernel(
    const float* __restrict__ pos, const float* __restrict__ quat,
    const float* __restrict__ linvel, const float* __restrict__ angvel,
    const bool* __restrict__ awake, const float* __restrict__ sleep_timer,
    const bool* __restrict__ alive, const int* __restrict__ motion_type,
    const float* __restrict__ bound_radius, const float* __restrict__ tin, int n,
    float* __restrict__ o_pos, float* __restrict__ o_quat, float* __restrict__ o_lv,
    float* __restrict__ o_av, bool* __restrict__ o_awake, float* __restrict__ o_sleep) {
  __shared__ int s_idx[kTinK];
  __shared__ float s_ctr[3 * kTinR], s_rad[kTinR];
  for (int j = threadIdx.x; j < kTinK; j += blockDim.x) s_idx[j] = __float_as_int(tin[kOIdx + j]);
  for (int j = threadIdx.x; j < 3 * kTinR; j += blockDim.x) s_ctr[j] = tin[kOCtr + j];
  for (int j = threadIdx.x; j < kTinR; j += blockDim.x) s_rad[j] = tin[kORad + j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row = -1;
  for (int j = 0; j < kTinK; ++j)
    if (s_idx[j] == i) row = j;
  float p[3], q[4], lv[3], av[3];
  const bool vel_row = row >= 0 && tin[kOVok + row] > 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = row >= 0 ? tin[kOPos + 3 * row + k] : pos[3 * i + k];
    lv[k] = vel_row ? tin[kOLv + 3 * row + k] : linvel[3 * i + k];
    av[k] = vel_row ? tin[kOAv + 3 * row + k] : angvel[3 * i + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = row >= 0 ? tin[kORot + 4 * row + k] : quat[4 * i + k];
  const bool aw = row >= 0 ? true : awake[i];
  const float st = row >= 0 ? 0.0f : sleep_timer[i];
  // Region wake on the new position (a -1e9 pad radius squares to 1e18 and
  // so meets every body, as in the reference).
  const float br = bound_radius[i];
  bool hit = false;
  for (int r = 0; r < kTinR; ++r) {
    const float d0 = p[0] - s_ctr[3 * r + 0];
    const float d1 = p[1] - s_ctr[3 * r + 1];
    const float d2 = p[2] - s_ctr[3 * r + 2];
    const float dd = d0 * d0 + d1 * d1 + d2 * d2;
    const float rr = (s_rad[r] + br) + 0.3f;
    hit = hit || dd <= rr * rr;
  }
  hit = hit && alive[i] && motion_type[i] == kDynamic;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_pos[3 * i + k] = p[k];
    o_lv[3 * i + k] = lv[k];
    o_av[3 * i + k] = av[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) o_quat[4 * i + k] = q[k];
  o_awake[i] = aw || hit;
  o_sleep[i] = hit ? 0.0f : st;
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
constexpr unsigned kFull = 0xffffffffu;

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

extern "C" int apply_tick_in(const float* pos, const float* quat, const float* linvel,
                             const float* angvel, const bool* awake, const float* sleep_timer,
                             const bool* alive, const int* motion_type,
                             const float* bound_radius, const float* tin, int n, float* o_pos,
                             float* o_quat, float* o_lv, float* o_av, bool* o_awake,
                             float* o_sleep, void* stream) {
  if (n > 0) {
    apply_tick_in_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pos, quat, linvel, angvel, awake, sleep_timer, alive, motion_type, bound_radius, tin, n,
        o_pos, o_quat, o_lv, o_av, o_awake, o_sleep);
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
