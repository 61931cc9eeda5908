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
// (:202-206); plain twin: serving_io.py:digest_tblock_plain.  Blocks 0-3
// each compact one event mask in order (newly awake, newly asleep, entered
// water, touching pairs): a warp ballot and popc give each set element its
// rank within the warp, the block adds the warps' counts in order, and the
// first 64 (128) ranks are written; the block also writes its count.  The
// remaining blocks write the [N, 14] transform block (unless `block` is null)
// and bit-pack the three body masks, one thread per body.  What bounds it on the card: bytes (the
// masks in, 56 bytes a body out).
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

// The ordered compaction of one mask by one block: the indices of its first
// `size` set entries (or, for the touching pairs, their (a, b)), -1 padded,
// and the total count.
__device__ void compact_block(const bool* __restrict__ mask, int len, int size,
                              const int* __restrict__ pa, const int* __restrict__ pb,
                              int* __restrict__ out, int* __restrict__ count) {
  __shared__ int s_warp[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int start = 0; start < len; start += blockDim.x) {
    const int j = start + tid;
    const bool f = j < len && mask[j];
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    const int rank = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (f && rank < size) {
      if (pa != nullptr) {
        out[2 * rank] = pa[j];
        out[2 * rank + 1] = pb[j];
      } else {
        out[rank] = j;
      }
    }
    base += total;
    __syncthreads();
  }
  for (int s = tid; s < size; s += blockDim.x) {
    if (s >= base) {
      if (pa != nullptr) {
        out[2 * s] = -1;
        out[2 * s + 1] = -1;
      } else {
        out[s] = -1;
      }
    }
  }
  if (tid == 0) *count = base;
}

__global__ void digest_tblock_kernel(
    const bool* __restrict__ up, const bool* __restrict__ down, const bool* __restrict__ wet,
    const bool* __restrict__ touch, const int* __restrict__ pa, const int* __restrict__ pb,
    const int* __restrict__ num_pairs, const int* __restrict__ overflow,
    const int* __restrict__ num_contacts, const int* __restrict__ num_awake,
    const int* __restrict__ steps_left, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ linvel,
    const float* __restrict__ angvel, const bool* __restrict__ underwater, int n, int p,
    int* __restrict__ out, float* __restrict__ block) {
  const int b = blockIdx.x;
  if (b == 0) {
    compact_block(up, n, kEvk, nullptr, nullptr, out, out + 192);
    if (threadIdx.x == 0) {
      out[196] = *num_pairs;
      out[197] = *overflow;
      out[198] = *num_contacts;
      out[199] = *num_awake;
      out[kHead - 1] = *steps_left;
    }
    return;
  }
  if (b == 1) {
    compact_block(down, n, kEvk, nullptr, nullptr, out + kEvk, out + 193);
    return;
  }
  if (b == 2) {
    compact_block(wet, n, kEvk, nullptr, nullptr, out + 2 * kEvk, out + 194);
    return;
  }
  if (b == 3) {
    compact_block(touch, p, kEvt, pa, pb, out + 200, out + 195);
    return;
  }
  const int i = (b - 4) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (block != nullptr) {
    float* row = block + 14 * i;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[k] = pos[3 * i + k];
      row[7 + k] = linvel[3 * i + k];
      row[10 + k] = angvel[3 * i + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) row[3 + k] = quat[4 * i + k];
    row[13] = underwater[i] ? 1.0f : 0.0f;
  }
  const int words = (n + 31) / 32;
  if (i < words) {
    const bool* masks[3] = {up, down, wet};
    for (int m = 0; m < 3; ++m) {
      unsigned bits = 0u;
      for (int j = 0; j < 32; ++j) {
        const int s = 32 * i + j;
        if (s < n && masks[m][s]) bits |= 1u << j;
      }
      out[kHead + m * words + i] = static_cast<int>(bits);
    }
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

extern "C" int digest_tblock(const bool* up, const bool* down, const bool* wet,
                             const bool* touch, const int* pa, const int* pb,
                             const int* num_pairs, const int* overflow, const int* num_contacts,
                             const int* num_awake, const int* steps_left, const float* pos,
                             const float* quat, const float* linvel, const float* angvel,
                             const bool* underwater, int n, int p, int* out, float* block,
                             void* stream) {
  const int blocks = 4 + (n + kThreads - 1) / kThreads;
  digest_tblock_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      up, down, wet, touch, pa, pb, num_pairs, overflow, num_contacts, num_awake, steps_left,
      pos, quat, linvel, angvel, underwater, n, p, out, block);
  return static_cast<int>(cudaGetLastError());
}
