// Shared device helpers for the substrata_tpu_torch kernels.
//
// Every helper repeats, operation for operation and in the same order, the
// plain PyTorch twin it stands beside (maths/quat.py, kernels/*.py).  The
// library is built with -fmad=false, so no multiply-add is contracted and
// each kernel rounds like its twin.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sbt {

constexpr float kContactMargin = 0.04f;

__device__ __forceinline__ float sgn(float x) { return x < 0.0f ? -1.0f : 1.0f; }

// maths/quat.py:to_matrix
__device__ __forceinline__ void quat_to_matrix(const float q[4], float r[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  r[0][0] = 1.0f - 2.0f * (yy + zz); r[0][1] = 2.0f * (xy - wz); r[0][2] = 2.0f * (xz + wy);
  r[1][0] = 2.0f * (xy + wz); r[1][1] = 1.0f - 2.0f * (xx + zz); r[1][2] = 2.0f * (yz - wx);
  r[2][0] = 2.0f * (xz - wy); r[2][1] = 2.0f * (yz + wx); r[2][2] = 1.0f - 2.0f * (xx + yy);
}

// out[i] = sum_k m[k][i] v[k]   (m^T v)
__device__ __forceinline__ void mtv(const float m[3][3], const float v[3], float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[0][i] * v[0] + m[1][i] * v[1] + m[2][i] * v[2];
}

// out[k] = sum_j m[k][j] v[j]   (m v)
__device__ __forceinline__ void mv(const float m[3][3], const float v[3], float out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = m[k][0] * v[0] + m[k][1] * v[1] + m[k][2] * v[2];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// maths/quat.py:cross
__device__ __forceinline__ void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// maths/quat.py:rotate_vec: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ void rotate_vec(const float q[4], const float v[3], float o[3]) {
  const float u[3] = {q[0], q[1], q[2]};
  float uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[3] * uv[k] + uuv[k]);
}

// The broadphase cell hash (kernels/cell_table.py:hash_cells): int32
// products that wrap, xor, and the modulo taken as uint32.  KP builds the
// table with it and KS reads the table's stencil with it.
__device__ __forceinline__ int cell_hash(int c0, int c1, int c2, int nb) {
  const uint32_t h = (static_cast<uint32_t>(c0) * 73856093u) ^
                     (static_cast<uint32_t>(c1) * 19349663u) ^
                     (static_cast<uint32_t>(c2) * 83492791u);
  return static_cast<int>(h % static_cast<uint32_t>(nb));
}

// Exclusive prefix sum over a block of up to 1024 threads (blockDim.x a
// multiple of 32); ``warp_tot`` is 32 ints of shared memory.  Returns the
// sum of the values of the lower threads; *total gets the block's sum.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < n_warps ? warp_tot[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) warp_tot[lane] = w;
  }
  __syncthreads();
  const T before = (warp > 0 ? warp_tot[warp - 1] : T(0)) + x - v;
  *total = warp_tot[n_warps - 1];
  __syncthreads();
  return before;
}

// Sum over a block (every thread gets it); ``warp_tot`` as above.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_tot) {
  T total;
  block_exclusive_scan(v, warp_tot, &total);
  return total;
}

// Round to bfloat16 (nearest even) and back, as tensor.to(torch.bfloat16).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace sbt
