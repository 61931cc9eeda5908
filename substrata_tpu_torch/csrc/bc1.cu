// Kernel KAC: BC1 (DXT1) encoding of every 4x4 block of a texture's mip
// chain in one launch (K18).
//
// Replaces substrata_tpu/shared/texture_compress.py:_bc1_kernel (:46,
// jitted at :120); plain twin: substrata_tpu_torch/kernels/bc1.py:
// bc1_encode_plain.
//
// One thread per block: a short serial program of a range fit, two
// least-squares refinements (assign each pixel to its nearest palette
// entry, solve the 2x2 normal equations for new endpoints), RGB565
// quantisation, the swap to the 4-colour mode and the final index pick
// against the quantised palette.  Every sum runs in the twin's order as an
// fma chain (__fmaf_rn; the library builds with -fmad=false, so nothing
// else contracts), the argmins keep the first minimum (strict <), the
// quantiser multiplies by fl(31 fl(1/255)) and fl(63 fl(1/255)), XLA's
// folded constants, and rounds half to even
// (rintf), the reciprocal of the determinant is a true division.  So the
// words equal the twin's bit for bit.
//
// A CTA of 128 threads first stages its 128 blocks (128 x 192 B = 24 KB)
// in shared memory with coalesced 16-byte loads; each thread then reads
// its 48 floats from there.  Output: two 32-bit words a block, one 8-byte
// store.
//
// What bounds it: bytes (192 B read and 8 B written a block: ~83 us for a
// 4096^2 chain's 1,398,103 blocks at 3.35 TB/s), against ~2.6 kFLOP a block
// (~54 us at 67 TFLOP/s).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockFloats = 48;

// Palette weight of c0 by index, as float32 (c1's is 1 - w, rounded).
__constant__ float kW[4] = {1.0f, 0.0f, 0.666666687f, 0.333333343f};

__device__ __forceinline__ void palette(const float c0[3], const float c1[3], float pal[4][3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) pal[k][c] = __fmaf_rn(kW[k], c0[c], (1.0f - kW[k]) * c1[c]);
}

__device__ __forceinline__ int nearest(const float* px, const float pal[4][3]) {
  float best = 0.0f;
  int idx = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e0 = px[0] - pal[k][0], e1 = px[1] - pal[k][1], e2 = px[2] - pal[k][2];
    const float d = __fmaf_rn(e2, e2, __fmaf_rn(e1, e1, e0 * e0));
    if (k == 0 || d < best) {
      best = d;
      idx = k;
    }
  }
  return idx;
}

__device__ __forceinline__ unsigned q565(const float c[3], float p[3]) {
  const float r = fminf(fmaxf(rintf(c[0] * 0.121568635f), 0.0f), 31.0f);
  const float g = fminf(fmaxf(rintf(c[1] * 0.247058839f), 0.0f), 63.0f);
  const float b = fminf(fmaxf(rintf(c[2] * 0.121568635f), 0.0f), 31.0f);
  p[0] = r * 8.22580624f;
  p[1] = g * 4.04761934f;
  p[2] = b * 8.22580624f;
  return (static_cast<unsigned>(r) << 11) | (static_cast<unsigned>(g) << 5) |
         static_cast<unsigned>(b);
}

__global__ void __launch_bounds__(kThreads)
bc1_kernel(const float* __restrict__ blocks, int2* __restrict__ out, int nb) {
  __shared__ float4 stage[kThreads * kBlockFloats / 4];
  const int first = blockIdx.x * kThreads;
  const int n_here = min(kThreads, nb - first);
  const float4* src = reinterpret_cast<const float4*>(blocks + static_cast<size_t>(first) * kBlockFloats);
  const int n_vec = n_here * kBlockFloats / 4;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) stage[i] = src[i];
  __syncthreads();
  if (threadIdx.x >= n_here) return;

  float px[16][3];
  const float* mine = reinterpret_cast<const float*>(stage) + threadIdx.x * kBlockFloats;
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c) px[p][c] = mine[p * 3 + c];

  float c0[3], c1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float mx = px[0][c], mn = px[0][c];
#pragma unroll
    for (int p = 1; p < 16; ++p) {
      mx = fmaxf(mx, px[p][c]);
      mn = fminf(mn, px[p][c]);
    }
    c0[c] = mx;
    c1[c] = mn;
  }

  float pal[4][3];
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    palette(c0, c1, pal);
    float sww = 0.0f, swv = 0.0f, svv = 0.0f, bw[3], bv[3];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float w = kW[nearest(px[p], pal)];
      const float v = 1.0f - w;
      if (p == 0) {
        sww = w * w;
        swv = w * v;
        svv = v * v;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bw[c] = w * px[0][c];
          bv[c] = v * px[0][c];
        }
      } else {
        sww = __fmaf_rn(w, w, sww);
        swv = __fmaf_rn(w, v, swv);
        svv = __fmaf_rn(v, v, svv);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bw[c] = __fmaf_rn(w, px[p][c], bw[c]);
          bv[c] = __fmaf_rn(v, px[p][c], bv[c]);
        }
      }
    }
    const float det = __fmaf_rn(sww, svv, -(swv * swv));
    if (fabsf(det) > 1e-6f) {
      const float inv = __fdiv_rn(1.0f, det);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float n0 = __fmaf_rn(svv, bw[c], -(swv * bv[c])) * inv;
        const float n1 = __fmaf_rn(sww, bv[c], -(swv * bw[c])) * inv;
        c0[c] = fminf(fmaxf(n0, 0.0f), 255.0f);
        c1[c] = fminf(fmaxf(n1, 0.0f), 255.0f);
      }
    }
  }

  float p0[3], p1[3];
  unsigned w0 = q565(c0, p0), w1 = q565(c1, p1);
  if (w0 < w1) {
    const unsigned t = w0;
    w0 = w1;
    w1 = t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f = p0[c];
      p0[c] = p1[c];
      p1[c] = f;
    }
  }
  unsigned bits = 0;
  if (w0 != w1) {
    palette(p0, p1, pal);
#pragma unroll
    for (int p = 0; p < 16; ++p) bits |= static_cast<unsigned>(nearest(px[p], pal)) << (2 * p);
  }
  out[first + threadIdx.x] = make_int2(static_cast<int>(w0 | (w1 << 16)), static_cast<int>(bits));
}

}  // namespace

extern "C" int bc1_encode(const float* blocks, int* out, int nb, void* stream) {
  if (nb == 0) return 0;
  const int grid = (nb + kThreads - 1) / kThreads;
  bc1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, reinterpret_cast<int2*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}
