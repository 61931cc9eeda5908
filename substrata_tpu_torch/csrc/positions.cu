// Kernel KU: the split-impulse, translation-only position solve (K7).
//
// Replaces substrata_tpu/physics/solver.py:solve_positions (:477); plain
// twin: substrata_tpu_torch/kernels/positions.py:solve_positions_plain.
//
// Each iteration is two launches.  The entry pass, one thread per pair
// entry: the residual penetration of each of its wm rows (the entry's
// bodies' displacement since the solve began, dotted with the normal), the
// push max(pen - slop, 0) * beta, divided by the entry's summed inverse
// mass (a true division, as the reference divides by a traced value), and
// the impulse summed over the rows.  The body pass, one thread per body:
// its static rows' pushes (the same over its K rows, divided by its own
// inverse mass), its entries' impulses gathered through the incidence table
// in slot order and signed, and the move.  Positions ping-pong between two
// buffers, so a pass never reads what another thread of it writes.  Every
// sum runs in the twin's order (first term, then each next one added), and
// -fmad=false keeps each product and sum rounded apart, as the twin's.
//
// What bounds it: memory.  At the bench shapes (10,240 bodies x 4 static
// rows, 16,384 entries x 4 rows, 8 table slots) an iteration reads ~5 MB of
// normals, penetrations and tables; the body pass's gather reads 12 bytes
// per table slot.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp_min0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ float im_of(const float* inv_mass, const bool* awake, int i) {
  return inv_mass[i] * static_cast<float>(awake[i]);
}

// (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3_seq(const float a[3], const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__global__ void __launch_bounds__(kThreads)
positions_entry_kernel(const float* __restrict__ pos, const float* __restrict__ pos0,
                       const float* __restrict__ inv_mass, const bool* __restrict__ awake,
                       const int* __restrict__ pa, const int* __restrict__ pb,
                       const bool* __restrict__ valid, const float* __restrict__ normal,
                       const float* __restrict__ pen, const float* __restrict__ slop_p, float beta,
                       int Q, int WM, int first, float* __restrict__ imp) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float slop = *slop_p;
  const int a = max(pa[q * WM], 0), b = max(pb[q * WM], 0);
  float w_sum = im_of(inv_mass, awake, a) + im_of(inv_mass, awake, b);
  w_sum = w_sum < 1e-9f ? 1e-9f : w_sum;
  float dp[3];
  if (!first) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dp[k] = (pos[a * 3 + k] - pos0[a * 3 + k]) - (pos[b * 3 + k] - pos0[b * 3 + k]);
  }
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < WM; ++j) {
    const int r = q * WM + j;
    const float* nrm = normal + static_cast<size_t>(r) * 3;
    const float pr = first ? pen[r] : pen[r] - dot3_seq(dp, nrm);
    const float push = clamp_min0(pr - slop) * beta;
    const float c = push / w_sum * (valid[r] ? 1.0f : 0.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = j == 0 ? nrm[k] * c : acc[k] + nrm[k] * c;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) imp[q * 3 + k] = acc[k];
}

__global__ void __launch_bounds__(kThreads)
positions_body_kernel(const float* __restrict__ pos, const float* __restrict__ pos0,
                      const float* __restrict__ inv_mass, const bool* __restrict__ awake,
                      const bool* __restrict__ s_valid, const float* __restrict__ s_normal,
                      const float* __restrict__ s_pen, const int* __restrict__ table,
                      const float* __restrict__ sign, const float* __restrict__ imp,
                      const float* __restrict__ slop_p, float beta, int N, int K, int CPB,
                      int first,
                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float slop = *slop_p;
  const float im = im_of(inv_mass, awake, i);
  const float w_s = im < 1e-9f ? 1e-9f : im;
  float p[3], ds[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = pos[i * 3 + k];
    ds[k] = p[k] - pos0[i * 3 + k];
  }
  float dpos_s[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < K; ++j) {
    const int r = i * K + j;
    const float* nrm = s_normal + static_cast<size_t>(r) * 3;
    const float pr = first ? s_pen[r] : s_pen[r] - dot3_seq(ds, nrm);
    const float push = clamp_min0(pr - slop) * beta;
    const float c = push / w_s * (s_valid[r] ? 1.0f : 0.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) dpos_s[k] = j == 0 ? nrm[k] * c : dpos_s[k] + nrm[k] * c;
  }
  float g[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < CPB; ++s) {
    const int t = table[i * CPB + s];
    const int ts = max(t, 0);
    const float sg = sign[i * CPB + s];
    const float v = t >= 0 ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = imp[ts * 3 + k] * sg * v;
      g[k] = s == 0 ? x : g[k] + x;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[i * 3 + k] = p[k] + im * (g[k] + dpos_s[k]);
}

}  // namespace

// pos0: the positions after integration (read only); buf: [N, 3] scratch;
// out: the result; imp: [Q, 3] scratch.
extern "C" int solve_positions(const float* pos0, const float* inv_mass, const bool* awake,
                               const bool* s_valid, const float* s_normal, const float* s_pen,
                               const int* pa, const int* pb, const bool* p_valid,
                               const float* p_normal, const float* p_pen, const int* table,
                               const float* sign, const float* slop, float beta, int N, int K,
                               int Q, int WM, int CPB, int iters, float* imp, float* buf,
                               float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cur = pos0;
  for (int it = 0; it < iters; ++it) {
    // The last iteration lands in out; the ones before alternate so that
    // no pass writes the buffer it reads.
    float* dst = ((iters - 1 - it) % 2 == 0) ? out : buf;
    if (Q > 0) {
      positions_entry_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          cur, pos0, inv_mass, awake, pa, pb, p_valid, p_normal, p_pen, slop, beta, Q, WM,
          it == 0, imp);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    positions_body_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        cur, pos0, inv_mass, awake, s_valid, s_normal, s_pen, table, sign, imp, slop, beta, N,
        K, CPB, it == 0, dst);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = dst;
  }
  return 0;
}
