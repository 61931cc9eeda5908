// Kernel KU: the split-impulse, translation-only position solve (K7).
//
// Replaces substrata_tpu/physics/solver.py:solve_positions (:477); plain
// twin: substrata_tpu_torch/kernels/positions.py:solve_positions_plain.
//
// One launch an iteration.  Each body takes a group of G lanes (G the power
// of two at or above its table slots CPB and static rows K, at most 32):
// lane s computes table slot s's entry impulse itself, with the operations
// of the twin's entry pass in its order (the entry's summed inverse mass,
// its bodies' displacement since the solve began, each of its wm rows'
// residual penetration, push max(pen - slop, 0) beta, a true division by
// the summed mass, the rows' running sum), then signs it; lane j < K
// computes static row j's push.  An entry is computed by both of its bodies
// and gives both the same bits.  The group's first lane adds the shuffled
// values in slot order (first term, then each next one added: the twin's
// _seq_sum; no atomics, no tree) and moves the body.  Slots and rows past G
// take further rounds of the same lanes, in order.  Positions ping-pong
// between two buffers, so a launch never reads what another thread of it
// writes.  -fmad=false keeps each product and sum rounded apart, as the
// twin's.
//
// What bounds it: latency, not bytes.  At the bench shapes (10,240 bodies
// x 4 static rows, 16,384 entries x 4 rows, 8 table slots) an iteration
// reads each static row once and each entry's rows twice (once a body),
// ~4 MB, against ~1 µs of memory time; a slot's lane waits on three
// dependent loads (its table entry, the entry's ids, their masses and
// positions).  Every load of a lane's rows is issued before its first use.
#include "common.cuh"

#include <cstdint>

// One packed argument (kernels/positions.py:_PACK).
struct PositionsArgs {
  const float* pos0;
  const float* inv_mass;
  const bool* awake;
  const bool* s_valid;
  const float* s_normal;
  const float* s_pen;
  const int* pa;
  const int* pb;
  const bool* p_valid;
  const float* p_normal;
  const float* p_pen;
  const int* table;
  const float* sign;
  const float* slop;
  float* buf;
  float* out;
  int64_t N, K, Q, WM, CPB, iters;
  double beta;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;   // WM a slot's entry may hold (the manifold width)

__device__ __forceinline__ float clamp_min0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ float im_of(const float* inv_mass, const bool* awake, int i) {
  return inv_mass[i] * static_cast<float>(awake[i]);
}

// (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3_seq(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// The impulse of entry q (the twin's imp[q]): its wm rows' pushes over the
// entry's summed inverse mass, times the normals, summed in row order.
__device__ __forceinline__ void entry_impulse(const PositionsArgs& A,
                                              const float* __restrict__ cur, int q, int WM,
                                              bool first, float slop, float beta,
                                              float acc[3]) {
  const int a = max(A.pa[q * WM], 0), b = max(A.pb[q * WM], 0);
  float nrm[kMaxRows][3], pen[kMaxRows], vf[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < WM) {
      const int r = q * WM + j;
      nrm[j][0] = A.p_normal[3 * r];
      nrm[j][1] = A.p_normal[3 * r + 1];
      nrm[j][2] = A.p_normal[3 * r + 2];
      pen[j] = A.p_pen[r];
      vf[j] = A.p_valid[r] ? 1.0f : 0.0f;
    }
  }
  float w_sum = im_of(A.inv_mass, A.awake, a) + im_of(A.inv_mass, A.awake, b);
  w_sum = w_sum < 1e-9f ? 1e-9f : w_sum;
  float dp[3] = {0.0f, 0.0f, 0.0f};
  if (!first) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dp[k] = (cur[a * 3 + k] - A.pos0[a * 3 + k]) - (cur[b * 3 + k] - A.pos0[b * 3 + k]);
  }
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < WM) {
      const float pr = first ? pen[j] : pen[j] - dot3_seq(dp, nrm[j]);
      const float push = clamp_min0(pr - slop) * beta;
      const float c = push / w_sum * vf[j];
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = j == 0 ? nrm[j][k] * c : acc[k] + nrm[j][k] * c;
    }
  }
}

// The group's first lane adds x of lanes 0..n-1 (lane order) into acc:
// acc = x_0 where `start`, else acc + x_0; then + x_1, ...  Every lane of
// the warp takes part in the shuffles.
__device__ __forceinline__ void fold3(float x[3], int base, int n, bool start, float acc[3]) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float y = __shfl_sync(0xffffffffu, x[k], base + j);
      acc[k] = (start && j == 0) ? y : acc[k] + y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
positions_kernel(const PositionsArgs A, const float* __restrict__ cur, float* __restrict__ dst,
                 int G, int first) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / G, lane = t % G;
  const int base = (threadIdx.x & 31) - lane;
  const int N = static_cast<int>(A.N), K = static_cast<int>(A.K);
  const int Q = static_cast<int>(A.Q), WM = static_cast<int>(A.WM);
  const int CPB = static_cast<int>(A.CPB);
  const bool body = i < N;
  const float slop = *A.slop;
  const float beta = static_cast<float>(A.beta);
  float im = 0.0f, p[3] = {0.0f, 0.0f, 0.0f}, ds[3] = {0.0f, 0.0f, 0.0f};
  if (body) {
    im = im_of(A.inv_mass, A.awake, i);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = cur[i * 3 + k];
      ds[k] = p[k] - A.pos0[i * 3 + k];
    }
  }
  const float w_s = im < 1e-9f ? 1e-9f : im;

  // The static rows: lane j takes row j (then j + G, ...).
  float dpos_s[3] = {0.0f, 0.0f, 0.0f};
  for (int r0 = 0; r0 < K; r0 += G) {
    float x[3] = {0.0f, 0.0f, 0.0f};
    const int j = r0 + lane;
    if (body && j < K) {
      const int r = i * K + j;
      const float nrm[3] = {A.s_normal[3 * r], A.s_normal[3 * r + 1], A.s_normal[3 * r + 2]};
      const float sp = A.s_pen[r];
      const float vf = A.s_valid[r] ? 1.0f : 0.0f;
      const float pr = first ? sp : sp - dot3_seq(ds, nrm);
      const float c = clamp_min0(pr - slop) * beta / w_s * vf;
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = nrm[k] * c;
    }
    fold3(x, base, min(G, K - r0), r0 == 0, dpos_s);
  }

  // The table: lane s takes slot s (then s + G, ...) and computes its entry.
  float g[3] = {0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < CPB; s0 += G) {
    float x[3] = {0.0f, 0.0f, 0.0f};
    const int s = s0 + lane;
    if (body && s < CPB && Q > 0) {
      const int tt = A.table[i * CPB + s];
      const float sg = A.sign[i * CPB + s];
      const float v = tt >= 0 ? 1.0f : 0.0f;
      float imp[3];
      entry_impulse(A, cur, max(tt, 0), WM, first, slop, beta, imp);
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = imp[k] * sg * v;
    }
    fold3(x, base, min(G, CPB - s0), s0 == 0, g);
  }

  if (body && lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) dst[i * 3 + k] = p[k] + im * (g[k] + dpos_s[k]);
  }
}

}  // namespace

// One packed argument (kernels/positions.py:_PACK): the inputs, the
// position scratch and the output; N, K, Q, WM, CPB, iters; beta.
extern "C" int solve_positions(const PositionsArgs* args, void* stream) {
  const PositionsArgs A = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A.WM > kMaxRows || A.WM < 1) return static_cast<int>(cudaErrorInvalidValue);
  int G = 1;
  while (G < A.CPB || G < A.K) G <<= 1;
  if (G > 32) G = 32;
  const long long threads = A.N * static_cast<long long>(G);
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const float* cur = A.pos0;
  for (int it = 0; it < A.iters; ++it) {
    // The last iteration lands in out; the ones before alternate so that
    // no launch writes the buffer it reads.
    float* dst = ((A.iters - 1 - it) % 2 == 0) ? A.out : A.buf;
    if (blocks > 0) positions_kernel<<<blocks, kThreads, 0, st>>>(A, cur, dst, G, it == 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = dst;
  }
  return 0;
}
