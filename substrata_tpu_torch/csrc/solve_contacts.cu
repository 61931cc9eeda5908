// KC: one projected-Jacobi (FISTA) iteration of the contact solve, and the
// warm-start pre-apply, as two ordered launches with no atomics.
//
// Replaces the iteration body and warm-start apply of
// substrata_tpu/physics/solver.py:solve_contacts (:336-401, :427-428); plain
// twin: substrata_tpu_torch/kernels/solve.py:solve_iteration_plain.
//
// The rows come in KQ's component-major layout (kernels/solve.py:
// row_layout): a [.., 3, 3] block of R rows is stored [9, R], a [.., 3]
// vector and the FISTA state [3, R], the incidence table and its weights
// slot-major.
//
// solve_rows: a thread per contact row, so the loads of a warp's rows
// coalesce.  The static rows take the first blocks, each body's K rows on K
// adjacent lanes (a group padded to a power of two, so no group straddles a
// warp); the pair rows take the rest, each entry's wm rows on wm adjacent
// lanes.  A row gets the projected update and the FISTA extrapolation
// (pair rows read both bodies' velocities rounded to bf16), writes its
// impulse triple, and its change weighted by the directions.  The group's
// first lane then folds the lanes' values in row order, adding each
// shuffled value in series exactly as the twin's _seq_sum does (no tree,
// no atomics), and writes the body's static sums or the entry's [9] bf16
// impulse block once.
// solve_bodies: a thread per body gathers its CPB entry blocks through the
// incidence table (slot-major, so the table and weight loads coalesce; the
// 18-byte blocks are a gather either way), weights them by side, folds in
// slot order in f32 and updates the velocities.
//
// What bounds it on the card: bytes.  A row pass reads the per-row
// constants (~130 bytes a static row, ~190 a pair row) and the carried
// impulses and writes the new ones; at the bench shapes (40,960 static +
// 65,536 pair rows) that is ~20 MB per iteration against ~60 flops per
// row.
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kThreads = 128;

struct PassArgs {
  const float *s_dir, *s_ang, *s_r, *s_k, *s_target, *s_fric, *s_valid, *s_y, *s_l;
  const float *p_dir, *p_ang_a, *p_ang_b, *p_ra, *p_rb, *p_k, *p_target, *p_fric, *p_valid;
  const int* p_ab;
  const float *p_y, *p_l, *linvel, *angvel;
  float *o_s_y, *o_s_l, *o_p_y, *o_p_l, *dlin_s, *dang_s;
  __nv_bfloat16* block;
  int N, K, Kp, Q, WM, WMp, static_blocks, warm;
  float beta;
};

struct RowOut {
  float y[3], l[3], d[3];
};

// kernels/solve.py:_project for one row; dir [9] = (n, t1, t2); the dot
// products are dot3_fma, as the jitted reference reduces them.
__device__ __forceinline__ void project(const float v[3], const float dir[9], const float k[3],
                                        float target, float fric, const float y[3],
                                        const float l_old[3], float beta, RowOut& o) {
  const float vn = sbt::dot3_fma(v, dir);
  const float ln = fmaxf(y[0] + (target - vn) / k[0], 0.0f);
  const float vt1 = sbt::dot3_fma(v, dir + 3);
  const float vt2 = sbt::dot3_fma(v, dir + 6);
  const float mf = fric * ln;
  const float lt1 = fminf(fmaxf(y[1] - vt1 / k[1], -mf), mf);
  const float lt2 = fminf(fmaxf(y[2] - vt2 / k[2], -mf), mf);
  o.l[0] = ln;
  o.l[1] = lt1;
  o.l[2] = lt2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.y[c] = __fmaf_rn(beta, o.l[c] - l_old[c], o.l[c]);   // l + beta (l - l0), contracted
    o.d[c] = o.y[c] - y[c];
  }
}

// d0 m[0..2] + d1 m[3..5] + d2 m[6..8] as the jitted reference contracts
// it, fma(d2, m2, fma(d0, m0, d1 m1)), times the row's validity.
__device__ __forceinline__ void dir_sum(const float d[3], const float m[9], float valid,
                                        float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fmaf_rn(d[2], m[6 + c], __fmaf_rn(d[0], m[c], d[1] * m[3 + c])) * valid;
}

// The 9 components of row r of a component-major [9, R] block.
__device__ __forceinline__ void load9(const float* __restrict__ m, int R, int r, float out[9]) {
#pragma unroll
  for (int c = 0; c < 9; ++c) out[c] = m[c * R + r];
}

// The group's first lane gets x[0] + x[1] + ... + x[g - 1] of its g lanes,
// added in lane order (every lane of the warp takes part in the shuffles).
template <int M>
__device__ __forceinline__ void fold_in_order(float x[M], int lane, int gp, int g) {
  const int base = (threadIdx.x & 31) - lane;
  float acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) acc[c] = x[c];
  for (int j = 1; j < gp; ++j) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const float y = __shfl_sync(0xffffffffu, x[c], base + j);
      if (j < g) acc[c] = acc[c] + y;
    }
  }
#pragma unroll
  for (int c = 0; c < M; ++c) x[c] = acc[c];
}

__device__ __forceinline__ void static_rows(const PassArgs& A) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = t / A.Kp, lane = t % A.Kp;
  const int S = A.N * A.K;
  const bool active = n < A.N && lane < A.K;
  const int r = n * A.K + lane;
  float sums[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    RowOut o;
    float dir[9], ang[9];
    load9(A.s_dir, S, r, dir);
    load9(A.s_ang, S, r, ang);
    if (A.warm) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o.d[c] = A.s_y[c * S + r];
    } else {
      float y[3], l[3], k[3], rr[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y[c] = A.s_y[c * S + r];
        l[c] = A.s_l[c * S + r];
        k[c] = A.s_k[c * S + r];
        rr[c] = A.s_r[c * S + r];
      }
      const float lv[3] = {A.linvel[n * 3], A.linvel[n * 3 + 1], A.linvel[n * 3 + 2]};
      const float av[3] = {A.angvel[n * 3], A.angvel[n * 3 + 1], A.angvel[n * 3 + 2]};
      float cr[3], v[3];
      sbt::cross_fma(av, rr, cr);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = lv[c] + cr[c];
      project(v, dir, k, A.s_target[r], A.s_fric[r], y, l, A.beta, o);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        A.o_s_y[c * S + r] = o.y[c];
        A.o_s_l[c * S + r] = o.l[c];
      }
    }
    const float valid = A.s_valid[r];
    dir_sum(o.d, dir, valid, sums);
    dir_sum(o.d, ang, valid, sums + 3);
  }
  fold_in_order<6>(sums, lane, A.Kp, A.K);
  if (lane == 0 && n < A.N) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A.dlin_s[n * 3 + c] = sums[c];
      A.dang_s[n * 3 + c] = sums[3 + c];
    }
  }
}

__device__ __forceinline__ void pair_rows(const PassArgs& A) {
  const int t = (blockIdx.x - A.static_blocks) * blockDim.x + threadIdx.x;
  const int q = t / A.WMp, lane = t % A.WMp;
  const int P = A.Q * A.WM;
  const bool active = q < A.Q && lane < A.WM;
  const int r = q * A.WM + lane;
  float bl[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) bl[c] = 0.0f;
  if (active) {
    RowOut o;
    float dir[9], ang_a[9], ang_b[9];
    load9(A.p_dir, P, r, dir);
    load9(A.p_ang_a, P, r, ang_a);
    load9(A.p_ang_b, P, r, ang_b);
    if (A.warm) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o.d[c] = A.p_y[c * P + r];
    } else {
      const int a = A.p_ab[q], b = A.p_ab[A.Q + q];
      float wa[6], wb[6];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        wa[c] = sbt::round_bf16(A.linvel[a * 3 + c]);
        wa[3 + c] = sbt::round_bf16(A.angvel[a * 3 + c]);
        wb[c] = sbt::round_bf16(A.linvel[b * 3 + c]);
        wb[3 + c] = sbt::round_bf16(A.angvel[b * 3 + c]);
      }
      float y[3], l[3], k[3], ra[3], rb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y[c] = A.p_y[c * P + r];
        l[c] = A.p_l[c * P + r];
        k[c] = A.p_k[c * P + r];
        ra[c] = A.p_ra[c * P + r];
        rb[c] = A.p_rb[c * P + r];
      }
      float ca[3], cb[3], v[3];
      sbt::cross_fma(wa + 3, ra, ca);
      sbt::cross_fma(wb + 3, rb, cb);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = (wa[c] + ca[c]) - (wb[c] + cb[c]);
      project(v, dir, k, A.p_target[r], A.p_fric[r], y, l, A.beta, o);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        A.o_p_y[c * P + r] = o.y[c];
        A.o_p_l[c * P + r] = o.l[c];
      }
    }
    const float valid = A.p_valid[r];
    dir_sum(o.d, dir, valid, bl);
    dir_sum(o.d, ang_a, valid, bl + 3);
    dir_sum(o.d, ang_b, valid, bl + 6);
  }
  fold_in_order<9>(bl, lane, A.WMp, A.WM);
  if (lane == 0 && q < A.Q) {
#pragma unroll
    for (int c = 0; c < 9; ++c) A.block[q * 9 + c] = __float2bfloat16_rn(bl[c]);
  }
}

__global__ void __launch_bounds__(kThreads) solve_rows_kernel(const PassArgs A) {
  if (static_cast<int>(blockIdx.x) < A.static_blocks)
    static_rows(A);
  else
    pair_rows(A);
}

// tbl [CPB, N], w [CPB, 3, N] (slot-major).
__global__ void __launch_bounds__(kThreads) solve_bodies_kernel(
    const int* __restrict__ tbl, const float* __restrict__ w, const float* __restrict__ im,
    const __nv_bfloat16* __restrict__ block, const float* __restrict__ dlin_s,
    const float* __restrict__ dang_s, const float* __restrict__ linvel,
    const float* __restrict__ angvel, float* __restrict__ o_lin, float* __restrict__ o_ang,
    int N, int CPB) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float ol[3], oa[3], ob[3];
  for (int c = 0; c < CPB; ++c) {
    const int e = tbl[c * N + n];
    const float w0 = w[(c * 3) * N + n], w1 = w[(c * 3 + 1) * N + n],
                w2 = w[(c * 3 + 2) * N + n];
    const __nv_bfloat16* g = block + static_cast<size_t>(e) * 9;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float gl = __bfloat162float(g[x]) * w0;
      const float ga = __bfloat162float(g[3 + x]) * w1;
      const float gb = __bfloat162float(g[6 + x]) * w2;
      ol[x] = c == 0 ? gl : ol[x] + gl;
      oa[x] = c == 0 ? ga : oa[x] + ga;
      ob[x] = c == 0 ? gb : ob[x] + gb;
    }
  }
  const float m = im[n];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    o_lin[n * 3 + x] = __fmaf_rn(m, ol[x] + dlin_s[n * 3 + x], linvel[n * 3 + x]);
    o_ang[n * 3 + x] = angvel[n * 3 + x] + oa[x] + ob[x] + dang_s[n * 3 + x];
  }
}

__host__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// One pass (the warm-start pre-apply or one iteration): solve_rows, then
// solve_bodies, on one stream.  The wrapper's arguments in one host buffer
// of 8-byte slots (kernels/solve.py:_PASS): static dir, ang, r, k, target,
// fric, valid, y, l (0-8); pair dir, ang_a, ang_b, ra, rb, k, target, fric,
// valid, ab, y, l (9-20); linvel, angvel (21-22); out s_y, s_l, p_y, p_l,
// dlin_s, dang_s, block (23-29); tbl, w, im, out linvel, angvel (30-34); N,
// K, Q, WM, CPB, warm (35-40); beta as a double (41).  With warm the state
// is read (y) and not written.
extern "C" int solve_pass(const long long* a, void* stream) {
  auto f = [a](int i) { return reinterpret_cast<const float*>(a[i]); };
  auto o = [a](int i) { return reinterpret_cast<float*>(a[i]); };
  auto v = [a](int i) { return static_cast<int>(a[i]); };
  double beta;
  memcpy(&beta, a + 41, sizeof(double));
  PassArgs A;
  A.s_dir = f(0); A.s_ang = f(1); A.s_r = f(2); A.s_k = f(3); A.s_target = f(4);
  A.s_fric = f(5); A.s_valid = f(6); A.s_y = f(7); A.s_l = f(8);
  A.p_dir = f(9); A.p_ang_a = f(10); A.p_ang_b = f(11); A.p_ra = f(12); A.p_rb = f(13);
  A.p_k = f(14); A.p_target = f(15); A.p_fric = f(16); A.p_valid = f(17);
  A.p_ab = reinterpret_cast<const int*>(a[18]);
  A.p_y = f(19); A.p_l = f(20); A.linvel = f(21); A.angvel = f(22);
  A.o_s_y = o(23); A.o_s_l = o(24); A.o_p_y = o(25); A.o_p_l = o(26);
  A.dlin_s = o(27); A.dang_s = o(28);
  A.block = reinterpret_cast<__nv_bfloat16*>(a[29]);
  const int N = v(35), CPB = v(39);
  A.N = N; A.K = v(36); A.Q = v(37); A.WM = v(38); A.warm = v(40);
  A.beta = static_cast<float>(beta);
  if (N < 1 || A.K < 0 || A.K > 32 || A.Q < 0 || A.WM < 1 || A.WM > 32 || CPB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  A.Kp = pow2_at_least(A.K > 0 ? A.K : 1);
  A.WMp = pow2_at_least(A.WM);
  A.static_blocks = (N * A.Kp + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = A.static_blocks + (A.Q * A.WMp + kThreads - 1) / kThreads;
  solve_rows_kernel<<<blocks, kThreads, 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_bodies_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      reinterpret_cast<const int*>(a[30]), f(31), f(32), A.block, A.dlin_s, A.dang_s, A.linvel,
      A.angvel, o(33), o(34), N, CPB);
  return static_cast<int>(cudaGetLastError());
}
