// KC: one projected-Jacobi (FISTA) iteration of the contact solve, and the
// warm-start pre-apply, as two launches with no atomics.
//
// Replaces the iteration body and warm-start apply of
// substrata_tpu/physics/solver.py:solve_contacts (:336-401, :427-428); plain
// twin: substrata_tpu_torch/kernels/solve.py:solve_iteration_plain.
//
// solve_rows: threads [0, N) take one body's K static rows each; threads
// [N, N+Q) take one pair entry's wm rows each, with both bodies'
// velocities rounded to bf16.  Each row's impulse triple gets the
// projected update, the FISTA extrapolation, and its change is folded into
// the body's static sums or the entry's [9] bf16 impulse block.
// solve_bodies: one thread per body gathers its CPB entry blocks through
// the incidence table, weights them by side, accumulates in f32 and
// updates the velocities.
// What bounds it on the card: memory.  A row pass reads the per-row
// constants (~150 bytes per row: directions, angular terms, lever arms,
// masses) and writes the carried impulses; at the 10k bench shapes
// (40,960 static + 65,536 pair rows) that is ~17 MB per iteration against
// ~60 flops per row.  The design reads each constant once per iteration,
// keeps the sums in registers, and makes the scatter a gather: the body
// pass reads 8 x 18 bytes of bf16 blocks per body instead of any atomic.
#include "common.cuh"

namespace {

struct RowOut {
  float y[3], l[3], d[3];
};

// kernels/solve.py:_project for one row.
__device__ __forceinline__ void project(const float v[3], const float* dir, const float* k,
                                        float target, float fric, const float* y,
                                        const float* l_old, float beta, RowOut& o) {
  const float vn = v[0] * dir[0] + v[1] * dir[1] + v[2] * dir[2];
  const float ln = fmaxf(y[0] + (target - vn) / k[0], 0.0f);
  const float vt1 = v[0] * dir[3] + v[1] * dir[4] + v[2] * dir[5];
  const float vt2 = v[0] * dir[6] + v[1] * dir[7] + v[2] * dir[8];
  const float mf = fric * ln;
  const float lt1 = fminf(fmaxf(y[1] - vt1 / k[1], -mf), mf);
  const float lt2 = fminf(fmaxf(y[2] - vt2 / k[2], -mf), mf);
  o.l[0] = ln;
  o.l[1] = lt1;
  o.l[2] = lt2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.y[c] = o.l[c] + beta * (o.l[c] - l_old[c]);
    o.d[c] = o.y[c] - y[c];
  }
}

// d0 dirs[0] + d1 dirs[1] + d2 dirs[2], times the row's validity.
__device__ __forceinline__ void dir_sum(const float d[3], const float* dirs, float valid,
                                        float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = (d[0] * dirs[c] + d[1] * dirs[3 + c] + d[2] * dirs[6 + c]) * valid;
}

__global__ void solve_rows_kernel(
    const float* __restrict__ s_dir, const float* __restrict__ s_ang,
    const float* __restrict__ s_r, const float* __restrict__ s_k,
    const float* __restrict__ s_target, const float* __restrict__ s_fric,
    const float* __restrict__ s_valid, const float* __restrict__ s_y,
    const float* __restrict__ s_l, const float* __restrict__ p_dir,
    const float* __restrict__ p_ang_a, const float* __restrict__ p_ang_b,
    const float* __restrict__ p_ra, const float* __restrict__ p_rb,
    const float* __restrict__ p_k, const float* __restrict__ p_target,
    const float* __restrict__ p_fric, const float* __restrict__ p_valid,
    const int* __restrict__ p_ab, const float* __restrict__ p_y,
    const float* __restrict__ p_l, const float* __restrict__ linvel,
    const float* __restrict__ angvel, float* __restrict__ o_s_y, float* __restrict__ o_s_l,
    float* __restrict__ o_p_y, float* __restrict__ o_p_l, float* __restrict__ dlin_s,
    float* __restrict__ dang_s, __nv_bfloat16* __restrict__ block, int N, int K, int Q,
    int WM, float beta, int warm) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < N) {
    // Static rows of body t: dense, f32 velocities.
    const int n = t;
    const float lv[3] = {linvel[n * 3], linvel[n * 3 + 1], linvel[n * 3 + 2]};
    const float av[3] = {angvel[n * 3], angvel[n * 3 + 1], angvel[n * 3 + 2]};
    float sl[3] = {0.0f, 0.0f, 0.0f}, sa[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < K; ++k) {
      const int r = n * K + k;
      RowOut o;
      if (warm) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o.y[c] = s_y[r * 3 + c];
          o.l[c] = s_l[r * 3 + c];
          o.d[c] = o.y[c];
        }
      } else {
        const float rr[3] = {s_r[r * 3], s_r[r * 3 + 1], s_r[r * 3 + 2]};
        float cr[3], v[3];
        sbt::cross3(av, rr, cr);
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = lv[c] + cr[c];
        project(v, s_dir + r * 9, s_k + r * 3, s_target[r], s_fric[r], s_y + r * 3,
                s_l + r * 3, beta, o);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o_s_y[r * 3 + c] = o.y[c];
        o_s_l[r * 3 + c] = o.l[c];
      }
      float il[3], ia[3];
      dir_sum(o.d, s_dir + r * 9, s_valid[r], il);
      dir_sum(o.d, s_ang + r * 9, s_valid[r], ia);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sl[c] = k == 0 ? il[c] : sl[c] + il[c];
        sa[c] = k == 0 ? ia[c] : sa[c] + ia[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dlin_s[n * 3 + c] = sl[c];
      dang_s[n * 3 + c] = sa[c];
    }
    return;
  }
  const int q = t - N;
  if (q >= Q) return;
  // Pair entry q: wm rows sharing one (a, b); bf16 velocity payloads.
  const int a = p_ab[q], b = p_ab[Q + q];
  float wa[6], wb[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wa[c] = sbt::round_bf16(linvel[a * 3 + c]);
    wa[3 + c] = sbt::round_bf16(angvel[a * 3 + c]);
    wb[c] = sbt::round_bf16(linvel[b * 3 + c]);
    wb[3 + c] = sbt::round_bf16(angvel[b * 3 + c]);
  }
  float bl[9];
  for (int w = 0; w < WM; ++w) {
    const int r = q * WM + w;
    RowOut o;
    if (warm) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o.y[c] = p_y[r * 3 + c];
        o.l[c] = p_l[r * 3 + c];
        o.d[c] = o.y[c];
      }
    } else {
      const float ra[3] = {p_ra[r * 3], p_ra[r * 3 + 1], p_ra[r * 3 + 2]};
      const float rb[3] = {p_rb[r * 3], p_rb[r * 3 + 1], p_rb[r * 3 + 2]};
      float ca[3], cb[3], v[3];
      sbt::cross3(wa + 3, ra, ca);
      sbt::cross3(wb + 3, rb, cb);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = (wa[c] + ca[c]) - (wb[c] + cb[c]);
      project(v, p_dir + r * 9, p_k + r * 3, p_target[r], p_fric[r], p_y + r * 3,
              p_l + r * 3, beta, o);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o_p_y[r * 3 + c] = o.y[c];
      o_p_l[r * 3 + c] = o.l[c];
    }
    float il[3], ia[3], ib[3];
    dir_sum(o.d, p_dir + r * 9, p_valid[r], il);
    dir_sum(o.d, p_ang_a + r * 9, p_valid[r], ia);
    dir_sum(o.d, p_ang_b + r * 9, p_valid[r], ib);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bl[c] = w == 0 ? il[c] : bl[c] + il[c];
      bl[3 + c] = w == 0 ? ia[c] : bl[3 + c] + ia[c];
      bl[6 + c] = w == 0 ? ib[c] : bl[6 + c] + ib[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) block[q * 9 + c] = __float2bfloat16_rn(bl[c]);
}

__global__ void solve_bodies_kernel(const int* __restrict__ tbl, const float* __restrict__ w,
                                    const float* __restrict__ im,
                                    const __nv_bfloat16* __restrict__ block,
                                    const float* __restrict__ dlin_s,
                                    const float* __restrict__ dang_s,
                                    const float* __restrict__ linvel,
                                    const float* __restrict__ angvel,
                                    float* __restrict__ o_lin, float* __restrict__ o_ang,
                                    int N, int CPB) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float ol[3], oa[3], ob[3];
  for (int c = 0; c < CPB; ++c) {
    const int e = tbl[n * CPB + c];
    const float w0 = w[(n * CPB + c) * 3], w1 = w[(n * CPB + c) * 3 + 1],
                w2 = w[(n * CPB + c) * 3 + 2];
    const __nv_bfloat16* g = block + e * 9;
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
    o_lin[n * 3 + x] = linvel[n * 3 + x] + m * (ol[x] + dlin_s[n * 3 + x]);
    o_ang[n * 3 + x] = angvel[n * 3 + x] + oa[x] + ob[x] + dang_s[n * 3 + x];
  }
}

}  // namespace

extern "C" int solve_rows(const float* s_dir, const float* s_ang, const float* s_r,
                          const float* s_k, const float* s_target, const float* s_fric,
                          const float* s_valid, const float* s_y, const float* s_l,
                          const float* p_dir, const float* p_ang_a, const float* p_ang_b,
                          const float* p_ra, const float* p_rb, const float* p_k,
                          const float* p_target, const float* p_fric, const float* p_valid,
                          const int* p_ab, const float* p_y, const float* p_l,
                          const float* linvel, const float* angvel, float* o_s_y,
                          float* o_s_l, float* o_p_y, float* o_p_l, float* dlin_s,
                          float* dang_s, __nv_bfloat16* block, int N, int K, int Q, int WM,
                          float beta, int warm, void* stream) {
  const int total = N + Q;
  if (total > 0) {
    const int threads = 128;
    const int blocks = (total + threads - 1) / threads;
    solve_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        s_dir, s_ang, s_r, s_k, s_target, s_fric, s_valid, s_y, s_l, p_dir, p_ang_a,
        p_ang_b, p_ra, p_rb, p_k, p_target, p_fric, p_valid, p_ab, p_y, p_l, linvel, angvel,
        o_s_y, o_s_l, o_p_y, o_p_l, dlin_s, dang_s, block, N, K, Q, WM, beta, warm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int solve_bodies(const int* tbl, const float* w, const float* im,
                            const __nv_bfloat16* block, const float* dlin_s,
                            const float* dang_s, const float* linvel, const float* angvel,
                            float* o_lin, float* o_ang, int N, int CPB, void* stream) {
  if (N > 0) {
    const int threads = 128;
    const int blocks = (N + threads - 1) / threads;
    solve_bodies_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        tbl, w, im, block, dlin_s, dang_s, linvel, angvel, o_lin, o_ang, N, CPB);
  }
  return static_cast<int>(cudaGetLastError());
}
