// Kernel KQ: the contact solve's per-step setup and its cache refresh (K6).
//
// solve_setup replaces substrata_tpu/physics/solver.py:solve_contacts
// before its iterations (:156-340, the warm-start probe :408-428); plain
// twin: substrata_tpu_torch/kernels/solve_setup.py:solve_setup_plain.  One
// launch: threads [0, N) take a body each — its awake-masked inverse mass,
// world inverse inertia and mass-split count, its incidence-table row
// (gather-safe slots and side weights) and its K static rows; threads
// [N, N + Q) take a pair entry each — both bodies' terms again (so no
// thread waits on another), the bf16 velocities of both, then the entry's
// wm rows.  A row gets its tangent basis, r x d and Iw (r x d) for the
// three directions, the effective masses, the restitution / Baumgarte
// target (divided by the traced dt) and, with a cache, the warm-start
// probe of the [H, 5] table with the friction-cone clamp.  Bound: bytes
// (~300 written per row); each thread's arithmetic is ~400 flops.
//
// cache_refresh replaces the refresh scatter (:449-471); twin:
// solve_setup.py:cache_refresh_plain.  A sequential scatter keeps the last
// row that writes a slot, so: (1) copy the cache and clear a per-slot
// "last row" word, (2) atomicMax of the row index into its slot, (3) only
// the winning row writes.  Deterministic; bound: bytes.
//
// Every expression repeats the twin's operations in its order; the library
// is built with -fmad=false, so nothing is contracted.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kDeep = 0.04f;

struct Terms {
  float pos[3];
  float im;
  float c;
  float iw[3][3];
};

// maths/transform.py:world_inv_inertia, the awake mask and the count.
__device__ void body_terms(int i, const float* __restrict__ pos, const float* __restrict__ quat,
                           const float* __restrict__ inv_mass,
                           const float* __restrict__ inv_inertia, const bool* __restrict__ awake,
                           const int* __restrict__ table, const bool* __restrict__ s_valid,
                           int K, int wm, int cpb, Terms& t) {
  const float awf = awake[i] ? 1.0f : 0.0f;
  t.im = inv_mass[i] * awf;
  const float q[4] = {quat[i * 4 + 0], quat[i * 4 + 1], quat[i * 4 + 2], quat[i * 4 + 3]};
  float r[3][3];
  sbt::quat_to_matrix(q, r);
  const float d[3] = {inv_inertia[i * 3 + 0] * awf, inv_inertia[i * 3 + 1] * awf,
                      inv_inertia[i * 3 + 2] * awf};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      t.iw[a][b] = r[a][0] * d[0] * r[b][0] + r[a][1] * d[1] * r[b][1] + r[a][2] * d[2] * r[b][2];
  int tabled = 0;
  for (int c = 0; c < cpb; ++c) tabled += table[i * cpb + c] >= 0;
  float vs = 0.0f;
  for (int k = 0; k < K; ++k) vs += s_valid[i * K + k] ? 1.0f : 0.0f;
  t.c = fmaxf(static_cast<float>(tabled) * static_cast<float>(wm) + vs, 1.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) t.pos[k] = pos[i * 3 + k];
}

// solve_setup.py:tangent_basis -> dirs = (n, t1, t2).
__device__ __forceinline__ void tangent_basis(const float n[3], float dirs[3][3]) {
  const float cf = fabsf(n[0]) < 0.9f ? 1.0f : 0.0f;
  const float ax[3] = {cf, 1.0f - cf, 0.0f};
  float t1[3];
  sbt::cross3(ax, n, t1);
  const float len = fmaxf(sqrtf(sbt::dot3(t1, t1)), 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) t1[k] = t1[k] / len;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dirs[0][k] = n[k];
    dirs[1][k] = t1[k];
  }
  sbt::cross3(n, t1, dirs[2]);
}

__device__ __forceinline__ float vn_target(float pen, float rest, float vn0, float baum,
                                           float thr, float dt) {
  const float rt = vn0 < -thr ? -rest * vn0 : -CUDART_INF_F;
  const float bias = pen > 0.0f ? fminf((baum / dt) * fmaxf(pen - kDeep, 0.0f), 3.0f) : pen / dt;
  return fmaxf(bias, rt);
}

__device__ __forceinline__ unsigned cache_slot(int a, int key, int H) {
  const unsigned ua = static_cast<unsigned>(a > 0 ? a : 0);
  return ((ua * 2654435761u) ^ (static_cast<unsigned>(key) * 40503u)) &
         static_cast<unsigned>(H - 1);
}

// The warm-start probe of one row (solver.py:408-428) -> y [3].
__device__ void warm_row(const float* __restrict__ cache, int H, int row, int a, int key,
                         bool valid, float fric, float validf, float* y, int* h_out,
                         bool* v_out) {
  if (cache == nullptr) {
    y[0] = y[1] = y[2] = 0.0f;
    return;
  }
  const bool va = valid && a >= 0;
  const unsigned h = cache_slot(a, key, H);
  const float* c = cache + static_cast<size_t>(h) * 5;
  const bool hit = va && __float_as_int(c[0]) == a && __float_as_int(c[1]) == key;
  const float w0 = hit ? c[2] : 0.0f, w1 = hit ? c[3] : 0.0f, w2 = hit ? c[4] : 0.0f;
  const float ln0 = fmaxf(w0, 0.0f) * validf;
  const float mf0 = fric * ln0;
  y[0] = ln0;
  y[1] = fminf(fmaxf(w1, -mf0), mf0) * validf;
  y[2] = fminf(fmaxf(w2, -mf0), mf0) * validf;
  h_out[row] = static_cast<int>(h);
  v_out[row] = va;
}

__global__ void __launch_bounds__(kThreads) solve_setup_kernel(
    const float* __restrict__ pos, const float* __restrict__ quat,
    const float* __restrict__ linvel, const float* __restrict__ angvel,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_inertia,
    const bool* __restrict__ awake, const int* __restrict__ table, const float* __restrict__ sign,
    const int* __restrict__ s_a, const float* __restrict__ s_point,
    const float* __restrict__ s_normal, const float* __restrict__ s_pen,
    const bool* __restrict__ s_valid, const float* __restrict__ s_fric,
    const float* __restrict__ s_rest, const int* __restrict__ s_key,
    const int* __restrict__ p_a, const int* __restrict__ p_b, const float* __restrict__ p_point,
    const float* __restrict__ p_normal, const float* __restrict__ p_pen,
    const bool* __restrict__ p_valid, const float* __restrict__ p_fric,
    const float* __restrict__ p_rest, const int* __restrict__ p_key,
    const float* __restrict__ baumgarte, const float* __restrict__ res_thr,
    const float* __restrict__ cache, int N, int K, int Q, int wm, int cpb, int H, float dt,
    float* __restrict__ o_sdir, float* __restrict__ o_sang, float* __restrict__ o_sr,
    float* __restrict__ o_sk, float* __restrict__ o_starget, float* __restrict__ o_svalid,
    float* __restrict__ o_pdir, float* __restrict__ o_pang_a, float* __restrict__ o_pang_b,
    float* __restrict__ o_pra, float* __restrict__ o_prb, float* __restrict__ o_pk,
    float* __restrict__ o_ptarget, float* __restrict__ o_pvalid, int* __restrict__ o_pab,
    int* __restrict__ o_tbl, float* __restrict__ o_w, float* __restrict__ o_im,
    float* __restrict__ o_ys, float* __restrict__ o_yp, int* __restrict__ o_h,
    bool* __restrict__ o_valid) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const float baum = *baumgarte, thr = *res_thr;
  if (tid < N) {
    const int i = tid;
    Terms t;
    body_terms(i, pos, quat, inv_mass, inv_inertia, awake, table, s_valid, K, wm, cpb, t);
    o_im[i] = t.im;
    for (int c = 0; c < cpb; ++c) {
      const int e = table[i * cpb + c];
      const float sv = sign[i * cpb + c] * (e >= 0 ? 1.0f : 0.0f);
      o_tbl[i * cpb + c] = e > 0 ? e : 0;
      o_w[(i * cpb + c) * 3 + 0] = sv;
      o_w[(i * cpb + c) * 3 + 1] = fmaxf(sv, 0.0f);
      o_w[(i * cpb + c) * 3 + 2] = fminf(sv, 0.0f);
    }
    const float lv[3] = {linvel[i * 3], linvel[i * 3 + 1], linvel[i * 3 + 2]};
    const float av[3] = {angvel[i * 3], angvel[i * 3 + 1], angvel[i * 3 + 2]};
    for (int k = 0; k < K; ++k) {
      const int row = i * K + k;
      const float n[3] = {s_normal[row * 3], s_normal[row * 3 + 1], s_normal[row * 3 + 2]};
      float dirs[3][3];
      tangent_basis(n, dirs);
      float r[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) r[c] = s_point[row * 3 + c] - t.pos[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float rx[3], term[3];
        sbt::cross3(r, dirs[d], rx);
        sbt::mv(t.iw, rx, term);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o_sdir[row * 9 + d * 3 + c] = dirs[d][c];
          o_sang[row * 9 + d * 3 + c] = term[c];
        }
        o_sk[row * 3 + d] = fmaxf(t.im * t.c + sbt::dot3(rx, term) * t.c, 1e-9f);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) o_sr[row * 3 + c] = r[c];
      float wr[3], v0[3];
      sbt::cross3(av, r, wr);
#pragma unroll
      for (int c = 0; c < 3; ++c) v0[c] = lv[c] + wr[c];
      o_starget[row] = vn_target(s_pen[row], s_rest[row], sbt::dot3(v0, n), baum, thr, dt);
      const float vf = s_valid[row] ? 1.0f : 0.0f;
      o_svalid[row] = vf;
      warm_row(cache, H, row, s_a[row], s_key[row], s_valid[row], s_fric[row], vf,
               o_ys + row * 3, o_h, o_valid);
    }
    return;
  }
  const int q = tid - N;
  if (q >= Q) return;
  const int ae = p_a[q * wm], be = p_b[q * wm];
  const int a = ae > 0 ? ae : 0, b = be > 0 ? be : 0;
  o_pab[q] = a;
  o_pab[Q + q] = b;
  Terms A, B;
  body_terms(a, pos, quat, inv_mass, inv_inertia, awake, table, s_valid, K, wm, cpb, A);
  body_terms(b, pos, quat, inv_mass, inv_inertia, awake, table, s_valid, K, wm, cpb, B);
  float wa[6], wb[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wa[c] = sbt::round_bf16(linvel[a * 3 + c]);
    wa[3 + c] = sbt::round_bf16(angvel[a * 3 + c]);
    wb[c] = sbt::round_bf16(linvel[b * 3 + c]);
    wb[3 + c] = sbt::round_bf16(angvel[b * 3 + c]);
  }
  const float kab = A.im * A.c + B.im * B.c;
  for (int rr = 0; rr < wm; ++rr) {
    const int row = q * wm + rr;
    const float n[3] = {p_normal[row * 3], p_normal[row * 3 + 1], p_normal[row * 3 + 2]};
    float dirs[3][3];
    tangent_basis(n, dirs);
    float ra[3], rb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ra[c] = p_point[row * 3 + c] - A.pos[c];
      rb[c] = p_point[row * 3 + c] - B.pos[c];
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float rax[3], rbx[3], ta[3], tb[3];
      sbt::cross3(ra, dirs[d], rax);
      sbt::cross3(rb, dirs[d], rbx);
      sbt::mv(A.iw, rax, ta);
      sbt::mv(B.iw, rbx, tb);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o_pdir[row * 9 + d * 3 + c] = dirs[d][c];
        o_pang_a[row * 9 + d * 3 + c] = ta[c];
        o_pang_b[row * 9 + d * 3 + c] = tb[c];
      }
      o_pk[row * 3 + d] =
          fmaxf(kab + sbt::dot3(rax, ta) * A.c + sbt::dot3(rbx, tb) * B.c, 1e-9f);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o_pra[row * 3 + c] = ra[c];
      o_prb[row * 3 + c] = rb[c];
    }
    float xa[3], xb[3], v0[3];
    sbt::cross3(wa + 3, ra, xa);
    sbt::cross3(wb + 3, rb, xb);
#pragma unroll
    for (int c = 0; c < 3; ++c) v0[c] = (wa[c] + xa[c]) - (wb[c] + xb[c]);
    o_ptarget[row] = vn_target(p_pen[row], p_rest[row], sbt::dot3(v0, n), baum, thr, dt);
    const float vf = p_valid[row] ? 1.0f : 0.0f;
    o_pvalid[row] = vf;
    warm_row(cache, H, N * K + row, p_a[row], p_key[row], p_valid[row], p_fric[row], vf,
             o_yp + row * 3, o_h, o_valid);
  }
}

__global__ void refresh_copy_kernel(const float* __restrict__ cache, int H,
                                    int* __restrict__ last, float* __restrict__ out) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < H; k += gridDim.x * blockDim.x) {
#pragma unroll
    for (int c = 0; c < 5; ++c) out[k * 5 + c] = cache[k * 5 + c];
    last[k] = -1;
  }
}

__global__ void refresh_claim_kernel(const int* __restrict__ h, const bool* __restrict__ valid,
                                     int rows, int* __restrict__ last) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < rows && valid[j]) atomicMax(last + h[j], j);
}

__global__ void refresh_write_kernel(const int* __restrict__ h, const bool* __restrict__ valid,
                                     const int* __restrict__ s_a, const int* __restrict__ s_key,
                                     const int* __restrict__ p_a, const int* __restrict__ p_key,
                                     const float* __restrict__ lam_s,
                                     const float* __restrict__ s_valid,
                                     const float* __restrict__ lam_p,
                                     const float* __restrict__ p_valid, int S, int P,
                                     const int* __restrict__ last, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= S + P || !valid[j] || last[h[j]] != j) return;
  const bool st = j < S;
  const int r = st ? j : j - S;
  float* o = out + static_cast<size_t>(h[j]) * 5;
  o[0] = __int_as_float(st ? s_a[r] : p_a[r]);
  o[1] = __int_as_float(st ? s_key[r] : p_key[r]);
  const float vf = st ? s_valid[r] : p_valid[r];
  const float* lam = st ? lam_s : lam_p;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[2 + c] = lam[r * 3 + c] * vf;
}

}  // namespace

extern "C" int solve_setup(
    const float* pos, const float* quat, const float* linvel, const float* angvel,
    const float* inv_mass, const float* inv_inertia, const bool* awake, const int* table,
    const float* sign, const int* s_a, const float* s_point, const float* s_normal,
    const float* s_pen, const bool* s_valid, const float* s_fric, const float* s_rest,
    const int* s_key, const int* p_a, const int* p_b, const float* p_point,
    const float* p_normal, const float* p_pen, const bool* p_valid, const float* p_fric,
    const float* p_rest, const int* p_key, const float* baumgarte, const float* res_thr,
    const float* cache, int N, int K, int Q, int wm, int cpb, int H, float dt, float* o_sdir,
    float* o_sang, float* o_sr, float* o_sk, float* o_starget, float* o_svalid, float* o_pdir,
    float* o_pang_a, float* o_pang_b, float* o_pra, float* o_prb, float* o_pk,
    float* o_ptarget, float* o_pvalid, int* o_pab, int* o_tbl, float* o_w, float* o_im,
    float* o_ys, float* o_yp, int* o_h, bool* o_valid, void* stream) {
  const int work = N + Q;
  if (work > 0)
    solve_setup_kernel<<<(work + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pos, quat, linvel, angvel, inv_mass, inv_inertia, awake, table, sign, s_a, s_point,
        s_normal, s_pen, s_valid, s_fric, s_rest, s_key, p_a, p_b, p_point, p_normal, p_pen,
        p_valid, p_fric, p_rest, p_key, baumgarte, res_thr, cache, N, K, Q, wm, cpb, H, dt,
        o_sdir, o_sang, o_sr, o_sk, o_starget, o_svalid, o_pdir, o_pang_a, o_pang_b, o_pra,
        o_prb, o_pk, o_ptarget, o_pvalid, o_pab, o_tbl, o_w, o_im, o_ys, o_yp, o_h, o_valid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cache_refresh(const float* cache, const int* h, const bool* valid, const int* s_a,
                             const int* s_key, const int* p_a, const int* p_key,
                             const float* lam_s, const float* s_valid, const float* lam_p,
                             const float* p_valid, int S, int P, int H, int* last, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = S + P;
  const int copy_blocks = (H + 255) / 256;
  refresh_copy_kernel<<<copy_blocks < 1024 ? copy_blocks : 1024, 256, 0, s>>>(cache, H, last,
                                                                                 out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || rows == 0) return static_cast<int>(err);
  const int blocks = (rows + 255) / 256;
  refresh_claim_kernel<<<blocks, 256, 0, s>>>(h, valid, rows, last);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  refresh_write_kernel<<<blocks, 256, 0, s>>>(h, valid, s_a, s_key, p_a, p_key, lam_s, s_valid,
                                              lam_p, p_valid, S, P, last, out);
  return static_cast<int>(cudaGetLastError());
}
