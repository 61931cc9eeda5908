// Kernel KQ: the contact solve's per-step setup and its cache refresh (K6).
//
// solve_setup replaces substrata_tpu/physics/solver.py:solve_contacts
// before its iterations (:156-340, the warm-start probe :408-428); plain
// twin: substrata_tpu_torch/kernels/solve_setup.py:solve_setup_plain.
//
// Two launches, one C call:
// 1. setup_bodies, a thread per body: its awake-masked inverse mass, world
//    inverse inertia, mass-split count and position, once, into a [N, 16]
//    scratch row (64 bytes: a pair row's gather of a body takes one or two
//    sectors), and its incidence-table row (gather-safe slots, side
//    weights).
// 2. setup_rows, a thread per contact row: the static rows (row n K + k)
//    fill the first blocks, the pair rows (row q wm + w) the rest.  A row
//    reads its bodies' terms from the scratch (the K or wm lanes of a body or
//    entry read the same words) and the bf16 velocities of a pair, then
//    computes its tangent basis, r x d and Iw (r x d) for the three
//    directions, the effective masses, the restitution / Baumgarte target
//    (divided by the traced dt) and, with a cache, the warm-start probe of
//    the [H, 5] table with the friction-cone clamp.
//
// The layout (kernels/solve.py:row_layout) is component-major: a [.., 3, 3]
// block of R rows is stored [9, R], a [.., 3] vector [3, R], the table and
// its weights slot-major ([CPB, N], [CPB, 3, N]).  So neighbouring threads
// write neighbouring words, and KC, which reads the rows 8 times a step,
// reads them coalesced too.  Bound: bytes, ~120 written per static row and
// ~170 per pair row; a row's arithmetic is ~150 flops.
//
// cache_refresh replaces the refresh scatter (:449-471); twin:
// solve_setup.py:cache_refresh_plain.  A sequential scatter keeps the last
// row that writes a slot, so: (1) copy the cache and clear a per-slot
// "last row" word, (2) atomicMax of the row index into its slot, (3) only
// the winning row writes.  Deterministic; bound: bytes.
//
// Every expression repeats the twin's operations in its order; the library
// is built with -fmad=false, so nothing is contracted but what the twin
// contracts as the jitted reference does: the cross products (cross_fma),
// the dot products and norms (dot3_fma) and Iw (r x d) (mv_fma).
#include "common.cuh"

#include <math_constants.h>

#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kTerms = 16;  // pos (3), im, c, iw (9), 2 unused
constexpr float kDeep = 0.04f;

struct Terms {
  float pos[3];
  float im;
  float c;
  float iw[3][3];
};

__device__ __forceinline__ void load_terms(const float* __restrict__ terms, int i, Terms& t) {
  const float4* p = reinterpret_cast<const float4*>(terms + static_cast<size_t>(i) * kTerms);
  const float4 a = p[0], b = p[1], c = p[2], d = p[3];
  t.pos[0] = a.x; t.pos[1] = a.y; t.pos[2] = a.z; t.im = a.w;
  t.c = b.x; t.iw[0][0] = b.y; t.iw[0][1] = b.z; t.iw[0][2] = b.w;
  t.iw[1][0] = c.x; t.iw[1][1] = c.y; t.iw[1][2] = c.z; t.iw[2][0] = c.w;
  t.iw[2][1] = d.x; t.iw[2][2] = d.y;
}

// maths/transform.py:world_inv_inertia, the awake mask and the count; the
// incidence table's gather-safe slots and side weights.
__global__ void __launch_bounds__(kThreads) setup_bodies_kernel(
    const float* __restrict__ pos, const float* __restrict__ quat,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_inertia,
    const bool* __restrict__ awake, const int* __restrict__ table,
    const float* __restrict__ sign, const bool* __restrict__ s_valid, int N, int K, int wm,
    int cpb, float* __restrict__ terms, int* __restrict__ o_tbl, float* __restrict__ o_w,
    float* __restrict__ o_im) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float awf = awake[i] ? 1.0f : 0.0f;
  const float im = inv_mass[i] * awf;
  const float q[4] = {quat[i * 4 + 0], quat[i * 4 + 1], quat[i * 4 + 2], quat[i * 4 + 3]};
  float r[3][3];
  sbt::quat_to_matrix(q, r);
  const float d[3] = {inv_inertia[i * 3 + 0] * awf, inv_inertia[i * 3 + 1] * awf,
                      inv_inertia[i * 3 + 2] * awf};
  float iw[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      iw[a][b] = r[a][0] * d[0] * r[b][0] + r[a][1] * d[1] * r[b][1] + r[a][2] * d[2] * r[b][2];
  int tabled = 0;
  for (int c = 0; c < cpb; ++c) {
    const int e = table[i * cpb + c];
    tabled += e >= 0;
    const float sv = sign[i * cpb + c] * (e >= 0 ? 1.0f : 0.0f);
    o_tbl[c * N + i] = e > 0 ? e : 0;
    o_w[(c * 3 + 0) * N + i] = sv;
    o_w[(c * 3 + 1) * N + i] = fmaxf(sv, 0.0f);
    o_w[(c * 3 + 2) * N + i] = fminf(sv, 0.0f);
  }
  float vs = 0.0f;
  for (int k = 0; k < K; ++k) vs += s_valid[i * K + k] ? 1.0f : 0.0f;
  const float cnt = fmaxf(static_cast<float>(tabled) * static_cast<float>(wm) + vs, 1.0f);
  o_im[i] = im;
  float4* o = reinterpret_cast<float4*>(terms + static_cast<size_t>(i) * kTerms);
  o[0] = make_float4(pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2], im);
  o[1] = make_float4(cnt, iw[0][0], iw[0][1], iw[0][2]);
  o[2] = make_float4(iw[1][0], iw[1][1], iw[1][2], iw[2][0]);
  o[3] = make_float4(iw[2][1], iw[2][2], 0.0f, 0.0f);
}

// solve_setup.py:tangent_basis -> dirs = (n, t1, t2).
__device__ __forceinline__ void tangent_basis(const float n[3], float dirs[3][3]) {
  const float cf = fabsf(n[0]) < 0.9f ? 1.0f : 0.0f;
  const float ax[3] = {cf, 1.0f - cf, 0.0f};
  float t1[3];
  sbt::cross_fma(ax, n, t1);
  const float len = fmaxf(sqrtf(sbt::dot3_fma(t1, t1)), 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) t1[k] = t1[k] / len;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dirs[0][k] = n[k];
    dirs[1][k] = t1[k];
  }
  sbt::cross_fma(n, t1, dirs[2]);
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

// The warm-start probe of one row (solver.py:408-428): y [3, R] at column
// ``col``, the slot and validity at ``row`` of the [S + P] lookup.
__device__ void warm_row(const float* __restrict__ cache, int H, int row, int a, int key,
                         bool valid, float fric, float validf, float* __restrict__ y, int col,
                         int R, int* __restrict__ h_out, bool* __restrict__ v_out) {
  if (cache == nullptr) {
    y[col] = y[R + col] = y[2 * R + col] = 0.0f;
    return;
  }
  const bool va = valid && a >= 0;
  const unsigned h = cache_slot(a, key, H);
  const float* c = cache + static_cast<size_t>(h) * 5;
  const bool hit = va && __float_as_int(c[0]) == a && __float_as_int(c[1]) == key;
  const float w0 = hit ? c[2] : 0.0f, w1 = hit ? c[3] : 0.0f, w2 = hit ? c[4] : 0.0f;
  const float ln0 = fmaxf(w0, 0.0f) * validf;
  const float mf0 = fric * ln0;
  y[col] = ln0;
  y[R + col] = fminf(fmaxf(w1, -mf0), mf0) * validf;
  y[2 * R + col] = fminf(fmaxf(w2, -mf0), mf0) * validf;
  h_out[row] = static_cast<int>(h);
  v_out[row] = va;
}

struct RowsArgs {
  const float *lin, *ang, *terms;
  const int* s_a;
  const float *s_point, *s_normal, *s_pen;
  const bool* s_valid;
  const float *s_fric, *s_rest;
  const int* s_key;
  const int *p_a, *p_b;
  const float *p_point, *p_normal, *p_pen;
  const bool* p_valid;
  const float *p_fric, *p_rest;
  const int* p_key;
  const float *baumgarte, *res_thr, *cache;
  int K, Q, wm, H, static_blocks;
  float dt;
  float *sdir, *sang, *sr, *sk, *starget, *svalid;
  float *pdir, *pang_a, *pang_b, *pra, *prb, *pk, *ptarget, *pvalid;
  int* pab;
  float *ys, *yp;
  int* h;
  bool* valid_all;
};

__device__ void static_row(const RowsArgs& A, int row, int S) {
  const float baum = *A.baumgarte, thr = *A.res_thr;
  Terms t;
  const int i = row / A.K;
  load_terms(A.terms, i, t);
  const float n[3] = {A.s_normal[row * 3], A.s_normal[row * 3 + 1], A.s_normal[row * 3 + 2]};
  float dirs[3][3];
  tangent_basis(n, dirs);
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = A.s_point[row * 3 + c] - t.pos[c];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float rx[3], term[3];
    sbt::cross_fma(r, dirs[d], rx);
    sbt::mv_fma(t.iw, rx, term);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A.sdir[(d * 3 + c) * S + row] = dirs[d][c];
      A.sang[(d * 3 + c) * S + row] = term[c];
    }
    A.sk[d * S + row] = fmaxf(t.im * t.c + sbt::dot3_fma(rx, term) * t.c, 1e-9f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) A.sr[c * S + row] = r[c];
  const float lv[3] = {A.lin[i * 3], A.lin[i * 3 + 1], A.lin[i * 3 + 2]};
  const float av[3] = {A.ang[i * 3], A.ang[i * 3 + 1], A.ang[i * 3 + 2]};
  float wr[3], v0[3];
  sbt::cross_fma(av, r, wr);
#pragma unroll
  for (int c = 0; c < 3; ++c) v0[c] = lv[c] + wr[c];
  A.starget[row] = vn_target(A.s_pen[row], A.s_rest[row], sbt::dot3_fma(v0, n), baum, thr, A.dt);
  const bool valid = A.s_valid[row];
  const float vf = valid ? 1.0f : 0.0f;
  A.svalid[row] = vf;
  warm_row(A.cache, A.H, row, A.s_a[row], A.s_key[row], valid, A.s_fric[row], vf, A.ys, row, S,
           A.h, A.valid_all);
}

__device__ void pair_row(const RowsArgs& A, int row, int S, int P) {
  const float baum = *A.baumgarte, thr = *A.res_thr;
  const int q = row / A.wm;
  const int ae = A.p_a[q * A.wm], be = A.p_b[q * A.wm];
  const int a = ae > 0 ? ae : 0, b = be > 0 ? be : 0;
  if (row == q * A.wm) {
    A.pab[q] = a;
    A.pab[A.Q + q] = b;
  }
  Terms TA, TB;
  load_terms(A.terms, a, TA);
  load_terms(A.terms, b, TB);
  float wa[6], wb[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wa[c] = sbt::round_bf16(A.lin[a * 3 + c]);
    wa[3 + c] = sbt::round_bf16(A.ang[a * 3 + c]);
    wb[c] = sbt::round_bf16(A.lin[b * 3 + c]);
    wb[3 + c] = sbt::round_bf16(A.ang[b * 3 + c]);
  }
  const float kab = TA.im * TA.c + TB.im * TB.c;
  const float n[3] = {A.p_normal[row * 3], A.p_normal[row * 3 + 1], A.p_normal[row * 3 + 2]};
  float dirs[3][3];
  tangent_basis(n, dirs);
  float ra[3], rb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ra[c] = A.p_point[row * 3 + c] - TA.pos[c];
    rb[c] = A.p_point[row * 3 + c] - TB.pos[c];
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float rax[3], rbx[3], ta[3], tb[3];
    sbt::cross_fma(ra, dirs[d], rax);
    sbt::cross_fma(rb, dirs[d], rbx);
    sbt::mv_fma(TA.iw, rax, ta);
    sbt::mv_fma(TB.iw, rbx, tb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A.pdir[(d * 3 + c) * P + row] = dirs[d][c];
      A.pang_a[(d * 3 + c) * P + row] = ta[c];
      A.pang_b[(d * 3 + c) * P + row] = tb[c];
    }
    A.pk[d * P + row] =
        fmaxf(kab + sbt::dot3_fma(rax, ta) * TA.c + sbt::dot3_fma(rbx, tb) * TB.c, 1e-9f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    A.pra[c * P + row] = ra[c];
    A.prb[c * P + row] = rb[c];
  }
  float xa[3], xb[3], v0[3];
  sbt::cross_fma(wa + 3, ra, xa);
  sbt::cross_fma(wb + 3, rb, xb);
#pragma unroll
  for (int c = 0; c < 3; ++c) v0[c] = (wa[c] + xa[c]) - (wb[c] + xb[c]);
  A.ptarget[row] = vn_target(A.p_pen[row], A.p_rest[row], sbt::dot3_fma(v0, n), baum, thr, A.dt);
  const bool valid = A.p_valid[row];
  const float vf = valid ? 1.0f : 0.0f;
  A.pvalid[row] = vf;
  warm_row(A.cache, A.H, S + row, A.p_a[row], A.p_key[row], valid, A.p_fric[row], vf, A.yp, row,
           P, A.h, A.valid_all);
}

__global__ void __launch_bounds__(kThreads) setup_rows_kernel(const RowsArgs A, int S, int P) {
  if (static_cast<int>(blockIdx.x) < A.static_blocks) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row < S) static_row(A, row, S);
  } else {
    const int row = (blockIdx.x - A.static_blocks) * blockDim.x + threadIdx.x;
    if (row < P) pair_row(A, row, S, P);
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

// lam_s / lam_p element (row r, component c) at r * rs + c * cs: (3, 1) for
// a row-major [.., 3] tensor, (1, R) for the solve's component-major state.
__global__ void refresh_write_kernel(const int* __restrict__ h, const bool* __restrict__ valid,
                                     const int* __restrict__ s_a, const int* __restrict__ s_key,
                                     const int* __restrict__ p_a, const int* __restrict__ p_key,
                                     const float* __restrict__ lam_s,
                                     const float* __restrict__ s_valid,
                                     const float* __restrict__ lam_p,
                                     const float* __restrict__ p_valid, int S, int P, int s_rs,
                                     int s_cs, int p_rs, int p_cs, const int* __restrict__ last,
                                     float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= S + P || !valid[j] || last[h[j]] != j) return;
  const bool st = j < S;
  const int r = st ? j : j - S;
  float* o = out + static_cast<size_t>(h[j]) * 5;
  o[0] = __int_as_float(st ? s_a[r] : p_a[r]);
  o[1] = __int_as_float(st ? s_key[r] : p_key[r]);
  const float vf = st ? s_valid[r] : p_valid[r];
  const float* lam = st ? lam_s : lam_p;
  const int rs = st ? s_rs : p_rs, cs = st ? s_cs : p_cs;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[2 + c] = lam[static_cast<size_t>(r) * rs + c * cs] * vf;
}

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/solve_setup.py:_PACK): body pos, quat, linvel, angvel, inv_mass,
// inv_inertia, awake, table, sign (0-8); static a, point, normal, pen,
// valid, fric, rest, key (9-16); pair a, b, point, normal, pen, valid,
// fric, rest, key (17-25); baumgarte, restitution_threshold, cache or 0
// (26-28); N, K, Q, wm, CPB, H (29-34); dt as a double (35); out s_dir,
// s_ang, s_r, s_k, s_target, s_valid, p_dir, p_ang_a, p_ang_b, p_ra, p_rb,
// p_k, p_target, p_valid, p_ab, tbl, w, im, y_s, y_p, hash slot, valid,
// body-term scratch (36-58).
extern "C" int solve_setup(const long long* a, void* stream) {
  auto f = [a](int i) { return reinterpret_cast<const float*>(a[i]); };
  auto n = [a](int i) { return reinterpret_cast<const int*>(a[i]); };
  auto b = [a](int i) { return reinterpret_cast<const bool*>(a[i]); };
  auto o = [a](int i) { return reinterpret_cast<float*>(a[i]); };
  auto v = [a](int i) { return static_cast<int>(a[i]); };
  double dt;
  memcpy(&dt, a + 35, sizeof(double));
  const int N = v(29), K = v(30), Q = v(31), wm = v(32), cpb = v(33), H = v(34);
  if (N < 1 || K < 0 || wm < 1 || cpb < 1 || (a[28] != 0 && (H < 1 || (H & (H - 1)) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* terms = o(58);
  setup_bodies_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      f(0), f(1), f(4), f(5), b(6), n(7), f(8), b(13), N, K, wm, cpb, terms,
      reinterpret_cast<int*>(a[51]), o(52), o(53));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = N * K, P = Q * wm;
  RowsArgs A;
  A.lin = f(2); A.ang = f(3); A.terms = terms;
  A.s_a = n(9); A.s_point = f(10); A.s_normal = f(11); A.s_pen = f(12); A.s_valid = b(13);
  A.s_fric = f(14); A.s_rest = f(15); A.s_key = n(16);
  A.p_a = n(17); A.p_b = n(18); A.p_point = f(19); A.p_normal = f(20); A.p_pen = f(21);
  A.p_valid = b(22); A.p_fric = f(23); A.p_rest = f(24); A.p_key = n(25);
  A.baumgarte = f(26); A.res_thr = f(27); A.cache = f(28);
  A.K = K; A.Q = Q; A.wm = wm; A.H = H;
  A.static_blocks = (S + kThreads - 1) / kThreads;
  A.dt = static_cast<float>(dt);
  A.sdir = o(36); A.sang = o(37); A.sr = o(38); A.sk = o(39); A.starget = o(40);
  A.svalid = o(41); A.pdir = o(42); A.pang_a = o(43); A.pang_b = o(44); A.pra = o(45);
  A.prb = o(46); A.pk = o(47); A.ptarget = o(48); A.pvalid = o(49);
  A.pab = reinterpret_cast<int*>(a[50]);
  A.ys = o(54); A.yp = o(55);
  A.h = reinterpret_cast<int*>(a[56]);
  A.valid_all = reinterpret_cast<bool*>(a[57]);
  const int blocks = A.static_blocks + (P + kThreads - 1) / kThreads;
  setup_rows_kernel<<<blocks, kThreads, 0, s>>>(A, S, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cache_refresh(const float* cache, const int* h, const bool* valid, const int* s_a,
                             const int* s_key, const int* p_a, const int* p_key,
                             const float* lam_s, const float* s_valid, const float* lam_p,
                             const float* p_valid, int S, int P, int H, int s_rs, int s_cs,
                             int p_rs, int p_cs, int* last, float* out, void* stream) {
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
                                              lam_p, p_valid, S, P, s_rs, s_cs, p_rs, p_cs, last,
                                              out);
  return static_cast<int>(cudaGetLastError());
}
