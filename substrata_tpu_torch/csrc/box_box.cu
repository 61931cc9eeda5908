// KA: box-box contact manifolds for the broadphase pair list.
//
// Replaces substrata_tpu/physics/narrowphase.py:pair_contacts (single-combo
// branch, :670-797) and _box_box (:227-385); plain twin:
// substrata_tpu_torch/kernels/box_box.py:box_box_rows_plain.
//
// Four lanes a pair slot (a quad), lane k owning row 4p + k.  The quad
// loads both bodies' 20 geometry floats five a lane, all issued before the
// first use, and shares them by shuffles.  Each lane computes the rotations,
// c = ra^T rb, |c| and the six face separations (cheap, and every lane needs
// them); the nine edge axes are split over the lanes (lane k takes axes k,
// k + 4, k + 8) and reduced by shuffles to the first maximum in index order,
// the serial scan's tie rule.  Only the chosen edge axis is used afterwards,
// recomputed from its index with the same operations, so no lane keeps an
// array of axes and nothing is indexed at run time (small selects instead).
// The face manifold's four corners are independent: lane k computes corner
// k.  The edge-edge point is lane 0's row; lanes 1-3 write the invalid rows.
// The speculative prune (narrowphase.py:739-742) reads the quad's four
// depths by shuffles and keeps the first deepest.  A warp's stores are 32
// consecutive rows of each field.  What bounds it on the card: the ~600
// dependent float operations per pair (SAT over 15 axes, then one
// manifold), not memory (16,384 slots move ~4.7 MB); the quads put four
// times the parent's warps in flight to hide that chain's latency.
//
// Every value rounds as the twin's (and the parent kernel's, one thread a
// slot) does: the same operations in the same order, IEEE divisions and
// square roots, -fmad=false.  Tie rules kept from the reference: argmax
// takes the first maximum (strict '>' while scanning), sign(x) + (x == 0)
// is sgn() below, and the biased face/edge choice of narrowphase.py:276-277.
#include "common.cuh"

namespace {

using sbt::kContactMargin;
using sbt::sgn;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// v[k] for a run-time k in 0..2, by selects (no local-memory array).
__device__ __forceinline__ float sel3(const float v[3], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ void col3(const float m[3][3], int k, float o[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) o[r] = sel3(m[r], k);
}

// kernels/box_box.py:segment_closest
__device__ __forceinline__ void segment_closest(const float p1[3], const float d1[3],
                                                const float p2[3], const float d2[3],
                                                float* t1o, float* t2o) {
  float r[3] = {p1[0] - p2[0], p1[1] - p2[1], p1[2] - p2[2]};
  const float a = sbt::dot3(d1, d1) + 1e-12f;
  const float e = sbt::dot3(d2, d2) + 1e-12f;
  const float b = sbt::dot3(d1, d2);
  const float c = sbt::dot3(d1, r);
  const float f = sbt::dot3(d2, r);
  const float denom = a * e - b * b;
  float t1 = 0.0f;
  if (denom > 1e-9f) t1 = fminf(fmaxf((b * f - c * e) / fmaxf(denom, 1e-9f), -1.0f), 1.0f);
  const float t2 = (b * t1 + f) / e;
  const float t2c = fminf(fmaxf(t2, -1.0f), 1.0f);
  *t1o = fminf(fmaxf((b * t2c - c) / a, -1.0f), 1.0f);
  *t2o = t2c;
}

__device__ __forceinline__ int argmax3(const float v[3]) {
  int k = 0;
  if (v[1] > v[0]) k = 1;
  if (v[2] > sel3(v, k)) k = 2;
  return k;
}

// Edge axis e = 3 i + j (the twin's loop body): the unit axis, its length
// and the separation along it.
__device__ __forceinline__ float edge_axis(int e, const float c[3][3], const float absc[3][3],
                                           const float t[3], const float hea[3],
                                           const float heb[3], float an[3], float* alen_o) {
  const int i = e / 3, j = e % 3;
  const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
  const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
  float cj[3], aj[3];   // column j of c and of |c|
  col3(c, j, cj);
  col3(absc, j, aj);
  float ar[3];          // row i of |c|
#pragma unroll
  for (int k = 0; k < 3; ++k)
    ar[k] = i == 0 ? absc[0][k] : (i == 1 ? absc[1][k] : absc[2][k]);
  float axis[3] = {0.0f, 0.0f, 0.0f};
  const float m2 = -sel3(cj, i2), m1 = sel3(cj, i1);
#pragma unroll
  for (int k = 0; k < 3; ++k) axis[k] = k == i1 ? m2 : (k == i2 ? m1 : 0.0f);
  const float alen = norm3(axis);
  const float den = fmaxf(alen, 1e-9f);
  an[0] = axis[0] / den;
  an[1] = axis[1] / den;
  an[2] = axis[2] / den;
  const float ra_proj = sel3(hea, i1) * sel3(aj, i2) + sel3(hea, i2) * sel3(aj, i1);
  const float rb_proj = sel3(heb, j1) * sel3(ar, j2) + sel3(heb, j2) * sel3(ar, j1);
  *alen_o = alen;
  return fabsf(sbt::dot3(t, an)) - (ra_proj + rb_proj) / den;
}

// Geometry float f (0..19) of the slot: body a's pos, quat, half extents,
// then body b's.
__device__ __forceinline__ float load_geom(int f, int a, int b, const float* __restrict__ pos,
                                           const float* __restrict__ quat,
                                           const float* __restrict__ params) {
  const int body = f < 10 ? a : b;
  const int g = f < 10 ? f : f - 10;
  return g < 3 ? pos[body * 3 + g]
               : (g < 7 ? quat[body * 4 + g - 3] : params[body * 4 + g - 7]);
}

__global__ void __launch_bounds__(kThreads) box_box_rows_kernel(
    const int* __restrict__ pair_a, const int* __restrict__ pair_b,
    const bool* __restrict__ pair_valid, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ params,
    const float* __restrict__ fric, const float* __restrict__ rest,
    const bool* __restrict__ sensor, int n_pairs, int* __restrict__ o_a,
    int* __restrict__ o_b, float* __restrict__ o_point, float* __restrict__ o_normal,
    float* __restrict__ o_pen, bool* __restrict__ o_valid, float* __restrict__ o_fric,
    float* __restrict__ o_rest, int* __restrict__ o_key, bool* __restrict__ o_touch) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gt & 3;
  const int p_raw = gt >> 2;
  const bool live = p_raw < n_pairs;   // tail quads compute the last slot, store nothing
  const int p = live ? p_raw : n_pairs - 1;
  const int qbase = (threadIdx.x & 31) & ~3;

  const bool pv = pair_valid[p];
  const int a = max(pair_a[p], 0);
  const int b = max(pair_b[p], 0);
  // Lane k loads geometry floats k, k + 4, ..., k + 16; the material of
  // both bodies is read by every lane (one address a quad).
  float mine[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) mine[r] = load_geom(4 * r + lane, a, b, pos, quat, params);
  const float fa = fric[a], fb = fric[b], rsa = rest[a], rsb = rest[b];
  const bool sens = sensor[a] || sensor[b];
  float geom[20];
#pragma unroll
  for (int f = 0; f < 20; ++f) geom[f] = __shfl_sync(kFull, mine[f >> 2], qbase + (f & 3));
  const float pa[3] = {geom[0], geom[1], geom[2]};
  const float qa[4] = {geom[3], geom[4], geom[5], geom[6]};
  const float hea[3] = {geom[7], geom[8], geom[9]};
  const float pb[3] = {geom[10], geom[11], geom[12]};
  const float qb[4] = {geom[13], geom[14], geom[15], geom[16]};
  const float heb[3] = {geom[17], geom[18], geom[19]};

  // SAT (kernels/box_box.py:box_box), the face axes on every lane.
  float ra[3][3], rb[3][3], c[3][3], absc[3][3];
  sbt::quat_to_matrix(qa, ra);
  sbt::quat_to_matrix(qb, rb);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[i][j] = ra[0][i] * rb[0][j] + ra[1][i] * rb[1][j] + ra[2][i] * rb[2][j];
      absc[i][j] = fabsf(c[i][j]) + 1e-5f;
    }
  const float t_w[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
  float t[3], tb[3], s1[3], s2[3], sep_a[3], sep_b[3];
  sbt::mtv(ra, t_w, t);
  sbt::mv(absc, heb, s1);
  sbt::mtv(c, t, tb);
  sbt::mtv(absc, hea, s2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sep_a[i] = fabsf(t[i]) - (hea[i] + s1[i]);
    sep_b[i] = fabsf(tb[i]) - (heb[i] + s2[i]);
  }

  // The edge axes: lane k scans axes k, k + 4, k + 8 (first maximum), then
  // the quad keeps the larger separation, the lower axis on ties.
  float best_edge = 0.0f;
  int eidx = -1;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int e = lane + 4 * r;
    if (e < 9) {
      float an[3], alen;
      float dist = edge_axis(e, c, absc, t, hea, heb, an, &alen);
      dist = alen > 1e-6f ? dist : -1e9f;
      if (eidx < 0 || dist > best_edge) {
        best_edge = dist;
        eidx = e;
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float s_o = __shfl_xor_sync(kFull, best_edge, o);
    const int e_o = __shfl_xor_sync(kFull, eidx, o);
    if (s_o > best_edge || (s_o == best_edge && e_o < eidx)) {
      best_edge = s_o;
      eidx = e_o;
    }
  }

  const float best_face_a = fmaxf(fmaxf(sep_a[0], sep_a[1]), sep_a[2]);
  const float best_face_b = fmaxf(fmaxf(sep_b[0], sep_b[1]), sep_b[2]);
  const float best_face = fmaxf(best_face_a, best_face_b);
  const bool separated = fmaxf(best_face, best_edge) > kContactMargin;
  const bool use_edge = best_edge > best_face * 0.98f + 0.001f;
  const bool use_b_face = !use_edge && (best_face_b > best_face_a * 0.98f + 0.001f);

  float pt[3], pen, normal[3];
  bool valid;
  if (!use_edge) {
    // Reference-face manifold (narrowphase.py:285-325): lane k clamps the
    // incident face's corner k into the reference face rectangle.
    float p_ref[3], q_ref[4], he_ref[3], p_inc[3], q_inc[4], he_inc[3], sep_sel[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p_ref[k] = use_b_face ? pb[k] : pa[k];
      he_ref[k] = use_b_face ? heb[k] : hea[k];
      p_inc[k] = use_b_face ? pa[k] : pb[k];
      he_inc[k] = use_b_face ? hea[k] : heb[k];
      sep_sel[k] = use_b_face ? sep_b[k] : sep_a[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q_ref[k] = use_b_face ? qb[k] : qa[k];
      q_inc[k] = use_b_face ? qa[k] : qb[k];
    }
    const int ax = argmax3(sep_sel);
    float r_ref[3][3], r_inc[3][3];
    sbt::quat_to_matrix(q_ref, r_ref);
    const float d_ri[3] = {p_inc[0] - p_ref[0], p_inc[1] - p_ref[1], p_inc[2] - p_ref[2]};
    float t_ref[3];
    sbt::mtv(r_ref, d_ri, t_ref);
    const float t_ax = sel3(t_ref, ax);
    const float he_ax = sel3(he_ref, ax);
    const float s = sgn(t_ax);
    float rc[3];
    col3(r_ref, ax, rc);
    const float n_world[3] = {s * rc[0], s * rc[1], s * rc[2]};
    sbt::quat_to_matrix(q_inc, r_inc);
    float dots[3];
    sbt::mtv(r_inc, n_world, dots);
    const float ad[3] = {fabsf(dots[0]), fabsf(dots[1]), fabsf(dots[2])};
    const int ai = argmax3(ad);
    const float inc_sgn = -sgn(sel3(dots, ai));
    const int u1 = (ai + 1) % 3, u2 = (ai + 2) % 3;
    float c0[3], c1[3], c2[3];
    col3(r_inc, ai, c0);
    col3(r_inc, u1, c1);
    col3(r_inc, u2, c2);
    const float h0 = sel3(he_inc, ai), h1 = sel3(he_inc, u1), h2 = sel3(he_inc, u2);
    float e0[3], e1[3], e2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e0[k] = (c0[k] * h0) * inc_sgn;
      e1[k] = c1[k] * h1;
      e2[k] = c2[k] * h2;
    }
    const float he_inc_max = fmaxf(fmaxf(he_inc[0], he_inc[1]), he_inc[2]);
    const float lat_lim = he_inc_max * 1.5f;
    // Corner k: (+e1, +e2), (-e1, +e2), (-e1, -e2), (+e1, -e2).
    const bool plus1 = lane == 0 || lane == 3, plus2 = lane < 2;
    float corner[3], rel[3], local[3], cl[3], diff[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float base = p_inc[k] + e0[k];
      const float b1 = plus1 ? base + e1[k] : base - e1[k];
      corner[k] = plus2 ? b1 + e2[k] : b1 - e2[k];
      rel[k] = corner[k] - p_ref[k];
    }
    sbt::mtv(r_ref, rel, local);
    const float depth = he_ax - s * sel3(local, ax);
    const float ax_val = s * (he_ax - fmaxf(depth, 0.0f) * 0.5f);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cl[j] = fminf(fmaxf(local[j], -he_ref[j]), he_ref[j]);
      if (j == ax) cl[j] = ax_val;
      diff[j] = j == ax ? 0.0f : cl[j] - local[j];
    }
    float wp[3];
    sbt::mv(r_ref, cl, wp);
    const float lateral = norm3(diff);
    const bool vm = (depth > -kContactMargin) && (lateral < lat_lim);
#pragma unroll
    for (int k = 0; k < 3; ++k) pt[k] = p_ref[k] + wp[k];
    pen = vm ? depth : -1e9f;
    valid = vm && !separated;
    // n_world points ref -> inc; the contact normal points b -> a.
#pragma unroll
    for (int k = 0; k < 3; ++k) normal[k] = use_b_face ? n_world[k] : -n_world[k];
  } else {
    // Edge-edge single point (narrowphase.py:349-377), the chosen axis
    // recomputed from its index.
    const int ei = eidx / 3, ej = eidx % 3;
    float an[3], alen;
    edge_axis(eidx, c, absc, t, hea, heb, an, &alen);
    float n_edge[3];
    sbt::mv(ra, an, n_edge);
    const float fl = sgn(sbt::dot3(n_edge, t_w));
#pragma unroll
    for (int k = 0; k < 3; ++k) n_edge[k] = n_edge[k] * fl;
    float sa_raw[3], sb_raw[3], va[3], vb[3];
    sbt::mtv(ra, n_edge, sa_raw);
    sbt::mtv(rb, n_edge, sb_raw);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      va[m] = m == ei ? 0.0f : sgn(sa_raw[m]) * hea[m];
      vb[m] = m == ej ? 0.0f : sgn(-sb_raw[m]) * heb[m];
    }
    float oa[3], ob[3], a_c[3], b_c[3], ea[3], eb[3], cra[3], crb[3];
    sbt::mv(ra, va, oa);
    sbt::mv(rb, vb, ob);
    col3(ra, ei, cra);
    col3(rb, ej, crb);
    const float hei = sel3(hea, ei), hej = sel3(heb, ej);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a_c[k] = pa[k] + oa[k];
      b_c[k] = pb[k] + ob[k];
      ea[k] = cra[k] * hei;
      eb[k] = crb[k] * hej;
    }
    float t1, t2;
    segment_closest(a_c, ea, b_c, eb, &t1, &t2);
    const float edge_pen = -best_edge;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pe_a = a_c[k] + ea[k] * t1;
      const float pe_b = b_c[k] + eb[k] * t2;
      pt[k] = lane == 0 ? 0.5f * (pe_a + pe_b) : 0.0f;
      normal[k] = -n_edge[k];
    }
    pen = lane == 0 ? edge_pen : -1e9f;
    valid = lane == 0 && (edge_pen > -kContactMargin) && !separated;
  }

  // Speculative one-point prune (narrowphase.py:739-742) over the quad.
  valid = valid && pv;
  const float v_mine = valid ? pen : -1e9f;
  const int near_mine = valid && pen > -0.01f;
  bool near = false;
  int deepest = 0;
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = __shfl_sync(kFull, v_mine, qbase + k);
    const int near_k = __shfl_sync(kFull, near_mine, qbase + k);   // every lane shuffles
    near = near || near_k != 0;
    if (k == 0 || v > best) {
      best = v;
      deepest = k;
    }
  }
  valid = valid && (near || lane == deepest);
  const unsigned ballot = __ballot_sync(kFull, valid);
  const bool touch = ((ballot >> qbase) & 0xfu) != 0u;
  if (!live) return;
  if (lane == 0) o_touch[p] = touch && pv;
  const int r = p * 4 + lane;
  o_a[r] = pv ? a : -1;
  o_b[r] = b;
  o_point[r * 3 + 0] = pt[0];
  o_point[r * 3 + 1] = pt[1];
  o_point[r * 3 + 2] = pt[2];
  o_normal[r * 3 + 0] = normal[0];
  o_normal[r * 3 + 1] = normal[1];
  o_normal[r * 3 + 2] = normal[2];
  o_pen[r] = pen;
  o_valid[r] = valid && !sens;
  o_fric[r] = sqrtf(fmaxf(fa * fb, 0.0f));
  o_rest[r] = fmaxf(rsa, rsb);
  o_key[r] = b * 4 + lane + 9;
}

}  // namespace

// One packed argument (kernels/box_box.py:_PACK): pair_a, pair_b,
// pair_valid, pos, quat, params, fric, rest, sensor, the 10 outputs, then
// the slot count.
struct BoxBoxArgs {
  const int* pair_a;
  const int* pair_b;
  const bool* pair_valid;
  const float* pos;
  const float* quat;
  const float* params;
  const float* fric;
  const float* rest;
  const bool* sensor;
  int* o_a;
  int* o_b;
  float* o_point;
  float* o_normal;
  float* o_pen;
  bool* o_valid;
  float* o_fric;
  float* o_rest;
  int* o_key;
  bool* o_touch;
  long long n_pairs;
};

extern "C" int box_box_rows(const BoxBoxArgs* args, void* stream) {
  const BoxBoxArgs A = *args;
  const int n = static_cast<int>(A.n_pairs);
  if (n > 0) {
    const long long threads = 4LL * n;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    box_box_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        A.pair_a, A.pair_b, A.pair_valid, A.pos, A.quat, A.params, A.fric, A.rest, A.sensor,
        n, A.o_a, A.o_b, A.o_point, A.o_normal, A.o_pen, A.o_valid, A.o_fric, A.o_rest,
        A.o_key, A.o_touch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
