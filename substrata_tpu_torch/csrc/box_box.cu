// KA: box-box contact manifolds for the broadphase pair list.
//
// Replaces substrata_tpu/physics/narrowphase.py:pair_contacts (single-combo
// branch, :670-797) and _box_box (:227-385); plain twin:
// substrata_tpu_torch/kernels/box_box.py:box_box_rows_plain.
//
// One thread per pair slot.  It gathers both bodies' pose and half-extents
// (2 x 44 bytes) and writes its 4 pair-blocked rows (4 x 49 bytes) plus the
// touching flag.  What bounds it on the card: the ~600 dependent float
// operations per pair (SAT over 15 axes, then one manifold), not memory —
// 16,384 slots move ~4.7 MB.  The design keeps everything in registers,
// one pair per thread with no shared memory and no inter-thread traffic;
// the 3x3 products are written out in the order of the plain twin.
//
// Tie rules kept from the reference: argmax takes the first maximum
// (strict '>' while scanning), sign(x) + (x == 0) is sgn() below, and the
// biased face/edge choice of narrowphase.py:276-277.
#include "common.cuh"

namespace {

using sbt::kContactMargin;
using sbt::sgn;

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// kernels/box_box.py:segment_closest
__device__ void segment_closest(const float p1[3], const float d1[3], const float p2[3],
                                const float d2[3], float* t1o, float* t2o) {
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
  if (v[1] > v[k]) k = 1;
  if (v[2] > v[k]) k = 2;
  return k;
}

// kernels/box_box.py:box_box for one pair.
__device__ void box_box(const float pa[3], const float qa[4], const float hea[3],
                        const float pb[3], const float qb[4], const float heb[3],
                        float pts[4][3], float pens[4], float normal[3], bool valid[4]) {
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

  float sep_e[9], axes_e[9][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      float axis[3] = {0.0f, 0.0f, 0.0f};
      axis[i1] = -c[i2][j];
      axis[i2] = c[i1][j];
      const float alen = norm3(axis);
      const float den = fmaxf(alen, 1e-9f);
      float an[3] = {axis[0] / den, axis[1] / den, axis[2] / den};
      const float ra_proj = hea[i1] * absc[i2][j] + hea[i2] * absc[i1][j];
      const float rb_proj = heb[j1] * absc[i][j2] + heb[j2] * absc[i][j1];
      float dist = fabsf(sbt::dot3(t, an)) - (ra_proj + rb_proj) / den;
      sep_e[i * 3 + j] = alen > 1e-6f ? dist : -1e9f;
      axes_e[i * 3 + j][0] = an[0];
      axes_e[i * 3 + j][1] = an[1];
      axes_e[i * 3 + j][2] = an[2];
    }

  const float best_face_a = fmaxf(fmaxf(sep_a[0], sep_a[1]), sep_a[2]);
  const float best_face_b = fmaxf(fmaxf(sep_b[0], sep_b[1]), sep_b[2]);
  int eidx = 0;
#pragma unroll
  for (int k = 1; k < 9; ++k)
    if (sep_e[k] > sep_e[eidx]) eidx = k;
  const float best_edge = sep_e[eidx];
  const float best_face = fmaxf(best_face_a, best_face_b);
  const bool separated = fmaxf(best_face, best_edge) > kContactMargin;
  const bool use_edge = best_edge > best_face * 0.98f + 0.001f;
  const bool use_b_face = !use_edge && (best_face_b > best_face_a * 0.98f + 0.001f);

  if (!use_edge) {
    // Reference-face manifold: the incident face's 4 corners clamped into
    // the reference face rectangle (narrowphase.py:285-325).
    const float* p_ref = use_b_face ? pb : pa;
    const float* q_ref = use_b_face ? qb : qa;
    const float* he_ref = use_b_face ? heb : hea;
    const float* p_inc = use_b_face ? pa : pb;
    const float* q_inc = use_b_face ? qa : qb;
    const float* he_inc = use_b_face ? hea : heb;
    const float* sep_sel = use_b_face ? sep_b : sep_a;
    const int ax = argmax3(sep_sel);
    float r_ref[3][3], r_inc[3][3];
    sbt::quat_to_matrix(q_ref, r_ref);
    const float d_ri[3] = {p_inc[0] - p_ref[0], p_inc[1] - p_ref[1], p_inc[2] - p_ref[2]};
    float t_ref[3];
    sbt::mtv(r_ref, d_ri, t_ref);
    const float t_ax = t_ref[ax];
    const float he_ax = he_ref[ax];
    const float s = sgn(t_ax);
    const float n_world[3] = {s * r_ref[0][ax], s * r_ref[1][ax], s * r_ref[2][ax]};
    sbt::quat_to_matrix(q_inc, r_inc);
    float dots[3];
    sbt::mtv(r_inc, n_world, dots);
    const float ad[3] = {fabsf(dots[0]), fabsf(dots[1]), fabsf(dots[2])};
    const int ai = argmax3(ad);
    const float inc_sgn = -sgn(dots[ai]);
    const int u1 = (ai + 1) % 3, u2 = (ai + 2) % 3;
    float e0[3], e1[3], e2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e0[k] = (r_inc[k][ai] * he_inc[ai]) * inc_sgn;
      e1[k] = r_inc[k][u1] * he_inc[u1];
      e2[k] = r_inc[k][u2] * he_inc[u2];
    }
    const float he_inc_max = fmaxf(fmaxf(he_inc[0], he_inc[1]), he_inc[2]);
    const float lat_lim = he_inc_max * 1.5f;
    const float sg1[4] = {1.0f, -1.0f, -1.0f, 1.0f};
    const float sg2[4] = {1.0f, 1.0f, -1.0f, -1.0f};
#pragma unroll
    for (int cidx = 0; cidx < 4; ++cidx) {
      float corner[3], rel[3], local[3], cl[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float base = p_inc[k] + e0[k];
        const float b1 = sg1[cidx] > 0.0f ? base + e1[k] : base - e1[k];
        corner[k] = sg2[cidx] > 0.0f ? b1 + e2[k] : b1 - e2[k];
        rel[k] = corner[k] - p_ref[k];
      }
      sbt::mtv(r_ref, rel, local);
      const float depth = he_ax - s * local[ax];
      const float ax_val = s * (he_ax - fmaxf(depth, 0.0f) * 0.5f);
      float diff[3];
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
      for (int k = 0; k < 3; ++k) pts[cidx][k] = p_ref[k] + wp[k];
      pens[cidx] = vm ? depth : -1e9f;
      valid[cidx] = vm && !separated;
    }
    // n_world points ref -> inc; the contact normal points b -> a.
#pragma unroll
    for (int k = 0; k < 3; ++k) normal[k] = use_b_face ? n_world[k] : -n_world[k];
    return;
  }

  // Edge-edge single point (narrowphase.py:349-377).
  const int ei = eidx / 3, ej = eidx % 3;
  float n_edge[3];
  sbt::mv(ra, axes_e[eidx], n_edge);
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
  float oa[3], ob[3], a_c[3], b_c[3], ea[3], eb[3];
  sbt::mv(ra, va, oa);
  sbt::mv(rb, vb, ob);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a_c[k] = pa[k] + oa[k];
    b_c[k] = pb[k] + ob[k];
    ea[k] = ra[k][ei] * hea[ei];
    eb[k] = rb[k][ej] * heb[ej];
  }
  float t1, t2;
  segment_closest(a_c, ea, b_c, eb, &t1, &t2);
  const float edge_pen = -best_edge;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float pe_a = a_c[k] + ea[k] * t1;
    const float pe_b = b_c[k] + eb[k] * t2;
    pts[0][k] = 0.5f * (pe_a + pe_b);
    normal[k] = -n_edge[k];
  }
#pragma unroll
  for (int cidx = 1; cidx < 4; ++cidx) {
    pts[cidx][0] = pts[cidx][1] = pts[cidx][2] = 0.0f;
    pens[cidx] = -1e9f;
    valid[cidx] = false;
  }
  pens[0] = edge_pen;
  valid[0] = (edge_pen > -kContactMargin) && !separated;
}

__global__ void box_box_rows_kernel(
    const int* __restrict__ pair_a, const int* __restrict__ pair_b,
    const bool* __restrict__ pair_valid, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ params,
    const float* __restrict__ fric, const float* __restrict__ rest,
    const bool* __restrict__ sensor, int n_pairs, int* __restrict__ o_a,
    int* __restrict__ o_b, float* __restrict__ o_point, float* __restrict__ o_normal,
    float* __restrict__ o_pen, bool* __restrict__ o_valid, float* __restrict__ o_fric,
    float* __restrict__ o_rest, int* __restrict__ o_key, bool* __restrict__ o_touch) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const bool pv = pair_valid[p];
  const int a = max(pair_a[p], 0);
  const int b = max(pair_b[p], 0);
  float pa[3], qa[4], hea[3], pb[3], qb[4], heb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pa[k] = pos[a * 3 + k];
    pb[k] = pos[b * 3 + k];
    hea[k] = params[a * 4 + k];
    heb[k] = params[b * 4 + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qa[k] = quat[a * 4 + k];
    qb[k] = quat[b * 4 + k];
  }
  float pts[4][3], pens[4], normal[3];
  bool valid[4];
  box_box(pa, qa, hea, pb, qb, heb, pts, pens, normal, valid);

  // Speculative one-point prune (narrowphase.py:739-742).
  bool near = false;
  int deepest = 0;
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    valid[k] = valid[k] && pv;
    near = near || (valid[k] && pens[k] > -0.01f);
    const float v = valid[k] ? pens[k] : -1e9f;
    if (k == 0 || v > best) {
      best = v;
      deepest = k;
    }
  }
  bool touch = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    valid[k] = valid[k] && (near || k == deepest);
    touch = touch || valid[k];
  }
  o_touch[p] = touch && pv;
  const bool sens = sensor[a] || sensor[b];
  const float fr = sqrtf(fmaxf(fric[a] * fric[b], 0.0f));
  const float re = fmaxf(rest[a], rest[b]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = p * 4 + k;
    o_a[r] = pv ? a : -1;
    o_b[r] = b;
    o_point[r * 3 + 0] = pts[k][0];
    o_point[r * 3 + 1] = pts[k][1];
    o_point[r * 3 + 2] = pts[k][2];
    o_normal[r * 3 + 0] = normal[0];
    o_normal[r * 3 + 1] = normal[1];
    o_normal[r * 3 + 2] = normal[2];
    o_pen[r] = pens[k];
    o_valid[r] = valid[k] && !sens;
    o_fric[r] = fr;
    o_rest[r] = re;
    o_key[r] = b * 4 + k + 9;
  }
}

}  // namespace

extern "C" int box_box_rows(const int* pair_a, const int* pair_b, const bool* pair_valid,
                            const float* pos, const float* quat, const float* params,
                            const float* fric, const float* rest, const bool* sensor,
                            int n_pairs, int* o_a, int* o_b, float* o_point,
                            float* o_normal, float* o_pen, bool* o_valid, float* o_fric,
                            float* o_rest, int* o_key, bool* o_touch, void* stream) {
  if (n_pairs > 0) {
    const int threads = 128;
    const int blocks = (n_pairs + threads - 1) / threads;
    box_box_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        pair_a, pair_b, pair_valid, pos, quat, params, fric, rest, sensor, n_pairs, o_a,
        o_b, o_point, o_normal, o_pen, o_valid, o_fric, o_rest, o_key, o_touch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
