// Sphere, box and capsule closed-form contacts for one pair, shared by KK
// (closed_forms.cu, the narrowphase buckets) and KL (character.cu, the
// character's capsule probes).
//
// Each routine repeats, operation for operation, its plain twin in
// substrata_tpu_torch/kernels/closed_forms.py (the reference:
// substrata_tpu/physics/narrowphase.py:72-222).  A manifold has 4 slots;
// point contacts fill slot 0 and leave slots 1-3 at (0, -1e9, invalid).
#pragma once

#include "common.cuh"

namespace sbt {

struct Manifold {
  float pts[4][3];
  float pens[4];
  float n[3];
  bool valid[4];
};

__device__ __forceinline__ float norm3f(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ void inverse_rotate_vec(const float q[4], const float v[3],
                                                   float o[3]) {
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  rotate_vec(qc, v, o);
}

// closed_forms.py:safe_normalize
__device__ __forceinline__ void safe_normalize(const float v[3], float o[3]) {
  const float n2 = dot3(v, v);
  if (n2 > 1e-12f) {
    const float inv = 1.0f / sqrtf(fmaxf(n2, 1e-12f));
    o[0] = v[0] * inv;
    o[1] = v[1] * inv;
    o[2] = v[2] * inv;
  } else {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 1.0f;
  }
}

// closed_forms.py:safe_normalize_fma: safe_normalize with |v|^2 a
// dot3_fma (the trimesh rows of KB and KL).
__device__ __forceinline__ void safe_normalize_fma(const float v[3], float o[3]) {
  const float n2 = dot3_fma(v, v);
  if (n2 > 1e-12f) {
    const float inv = 1.0f / sqrtf(fmaxf(n2, 1e-12f));
    o[0] = v[0] * inv;
    o[1] = v[1] * inv;
    o[2] = v[2] * inv;
  } else {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 1.0f;
  }
}

__device__ __forceinline__ void one_point(Manifold& m, const float point[3], float pen,
                                          const float n[3], bool ok) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int k = 0; k < 3; ++k) m.pts[s][k] = s == 0 ? point[k] : 0.0f;
    m.pens[s] = s == 0 ? pen : -1e9f;
    m.valid[s] = s == 0 && ok;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) m.n[k] = n[k];
}

__device__ inline void sphere_sphere(const float pa[3], float ra, const float pb[3], float rb,
                                     Manifold& m) {
  const float d[3] = {pa[0] - pb[0], pa[1] - pb[1], pa[2] - pb[2]};
  const float dist = norm3f(d);
  float n[3];
  safe_normalize(d, n);
  const float pen = ra + rb - dist;
  const float s = rb - 0.5f * pen;
  const float point[3] = {pb[0] + n[0] * s, pb[1] + n[1] * s, pb[2] + n[2] * s};
  one_point(m, point, pen, n, pen > -kContactMargin);
}

__device__ inline void sphere_box(const float ps[3], float rs, const float pb[3],
                                  const float qb[4], const float he[3], Manifold& m) {
  const float rel[3] = {ps[0] - pb[0], ps[1] - pb[1], ps[2] - pb[2]};
  float p[3], c[3], delta[3], depth[3];
  inverse_rotate_vec(qb, rel, p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = fminf(fmaxf(p[k], -he[k]), he[k]);
    delta[k] = p[k] - c[k];
    depth[k] = he[k] - fabsf(p[k]);
  }
  const float dist = norm3f(delta);
  const bool outside = dist > 1e-9f;
  int ax = 0;
  if (depth[1] < depth[ax]) ax = 1;
  if (depth[2] < depth[ax]) ax = 2;
  const float p_ax = p[ax];
  const float d_ax = fminf(fminf(depth[0], depth[1]), depth[2]);
  const float s = p_ax < 0.0f ? -1.0f : 1.0f;
  float n_in[3], n_local[3], surf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) n_in[k] = (k == ax ? 1.0f : 0.0f) * s;
  if (outside) {
    safe_normalize(delta, n_local);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) n_local[k] = n_in[k];
  }
  const float pen = outside ? rs - dist : rs + d_ax;
#pragma unroll
  for (int k = 0; k < 3; ++k) surf[k] = outside ? c[k] : p[k] + n_in[k] * d_ax;
  float n[3], sw[3];
  rotate_vec(qb, n_local, n);
  rotate_vec(qb, surf, sw);
  const float point[3] = {pb[0] + sw[0], pb[1] + sw[1], pb[2] + sw[2]};
  one_point(m, point, pen, n, pen > -kContactMargin);
}

// closed_forms.py:_axis
__device__ __forceinline__ void capsule_axis(const float q[4], float h, float z[3]) {
  const float ez[3] = {0.0f, 0.0f, 1.0f};
  rotate_vec(q, ez, z);
  z[0] = z[0] * h;
  z[1] = z[1] * h;
  z[2] = z[2] * h;
}

// kernels/box_box.py:segment_closest
__device__ inline void segment_closest_pts(const float p1[3], const float d1[3],
                                           const float p2[3], const float d2[3], float* t1o,
                                           float* t2o) {
  const float r[3] = {p1[0] - p2[0], p1[1] - p2[1], p1[2] - p2[2]};
  const float a = dot3(d1, d1) + 1e-12f;
  const float e = dot3(d2, d2) + 1e-12f;
  const float b = dot3(d1, d2);
  const float c = dot3(d1, r);
  const float f = dot3(d2, r);
  const float denom = a * e - b * b;
  float t1 = 0.0f;
  if (denom > 1e-9f) t1 = fminf(fmaxf((b * f - c * e) / fmaxf(denom, 1e-9f), -1.0f), 1.0f);
  const float t2 = (b * t1 + f) / e;
  const float t2c = fminf(fmaxf(t2, -1.0f), 1.0f);
  *t1o = fminf(fmaxf((b * t2c - c) / a, -1.0f), 1.0f);
  *t2o = t2c;
}

__device__ inline void capsule_capsule(const float pa[3], const float qa[4], float ra, float ha,
                                       const float pb[3], const float qb[4], float rb, float hb,
                                       Manifold& m) {
  float za[3], zb[3], t1, t2;
  capsule_axis(qa, ha, za);
  capsule_axis(qb, hb, zb);
  segment_closest_pts(pa, za, pb, zb, &t1, &t2);
  const float ca[3] = {pa[0] + za[0] * t1, pa[1] + za[1] * t1, pa[2] + za[2] * t1};
  const float cb[3] = {pb[0] + zb[0] * t2, pb[1] + zb[1] * t2, pb[2] + zb[2] * t2};
  sphere_sphere(ca, ra, cb, rb, m);
}

__device__ inline void sphere_capsule(const float ps[3], float rs, const float pc[3],
                                      const float qc[4], float rc, float hc, Manifold& m) {
  float z[3];
  capsule_axis(qc, hc, z);
  const float rel[3] = {ps[0] - pc[0], ps[1] - pc[1], ps[2] - pc[2]};
  const float t = fminf(fmaxf(dot3(rel, z) / (dot3(z, z) + 1e-12f), -1.0f), 1.0f);
  const float c[3] = {pc[0] + z[0] * t, pc[1] + z[1] * t, pc[2] + z[2] * t};
  sphere_sphere(ps, rs, c, rc, m);
}

// The capsule-box search as the jitted reference rounds it
// (closed_forms.py:capsule_box, box_sdf): the rotations are rotate_vec (the
// jitted form), the segment point fma(z, t, pc), and the distance's norm the
// fma chain under sqrt.
__device__ __forceinline__ float box_sdf(const float p[3], const float he[3]) {
  float q[3], qp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[k] = fabsf(p[k]) - he[k];
    qp[k] = fmaxf(q[k], 0.0f);
  }
  const float n = sqrtf(__fmaf_rn(qp[2], qp[2], __fmaf_rn(qp[1], qp[1], qp[0] * qp[0])));
  return n + fminf(fmaxf(fmaxf(q[0], q[1]), q[2]), 0.0f);
}

__device__ __forceinline__ float seg_box_dist(const float pc[3], const float z[3], float t,
                                              const float pb[3], const float qb_inv[4],
                                              const float he[3]) {
  const float rel[3] = {__fmaf_rn(z[0], t, pc[0]) - pb[0], __fmaf_rn(z[1], t, pc[1]) - pb[1],
                        __fmaf_rn(z[2], t, pc[2]) - pb[2]};
  float p[3];
  rotate_vec(qb_inv, rel, p);
  return box_sdf(p, he);
}

__device__ inline void capsule_box(const float pc[3], const float qc[4], float rc, float hc,
                                   const float pb[3], const float qb[4], const float he[3],
                                   Manifold& m) {
  float z[3];
  capsule_axis(qc, hc, z);
  const float qb_inv[4] = {-qb[0], -qb[1], -qb[2], qb[3]};
  float lo = -1.0f, hi = 1.0f;
  for (int it = 0; it < 14; ++it) {
    // XLA runs the reference's static division by 3 as a multiply-add by
    // the float32 reciprocal (kernels/closed_forms.py).
    const float m1 = __fmaf_rn(hi - lo, 1.0f / 3.0f, lo);
    const float m2 = __fmaf_rn(hi - lo, -(1.0f / 3.0f), hi);
    const bool closer =
        seg_box_dist(pc, z, m1, pb, qb_inv, he) < seg_box_dist(pc, z, m2, pb, qb_inv, he);
    const float nlo = closer ? lo : m1;
    hi = closer ? m2 : hi;
    lo = nlo;
  }
  const float tstar = 0.5f * (lo + hi);
  const float c0[3] = {pc[0] + z[0] * tstar, pc[1] + z[1] * tstar, pc[2] + z[2] * tstar};
  sphere_box(c0, rc, pb, qb, he, m);   // slot 0 and the normal; slots 2-3 empty
  float pt1[3] = {0.0f, 0.0f, 0.0f};
  float pen1 = -1e9f;
  bool val1 = false;
  for (int e = 0; e < 2; ++e) {
    const float end = e == 0 ? -1.0f : 1.0f;
    const float ce[3] = {pc[0] + z[0] * end, pc[1] + z[1] * end, pc[2] + z[2] * end};
    Manifold me;
    sphere_box(ce, rc, pb, qb, he, me);
    if (me.valid[0] && me.pens[0] > pen1) {
      pt1[0] = me.pts[0][0];
      pt1[1] = me.pts[0][1];
      pt1[2] = me.pts[0][2];
      pen1 = me.pens[0];
      val1 = true;
    }
  }
  const float dd[3] = {m.pts[0][0] - pt1[0], m.pts[0][1] - pt1[1], m.pts[0][2] - pt1[2]};
  const bool dup = norm3f(dd) < 0.5f * rc;
  m.pts[1][0] = pt1[0];
  m.pts[1][1] = pt1[1];
  m.pts[1][2] = pt1[2];
  m.pens[1] = pen1;
  m.valid[1] = val1 && !dup;
}

// The per-bucket epilogue of pair_contacts (narrowphase.py:729-775) for one
// bucket slot p, shared by KK and KO (twin: closed_forms.py:bucket_rows_plain):
// the speculative one-point prune (:739-742), sensor, friction and
// restitution, `wm` rows (key b*4 + slot + 9) and the touching flag.
__device__ inline void write_rows(Manifold& m, int p, bool pv, int a, int b, int wm, int blocked,
                                  const float* __restrict__ fric,
                                  const float* __restrict__ rest,
                                  const bool* __restrict__ sensor, int* __restrict__ o_a,
                                  int* __restrict__ o_b, float* __restrict__ o_point,
                                  float* __restrict__ o_normal, float* __restrict__ o_pen,
                                  bool* __restrict__ o_valid, float* __restrict__ o_fric,
                                  float* __restrict__ o_rest, int* __restrict__ o_key,
                                  bool* __restrict__ o_touch) {
  bool near = false;
  int deepest = 0;
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m.valid[k] = m.valid[k] && pv;
    near = near || (m.valid[k] && m.pens[k] > -0.01f);
    const float v = m.valid[k] ? m.pens[k] : -1e9f;
    if (k == 0 || v > best) {
      best = v;
      deepest = k;
    }
  }
  bool touch = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m.valid[k] = m.valid[k] && (near || k == deepest);
    touch = touch || m.valid[k];
  }
  o_touch[p] = touch;
  const bool sens = sensor[a] || sensor[b];
  const float fr = sqrtf(fmaxf(fric[a] * fric[b], 0.0f));
  const float re = fmaxf(rest[a], rest[b]);
  for (int k = 0; k < wm; ++k) {
    const int r = p * wm + k;
    o_a[r] = (blocked && !pv) ? -1 : a;
    o_b[r] = b;
    o_point[r * 3 + 0] = m.pts[k][0];
    o_point[r * 3 + 1] = m.pts[k][1];
    o_point[r * 3 + 2] = m.pts[k][2];
    o_normal[r * 3 + 0] = m.n[0];
    o_normal[r * 3 + 1] = m.n[1];
    o_normal[r * 3 + 2] = m.n[2];
    o_pen[r] = m.pens[k];
    o_valid[r] = m.valid[k] && !sens;
    o_fric[r] = fr;
    o_rest[r] = re;
    o_key[r] = b * 4 + k + 9;
  }
}

// closed_forms.py:closed_form on per-side rows (pos, quat, params).
__device__ inline void closed_form(int code, const float pa[3], const float qa[4],
                                   const float pra[4], const float pb[3], const float qb[4],
                                   const float prb[4], Manifold& m) {
  bool flip = false;
  switch (code) {
    case 0: sphere_sphere(pa, pra[0], pb, prb[0], m); break;
    case 1: sphere_box(pa, pra[0], pb, qb, prb, m); break;
    case 2: sphere_capsule(pa, pra[0], pb, qb, prb[0], prb[1], m); break;
    case 4: sphere_box(pb, prb[0], pa, qa, pra, m); flip = true; break;
    case 6: capsule_box(pb, qb, prb[0], prb[1], pa, qa, pra, m); flip = true; break;
    case 8: sphere_capsule(pb, prb[0], pa, qa, pra[0], pra[1], m); flip = true; break;
    case 9: capsule_box(pa, qa, pra[0], pra[1], pb, qb, prb, m); break;
    default: capsule_capsule(pa, qa, pra[0], pra[1], pb, qb, prb[0], prb[1], m); break;
  }
  if (flip) {
    m.n[0] = -m.n[0];
    m.n[1] = -m.n[1];
    m.n[2] = -m.n[2];
  }
}

}  // namespace sbt
