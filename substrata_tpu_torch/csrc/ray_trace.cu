// KH: the first hit of each ray among the bodies, the heightfield and the
// static trimesh.
//
// Replaces substrata_tpu/physics/queries.py:_ray_bodies (:243-390) with the
// hull-plane clip _ray_hull_planes (:134-158), _ray_heightfield_single
// (:180-220) and _ray_trimesh_single (:223-240) with _ray_triangle (:161), as
// trace_rays (:395-440) combines them; plain twin:
// substrata_tpu_torch/kernels/ray_trace.py:ray_trace_plain.
//
// What bounds it on the card: latency.  Every candidate is a chain of
// dependent gathers (its table entry, then the body's flags, position and
// radius), every trimesh test another (the cell entry, the triangle, its
// vertices), and the bytes and operations are small (bounds of 0.003-0.8
// us).  A thread per ray walked its 118-1,216 candidates and its 128
// triangle tests one after another; the design spreads each ray over one
// warp, four rays a block, so that no thread walks a ray's candidates or
// triangles alone:
// - Stage 1: the lanes stride the ray's candidate columns in the
//   reference's gather order (9 xy-neighbour cells x body_steps march
//   points x cell capacity, then the oversize slots), four columns a lane a
//   pass with all their loads issued before any is used, and key each by
//   its bounding-sphere entry distance.  A ballot names the finite keys
//   (few: most columns are empty or out of reach); the warp inserts each,
//   in column order, into the k-entry sorted list that lane j holds entry j
//   of: a ballot counts the entries before it (ties to the earlier column,
//   or with dedup to the lower slot; a body met again is skipped, all its
//   copies sharing one key), as lax.top_k picks them from the reference's
//   slot-sorted row.  With no finite key, survivor 0 is the first
//   candidate (the lowest slot with dedup) and only its normal is reported.
// - Stage 2: lane j runs the exact sphere, box, capsule or hull test on
//   survivor j (a hull: the ray in hull-local space clipped by its library
//   planes, the entering face's normal, the first on ties); a warp argmin
//   keeps the first minimum.
// - The heightfield: the lanes take the march samples (flat: the analytic
//   plane hit); a ballot finds the first below the surface; the 10
//   bisection steps stay serial, warp-uniform, their midpoints rounding as
//   the twin's.
// - The trimesh: the lanes take the n_steps x 8 (step, slot) tests (the
//   first 8 triangles of the grid cell at each march point, Moller-Trumbore;
//   empty slots are skipped, as the twin masks them); a warp argmin keeps
//   the first minimum.  It wins the combine only strictly and reports its
//   triangle's owner and material.
// No [rays x candidates] intermediate reaches device memory.
#include <cstring>

#include "trimesh.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxK = 16;
constexpr int kTriCap = 8;   // triangles read per grid cell of the march
constexpr int kSphere = 0, kBox = 1, kCapsule = 2;
constexpr int kWarps = 4;    // rays (warps) per block
constexpr int kUnroll = 4;   // candidate columns per lane per pass
constexpr unsigned kFull = 0xffffffffu;

// kernels/ray_trace.py:_ray_sphere
__device__ float ray_sphere(const float o[3], const float d[3], const float c[3], float r,
                            float n[3]) {
  const float oc[3] = {o[0] - c[0], o[1] - c[1], o[2] - c[2]};
  const float b = sbt::dot3(oc, d);
  const float cc = sbt::dot3(oc, oc) - r * r;
  const float disc = b * b - cc;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = -b - sq;
  if (t < 0.0f) t = -b + sq;
  const bool ok = disc >= 0.0f && t >= 0.0f;
  const float rr = fmaxf(r, 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = (o[k] + d[k] * t - c[k]) / rr;
  return ok ? t : kBig;
}

__device__ __forceinline__ void inv_rotate(const float q[4], const float v[3], float o[3]) {
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  sbt::rotate_vec(qc, v, o);
}

// kernels/ray_trace.py:_ray_box
__device__ float ray_box(const float o[3], const float d[3], const float pb[3],
                         const float qb[4], const float he[3], float n[3]) {
  const float rel[3] = {o[0] - pb[0], o[1] - pb[1], o[2] - pb[2]};
  float ol[3], dl[3], tmin_ax[3], tmax_ax[3];
  inv_rotate(qb, rel, ol);
  inv_rotate(qb, d, dl);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float small = (dl[k] < 0.0f ? -1e-9f : (dl[k] > 0.0f ? 1e-9f : 0.0f)) +
                        (dl[k] == 0.0f ? 1e-9f : 0.0f);
    const float inv = 1.0f / (fabsf(dl[k]) > 1e-9f ? dl[k] : small);
    const float t1 = (-he[k] - ol[k]) * inv;
    const float t2 = (he[k] - ol[k]) * inv;
    tmin_ax[k] = fminf(t1, t2);
    tmax_ax[k] = fmaxf(t1, t2);
  }
  const float tmin = fmaxf(fmaxf(tmin_ax[0], tmin_ax[1]), tmin_ax[2]);
  const float tmax = fminf(fminf(tmax_ax[0], tmax_ax[1]), tmax_ax[2]);
  const bool ok = tmax >= tmin && tmax >= 0.0f;
  const float t = tmin >= 0.0f ? tmin : tmax;
  int ax = 0;
  if (tmin_ax[1] > tmin_ax[ax]) ax = 1;
  if (tmin_ax[2] > tmin_ax[ax]) ax = 2;
  const float dax = dl[ax];
  const float val = (dax < 0.0f ? 1.0f : (dax > 0.0f ? -1.0f : 0.0f)) + (dax == 0.0f ? 1.0f : 0.0f);
  float nl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nl[k] = (k == ax ? 1.0f : 0.0f) * val;
  sbt::rotate_vec(qb, nl, n);
  return ok ? t : kBig;
}

// kernels/ray_trace.py:_ray_capsule
__device__ float ray_capsule(const float o[3], const float d[3], const float pc[3],
                             const float qc[4], float r, float hh, float n[3]) {
  const float ez[3] = {0.0f, 0.0f, 1.0f};
  float z[3];
  sbt::rotate_vec(qc, ez, z);
#pragma unroll
  for (int k = 0; k < 3; ++k) z[k] = z[k] * hh;
  const float w[3] = {o[0] - pc[0], o[1] - pc[1], o[2] - pc[2]};
  const float zn = sqrtf(sbt::dot3(z, z));
  const float zd = fmaxf(zn, 1e-9f);
  const float a_ax[3] = {z[0] / zd, z[1] / zd, z[2] / zd};
  const float da = sbt::dot3(d, a_ax), wa = sbt::dot3(w, a_ax);
  float d_perp[3], w_perp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d_perp[k] = d[k] - da * a_ax[k];
    w_perp[k] = w[k] - wa * a_ax[k];
  }
  const float a = sbt::dot3(d_perp, d_perp);
  const float b = sbt::dot3(d_perp, w_perp);
  const float c = sbt::dot3(w_perp, w_perp) - r * r;
  const float disc = b * b - a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t_cyl = (-b - sq) / (a > 1e-9f ? a : 1e-9f);
  bool ok_cyl = disc >= 0.0f && a > 1e-9f && t_cyl >= 0.0f;
  float hitp[3], rel[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hitp[k] = o[k] + d[k] * t_cyl;
    rel[k] = hitp[k] - pc[k];
  }
  const float s = sbt::dot3(rel, a_ax);
  ok_cyl = ok_cyl && fabsf(s) <= zn;
  float n_cyl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) n_cyl[k] = hitp[k] - (pc[k] + a_ax[k] * s);
  const float nn = fmaxf(sqrtf(sbt::dot3(n_cyl, n_cyl)), 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) n_cyl[k] = n_cyl[k] / nn;
  const float ca[3] = {pc[0] + z[0], pc[1] + z[1], pc[2] + z[2]};
  const float cb[3] = {pc[0] - z[0], pc[1] - z[1], pc[2] - z[2]};
  float n_a[3], n_b[3];
  const float t_a = ray_sphere(o, d, ca, r, n_a);
  const float t_b = ray_sphere(o, d, cb, r, n_b);
  float t = ok_cyl ? t_cyl : kBig;
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = ok_cyl ? n_cyl[k] : ez[k];
  if (t_a < t) {
    t = t_a;
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = n_a[k];
  }
  if (t_b < t) {
    t = t_b;
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = n_b[k];
  }
  return t;
}

// kernels/ray_trace.py:_ray_hull_planes: the ray clipped by the hull's face
// planes `pl` [MF, 4] (the first nf valid).
__device__ float ray_hull(const float o[3], const float d[3], const float pb[3],
                          const float qb[4], const float* __restrict__ pl, int nf, int MF,
                          float n[3]) {
  const float rel[3] = {o[0] - pb[0], o[1] - pb[1], o[2] - pb[2]};
  float ol[3], dl[3];
  inv_rotate(qb, rel, ol);
  inv_rotate(qb, d, dl);
  const float eps = 1e-9f;
  // Faces past nf enter the reference's max as 0 and its argmax as -BIG.
  float t_enter = nf < MF ? 0.0f : -INFINITY;
  float t_exit = kBig;
  float score = -kBig;
  int j = 0;
  bool par_out = false;
  for (int f = 0; f < nf; ++f) {
    const float* row = pl + 4 * f;
    const float denom = row[0] * dl[0] + row[1] * dl[1] + row[2] * dl[2];
    const float dist = row[3] - (row[0] * ol[0] + row[1] * ol[1] + row[2] * ol[2]);
    const float t_pl = dist / (fabsf(denom) > eps ? denom : eps);
    const bool entering = denom < -eps, exiting = denom > eps;
    par_out = par_out || (fabsf(denom) <= eps && dist < 0.0f);
    t_enter = fmaxf(t_enter, entering ? t_pl : 0.0f);
    if (exiting) t_exit = fminf(t_exit, t_pl);
    const float sc = entering ? t_pl : -kBig;
    if (sc > score) {
      score = sc;
      j = f;
    }
  }
  const bool ok = t_enter <= t_exit && !par_out && nf > 0 && t_enter > 0.0f;
  const float nl[3] = {pl[4 * j], pl[4 * j + 1], pl[4 * j + 2]};
  sbt::rotate_vec(qb, nl, n);
  return ok ? t_enter : kBig;
}

struct Hulls {
  const float* planes;   // [H, MF, 4]
  const int* n_faces;    // [H]
  int H, MF;
};

// The exact test against body `slot`'s own shape.
__device__ float ray_shape(const float o[3], const float d[3], int slot,
                           const float* __restrict__ pos, const float* __restrict__ quat,
                           const int* __restrict__ shape_type,
                           const float* __restrict__ params, const Hulls& hl, float n[3]) {
  const int st = shape_type[slot];
  const float p[3] = {pos[slot * 3 + 0], pos[slot * 3 + 1], pos[slot * 3 + 2]};
  const float q[4] = {quat[slot * 4 + 0], quat[slot * 4 + 1], quat[slot * 4 + 2],
                      quat[slot * 4 + 3]};
  const float prm[3] = {params[slot * 4 + 0], params[slot * 4 + 1], params[slot * 4 + 2]};
  if (st == kSphere) return ray_sphere(o, d, p, prm[0], n);
  if (st == kBox) return ray_box(o, d, p, q, prm, n);
  if (st == kCapsule) return ray_capsule(o, d, p, q, prm[0], prm[1], n);
  const int hid = min(max(static_cast<int>(prm[0]), 0), hl.H - 1);
  return ray_hull(o, d, p, q, hl.planes + static_cast<size_t>(hid) * hl.MF * 4,
                  hl.n_faces[hid], hl.MF, n);
}

// kernels/ray_trace.py:_ray_triangle, the t only (BIG on a miss).
__device__ __forceinline__ float ray_triangle_t(const float o[3], const float d[3],
                                                const float v0[3], const float v1[3],
                                                const float v2[3]) {
  float e1[3], e2[3], s[3], p[3], q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = v1[k] - v0[k];
    e2[k] = v2[k] - v0[k];
    s[k] = o[k] - v0[k];
  }
  sbt::cross_fma(d, e2, p);
  const float det = sbt::dot3(e1, p);
  const float inv_det = 1.0f / (fabsf(det) > 1e-12f ? det : 1e-12f);
  const float u = sbt::dot3(s, p) * inv_det;
  sbt::cross_fma(s, e1, q);
  const float v = sbt::dot3(d, q) * inv_det;
  const float t = sbt::dot3(e2, q) * inv_det;
  const bool ok = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
  return ok ? t : kBig;
}

// Its normal: the unit triangle normal facing the ray.
__device__ void ray_triangle_n(const float d[3], const float v0[3], const float v1[3],
                               const float v2[3], float n[3]) {
  float e1[3], e2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = v1[k] - v0[k];
    e2[k] = v2[k] - v0[k];
  }
  sbt::cross_fma(e1, e2, n);
  const float nn = fmaxf(sqrtf(sbt::dot3_fma(n, n)), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = n[k] / nn;
  if (sbt::dot3(n, d) > 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = -n[k];
  }
}

struct Heightfield {
  const float* h;
  float ox, oy, cw, umax, vmax;
  int hy;
};

// physics/state.py:Heightfield._patch and the bilinear height.
__device__ void hf_patch(const Heightfield& hf, float x, float y, float& fu, float& fv,
                         float& h00, float& h10, float& h01, float& h11) {
  float u = (x - hf.ox) / hf.cw;
  float v = (y - hf.oy) / hf.cw;
  u = fminf(fmaxf(u, 0.0f), hf.umax);
  v = fminf(fmaxf(v, 0.0f), hf.vmax);
  const int i0 = static_cast<int>(floorf(u));
  const int j0 = static_cast<int>(floorf(v));
  fu = u - static_cast<float>(i0);
  fv = v - static_cast<float>(j0);
  h00 = hf.h[i0 * hf.hy + j0];
  h10 = hf.h[(i0 + 1) * hf.hy + j0];
  h01 = hf.h[i0 * hf.hy + j0 + 1];
  h11 = hf.h[(i0 + 1) * hf.hy + j0 + 1];
}

__device__ float hf_sample(const Heightfield& hf, float x, float y) {
  float fu, fv, h00, h10, h01, h11;
  hf_patch(hf, x, y, fu, fv, h00, h10, h01, h11);
  return sbt::hf_bilinear(fu, fv, h00, h10, h01, h11);
}

__device__ void hf_normal(const Heightfield& hf, float x, float y, float n[3]) {
  float fu, fv, h00, h10, h01, h11;
  hf_patch(hf, x, y, fu, fv, h00, h10, h01, h11);
  sbt::hf_patch_normal(fu, fv, h00, h10, h01, h11, hf.cw, n[0], n[1], n[2]);
}

// jnp.linspace(0, 1, n)[s]: s times the float32 reciprocal of n - 1, the
// last exactly 1.
__device__ __forceinline__ float march_fraction(int s, int n) {
  if (n == 1) return 0.0f;
  if (s == n - 1) return 1.0f;
  return static_cast<float>(s) * (1.0f / static_cast<float>(n - 1));
}

// The (key, slot) of one candidate column, or key = +inf when the column
// is empty, excluded or out of the bounding sphere's reach.
struct Col {
  int cand;
  float key;
};

__device__ __forceinline__ int column_cand(int col, int n_grid, int cap, int body_steps,
                                           const float o[3], const float d[3], float mt,
                                           float rcp_cell, int num_buckets,
                                           const int* __restrict__ table,
                                           const int* __restrict__ os_idx) {
  if (col >= n_grid) return os_idx[col - n_grid];
  const int blk = col / cap, slot = col - blk * cap;   // blk = (offset, step)
  const int off = blk / body_steps, s = blk - off * body_steps;
  const float ts = body_steps == 1 ? 0.5f * mt : march_fraction(s, body_steps) * mt;
  int cell[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) cell[k] = static_cast<int>(floorf(__fmaf_rn(d[k], ts, o[k]) * rcp_cell));
  return table[sbt::cell_hash(cell[0] + off / 3 - 1, cell[1] + off % 3 - 1, cell[2], num_buckets) *
                   cap + slot];
}

__global__ void __launch_bounds__(kWarps * 32) ray_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ max_ts, const int* __restrict__ exclude,
    const float* __restrict__ pos, const float* __restrict__ quat,
    const float* __restrict__ bound_radius, const int* __restrict__ shape_type,
    const float* __restrict__ params, const bool* __restrict__ alive,
    const int* __restrict__ layer, const int* __restrict__ table,
    const int* __restrict__ os_idx, const float* __restrict__ heights,
    const float* __restrict__ hf_origin, const float* __restrict__ hf_cell_w,
    const bool* __restrict__ has_hf, const float* __restrict__ hull_planes,
    const int* __restrict__ hull_n_faces, const float* __restrict__ tri_verts,
    const int* __restrict__ tris, const int* __restrict__ tri_mats,
    const int* __restrict__ tri_owner, const int* __restrict__ cell_tris,
    const float* __restrict__ tri_origin, const float* __restrict__ tri_cell_w, int R,
    int num_buckets, int cap, int n_os, int hx, int hy, int n_steps, int body_steps, int K,
    int flags, int H, int MF, int gx, int gy, int tcap, float rcp_cell,
    float* __restrict__ o_t, float* __restrict__ o_n, int* __restrict__ o_body,
    bool* __restrict__ o_hit, int* __restrict__ o_mat) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= R) return;   // the whole warp: one ray per warp
  const bool is_flat = flags & 1, collidable_only = flags & 2, dedup = flags & 4;
  const bool use_tm = flags & 8;
  const Hulls hl{hull_planes, hull_n_faces, H, MF};
  const float o[3] = {origins[i * 3 + 0], origins[i * 3 + 1], origins[i * 3 + 2]};
  const float d[3] = {dirs[i * 3 + 0], dirs[i * 3 + 1], dirs[i * 3 + 2]};
  const float mt = max_ts[i];
  const int ex = exclude[i];

  // ---- Stage 1: the k smallest bounding-sphere keys, lane j holding entry j ----
  const int n_grid = 9 * body_steps * cap;
  const int n_cols = n_grid + n_os;
  float lk = kBig;   // this lane's list entry: key and slot
  int ls = -1;
  int cnt = 0;
  int first_cand = 0, min_cand = 0x7fffffff;
  for (int base = 0; base < n_cols; base += 32 * kUnroll) {
    Col c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = base + u * 32 + lane;
      c[u].cand = col < n_cols ? column_cand(col, n_grid, cap, body_steps, o, d, mt, rcp_cell,
                                             num_buckets, table, os_idx)
                               : 0x7fffffff;
    }
    if (base == 0) first_cand = __shfl_sync(kFull, c[0].cand, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      min_cand = min(min_cand, c[u].cand);
      const int cand = c[u].cand;
      const int b = cand >= 0 && cand != 0x7fffffff ? cand : 0;
      const int lay = layer[b];
      const bool live = alive[b];
      const float oc[3] = {o[0] - pos[b * 3 + 0], o[1] - pos[b * 3 + 1], o[2] - pos[b * 3 + 2]};
      const float crad = bound_radius[b];
      const float bb = sbt::dot3(oc, d);
      const float cc = sbt::dot3(oc, oc) - crad * crad;
      const float disc = bb * bb - cc;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t_in = fmaxf(-bb - sq, 0.0f);
      const bool ok = cand >= 0 && cand != 0x7fffffff && cand != ex && live &&
                      !(collidable_only && !(lay == 0 || lay == 1)) && disc >= 0.0f &&
                      -bb + sq >= 0.0f && t_in <= mt;
      c[u].key = ok ? t_in : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned found = __ballot_sync(kFull, c[u].key != INFINITY);
      while (found) {   // warp-uniform: insert the finite keys in column order
        const int src = __ffs(found) - 1;
        found &= found - 1;
        const float kn = __shfl_sync(kFull, c[u].key, src);
        const int cn = __shfl_sync(kFull, c[u].cand, src);
        const bool held = lane < cnt;
        if (dedup && __any_sync(kFull, held && ls == cn)) continue;
        const bool before = held && (lk < kn || (lk == kn && (!dedup || ls < cn)));
        const int at = __popc(__ballot_sync(kFull, before));
        const float up_k = __shfl_up_sync(kFull, lk, 1);
        const int up_s = __shfl_up_sync(kFull, ls, 1);
        if (at < K) {
          if (lane > at) {
            lk = up_k;
            ls = up_s;
          } else if (lane == at) {
            lk = kn;
            ls = cn;
          }
          cnt = min(cnt + 1, K);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) min_cand = min(min_cand, __shfl_xor_sync(kFull, min_cand, off));

  // ---- Stage 2: lane j tests survivor j; the first minimum ----
  float tb = kBig, nb[3] = {0.0f, 0.0f, 0.0f};
  int bi = -1;
  if (cnt == 0) {
    const int s0 = dedup ? min_cand : first_cand;   // survivor 0 of an all-BIG row
    ray_shape(o, d, max(s0, 0), pos, quat, shape_type, params, hl, nb);
  } else {
    float t = INFINITY, n[3] = {0.0f, 0.0f, 0.0f};
    if (lane < cnt) t = ray_shape(o, d, ls, pos, quat, shape_type, params, hl, n);
    float bt = t;
    int bj = lane < cnt ? lane : 32;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, bt, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    // Lanes past cnt hold +inf: a live lane holds the minimum (BIG at most).
    tb = __shfl_sync(kFull, t, bj);
#pragma unroll
    for (int k = 0; k < 3; ++k) nb[k] = __shfl_sync(kFull, n[k], bj);
    const int best_slot = __shfl_sync(kFull, ls, bj);
    bi = tb < kBig ? best_slot : -1;
  }

  // ---- The heightfield: the lanes take the march samples ----
  float th = kBig, nh[3] = {0.0f, 0.0f, 1.0f};
  if (is_flat) {
    const float z0 = heights[0];
    const float dz = fabsf(d[2]) > 1e-9f ? d[2] : 1e-9f;
    float t = (z0 - o[2]) / dz;
    const bool start_below = o[2] < z0;
    const bool ok = start_below || (t >= 0.0f && t <= mt && d[2] < 0.0f);
    if (start_below) t = 0.0f;
    th = ok ? t : kBig;
  } else {
    const Heightfield hf{heights, hf_origin[0], hf_origin[1], *hf_cell_w,
                         static_cast<float>(hx - 1.001), static_cast<float>(hy - 1.001), hy};
    int first = -1;
    float val0 = 0.0f;
    for (int sb = 0; sb < n_steps; sb += 32) {
      const int s = sb + lane;
      float val = 0.0f;
      if (s < n_steps) {
        const float ts = march_fraction(s, n_steps) * mt;
        const float p[3] = {o[0] + d[0] * ts, o[1] + d[1] * ts, o[2] + d[2] * ts};
        val = p[2] - hf_sample(hf, p[0], p[1]);
      }
      if (sb == 0) val0 = __shfl_sync(kFull, val, 0);
      const unsigned below = __ballot_sync(kFull, s < n_steps && val < 0.0f);
      if (first < 0 && below) first = sb + __ffs(below) - 1;
    }
    const bool any_below = first >= 0;
    const int f = any_below ? first : 0;
    float lo = march_fraction(max(f - 1, 0), n_steps) * mt;
    float hi = march_fraction(f, n_steps) * mt;
    for (int it = 0; it < 10; ++it) {
      const float mid = 0.5f * (lo + hi);
      const float p[3] = {o[0] + d[0] * mid, o[1] + d[1] * mid, o[2] + d[2] * mid};
      const bool is_above = p[2] - hf_sample(hf, p[0], p[1]) > 0.0f;
      lo = is_above ? mid : lo;
      hi = is_above ? hi : mid;
    }
    float t = 0.5f * (lo + hi);
    hf_normal(hf, o[0] + d[0] * t, o[1] + d[1] * t, nh);
    if (val0 < 0.0f) t = 0.0f;
    th = any_below ? t : kBig;
  }
  if (!*has_hf) th = kBig;

  // ---- The trimesh: the lanes take the (step, slot) tests ----
  float tt = kBig, nt[3] = {0.0f, 0.0f, 0.0f};
  int mat = 0, owner = 0;
  if (use_tm) {
    const sbt::TriMeshView tm{tri_verts, tris, cell_tris, tri_origin[0], tri_origin[1],
                              *tri_cell_w, gx, gy, tcap};
    const int kt = min(tcap, kTriCap);
    const int n_tests = n_steps * kt;
    float bt = kBig;          // this lane's first minimum below BIG
    int bidx = 0x7fffffff, btri = -1;
    for (int tb0 = 0; tb0 < n_tests; tb0 += 32) {
      const int idx = tb0 + lane;
      if (idx >= n_tests) continue;
      const int s = idx / kt, c = idx - s * kt;
      const float ts = march_fraction(s, n_steps) * mt;
      const int tri = cell_tris[sbt::tri_cell(tm, o[0] + d[0] * ts, o[1] + d[1] * ts) + c];
      if (tri < 0) continue;
      float v0[3], v1[3], v2[3];
      sbt::load_vert(tm, tris[3 * tri], v0);
      sbt::load_vert(tm, tris[3 * tri + 1], v1);
      sbt::load_vert(tm, tris[3 * tri + 2], v2);
      const float t = ray_triangle_t(o, d, v0, v1, v2);
      if (t < bt) {
        bt = t;
        bidx = idx;
        btri = tri;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, bt, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      const int otri = __shfl_xor_sync(kFull, btri, off);
      if (ot < bt || (ot == bt && oi < bidx)) {
        bt = ot;
        bidx = oi;
        btri = otri;
      }
    }
    if (btri >= 0) {
      tt = bt;
      float v0[3], v1[3], v2[3];
      sbt::load_vert(tm, tris[3 * btri], v0);
      sbt::load_vert(tm, tris[3 * btri + 1], v1);
      sbt::load_vert(tm, tris[3 * btri + 2], v2);
      ray_triangle_n(d, v0, v1, v2, nt);
      mat = tri_mats[btri];
      owner = tri_owner[btri];
    }
  }

  if (lane == 0) {
    const bool body_first = tb <= th && tb <= tt;
    const bool tri_wins = tt < th && tt < tb;
    const float t = fminf(fminf(tb, th), tt);
    const bool hit = t <= mt;
    o_t[i] = hit ? t : kBig;
#pragma unroll
    for (int k = 0; k < 3; ++k) o_n[i * 3 + k] = body_first ? nb[k] : (th <= tt ? nh[k] : nt[k]);
    o_body[i] = body_first ? bi : (tri_wins ? owner : -1);
    o_hit[i] = hit;
    o_mat[i] = tri_wins ? mat : 0;
  }
}

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/ray_trace.py:_launch): 26 input pointers, R and 14 sizes, 1 /
// cell_size as a double, 5 output pointers.
extern "C" int ray_trace(const long long* a, void* stream) {
  auto f = [a](int i) { return reinterpret_cast<const float*>(a[i]); };
  auto n = [a](int i) { return reinterpret_cast<const int*>(a[i]); };
  auto b = [a](int i) { return reinterpret_cast<const bool*>(a[i]); };
  auto v = [a](int i) { return static_cast<int>(a[i]); };
  double rcp;
  memcpy(&rcp, a + 41, sizeof(double));
  const int R = v(26), K = v(34), H = v(36), MF = v(37), cap = v(28), body_steps = v(33);
  if (K < 1 || K > kMaxK || H < 1 || MF > 32 || cap < 1 || body_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0) {
    const int blocks = (R + kWarps - 1) / kWarps;
    ray_trace_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        f(0), f(1), f(2), n(3), f(4), f(5), f(6), n(7), f(8), b(9), n(10), n(11), n(12), f(13),
        f(14), f(15), b(16), f(17), n(18), f(19), n(20), n(21), n(22), n(23), f(24), f(25), R,
        v(27), cap, v(29), v(30), v(31), v(32), body_steps, K, v(35), H, MF, v(38), v(39), v(40),
        static_cast<float>(rcp), reinterpret_cast<float*>(a[42]), reinterpret_cast<float*>(a[43]),
        reinterpret_cast<int*>(a[44]), reinterpret_cast<bool*>(a[45]),
        reinterpret_cast<int*>(a[46]));
  }
  return static_cast<int>(cudaGetLastError());
}
