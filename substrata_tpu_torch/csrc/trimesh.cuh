// Static-trimesh helpers shared by KB (static_contacts.cu), KH (ray_trace.cu)
// and KL (character.cu).
//
// Each routine repeats, operation for operation, its plain twin:
// closest_point_triangle is kernels/closed_forms.py:closest_point_triangle
// (the reference: substrata_tpu/physics/narrowphase.py:870), sphere_vs_cell is
// one sample of kernels/static_contacts.py:trimesh_sphere_rows
// (narrowphase.py:944-976, character.py:204-227).
#pragma once

#include "closed_forms.cuh"

namespace sbt {

struct TriMeshView {
  const float* verts;     // [V, 3]
  const int* tris;        // [T, 3]
  const int* cell_tris;   // [GX, GY, cap]
  float ox, oy, cw;
  int gx, gy, cap;
};

__device__ __forceinline__ float safe_denom(float x) { return fabsf(x) > 1e-12f ? x : 1e-12f; }

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Ericson 5.1.5, branch-free, in the twin's order of selections.
__device__ inline void closest_point_triangle(const float p[3], const float v0[3],
                                              const float v1[3], const float v2[3],
                                              float res[3]) {
  float ab[3], ac[3], ap[3], bp[3], cp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ab[k] = v1[k] - v0[k];
    ac[k] = v2[k] - v0[k];
    ap[k] = p[k] - v0[k];
    bp[k] = p[k] - v1[k];
    cp[k] = p[k] - v2[k];
  }
  const float d1 = dot3(ab, ap), d2 = dot3(ac, ap);
  const float d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  const float d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float denom = va + vb + vc;
  const float v = vb / safe_denom(denom);
  const float w = vc / safe_denom(denom);
#pragma unroll
  for (int k = 0; k < 3; ++k) res[k] = v0[k] + ab[k] * v + ac[k] * w;
  if (d1 <= 0.0f && d2 <= 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) res[k] = v0[k];
  }
  if (d3 >= 0.0f && d4 <= d3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) res[k] = v1[k];
  }
  if (d6 >= 0.0f && d5 <= d6) {
#pragma unroll
    for (int k = 0; k < 3; ++k) res[k] = v2[k];
  }
  const float t_ab = clamp01(d1 / safe_denom(d1 - d3));
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) res[k] = v0[k] + t_ab * ab[k];
  }
  const float t_ac = clamp01(d2 / safe_denom(d2 - d6));
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) res[k] = v0[k] + t_ac * ac[k];
  }
  const float t_bc = clamp01((d4 - d3) / safe_denom((d4 - d3) + (d5 - d6)));
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) res[k] = v1[k] + t_bc * (v2[k] - v1[k]);
  }
}

// The grid cell of world xy: truncated toward zero, then clamped.
__device__ __forceinline__ int tri_cell(const TriMeshView& tm, float x, float y) {
  const int ci = min(max(static_cast<int>((x - tm.ox) / tm.cw), 0), tm.gx - 1);
  const int cj = min(max(static_cast<int>((y - tm.oy) / tm.cw), 0), tm.gy - 1);
  return (ci * tm.gy + cj) * tm.cap;
}

__device__ __forceinline__ void load_vert(const TriMeshView& tm, int v, float o[3]) {
  o[0] = tm.verts[3 * v];
  o[1] = tm.verts[3 * v + 1];
  o[2] = tm.verts[3 * v + 2];
}

// A sphere (centre p, radius rad) against the first k triangles of its cell:
// the deepest (rad - signed distance) first on ties, its closest point and
// normal; returns false when the cell has no triangle.  Empty slots (-1)
// form a suffix of each cell's list (the host build fills slots in order),
// so the scan stops at the first.
__device__ inline bool sphere_vs_cell(const TriMeshView& tm, const float p[3], float rad, int k,
                                      float& best_pen, float best_pt[3], float best_n[3]) {
  const int base = tri_cell(tm, p[0], p[1]);
  bool any = false;
  for (int c = 0; c < k; ++c) {
    const int t = tm.cell_tris[base + c];
    if (t < 0) break;
    float v0[3], v1[3], v2[3], cp[3], e1[3], e2[3], cr[3], tn[3], delta[3], rel[3];
    load_vert(tm, tm.tris[3 * t], v0);
    load_vert(tm, tm.tris[3 * t + 1], v1);
    load_vert(tm, tm.tris[3 * t + 2], v2);
    closest_point_triangle(p, v0, v1, v2, cp);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      delta[q] = p[q] - cp[q];
      e1[q] = v1[q] - v0[q];
      e2[q] = v2[q] - v0[q];
      rel[q] = p[q] - v0[q];
    }
    const float dist = norm3f(delta);
    cross3(e1, e2, cr);
    safe_normalize(cr, tn);
    const float side = dot3(rel, tn);
    const float sdist = side >= 0.0f ? dist : -dist;
    const float pen = rad - sdist;
    if (!any || pen > best_pen) {
      any = true;
      best_pen = pen;
      const bool out = dist > 1e-6f && side >= 0.0f;
      const float dd = fmaxf(dist, 1e-6f);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        best_pt[q] = cp[q];
        best_n[q] = out ? delta[q] / dd : tn[q];
      }
    }
  }
  return any;
}

}  // namespace sbt
