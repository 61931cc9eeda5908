// KB: static contacts of every body's sample points against the heightfield
// and the static trimesh.
//
// Replaces substrata_tpu/physics/narrowphase.py:static_contacts (:911-1045),
// shape_sample_points (:804-867), _closest_point_triangle (:870) and
// state.py:Heightfield.sample_with_normal (:208-247); plain twin:
// substrata_tpu_torch/kernels/static_contacts.py:static_contacts_plain.
//
// One thread per body.  It builds its 8 sample points (a hull's: the
// vertices furthest along world-down and a 30-degree ring of 8 directions in
// its local frame, the first vertex on ties), samples the heightfield (the
// flat fast path, or one bilinear patch and its analytic normal per point),
// and, when the world has a trimesh, tests each sample against the first
// min(cap, max_tri_candidates) triangles of its grid cell (trimesh.cuh) and
// keeps the deeper of the two.  Then it keeps the K deepest eligible
// samples with the lower sample index first on ties, as lax.top_k does: K
// passes of a strict '>' scan.  The selected sample index is the warm-start
// key.  Only eligible bodies (alive, awake, dynamic, collidable) sample the
// trimesh: the others' rows are invalid whatever it holds.  What bounds it
// on the card: memory on the heightfield path — 80 bytes of body state in,
// K x 49 bytes of rows out per body, ~300 flops; with the trimesh, latency
// and operations — up to 8 x 16 dependent triangle gathers (36 + 12 bytes,
// cached across neighbouring samples) and ~150 flops each.  The design keeps
// the 8 candidates in registers and writes each output row once: no [N*8]
// intermediate reaches device memory.
#include "trimesh.cuh"

namespace {

constexpr int kSphere = 0, kBox = 1, kCapsule = 2, kHull = 3;

// cos and sin of the ring's 8 angles as the reference rounds them
// (kernels/static_contacts.py:RING_COS, RING_SIN).
__constant__ float kRingCos[8] = {0x1p+0f, 0x1.6a09e6p-1f, -0x1.777a5cp-25f, -0x1.6a09e6p-1f,
                                  -0x1p+0f, -0x1.6a09e2p-1f, 0x1.99bc5cp-27f, 0x1.6a09eep-1f};
__constant__ float kRingSin[8] = {0x0p+0f, 0x1.6a09e6p-1f, 0x1p+0f, 0x1.6a09e6p-1f,
                                  -0x1.777a5cp-24f, -0x1.6a09eap-1f, -0x1p+0f, -0x1.6a09dep-1f};

__global__ void static_contacts_kernel(
    const float* __restrict__ pos, const float* __restrict__ quat,
    const int* __restrict__ shape_type, const float* __restrict__ params,
    const bool* __restrict__ alive, const int* __restrict__ layer,
    const int* __restrict__ motion, const bool* __restrict__ sensor,
    const bool* __restrict__ awake, const float* __restrict__ fric,
    const float* __restrict__ rest, const float* __restrict__ heights,
    const float* __restrict__ hf_origin, const float* __restrict__ hf_cell_w,
    const bool* __restrict__ has_hf, const float* __restrict__ hull_verts,
    const int* __restrict__ hull_n_verts, const float* __restrict__ tri_verts,
    const int* __restrict__ tris, const int* __restrict__ cell_tris,
    const float* __restrict__ tri_origin, const float* __restrict__ tri_cell_w, int n, int hx,
    int hy, int flags, int K, int H, int MV, int gx, int gy, int tcap, int kc,
    int* __restrict__ o_a, int* __restrict__ o_b, float* __restrict__ o_point,
    float* __restrict__ o_normal, float* __restrict__ o_pen, bool* __restrict__ o_valid,
    float* __restrict__ o_fric, float* __restrict__ o_rest, int* __restrict__ o_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool is_flat = flags & 1;
  const int present = (flags >> 1) & 15;
  const bool use_tm = (flags >> 5) & 1;
  const int st = shape_type[i];
  const float p0 = params[i * 4 + 0], p1 = params[i * 4 + 1], p2 = params[i * 4 + 2];
  const float q[4] = {quat[i * 4 + 0], quat[i * 4 + 1], quat[i * 4 + 2], quat[i * 4 + 3]};
  const float c[3] = {pos[i * 3 + 0], pos[i * 3 + 1], pos[i * 3 + 2]};

  // Local sample set: the candidates of the present shape types in the
  // order box, capsule, hull, sphere; the last one is every other body's
  // default.
  int cands[4], nc = 0;
  if (present & (1 << kBox)) cands[nc++] = kBox;
  if (present & (1 << kCapsule)) cands[nc++] = kCapsule;
  if (present & (1 << kHull)) cands[nc++] = kHull;
  if ((present & (1 << kSphere)) || nc == 0) cands[nc++] = kSphere;
  int local_type = cands[nc - 1];
  for (int k = 0; k < nc - 1; ++k)
    if (st == cands[k]) local_type = cands[k];
  const int n_samples = st == kBox ? 8 : st == kCapsule ? 2 : st == kHull ? 8 : 1;
  const float rad = (st == kSphere || st == kCapsule) ? p0 : 0.0f;

  const bool hf_on = *has_hf;
  const float ox = hf_origin[0], oy = hf_origin[1], cw = *hf_cell_w;
  const float umax = static_cast<float>(hx - 1.001), vmax = static_cast<float>(hy - 1.001);
  const bool elig = alive[i] && (layer[i] == 0 || layer[i] == 1) && motion[i] == 2 &&
                    !sensor[i] && awake[i];

  // A hull's ring directions (kernels/static_contacts.py:hull_sample_local).
  const float* hv = nullptr;
  int hnv = 0;
  float down_l[3], u1[3], u2[3];
  if (local_type == kHull) {
    const int hid = min(max(static_cast<int>(p0), 0), H - 1);
    hv = hull_verts + static_cast<size_t>(hid) * MV * 3;
    hnv = max(min(hull_n_verts[hid], MV), 1);   // padded rows repeat vertex 0
    const float down[3] = {0.0f, 0.0f, -1.0f};
    const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
    sbt::rotate_vec(qc, down, down_l);
    const float ax[3] = {fabsf(down_l[0]) < 0.9f ? 1.0f : 0.0f,
                         fabsf(down_l[0]) < 0.9f ? 0.0f : 1.0f, 0.0f};
    sbt::cross3(ax, down_l, u1);
    const float un = fmaxf(sbt::norm3f(u1), 1e-9f);
    u1[0] = u1[0] / un;
    u1[1] = u1[1] / un;
    u1[2] = u1[2] / un;
    sbt::cross3(down_l, u1, u2);
  }
  const sbt::TriMeshView tm{tri_verts, tris, cell_tris, tri_origin[0], tri_origin[1],
                            *tri_cell_w, gx, gy, tcap};

  float pts[8][3], nrm[8][3], pen[8], val[8];
  bool ok[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float local[3] = {0.0f, 0.0f, 0.0f};
    if (local_type == kBox) {
      local[0] = ((s >> 2) & 1 ? 1.0f : -1.0f) * p0;
      local[1] = ((s >> 1) & 1 ? 1.0f : -1.0f) * p1;
      local[2] = (s & 1 ? 1.0f : -1.0f) * p2;
    } else if (local_type == kCapsule) {
      if (s == 0) local[2] = p1;
      if (s == 1) local[2] = -p1;
    } else if (local_type == kHull) {
      float dir[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dir[k] = down_l[k] * 0.866f + (u1[k] * kRingCos[s] + u2[k] * kRingSin[s]) * 0.5f;
      int best = 0;
      float bs = -INFINITY;
      for (int v = 0; v < hnv; ++v) {
        const float sc = hv[3 * v] * dir[0] + hv[3 * v + 1] * dir[1] + hv[3 * v + 2] * dir[2];
        if (v == 0 || sc > bs) {
          bs = sc;
          best = v;
        }
      }
      local[0] = hv[3 * best];
      local[1] = hv[3 * best + 1];
      local[2] = hv[3 * best + 2];
    }
    float rv[3], w[3];
    sbt::rotate_vec(q, local, rv);
    w[0] = c[0] + rv[0];
    w[1] = c[1] + rv[1];
    w[2] = c[2] + rv[2];

    float h, nx, ny, nz;
    if (is_flat) {
      h = heights[0];
      nx = 0.0f;
      ny = 0.0f;
      nz = 1.0f;
    } else {
      float u = (w[0] - ox) / cw;
      float v = (w[1] - oy) / cw;
      u = fminf(fmaxf(u, 0.0f), umax);
      v = fminf(fmaxf(v, 0.0f), vmax);
      const int i0 = static_cast<int>(floorf(u));
      const int j0 = static_cast<int>(floorf(v));
      const float fu = u - static_cast<float>(i0);
      const float fv = v - static_cast<float>(j0);
      const float h00 = heights[i0 * hy + j0];
      const float h10 = heights[(i0 + 1) * hy + j0];
      const float h01 = heights[i0 * hy + j0 + 1];
      const float h11 = heights[(i0 + 1) * hy + j0 + 1];
      h = sbt::hf_bilinear(fu, fv, h00, h10, h01, h11);
      sbt::hf_patch_normal(fu, fv, h00, h10, h01, h11, cw, nx, ny, nz);
    }
    const float pe = (h - (w[2] - rad)) * nz;
    if (rad > 0.0f) {
      // The jitted reference contracts flat - n * rad into fma(-n, rad, flat).
      pts[s][0] = __fmaf_rn(-nx, rad, w[0]);
      pts[s][1] = __fmaf_rn(-ny, rad, w[1]);
      pts[s][2] = __fmaf_rn(-nz, rad, w[2]);
    } else {
      pts[s][0] = w[0];
      pts[s][1] = w[1];
      pts[s][2] = h;
    }
    nrm[s][0] = nx;
    nrm[s][1] = ny;
    nrm[s][2] = nz;
    bool hit = hf_on && pe > -sbt::kContactMargin;
    float pe_s = pe;
    if (use_tm && elig) {
      float tpen, tpt[3], tn[3];
      if (sbt::sphere_vs_cell(tm, w, rad, kc, tpen, tpt, tn) && tpen > -sbt::kContactMargin &&
          tpen < 1e8f && (!hit || tpen > pe)) {
        hit = true;
        pe_s = tpen;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pts[s][k] = tpt[k];
          nrm[s][k] = tn[k];
        }
      }
    }
    ok[s] = hit && s < n_samples && elig;
    pen[s] = fminf(fmaxf(pe_s, -1e9f), 0.5f);
    val[s] = ok[s] ? pen[s] : -1e9f;
  }

  const float fr = sqrtf(fmaxf(fric[i] * 0.5f, 0.0f));
  const float re = rest[i];
  unsigned used = 0u;
  for (int k = 0; k < K; ++k) {
    int sel = k;
    if (K < 8) {
      sel = -1;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        if (!(used & (1u << s)) && (sel < 0 || val[s] > val[sel])) sel = s;
      used |= 1u << sel;
    }
    const int r = i * K + k;
    o_a[r] = i;
    o_b[r] = -1;
    o_point[r * 3 + 0] = pts[sel][0];
    o_point[r * 3 + 1] = pts[sel][1];
    o_point[r * 3 + 2] = pts[sel][2];
    o_normal[r * 3 + 0] = nrm[sel][0];
    o_normal[r * 3 + 1] = nrm[sel][1];
    o_normal[r * 3 + 2] = nrm[sel][2];
    o_pen[r] = pen[sel];
    o_valid[r] = ok[sel] && (K >= 8 || val[sel] > -1e8f);
    o_fric[r] = fr;
    o_rest[r] = re;
    o_key[r] = sel + 1;
  }
}

}  // namespace

extern "C" int static_contacts(const float* pos, const float* quat, const int* shape_type,
                               const float* params, const bool* alive, const int* layer,
                               const int* motion, const bool* sensor, const bool* awake,
                               const float* fric, const float* rest, const float* heights,
                               const float* hf_origin, const float* hf_cell_w,
                               const bool* has_hf, const float* hull_verts,
                               const int* hull_n_verts, const float* tri_verts, const int* tris,
                               const int* cell_tris, const float* tri_origin,
                               const float* tri_cell_w, int n, int hx, int hy, int flags, int K,
                               int H, int MV, int gx, int gy, int tcap, int kc, int* o_a,
                               int* o_b, float* o_point, float* o_normal, float* o_pen,
                               bool* o_valid, float* o_fric, float* o_rest, int* o_key,
                               void* stream) {
  if (H < 1 || kc > tcap) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    static_contacts_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, quat, shape_type, params, alive, layer, motion, sensor, awake, fric, rest,
        heights, hf_origin, hf_cell_w, has_hf, hull_verts, hull_n_verts, tri_verts, tris,
        cell_tris, tri_origin, tri_cell_w, n, hx, hy, flags, K, H, MV, gx, gy, tcap, kc, o_a,
        o_b, o_point, o_normal, o_pen, o_valid, o_fric, o_rest, o_key);
  }
  return static_cast<int>(cudaGetLastError());
}
