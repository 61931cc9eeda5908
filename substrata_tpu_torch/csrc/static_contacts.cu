// KB: static contacts of every body's sample points against the heightfield
// and the static trimesh.
//
// Replaces substrata_tpu/physics/narrowphase.py:static_contacts (:911-1045),
// shape_sample_points (:804-867), _closest_point_triangle (:870) and
// state.py:Heightfield.sample_with_normal (:208-247); plain twin:
// substrata_tpu_torch/kernels/static_contacts.py:static_contacts_plain.
//
// Each body has 8 sample points (a hull's: the vertices furthest along
// world-down and a 30-degree ring of 8 directions in its local frame, the
// first vertex on ties).  Each samples the heightfield (the flat fast path,
// or one bilinear patch and its analytic normal) and, for an eligible body
// (alive, awake, dynamic, collidable, not a sensor) in a world with a
// trimesh, the first min(cap, max_tri_candidates) = kc triangles of its grid
// cell, keeping the deeper of the two.  Then the body keeps its K deepest
// eligible samples, the lower sample index first on ties, as lax.top_k picks
// them; the selected sample index is the warm-start key.
//
// What bounds it on the card.  The heightfield path moves 80 bytes of body
// state in and K x 49 bytes of rows out per body for ~300 flops: bytes.  The
// trimesh path is latency: each triangle test is a chain of dependent
// gathers (the cell entry, the triangle row, its three vertex rows) before
// ~150 flops, up to 8 x 16 of them a body.  One thread walking those
// chains for its body (the design before) left a mesh world's 512 dynamic
// hulls in 4 blocks on 4 SMs, ~193 us a launch against a 0.5 us bound.
//
// The design: one launch, two kinds of block.
// - Warp blocks (only when the world has a trimesh, flags bit 5) come
//   first, four bodies a block, a warp a body; a warp whose body is not
//   eligible returns at once.  Lane 4s + q works on sample s: the four
//   lanes of a sample split a hull's vertices for the ring direction's
//   support (each keeps its first maximum, a shuffle reduction keeps the
//   larger score and on equal scores the lower vertex), then split the
//   cell's kc candidate slots (lane q tests slots q, q + 4, ..., four a pass
//   with every load of the pass issued before any is used) and reduce by
//   shuffles to the deepest, the lower slot on equal depths (-0 and +0
//   equal), which is the twin's first maximum over the slots with the empty
//   ones (-1) left out.  The heightfield row stays unless the triangle row
//   is strictly deeper.  The K-of-8 selection is a rank: the samples with a
//   larger value, or an equal one at a lower index, counted by 8 shuffles,
//   the K-pass strict-'>' scan's order; the lane of each selected sample
//   writes its row.
// - Thread blocks: one thread a body, as before, for every body of a world
//   without a trimesh (the bench world) and the ineligible bodies of one
//   with a trimesh (asleep, static, sensor, layer >= 2, dead): their rows
//   are heightfield rows, a few hundred flops and one patch read a sample,
//   which a thread does at the bytes' pace; a warp each would only add
//   blocks.  In a trimesh world the thread of an eligible body returns at
//   once, its warp writing its rows.
// Every output row is written once, body-blocked (rows n K .. n K + K - 1),
// and no [N * 8] intermediate reaches device memory.
#include "trimesh.cuh"

namespace {

constexpr int kSphere = 0, kBox = 1, kCapsule = 2, kHull = 3;
constexpr int kThreads = 128;            // threads a block, both kinds
constexpr int kWarps = kThreads / 32;    // bodies a warp block
constexpr int kTests = 4;                // candidate slots a lane tests a pass
constexpr unsigned kFull = 0xffffffffu;

// cos and sin of the ring's 8 angles as the reference rounds them
// (kernels/static_contacts.py:RING_COS, RING_SIN).
__constant__ float kRingCos[8] = {0x1p+0f, 0x1.6a09e6p-1f, -0x1.777a5cp-25f, -0x1.6a09e6p-1f,
                                  -0x1p+0f, -0x1.6a09e2p-1f, 0x1.99bc5cp-27f, 0x1.6a09eep-1f};
__constant__ float kRingSin[8] = {0x0p+0f, 0x1.6a09e6p-1f, 0x1p+0f, 0x1.6a09e6p-1f,
                                  -0x1.777a5cp-24f, -0x1.6a09eap-1f, -0x1p+0f, -0x1.6a09dep-1f};

// The launcher's arguments (kernels/static_contacts.py:_PACK's order).
struct Args {
  const float* pos;
  const float* quat;
  const int* shape_type;
  const float* params;
  const bool* alive;
  const int* layer;
  const int* motion;
  const bool* sensor;
  const bool* awake;
  const float* fric;
  const float* rest;
  const float* heights;
  const float* hf_origin;
  const float* hf_cell_w;
  const bool* has_hf;
  const float* hull_verts;
  const int* hull_n_verts;
  const float* tri_verts;
  const int* tris;
  const int* cell_tris;
  const float* tri_origin;
  const float* tri_cell_w;
  int n, hx, hy, flags, K, H, MV, gx, gy, tcap, kc;
  int* o_a;
  int* o_b;
  float* o_point;
  float* o_normal;
  float* o_pen;
  bool* o_valid;
  float* o_fric;
  float* o_rest;
  int* o_key;
};

__device__ __forceinline__ bool eligible(const Args& a, int i) {
  return a.alive[i] && (a.layer[i] == 0 || a.layer[i] == 1) && a.motion[i] == 2 &&
         !a.sensor[i] && a.awake[i];
}

// What the sample points of body i depend on.
struct Body {
  float c[3], q[4], p0, p1, p2, rad;
  int local_type, n_samples;
  const float* hv;   // the hull's vertex rows (hulls only)
  int hnv;
  float down_l[3], u1[3], u2[3];
};

__device__ __forceinline__ void load_body(const Args& a, int i, Body& b) {
  const int present = (a.flags >> 1) & 15;
  const int st = a.shape_type[i];
  b.p0 = a.params[i * 4 + 0];
  b.p1 = a.params[i * 4 + 1];
  b.p2 = a.params[i * 4 + 2];
#pragma unroll
  for (int k = 0; k < 4; ++k) b.q[k] = a.quat[i * 4 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) b.c[k] = a.pos[i * 3 + k];
  // Local sample set: the candidates of the present shape types in the
  // order box, capsule, hull, sphere; the last one is every other body's
  // default.
  int cands[4], nc = 0;
  if (present & (1 << kBox)) cands[nc++] = kBox;
  if (present & (1 << kCapsule)) cands[nc++] = kCapsule;
  if (present & (1 << kHull)) cands[nc++] = kHull;
  if ((present & (1 << kSphere)) || nc == 0) cands[nc++] = kSphere;
  b.local_type = cands[nc - 1];
  for (int k = 0; k < nc - 1; ++k)
    if (st == cands[k]) b.local_type = cands[k];
  b.n_samples = st == kBox ? 8 : st == kCapsule ? 2 : st == kHull ? 8 : 1;
  b.rad = (st == kSphere || st == kCapsule) ? b.p0 : 0.0f;
  b.hv = nullptr;
  b.hnv = 0;
  if (b.local_type == kHull) {
    // A hull's ring directions (kernels/static_contacts.py:hull_sample_local).
    const int hid = min(max(static_cast<int>(b.p0), 0), a.H - 1);
    b.hv = a.hull_verts + static_cast<size_t>(hid) * a.MV * 3;
    b.hnv = max(min(a.hull_n_verts[hid], a.MV), 1);   // padded rows repeat vertex 0
    const float down[3] = {0.0f, 0.0f, -1.0f};
    const float qc[4] = {-b.q[0], -b.q[1], -b.q[2], b.q[3]};
    sbt::rotate_vec(qc, down, b.down_l);
    const float ax[3] = {fabsf(b.down_l[0]) < 0.9f ? 1.0f : 0.0f,
                         fabsf(b.down_l[0]) < 0.9f ? 0.0f : 1.0f, 0.0f};
    sbt::cross_fma(ax, b.down_l, b.u1);
    const float un = fmaxf(sqrtf(sbt::dot3_fma(b.u1, b.u1)), 1e-9f);
    b.u1[0] = b.u1[0] / un;
    b.u1[1] = b.u1[1] / un;
    b.u1[2] = b.u1[2] / un;
    sbt::cross_fma(b.down_l, b.u1, b.u2);
  }
}

// Ring direction s of a hull; u1 cos + u2 sin one fma, as the jitted
// reference contracts it.
__device__ __forceinline__ void ring_dir(const Body& b, int s, float dir[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dir[k] = b.down_l[k] * 0.866f +
             __fmaf_rn(b.u1[k], kRingCos[s], b.u2[k] * kRingSin[s]) * 0.5f;
}

// The einsum's score, a dot3_fma chain.
__device__ __forceinline__ float support_score(const float* hv, int v, const float dir[3]) {
  return __fmaf_rn(hv[3 * v + 2], dir[2], __fmaf_rn(hv[3 * v + 1], dir[1], hv[3 * v] * dir[0]));
}

// The local point of sample s of a box, capsule or sphere (zeros).
__device__ __forceinline__ void primitive_local(const Body& b, int s, float local[3]) {
  local[0] = local[1] = local[2] = 0.0f;
  if (b.local_type == kBox) {
    local[0] = ((s >> 2) & 1 ? 1.0f : -1.0f) * b.p0;
    local[1] = ((s >> 1) & 1 ? 1.0f : -1.0f) * b.p1;
    local[2] = (s & 1 ? 1.0f : -1.0f) * b.p2;
  } else if (b.local_type == kCapsule) {
    if (s == 0) local[2] = b.p1;
    if (s == 1) local[2] = -b.p1;
  }
}

// The heightfield at the world sample w: its contact point, normal and
// depth along the normal.
__device__ __forceinline__ void hf_sample(const Args& a, const float w[3], float rad,
                                          float pt[3], float nrm[3], float& pe) {
  float h, nx, ny, nz;
  if (a.flags & 1) {
    h = a.heights[0];
    nx = 0.0f;
    ny = 0.0f;
    nz = 1.0f;
  } else {
    const float ox = a.hf_origin[0], oy = a.hf_origin[1], cw = *a.hf_cell_w;
    const float umax = static_cast<float>(a.hx - 1.001), vmax = static_cast<float>(a.hy - 1.001);
    float u = (w[0] - ox) / cw;
    float v = (w[1] - oy) / cw;
    u = fminf(fmaxf(u, 0.0f), umax);
    v = fminf(fmaxf(v, 0.0f), vmax);
    const int i0 = static_cast<int>(floorf(u));
    const int j0 = static_cast<int>(floorf(v));
    const float fu = u - static_cast<float>(i0);
    const float fv = v - static_cast<float>(j0);
    const float h00 = a.heights[i0 * a.hy + j0];
    const float h10 = a.heights[(i0 + 1) * a.hy + j0];
    const float h01 = a.heights[i0 * a.hy + j0 + 1];
    const float h11 = a.heights[(i0 + 1) * a.hy + j0 + 1];
    h = sbt::hf_bilinear(fu, fv, h00, h10, h01, h11);
    sbt::hf_patch_normal(fu, fv, h00, h10, h01, h11, cw, nx, ny, nz);
  }
  pe = (h - (w[2] - rad)) * nz;
  if (rad > 0.0f) {
    // The jitted reference contracts flat - n * rad into fma(-n, rad, flat).
    pt[0] = __fmaf_rn(-nx, rad, w[0]);
    pt[1] = __fmaf_rn(-ny, rad, w[1]);
    pt[2] = __fmaf_rn(-nz, rad, w[2]);
  } else {
    pt[0] = w[0];
    pt[1] = w[1];
    pt[2] = h;
  }
  nrm[0] = nx;
  nrm[1] = ny;
  nrm[2] = nz;
}

__device__ __forceinline__ void write_row(const Args& a, int r, int i, const float pt[3],
                                          const float nrm[3], float pen, bool valid, int key) {
  a.o_a[r] = i;
  a.o_b[r] = -1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.o_point[r * 3 + k] = pt[k];
    a.o_normal[r * 3 + k] = nrm[k];
  }
  a.o_pen[r] = pen;
  a.o_valid[r] = valid;
  a.o_fric[r] = sqrtf(fmaxf(a.fric[i] * 0.5f, 0.0f));
  a.o_rest[r] = a.rest[i];
  a.o_key[r] = key;
}

// One thread, body i, heightfield rows only (no trimesh test).
__device__ void body_thread(const Args& a, int i) {
  Body b;
  load_body(a, i, b);
  const bool elig = eligible(a, i);
  const bool hf_on = *a.has_hf;
  float pts[8][3], nrm[8][3], pen[8], val[8];
  bool ok[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float local[3];
    primitive_local(b, s, local);
    if (b.local_type == kHull) {
      float dir[3];
      ring_dir(b, s, dir);
      int best = 0;
      float bs = -INFINITY;
      for (int v = 0; v < b.hnv; ++v) {
        const float sc = support_score(b.hv, v, dir);
        if (v == 0 || sc > bs) {
          bs = sc;
          best = v;
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) local[k] = b.hv[3 * best + k];
    }
    float rv[3], w[3], pe;
    sbt::rotate_vec(b.q, local, rv);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = b.c[k] + rv[k];
    hf_sample(a, w, b.rad, pts[s], nrm[s], pe);
    ok[s] = hf_on && pe > -sbt::kContactMargin && s < b.n_samples && elig;
    pen[s] = fminf(fmaxf(pe, -1e9f), 0.5f);
    val[s] = ok[s] ? pen[s] : -1e9f;
  }
  unsigned used = 0u;
  for (int k = 0; k < a.K; ++k) {
    int sel = k;
    if (a.K < 8) {
      sel = -1;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        if (!(used & (1u << s)) && (sel < 0 || val[s] > val[sel])) sel = s;
      used |= 1u << sel;
    }
    write_row(a, i * a.K + k, i, pts[sel], nrm[sel], pen[sel],
              ok[sel] && (a.K >= 8 || val[sel] > -1e8f), sel + 1);
  }
}

// One warp, eligible body i of a trimesh world; lane 4 s + q, sample s.
__device__ void body_warp(const Args& a, int i, int lane) {
  const int s = lane >> 2, q = lane & 3;
  Body b;
  load_body(a, i, b);
  float local[3];
  primitive_local(b, s, local);
  if (b.local_type == kHull) {
    float dir[3];
    ring_dir(b, s, dir);
    int best = -1;
    float bs = 0.0f;
    for (int v = q; v < b.hnv; v += 4) {
      const float sc = support_score(b.hv, v, dir);
      if (best < 0 || sc > bs) {
        bs = sc;
        best = v;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int ov = __shfl_xor_sync(kFull, best, off);
      if (ov >= 0 && (best < 0 || os > bs || (os == bs && ov < best))) {
        bs = os;
        best = ov;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) local[k] = b.hv[3 * best + k];
  }
  float rv[3], w[3], pt[3], nrm[3], pe;
  sbt::rotate_vec(b.q, local, rv);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = b.c[k] + rv[k];
  hf_sample(a, w, b.rad, pt, nrm, pe);

  // The cell's candidates: lane q takes slots q, q + 4, ... < kc.
  const sbt::TriMeshView tm{a.tri_verts, a.tris, a.cell_tris, a.tri_origin[0],
                            a.tri_origin[1], *a.tri_cell_w, a.gx, a.gy, a.tcap};
  const int base = sbt::tri_cell(tm, w[0], w[1]);
  int bc = -1;
  float bp = 0.0f, bpt[3] = {0.0f, 0.0f, 0.0f}, bn[3] = {0.0f, 0.0f, 0.0f};
  for (int c0 = q; c0 < a.kc; c0 += 4 * kTests) {
    int t[kTests], vi[kTests][3];
    float v[kTests][3][3];
#pragma unroll
    for (int m = 0; m < kTests; ++m) {
      const int c = c0 + 4 * m;
      t[m] = c < a.kc ? a.cell_tris[base + c] : -1;
    }
#pragma unroll
    for (int m = 0; m < kTests; ++m)
#pragma unroll
      for (int j = 0; j < 3; ++j) vi[m][j] = t[m] >= 0 ? a.tris[3 * t[m] + j] : 0;
#pragma unroll
    for (int m = 0; m < kTests; ++m)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (t[m] >= 0) sbt::load_vert(tm, vi[m][j], v[m][j]);
        else v[m][j][0] = v[m][j][1] = v[m][j][2] = 0.0f;
      }
#pragma unroll
    for (int m = 0; m < kTests; ++m) {
      if (t[m] < 0) continue;
      float tpt[3], tn[3];
      const float tpen = sbt::sphere_vs_tri_verts(w, b.rad, v[m][0], v[m][1], v[m][2], tpt, tn);
      if (bc < 0 || tpen > bp) {
        bc = c0 + 4 * m;
        bp = tpen;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          bpt[k] = tpt[k];
          bn[k] = tn[k];
        }
      }
    }
  }
  // The deepest of the sample's four lanes, the lower slot on equal depths.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float op = __shfl_xor_sync(kFull, bp, off);
    const int oc = __shfl_xor_sync(kFull, bc, off);
    float opt[3], on[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      opt[k] = __shfl_xor_sync(kFull, bpt[k], off);
      on[k] = __shfl_xor_sync(kFull, bn[k], off);
    }
    if (oc >= 0 && (bc < 0 || op > bp || (op == bp && oc < bc))) {
      bc = oc;
      bp = op;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bpt[k] = opt[k];
        bn[k] = on[k];
      }
    }
  }
  bool hit = *a.has_hf && pe > -sbt::kContactMargin;
  float pe_s = pe;
  if (bc >= 0 && bp > -sbt::kContactMargin && bp < 1e8f && (!hit || bp > pe)) {
    hit = true;
    pe_s = bp;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pt[k] = bpt[k];
      nrm[k] = bn[k];
    }
  }
  const bool ok = hit && s < b.n_samples;
  const float pen = fminf(fmaxf(pe_s, -1e9f), 0.5f);
  const float val = ok ? pen : -1e9f;
  int rank = s;
  if (a.K < 8) {
    rank = 0;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float vo = __shfl_sync(kFull, val, 4 * o);
      rank += (vo > val || (vo == val && o < s)) ? 1 : 0;
    }
  }
  if (q == 0 && rank < a.K)
    write_row(a, i * a.K + rank, i, pt, nrm, pen, ok && (a.K >= 8 || val > -1e8f), s + 1);
}

// Blocks [0, warp_blocks) are warp blocks (kTrimesh only), the rest thread
// blocks.
template <bool kTrimesh>
__global__ void __launch_bounds__(kThreads) static_contacts_kernel(const Args a,
                                                                   int warp_blocks) {
  if (kTrimesh && static_cast<int>(blockIdx.x) < warp_blocks) {
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i < a.n && eligible(a, i)) body_warp(a, i, threadIdx.x & 31);
    return;
  }
  const int i = (blockIdx.x - warp_blocks) * kThreads + threadIdx.x;
  if (i >= a.n || (kTrimesh && eligible(a, i))) return;
  body_thread(a, i);
}

}  // namespace

// ``s``: 42 slots of 8 bytes — 11 body pointers (pos, quat, shape_type,
// params, alive, layer, motion, sensor, awake, fric, rest), 11 static-world
// pointers (heights, hf_origin, hf_cell_w, has_hf, hull verts, hull
// n_verts, tri verts, tris, cell_tris, tri origin, tri cell_w), 11 sizes
// (N, HX, HY, flags: bit 0 flat, bits 1-4 the present shape types, bit 5
// the trimesh; K, H, max hull verts, GX, GY, cell cap, candidates) and 9
// output pointers (a, b, point, normal, pen, valid, fric, rest, key).
extern "C" int static_contacts(const long long* s, void* stream) {
  Args a;
  auto f = [s](int i) { return reinterpret_cast<const float*>(s[i]); };
  auto n = [s](int i) { return reinterpret_cast<const int*>(s[i]); };
  auto b = [s](int i) { return reinterpret_cast<const bool*>(s[i]); };
  auto v = [s](int i) { return static_cast<int>(s[i]); };
  a.pos = f(0);
  a.quat = f(1);
  a.shape_type = n(2);
  a.params = f(3);
  a.alive = b(4);
  a.layer = n(5);
  a.motion = n(6);
  a.sensor = b(7);
  a.awake = b(8);
  a.fric = f(9);
  a.rest = f(10);
  a.heights = f(11);
  a.hf_origin = f(12);
  a.hf_cell_w = f(13);
  a.has_hf = b(14);
  a.hull_verts = f(15);
  a.hull_n_verts = n(16);
  a.tri_verts = f(17);
  a.tris = n(18);
  a.cell_tris = n(19);
  a.tri_origin = f(20);
  a.tri_cell_w = f(21);
  a.n = v(22);
  a.hx = v(23);
  a.hy = v(24);
  a.flags = v(25);
  a.K = v(26);
  a.H = v(27);
  a.MV = v(28);
  a.gx = v(29);
  a.gy = v(30);
  a.tcap = v(31);
  a.kc = v(32);
  a.o_a = reinterpret_cast<int*>(s[33]);
  a.o_b = reinterpret_cast<int*>(s[34]);
  a.o_point = reinterpret_cast<float*>(s[35]);
  a.o_normal = reinterpret_cast<float*>(s[36]);
  a.o_pen = reinterpret_cast<float*>(s[37]);
  a.o_valid = reinterpret_cast<bool*>(s[38]);
  a.o_fric = reinterpret_cast<float*>(s[39]);
  a.o_rest = reinterpret_cast<float*>(s[40]);
  a.o_key = reinterpret_cast<int*>(s[41]);
  if (a.H < 1 || a.kc > a.tcap || a.K > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int thread_blocks = (a.n + kThreads - 1) / kThreads;
    if ((a.flags >> 5) & 1) {
      const int warp_blocks = (a.n + kWarps - 1) / kWarps;
      static_contacts_kernel<true><<<warp_blocks + thread_blocks, kThreads, 0, st>>>(
          a, warp_blocks);
    } else {
      static_contacts_kernel<false><<<thread_blocks, kThreads, 0, st>>>(a, 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
