// KO: generic convex-vs-convex contacts for one narrowphase bucket of a hull combo.
//
// Replaces substrata_tpu/physics/narrowphase.py:_convex_rep (:499),
// _convex_convex (:404) and _make_convex_kernel (:538) over a combo-code bucket
// (codes 3, 7, 11, 12, 13, 14, 15), with the epilogue of pair_contacts
// (:729-775); plain twin: substrata_tpu_torch/kernels/convex.py:convex_rows_plain.
//
// One warp per bucket slot; an empty slot writes invalid rows and stops.
// Lane i holds vertex i and face plane i of each
// side in world space (a hull has at most 32 of each, a box 8 and 6, a
// capsule 2 and no faces, a sphere 1 and none); loops run to the hull's
// n_verts and n_faces, and the other side's vertices reach a lane by warp
// shuffles.  Every min, max and arg-reduction is a shuffle tree that keeps
// the lower index on ties, as jnp.argmax / argmin / lax.top_k do: the face
// argmax, the flat [Va, Vb] argmin of the vertex distances, the four rounds
// of the top-4 depths and the support arguments.  Only the branch the SAT
// selects (a face manifold of A or B, or the auxiliary point) is built.
// What bounds it on the card: latency and operations -- a hull-hull slot
// does ~2 x 32 x 32 dot products for the face separations and 32 x 32
// distances (~15 k float operations) over ~60 dependent shuffle steps, and
// reads two hull rows (2 x 896 bytes, cached across slots that share a hull)
// and two bodies; its rows are 4 x 49 bytes.
#include "closed_forms.cuh"

namespace {

constexpr float kNeg = -3e38f;
constexpr float kPos = 3e38f;
constexpr int kSphere = 0, kBox = 1, kCapsule = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Side {
  float pos[3];
  float v[3];   // this lane's vertex (lanes < vpad)
  float pl[4];  // this lane's face plane (zeros past nf)
  float r;
  int nv, vpad, nf;
};

__device__ __forceinline__ float shfl(float x, int lane) { return __shfl_sync(kFull, x, lane); }

// (value, index): the largest value, the lower index on ties, in every lane.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// kernels/convex.py:convex_rep for this lane's vertex and plane.
__device__ void load_side(int stype, int body, int lane, const float* __restrict__ pos,
                          const float* __restrict__ quat, const float* __restrict__ params,
                          const float* __restrict__ hv, const int* __restrict__ hnv,
                          const float* __restrict__ hp, const int* __restrict__ hnf, int H,
                          int MV, int MF, Side& s) {
  const float p[3] = {pos[3 * body], pos[3 * body + 1], pos[3 * body + 2]};
  const float q[4] = {quat[4 * body], quat[4 * body + 1], quat[4 * body + 2],
                      quat[4 * body + 3]};
  const float prm[4] = {params[4 * body], params[4 * body + 1], params[4 * body + 2],
                        params[4 * body + 3]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = p[k];
    s.v[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s.pl[k] = 0.0f;
  s.r = 0.0f;
  float local[3] = {0.0f, 0.0f, 0.0f};
  float nl[3] = {0.0f, 0.0f, 0.0f}, dl = 0.0f;
  bool has_plane = false;
  if (stype == kSphere) {
    s.nv = s.vpad = 1;
    s.nf = 0;
    s.r = prm[0];
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s.v[k] = p[k];
    }
    return;
  }
  if (stype == kCapsule) {
    s.nv = s.vpad = 2;
    s.nf = 0;
    s.r = prm[0];
    const float ez[3] = {0.0f, 0.0f, 1.0f};
    float z[3];
    sbt::rotate_vec(q, ez, z);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z[k] = z[k] * prm[1];
      if (lane == 0) s.v[k] = p[k] + z[k];
      if (lane == 1) s.v[k] = p[k] - z[k];
    }
    return;
  }
  if (stype == kBox) {
    s.nv = s.vpad = 8;
    s.nf = 6;
    if (lane < 8) {
      local[0] = ((lane >> 2) & 1 ? 1.0f : -1.0f) * prm[0];
      local[1] = ((lane >> 1) & 1 ? 1.0f : -1.0f) * prm[1];
      local[2] = (lane & 1 ? 1.0f : -1.0f) * prm[2];
    }
    if (lane < 6) {
      nl[lane >> 1] = (lane & 1) ? -1.0f : 1.0f;
      dl = prm[lane >> 1];
      has_plane = true;
    }
  } else {   // hull: params[0] is the library slot
    int hid = static_cast<int>(prm[0]);
    hid = min(max(hid, 0), H - 1);
    s.nv = hnv[hid];
    s.vpad = MV;
    s.nf = hnf[hid];
    if (lane < MV) {
#pragma unroll
      for (int k = 0; k < 3; ++k) local[k] = hv[(static_cast<size_t>(hid) * MV + lane) * 3 + k];
    }
    if (lane < MF) {
      const float* row = hp + (static_cast<size_t>(hid) * MF + lane) * 4;
      nl[0] = row[0];
      nl[1] = row[1];
      nl[2] = row[2];
      dl = row[3];
      has_plane = true;
    }
  }
  if (lane < s.vpad) {
    float rv[3];
    sbt::rotate_vec(q, local, rv);
#pragma unroll
    for (int k = 0; k < 3; ++k) s.v[k] = p[k] + rv[k];
  }
  if (has_plane) {
    float nw[3];
    sbt::rotate_vec(q, nl, nw);
    s.pl[0] = nw[0];
    s.pl[1] = nw[1];
    s.pl[2] = nw[2];
    s.pl[3] = dl + sbt::dot3(nw, p);
  }
}

// Separation along this lane's face of `f` against the vertices of `o`
// (narrowphase.py:414-419), NEG past f.nf.
__device__ float face_sep(const Side& f, const Side& o, int lane) {
  float mn = kPos;
  for (int k = 0; k < o.nv; ++k) {
    const float w[3] = {shfl(o.v[0], k), shfl(o.v[1], k), shfl(o.v[2], k)};
    mn = fminf(mn, w[0] * f.pl[0] + w[1] * f.pl[1] + w[2] * f.pl[2]);
  }
  return lane < f.nf ? (mn - o.r) - f.pl[3] : kNeg;
}

// The reference face's manifold (narrowphase.py:451-465): face j of `f`,
// incident side `in`; the 4 deepest incident vertices, lower index first.
__device__ void face_manifold(const Side& f, int j, const Side& in, int lane, sbt::Manifold& m,
                              float n[3]) {
  n[0] = shfl(f.pl[0], j);
  n[1] = shfl(f.pl[1], j);
  n[2] = shfl(f.pl[2], j);
  const float d = shfl(f.pl[3], j);
  float depth = -INFINITY;   // lanes past the incident side's rows never win
  if (lane < in.vpad)
    depth = lane < in.nv ? (d + in.r) - (in.v[0] * n[0] + in.v[1] * n[1] + in.v[2] * n[2])
                         : kNeg;
  const int k = min(4, in.vpad);
  for (int s = 0; s < 4; ++s) {
    float td = kNeg;
    int ti = 0;
    if (s < k) {
      td = depth;
      ti = lane;
      warp_argmax(td, ti);
      if (lane == ti) depth = -INFINITY;
    }
    const float vx = shfl(in.v[0], ti), vy = shfl(in.v[1], ti), vz = shfl(in.v[2], ti);
    const float sc = in.r - 0.5f * fmaxf(td, 0.0f);
    m.pts[s][0] = vx - n[0] * sc;
    m.pts[s][1] = vy - n[1] * sc;
    m.pts[s][2] = vz - n[2] * sc;
    m.pens[s] = td;
    m.valid[s] = td > -sbt::kContactMargin;
  }
}

__global__ void convex_rows_kernel(
    const int* __restrict__ ba, const int* __restrict__ bb, const bool* __restrict__ bvalid,
    const float* __restrict__ pos, const float* __restrict__ quat,
    const float* __restrict__ params, const float* __restrict__ fric,
    const float* __restrict__ rest, const bool* __restrict__ sensor,
    const float* __restrict__ hv, const int* __restrict__ hnv, const float* __restrict__ hp,
    const int* __restrict__ hnf, int cap, int code, int wm, int blocked, int H, int MV, int MF,
    int* __restrict__ o_a, int* __restrict__ o_b, float* __restrict__ o_point,
    float* __restrict__ o_normal, float* __restrict__ o_pen, bool* __restrict__ o_valid,
    float* __restrict__ o_fric, float* __restrict__ o_rest, int* __restrict__ o_key,
    bool* __restrict__ o_touch) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= cap) return;   // warp-uniform
  const bool pv = bvalid[p];
  const int a = ba[p], b = bb[p];
  if (!pv) {
    // An empty slot: its rows are invalid whatever its manifold; write the
    // twin's (0, -1e9, (0, 0, 1)) rows without running the SAT.
    sbt::Manifold m;
    const float z[3] = {0.0f, 0.0f, 0.0f}, up[3] = {0.0f, 0.0f, 1.0f};
    sbt::one_point(m, z, -1e9f, up, false);
    if (lane == 0)
      sbt::write_rows(m, p, pv, a, b, wm, blocked, fric, rest, sensor, o_a, o_b, o_point,
                      o_normal, o_pen, o_valid, o_fric, o_rest, o_key, o_touch);
    return;
  }
  Side A, B;
  load_side(code >> 2, a, lane, pos, quat, params, hv, hnv, hp, hnf, H, MV, MF, A);
  load_side(code & 3, b, lane, pos, quat, params, hv, hnv, hp, hnf, H, MV, MF, B);

  // Face axes of both sides.
  float best_a = face_sep(A, B, lane);
  int ja = lane;
  warp_argmax(best_a, ja);
  float best_b = face_sep(B, A, lane);
  int jb = lane;
  warp_argmax(best_b, jb);

  // Closest vertices: the flat argmin over [Va, Vb] (lower row, then column).
  float d2 = kPos;
  int ib = 0;
  for (int k = 0; k < B.nv; ++k) {   // every lane shuffles; rows past A.nv stay at kPos
    const float dx = A.v[0] - shfl(B.v[0], k);
    const float dy = A.v[1] - shfl(B.v[1], k);
    const float dz = A.v[2] - shfl(B.v[2], k);
    const float e = dx * dx + dy * dy + dz * dz;
    if (lane < A.nv && e < d2) {
      d2 = e;
      ib = k;
    }
  }
  int ia = lane;
  {
    float v = d2;
    int key = lane;
    warp_argmin(v, key);
    ia = key;
    ib = __shfl_sync(kFull, ib, ia);
  }
  float axes[2][3];
  {
    const float dv[3] = {shfl(B.v[0], ib) - shfl(A.v[0], ia), shfl(B.v[1], ib) - shfl(A.v[1], ia),
                         shfl(B.v[2], ib) - shfl(A.v[2], ia)};
    sbt::safe_normalize(dv, axes[0]);
    const float dc[3] = {B.pos[0] - A.pos[0], B.pos[1] - A.pos[1], B.pos[2] - A.pos[2]};
    sbt::safe_normalize(dc, axes[1]);
  }
  float sep_aux[2];
  int sup_a[2], sup_b[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float* u = axes[x];
    float va = lane < A.nv ? A.v[0] * u[0] + A.v[1] * u[1] + A.v[2] * u[2] : kNeg;
    float vb = lane < B.nv ? B.v[0] * u[0] + B.v[1] * u[1] + B.v[2] * u[2] : kPos;
    int ka = lane, kb = lane;
    warp_argmax(va, ka);
    warp_argmin(vb, kb);
    sup_a[x] = ka;
    sup_b[x] = kb;
    sep_aux[x] = (vb - B.r) - (va + A.r);
  }
  const int sel = sep_aux[1] > sep_aux[0] ? 1 : 0;
  const float best_x = fmaxf(sep_aux[0], sep_aux[1]);
  const bool separated = fmaxf(fmaxf(best_a, best_b), best_x) > sbt::kContactMargin;
  const float best_face = fmaxf(best_a, best_b);
  const bool use_aux = best_x > best_face * 0.98f + 0.001f;
  const bool use_b = !use_aux && (best_b > best_a * 0.98f + 0.001f);

  sbt::Manifold m;
  if (use_aux) {
    const float* u = axes[sel];
    const int ka = sup_a[sel], kb = sup_b[sel];
    float point[3], nrm[3];
    const float pen = -best_x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ps_a = shfl(A.v[k], ka) + u[k] * A.r;
      const float ps_b = shfl(B.v[k], kb) - u[k] * B.r;
      point[k] = 0.5f * (ps_a + ps_b);
      nrm[k] = -u[k];
    }
    sbt::one_point(m, point, pen, nrm, pen > -sbt::kContactMargin);
  } else if (use_b) {
    float n[3];
    face_manifold(B, jb, A, lane, m, n);
#pragma unroll
    for (int k = 0; k < 3; ++k) m.n[k] = n[k];
  } else {
    float n[3];
    face_manifold(A, ja, B, lane, m, n);
#pragma unroll
    for (int k = 0; k < 3; ++k) m.n[k] = -n[k];
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) m.valid[s] = m.valid[s] && !separated;
  if (lane == 0)
    sbt::write_rows(m, p, pv, a, b, wm, blocked, fric, rest, sensor, o_a, o_b, o_point,
                    o_normal, o_pen, o_valid, o_fric, o_rest, o_key, o_touch);
}

}  // namespace

extern "C" int convex_rows(const int* ba, const int* bb, const bool* bvalid, const float* pos,
                           const float* quat, const float* params, const float* fric,
                           const float* rest, const bool* sensor, const float* hull_verts,
                           const int* hull_n_verts, const float* hull_planes,
                           const int* hull_n_faces, int cap, int code, int wm, int blocked,
                           int H, int MV, int MF, int* o_a, int* o_b, float* o_point,
                           float* o_normal, float* o_pen, bool* o_valid, float* o_fric,
                           float* o_rest, int* o_key, bool* o_touch, void* stream) {
  if (wm < 1 || wm > 4 || MV > 32 || MF > 32 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap > 0) {
    const int threads = 128;   // 4 slots a block
    const int blocks = (cap + 3) / 4;
    convex_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        ba, bb, bvalid, pos, quat, params, fric, rest, sensor, hull_verts, hull_n_verts,
        hull_planes, hull_n_faces, cap, code, wm, blocked, H, MV, MF, o_a, o_b, o_point,
        o_normal, o_pen, o_valid, o_fric, o_rest, o_key, o_touch);
  }
  return static_cast<int>(cudaGetLastError());
}
