// KO: generic convex-vs-convex contacts for every hull bucket of a step, in
// one launch.
//
// Replaces substrata_tpu/physics/narrowphase.py:_convex_rep (:499),
// _convex_convex (:404) and _make_convex_kernel (:538) over the combo-code
// buckets of the hull codes (3, 7, 11, 12, 13, 14, 15), with the epilogue of
// pair_contacts (:729-775); plain twin:
// substrata_tpu_torch/kernels/convex.py:convex_rows_plain.
//
// The bucket table (kernels/convex.py:_Plan: each bucket's first block, and
// its code, width, slots and the offsets of its slots, rows and touching
// flags) rides in the launch's parameters, as KK's does.  A bucket's slots
// go in tiles of 32, and a tile has 8 blocks of 4 warps: a warp for each
// slot the tile may hold.  Every warp loads its tile's 32 bvalid, ba and bb
// at once (one coalesced load each) and ballots the occupied slots; warp g
// of the tile takes the g-th occupied slot and runs its SAT, so the
// occupied slots of a full tile each get a warp, as before, and a warp past
// the tile's count returns after those three loads.  The first warp past
// the count writes the empty slots' invalid rows, a lane a slot, coalesced,
// off the SATs' path: the bytes the twin writes, (0, -1e9, (0, 0, 1)),
// a = -1 in the blocked layout.
//
// A slot's warp issues its loads in two rounds: both bodies' pose and
// shape, then (a hull side's library id known) both sides' library rows
// together.  Lane i holds vertex i and face plane i of each side in world
// space (a hull has at most 32 of each, a box 8 and 6, a capsule 2 and no
// faces, a sphere 1 and none) and stages them in shared memory as float4
// rows, so the walk over the other side's vertices reads each vertex with
// one broadcast load: the two face-separation minima and the flat [Va, Vb]
// argmin of the vertex distances run in one loop over k, as three
// independent chains.  Every min, max and arg-reduction keeps the lower
// index on ties, as jnp.argmax / argmin / lax.top_k do: the face argmax,
// the argmin, the four rounds of the top-4 depths and the support
// arguments.  Only the branch the SAT selects (a face manifold of A or B,
// or the auxiliary point) is built.  Lane s < wm writes row s of the slot.
//
// What bounds it on the card: latency -- a hull-hull slot does ~2 x 32 x 32
// dot products for the face separations and 32 x 32 distances (~15 k float
// operations) behind two rounds of loads, and reads two hull rows (2 x 896
// bytes, cached across slots that share a hull) and two bodies; its rows
// are 4 x 49 bytes.  One launch a step pays the launch's fixed cost once
// for every hull bucket.
#include <cstring>

#include "closed_forms.cuh"

namespace {

constexpr float kNeg = -3e38f;
constexpr float kPos = 3e38f;
constexpr int kSphere = 0, kBox = 1, kCapsule = 2, kHull = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                         // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                         // slots a tile: one ballot word
constexpr int kBlocksPerTile = kTile / kWarps;    // kernels/convex.py:_TILE_BLOCKS
constexpr int kMaxBuckets = 7;                    // a bucket a hull code at most

// One bucket's record (kernels/convex.py:_BUCKET).
struct Bucket {
  long long in_off;
  long long row_off;
  long long touch_off;
  int code;
  int wm;
  int first;
  int slots;
};

struct Args {
  const int* ba;
  const int* bb;
  const bool* bvalid;
  const float* pos;
  const float* quat;
  const float* params;
  const float* fric;
  const float* rest;
  const bool* sensor;
  const float* hv;    // [H, MV, 3]
  const int* hnv;     // [H]
  const float* hp;    // [H, MF, 4]
  const int* hnf;     // [H]
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
  int blocked;
  int n_buckets;
  int H;
  int MV;
  int MF;
  int first[kMaxBuckets];
  Bucket bucket[kMaxBuckets];
};

struct Body {
  float p[3], q[4], prm[4];
};

// One side of the slot as lane ``lane`` holds it.
struct Side {
  float pos[3];
  float v[3];   // this lane's vertex (lanes < vpad; zeros past)
  float pl[4];  // this lane's face plane (zeros past nf)
  float r;
  int nv, vpad, nf;
};

// A warp's staged rows: each side's vertices and face planes.
struct Stage {
  float4 v[2][32];
  float4 pl[2][32];
};

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

__device__ __forceinline__ void load_body(const Args& g, int i, Body& b) {
#pragma unroll
  for (int k = 0; k < 3; ++k) b.p[k] = g.pos[3 * i + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.q[k] = g.quat[4 * i + k];
    b.prm[k] = g.params[4 * i + k];
  }
}

// A hull side's library rows for this lane: its local vertex and plane.
struct HullRows {
  float local[3];
  float plane[4];
  int nv, nf;
};

__device__ __forceinline__ int hull_id(const Args& g, const Body& b) {
  const int hid = static_cast<int>(b.prm[0]);
  return min(max(hid, 0), g.H - 1);
}

__device__ __forceinline__ void load_hull(const Args& g, int hid, int lane, HullRows& h) {
  h.nv = g.hnv[hid];
  h.nf = g.hnf[hid];
#pragma unroll
  for (int k = 0; k < 3; ++k) h.local[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) h.plane[k] = 0.0f;
  if (lane < g.MV) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      h.local[k] = g.hv[(static_cast<size_t>(hid) * g.MV + lane) * 3 + k];
  }
  if (lane < g.MF) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h.plane[k] = g.hp[(static_cast<size_t>(hid) * g.MF + lane) * 4 + k];
  }
}

// kernels/convex.py:convex_rep for this lane's vertex and plane.
__device__ __forceinline__ void make_side(int stype, const Body& b, const HullRows& h,
                                          int lane, int MV, int MF, Side& s) {
  const float* p = b.p;
  const float* q = b.q;
  const float* prm = b.prm;
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
    if (lane < 6) {   // face lane: axis lane / 2, outward sign; selects keep it in registers
      const int ax = lane >> 1;
      const float sgn = (lane & 1) ? -1.0f : 1.0f;
      nl[0] = ax == 0 ? sgn : 0.0f;
      nl[1] = ax == 1 ? sgn : 0.0f;
      nl[2] = ax == 2 ? sgn : 0.0f;
      dl = ax == 0 ? prm[0] : (ax == 1 ? prm[1] : prm[2]);
      has_plane = true;
    }
  } else {   // hull: params[0] is the library slot
    s.nv = h.nv;
    s.vpad = MV;
    s.nf = h.nf;
#pragma unroll
    for (int k = 0; k < 3; ++k) local[k] = h.local[k];
    if (lane < MF) {
      nl[0] = h.plane[0];
      nl[1] = h.plane[1];
      nl[2] = h.plane[2];
      dl = h.plane[3];
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

// The reference face's manifold (narrowphase.py:451-465): face j of the
// side whose planes are ``fpl``, incident side ``in`` (its vertices ``inv``);
// the 4 deepest incident vertices, lower index first.
__device__ __forceinline__ void face_manifold(const float4* fpl, int j, const Side& in,
                                              const float4* inv, int lane, sbt::Manifold& m,
                                              float n[3]) {
  const float4 P = fpl[j];
  n[0] = P.x;
  n[1] = P.y;
  n[2] = P.z;
  const float d = P.w;
  float depth = -INFINITY;   // lanes past the incident side's rows never win
  if (lane < in.vpad)
    depth = lane < in.nv ? (d + in.r) - (in.v[0] * n[0] + in.v[1] * n[1] + in.v[2] * n[2])
                         : kNeg;
  const int k = min(4, in.vpad);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float td = kNeg;
    int ti = 0;
    if (s < k) {
      td = depth;
      ti = lane;
      warp_argmax(td, ti);
      if (lane == ti) depth = -INFINITY;
    }
    const float4 V = inv[ti];
    const float sc = in.r - 0.5f * fmaxf(td, 0.0f);
    m.pts[s][0] = V.x - n[0] * sc;
    m.pts[s][1] = V.y - n[1] * sc;
    m.pts[s][2] = V.z - n[2] * sc;
    m.pens[s] = td;
    m.valid[s] = td > -sbt::kContactMargin;
  }
}

// One occupied slot's SAT and rows; every lane of the warp calls it.
__device__ __forceinline__ void slot_sat(const Args& g, const Bucket& bk, Stage& st, int p,
                                         int a, int b, int lane) {
  const int code = bk.code;
  const int ta = code >> 2, tb = code & 3;
  Body A_body, B_body;
  load_body(g, a, A_body);
  load_body(g, b, B_body);
  HullRows ha, hb;
  ha.nv = hb.nv = ha.nf = hb.nf = 0;
  // Both library ids first, then both sides' rows together.
  const int hid_a = ta == kHull ? hull_id(g, A_body) : 0;
  const int hid_b = tb == kHull ? hull_id(g, B_body) : 0;
  if (ta == kHull) load_hull(g, hid_a, lane, ha);
  if (tb == kHull) load_hull(g, hid_b, lane, hb);
  // The epilogue's body rows, needed last.
  const bool sens = g.sensor[a] || g.sensor[b];
  const float fa = g.fric[a], fb = g.fric[b], ra = g.rest[a], rb = g.rest[b];

  Side A, B;
  make_side(ta, A_body, ha, lane, g.MV, g.MF, A);
  make_side(tb, B_body, hb, lane, g.MV, g.MF, B);
  st.v[0][lane] = make_float4(A.v[0], A.v[1], A.v[2], 0.0f);
  st.v[1][lane] = make_float4(B.v[0], B.v[1], B.v[2], 0.0f);
  st.pl[0][lane] = make_float4(A.pl[0], A.pl[1], A.pl[2], A.pl[3]);
  st.pl[1][lane] = make_float4(B.pl[0], B.pl[1], B.pl[2], B.pl[3]);
  __syncwarp();

  // Face axes of both sides (narrowphase.py:414-419) and the closest
  // vertices (the flat argmin over [Va, Vb]: lower row, then column), in
  // one walk: three independent chains.
  float mn_a = kPos, mn_b = kPos, d2 = kPos;
  int ib = 0;
  const int kmax = max(A.nv, B.nv);
  for (int k = 0; k < kmax; ++k) {
    if (k < B.nv) {
      const float4 w = st.v[1][k];
      mn_a = fminf(mn_a, w.x * A.pl[0] + w.y * A.pl[1] + w.z * A.pl[2]);
      const float dx = A.v[0] - w.x;
      const float dy = A.v[1] - w.y;
      const float dz = A.v[2] - w.z;
      const float e = dx * dx + dy * dy + dz * dz;
      if (lane < A.nv && e < d2) {
        d2 = e;
        ib = k;
      }
    }
    if (k < A.nv) {
      const float4 w = st.v[0][k];
      mn_b = fminf(mn_b, w.x * B.pl[0] + w.y * B.pl[1] + w.z * B.pl[2]);
    }
  }
  float best_a = lane < A.nf ? (mn_a - B.r) - A.pl[3] : kNeg;
  int ja = lane;
  warp_argmax(best_a, ja);
  float best_b = lane < B.nf ? (mn_b - A.r) - B.pl[3] : kNeg;
  int jb = lane;
  warp_argmax(best_b, jb);
  int ia = lane;
  {
    float v = d2;
    warp_argmin(v, ia);
    ib = __shfl_sync(kFull, ib, ia);
  }
  float axes[2][3];
  {
    const float4 va = st.v[0][ia], vb = st.v[1][ib];
    const float dv[3] = {vb.x - va.x, vb.y - va.y, vb.z - va.z};
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
    float u[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k] = sel ? axes[1][k] : axes[0][k];
    const float4 va = st.v[0][sel ? sup_a[1] : sup_a[0]];
    const float4 vb = st.v[1][sel ? sup_b[1] : sup_b[0]];
    const float wa[3] = {va.x, va.y, va.z}, wb[3] = {vb.x, vb.y, vb.z};
    float point[3], nrm[3];
    const float pen = -best_x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ps_a = wa[k] + u[k] * A.r;
      const float ps_b = wb[k] - u[k] * B.r;
      point[k] = 0.5f * (ps_a + ps_b);
      nrm[k] = -u[k];
    }
    sbt::one_point(m, point, pen, nrm, pen > -sbt::kContactMargin);
  } else if (use_b) {
    float n[3];
    face_manifold(st.pl[1], jb, A, st.v[0], lane, m, n);
#pragma unroll
    for (int k = 0; k < 3; ++k) m.n[k] = n[k];
  } else {
    float n[3];
    face_manifold(st.pl[0], ja, B, st.v[1], lane, m, n);
#pragma unroll
    for (int k = 0; k < 3; ++k) m.n[k] = -n[k];
  }

  // The epilogue (closed_forms.cuh:write_rows on an occupied slot): the
  // speculative prune over the four slots, then lane s writes row s.
  bool near = false, touch = false;
  int deepest = 0;
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m.valid[k] = m.valid[k] && !separated;
    near = near || (m.valid[k] && m.pens[k] > -0.01f);
    const float v = m.valid[k] ? m.pens[k] : -1e9f;
    if (k == 0 || v > best) {
      best = v;
      deepest = k;
    }
  }
  float pt[3] = {0.0f, 0.0f, 0.0f}, pen = 0.0f;
  bool valid = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m.valid[k] = m.valid[k] && (near || k == deepest);
    touch = touch || m.valid[k];
    if (lane == k) {
      pt[0] = m.pts[k][0];
      pt[1] = m.pts[k][1];
      pt[2] = m.pts[k][2];
      pen = m.pens[k];
      valid = m.valid[k];
    }
  }
  if (lane == 0) g.o_touch[bk.touch_off + p] = touch;
  const int wm = bk.wm;
  if (lane < wm) {
    const long long r = bk.row_off + static_cast<long long>(p) * wm + lane;
    g.o_a[r] = a;
    g.o_b[r] = b;
    g.o_point[3 * r + 0] = pt[0];
    g.o_point[3 * r + 1] = pt[1];
    g.o_point[3 * r + 2] = pt[2];
    g.o_normal[3 * r + 0] = m.n[0];
    g.o_normal[3 * r + 1] = m.n[1];
    g.o_normal[3 * r + 2] = m.n[2];
    g.o_pen[r] = pen;
    g.o_valid[r] = valid && !sens;
    g.o_fric[r] = sqrtf(fmaxf(fa * fb, 0.0f));
    g.o_rest[r] = fmaxf(ra, rb);
    g.o_key[r] = b * 4 + lane + 9;
  }
}

__global__ void __launch_bounds__(kThreads) convex_buckets_kernel(const Args g) {
  __shared__ Stage stage[kWarps];
  // The block's bucket: the last whose first block is at or below it.
  const int bid = static_cast<int>(blockIdx.x);
  int k = g.n_buckets - 1;
  while (k > 0 && bid < g.first[k]) --k;
  const Bucket& bk = g.bucket[k];
  const int local = bid - bk.first;
  const int tile0 = local / kBlocksPerTile * kTile;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = local % kBlocksPerTile * kWarps + warp;   // the tile's warp

  // The tile's slots, one a lane: occupancy and bodies, loaded at once.
  const int p = tile0 + lane;
  const bool in = p < bk.slots;
  bool pv = false;
  int a = 0, b = 0;
  if (in) {
    pv = g.bvalid[bk.in_off + p];
    a = g.ba[bk.in_off + p];
    b = g.bb[bk.in_off + p];
  }
  const unsigned occupied = __ballot_sync(kFull, pv);
  const int n_occupied = __popc(occupied);

  // The tile's first warp without a slot of its own writes the empty rows
  // (there is one wherever a slot of the tile is empty).
  if (rank == n_occupied && in && !pv) {
    // An empty slot: its rows are invalid whatever its manifold, the twin's
    // (0, -1e9, (0, 0, 1)) rows, written without the SAT.
    const float fr = sqrtf(fmaxf(g.fric[a] * g.fric[b], 0.0f));
    const float re = fmaxf(g.rest[a], g.rest[b]);
    const int wm = bk.wm;
    g.o_touch[bk.touch_off + p] = false;
    for (int s = 0; s < wm; ++s) {
      const long long r = bk.row_off + static_cast<long long>(p) * wm + s;
      g.o_a[r] = g.blocked ? -1 : a;
      g.o_b[r] = b;
      g.o_point[3 * r + 0] = 0.0f;
      g.o_point[3 * r + 1] = 0.0f;
      g.o_point[3 * r + 2] = 0.0f;
      g.o_normal[3 * r + 0] = 0.0f;
      g.o_normal[3 * r + 1] = 0.0f;
      g.o_normal[3 * r + 2] = 1.0f;
      g.o_pen[r] = -1e9f;
      g.o_valid[r] = false;
      g.o_fric[r] = fr;
      g.o_rest[r] = re;
      g.o_key[r] = b * 4 + s + 9;
    }
  }
  if (rank >= n_occupied) return;   // warp-uniform
  // This warp's slot: the rank-th occupied one.
  unsigned rest = occupied;
  for (int i = 0; i < rank; ++i) rest &= rest - 1;
  const int src = __ffs(rest) - 1;
  slot_sat(g, bk, stage[warp], tile0 + src, __shfl_sync(kFull, a, src),
           __shfl_sync(kFull, b, src), lane);
}

}  // namespace

// One host buffer (kernels/convex.py:_PACK, then _Plan.table): int64 words
// ba, bb, bvalid, pos, quat, params, fric, rest, sensor, hull verts,
// n_verts, planes, n_faces, out a, b, point, normal, pen, valid, fric, rest,
// key, touch; blocked, the number of buckets and of blocks, H, the library's
// max verts and max faces; then the first blocks and the buckets' records
// (Args::first, Args::bucket).
extern "C" int convex_buckets(const long long* s, void* stream) {
  Args g;
  g.ba = reinterpret_cast<const int*>(s[0]);
  g.bb = reinterpret_cast<const int*>(s[1]);
  g.bvalid = reinterpret_cast<const bool*>(s[2]);
  g.pos = reinterpret_cast<const float*>(s[3]);
  g.quat = reinterpret_cast<const float*>(s[4]);
  g.params = reinterpret_cast<const float*>(s[5]);
  g.fric = reinterpret_cast<const float*>(s[6]);
  g.rest = reinterpret_cast<const float*>(s[7]);
  g.sensor = reinterpret_cast<const bool*>(s[8]);
  g.hv = reinterpret_cast<const float*>(s[9]);
  g.hnv = reinterpret_cast<const int*>(s[10]);
  g.hp = reinterpret_cast<const float*>(s[11]);
  g.hnf = reinterpret_cast<const int*>(s[12]);
  g.o_a = reinterpret_cast<int*>(s[13]);
  g.o_b = reinterpret_cast<int*>(s[14]);
  g.o_point = reinterpret_cast<float*>(s[15]);
  g.o_normal = reinterpret_cast<float*>(s[16]);
  g.o_pen = reinterpret_cast<float*>(s[17]);
  g.o_valid = reinterpret_cast<bool*>(s[18]);
  g.o_fric = reinterpret_cast<float*>(s[19]);
  g.o_rest = reinterpret_cast<float*>(s[20]);
  g.o_key = reinterpret_cast<int*>(s[21]);
  g.o_touch = reinterpret_cast<bool*>(s[22]);
  g.blocked = static_cast<int>(s[23]);
  const long long n_buckets = s[24], blocks = s[25];
  g.H = static_cast<int>(s[26]);
  g.MV = static_cast<int>(s[27]);
  g.MF = static_cast<int>(s[28]);
  if (n_buckets < 1 || n_buckets > kMaxBuckets || blocks < 0 || blocks > 0x7fffffffLL ||
      g.MV > 32 || g.MF > 32 || g.H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  g.n_buckets = static_cast<int>(n_buckets);
  const char* table = reinterpret_cast<const char*>(s + 29);
  memcpy(g.first, table, sizeof g.first);
  memcpy(g.bucket, table + sizeof g.first, sizeof g.bucket);
  for (int k = 0; k < g.n_buckets; ++k)
    if (g.bucket[k].wm < 1 || g.bucket[k].wm > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    convex_buckets_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}
