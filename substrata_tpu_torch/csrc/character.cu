// KL: the character controller's whole update, in one block.
//
// Replaces substrata_tpu/physics/character.py:character_update (:264-500)
// with _gather_capsule_candidates (:108), _capsule_probe (:147),
// _support_info (:245) and the packed readback of _player_update_packed
// (:504-523); plain twin:
// substrata_tpu_torch/kernels/character.py:character_packed_plain.
//
// One block of 256 threads, one launch per tick.  The static rows are the
// capsule segment's three sample spheres on the heightfield (threads 0-2)
// and on the static trimesh (threads 3-5: every triangle of the sample's
// grid cell, trimesh.cuh, the deepest first on ties).  The block gathers the
// candidate rows (the 27-cell neighbourhoods of two or three capsule centres
// in the cell table, then the oversize slots: 550 rows at the bench) and
// their bodies' fields into shared memory once; every probe (5 to 28 a tick)
// then has the threads stride the rows, run the row's own closed form from
// closed_forms.cuh (capsule-box: a 14-step ternary search) on rows that pass
// the sphere test, and leave one contact per row in shared memory.  Every
// argmax is a block reduction that breaks ties toward the lower row, as
// jnp.argmax does.  The scalar state (foot, velocity, flags) is computed
// identically by every thread, so the reference's two lax.conds (the stair
// walk, the stick-to-floor scan) are block-uniform branches: no host sync.
// Scans that the reference runs in full and reads only up to a first hit
// stop at that hit.  What bounds it on the card: latency — ~30 dependent
// block-wide steps (probe, sync, reduction) of a few hundred operations per
// row; the bytes (the candidate rows, ~25 KB) and operations (~1 M) are
// small.
#include "trimesh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStatic = 6;
constexpr int kHead = 15;
constexpr float kR = 0.3f;
constexpr float kEye = 1.67f;
constexpr float kLower = static_cast<float>(0.3 * 1.05);
constexpr float kGravWater = static_cast<float>(9.81 * 1.1);
constexpr float kMaxSlopeCos = 0.6428f;
constexpr int kSphere = 0, kBox = 1, kCapsule = 2;

struct Ctx {
  // candidate rows (Kc)
  float *c_pos, *c_quat, *c_prm, *c_lv, *c_av, *c_bound;
  int *c_type, *c_idx, *c_ok;
  // one probe's rows (K = kStatic + Kc)
  float *p_n, *p_pen, *p_pt, *p_vel, *p_val;
  int* p_ok;
  float* s_red_v;
  int* s_red_i;
  int K, Kc;
  // heightfield
  const float* heights;
  float ox, oy, cw, umax, vmax;
  int hy;
  bool flat, has_hf;
  // static trimesh (tm.cap == 0: none)
  sbt::TriMeshView tm;
};

// physics/state.py:Heightfield.sample_with_normal
__device__ void hf_sample_normal(const Ctx& c, float x, float y, float& h, float n[3]) {
  if (c.flat) {
    h = c.heights[0];
    n[0] = 0.0f;
    n[1] = 0.0f;
    n[2] = 1.0f;
    return;
  }
  float u = (x - c.ox) / c.cw;
  float v = (y - c.oy) / c.cw;
  u = fminf(fmaxf(u, 0.0f), c.umax);
  v = fminf(fmaxf(v, 0.0f), c.vmax);
  const int i0 = static_cast<int>(floorf(u));
  const int j0 = static_cast<int>(floorf(v));
  const float fu = u - static_cast<float>(i0);
  const float fv = v - static_cast<float>(j0);
  const float h00 = c.heights[i0 * c.hy + j0], h10 = c.heights[(i0 + 1) * c.hy + j0];
  const float h01 = c.heights[i0 * c.hy + j0 + 1], h11 = c.heights[(i0 + 1) * c.hy + j0 + 1];
  h = sbt::hf_bilinear(fu, fv, h00, h10, h01, h11);
  sbt::hf_patch_normal(fu, fv, h00, h10, h01, h11, c.cw, n[0], n[1], n[2]);
}

// argmax over v[0:K] (first maximum), the result in every thread.
__device__ void block_argmax(const Ctx& c, const float* v, float& best, int& bi) {
  float b = -INFINITY;
  int idx = 0x7fffffff;
  for (int r = threadIdx.x; r < c.K; r += blockDim.x) {
    if (v[r] > b) {
      b = v[r];
      idx = r;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, b, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (ob > b || (ob == b && oi < idx)) {
      b = ob;
      idx = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // the scratch may still be read by an earlier reduction
  if (lane == 0) {
    c.s_red_v[warp] = b;
    c.s_red_i[warp] = idx;
  }
  __syncthreads();
  b = c.s_red_v[0];
  idx = c.s_red_i[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    const float ob = c.s_red_v[w];
    const int oi = c.s_red_i[w];
    if (ob > b || (ob == b && oi < idx)) {
      b = ob;
      idx = oi;
    }
  }
  best = b;
  bi = idx;
}

// The capsule's contacts at `foot`: one row per static sample and candidate
// (kernels/character.py:capsule_probe).
__device__ void probe(const Ctx& c, const float foot[3], float cyl_h) {
  const float center[3] = {foot[0] + 0.0f, foot[1] + 0.0f, foot[2] + (kR + 0.5f * cyl_h)};
  const float half_h = 0.5f * cyl_h;
  const int t = threadIdx.x;
  if (t < 3) {
    const float dz = t == 0 ? -half_h : (t == 2 ? half_h : 0.0f);
    const float s[3] = {t == 1 ? center[0] : center[0] + 0.0f,
                        t == 1 ? center[1] : center[1] + 0.0f,
                        t == 1 ? center[2] : center[2] + dz};
    float h, n[3];
    hf_sample_normal(c, s[0], s[1], h, n);
    const float pen = (h - (s[2] - kR)) * n[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c.p_n[3 * t + k] = n[k];
      c.p_vel[3 * t + k] = 0.0f;
    }
    c.p_pt[3 * t + 0] = s[0];
    c.p_pt[3 * t + 1] = s[1];
    c.p_pt[3 * t + 2] = h;
    c.p_pen[t] = pen;
    c.p_ok[t] = c.has_hf && pen > -0.05f;
  } else if (t < kStatic) {
    // The same sample against every triangle of its trimesh cell
    // (kernels/character.py:_trimesh_rows); no triangle: an invalid row.
    const int si = t - 3;
    const float dz = si == 0 ? -half_h : (si == 2 ? half_h : 0.0f);
    const float s[3] = {si == 1 ? center[0] : center[0] + 0.0f,
                        si == 1 ? center[1] : center[1] + 0.0f,
                        si == 1 ? center[2] : center[2] + dz};
    float pen = -1e9f, pt[3] = {0.0f, 0.0f, 0.0f}, n[3] = {0.0f, 0.0f, 1.0f};
    if (c.tm.cap > 0 && !sbt::sphere_vs_cell(c.tm, s, kR, c.tm.cap, pen, pt, n)) {
      pen = -1e9f;
      pt[0] = pt[1] = pt[2] = 0.0f;
      n[0] = n[1] = 0.0f;
      n[2] = 1.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c.p_n[3 * t + k] = n[k];
      c.p_pt[3 * t + k] = pt[k];
      c.p_vel[3 * t + k] = 0.0f;
    }
    c.p_pen[t] = pen;
    c.p_ok[t] = pen > -0.05f;
  }
  const float up_q[4] = {0.0f, 0.0f, 0.0f, 1.0f};
  for (int j = t; j < c.Kc; j += blockDim.x) {
    const int r = kStatic + j;
    const float pb[3] = {c.c_pos[3 * j], c.c_pos[3 * j + 1], c.c_pos[3 * j + 2]};
    const float d[3] = {pb[0] - center[0], pb[1] - center[1], pb[2] - center[2]};
    const float reach = c.c_bound[j] + half_h + kR + 0.6f;
    const bool okc = c.c_ok[j] && sbt::dot3(d, d) <= reach * reach;
    float n[3] = {0.0f, 0.0f, 1.0f}, pt[3] = {0.0f, 0.0f, 0.0f}, vel[3] = {0.0f, 0.0f, 0.0f};
    float pen = -1e9f;
    bool ok = false;
    if (okc) {
      const float qb[4] = {c.c_quat[4 * j], c.c_quat[4 * j + 1], c.c_quat[4 * j + 2],
                           c.c_quat[4 * j + 3]};
      const float prm[4] = {c.c_prm[4 * j], c.c_prm[4 * j + 1], c.c_prm[4 * j + 2],
                            c.c_prm[4 * j + 3]};
      const int st = c.c_type[j];
      sbt::Manifold m;
      if (st == kSphere) {
        sbt::sphere_capsule(pb, prm[0], center, up_q, kR, half_h, m);
        m.n[0] = -m.n[0];
        m.n[1] = -m.n[1];
        m.n[2] = -m.n[2];
      } else if (st == kCapsule) {
        sbt::capsule_capsule(center, up_q, kR, half_h, pb, qb, prm[0], prm[1], m);
      } else {
        // Boxes take params[:3], hulls params[1:4] (character.py:169-170).
        sbt::capsule_box(center, up_q, kR, half_h, pb, qb, st == kBox ? prm : prm + 1, m);
      }
      int k = 0;
      float best = m.valid[0] ? m.pens[0] : -1e9f;
#pragma unroll
      for (int s = 1; s < 4; ++s) {
        const float v = m.valid[s] ? m.pens[s] : -1e9f;
        if (v > best) {
          best = v;
          k = s;
        }
      }
      pen = m.pens[k];
      ok = m.valid[k];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        n[q] = m.n[q];
        pt[q] = m.pts[k][q];
      }
      const float av[3] = {c.c_av[3 * j], c.c_av[3 * j + 1], c.c_av[3 * j + 2]};
      const float rel[3] = {pt[0] - pb[0], pt[1] - pb[1], pt[2] - pb[2]};
      float w[3];
      sbt::cross3(av, rel, w);
#pragma unroll
      for (int q = 0; q < 3; ++q) vel[q] = c.c_lv[3 * j + q] + w[q];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      c.p_n[3 * r + q] = n[q];
      c.p_pt[3 * r + q] = pt[q];
      c.p_vel[3 * r + q] = vel[q];
    }
    c.p_pen[r] = pen;
    c.p_ok[r] = ok;
  }
  __syncthreads();
}

struct Support {
  bool supported, steep;
  float gn[3], gv[3];
};

// kernels/character.py:support_info on the current probe's rows.
__device__ Support support_info(const Ctx& c, const float foot[3]) {
  const float lim = foot[2] + kLower;
  bool any = false;
  for (int r = threadIdx.x; r < c.K; r += blockDim.x) {
    const bool touching = c.p_ok[r] && c.p_pt[3 * r + 2] <= lim && c.p_pen[r] > -0.02f;
    c.p_val[r] = touching ? c.p_n[3 * r + 2] : -1e9f;
    any = any || touching;
  }
  Support s;
  s.supported = __syncthreads_or(any);
  float best;
  int gi;
  block_argmax(c, c.p_val, best, gi);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.gn[k] = s.supported ? c.p_n[3 * gi + k] : (k == 2 ? 1.0f : 0.0f);
    s.gv[k] = s.supported ? c.p_vel[3 * gi + k] : 0.0f;
  }
  s.steep = s.gn[2] < kMaxSlopeCos;
  __syncthreads();
  return s;
}

// max over rows of (ok ? pen : -1e9), in every thread.
__device__ float max_ok_pen(const Ctx& c) {
  for (int r = threadIdx.x; r < c.K; r += blockDim.x) c.p_val[r] = c.p_ok[r] ? c.p_pen[r] : -1e9f;
  __syncthreads();
  float best;
  int bi;
  block_argmax(c, c.p_val, best, bi);
  __syncthreads();
  return best;
}

// any(ok & pen > thresh)
__device__ bool any_ok_deeper(const Ctx& c, float thresh) {
  bool any = false;
  for (int r = threadIdx.x; r < c.K; r += blockDim.x) any = any || (c.p_ok[r] && c.p_pen[r] > thresh);
  return __syncthreads_or(any);
}

__device__ __forceinline__ float norm3(const float v[3]) { return sqrtf(sbt::dot3(v, v)); }

__global__ void __launch_bounds__(kThreads) character_kernel(
    const float* __restrict__ ch_pos, const float* __restrict__ ch_vel,
    const bool* __restrict__ ch_on_ground, const float* __restrict__ ch_gn,
    const float* __restrict__ ch_gv, const float* __restrict__ ch_cz,
    const bool* __restrict__ ch_grav, const bool* __restrict__ ch_fly,
    const bool* __restrict__ ch_sit, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ linvel,
    const float* __restrict__ angvel, const int* __restrict__ shape_type,
    const float* __restrict__ params, const float* __restrict__ bound_radius,
    const bool* __restrict__ alive, const int* __restrict__ layer,
    const bool* __restrict__ sensor, const int* __restrict__ table,
    const int* __restrict__ os_idx, const float* __restrict__ heights,
    const float* __restrict__ hf_origin, const float* __restrict__ hf_cell_w,
    const bool* __restrict__ has_hf, const float* __restrict__ water_z,
    const float* __restrict__ scal, const float* __restrict__ tri_verts,
    const int* __restrict__ tris, const int* __restrict__ cell_tris,
    const float* __restrict__ tri_origin, const float* __restrict__ tri_cell_w, int num_buckets,
    int cap, int n_os, int n_centers, int hx, int hy, int flat, int gx, int gy, int tcap,
    float rcp_cell, float* __restrict__ o_pos, float* __restrict__ o_vel,
    bool* __restrict__ o_on_ground, float* __restrict__ o_gn, float* __restrict__ o_gv,
    float* __restrict__ o_cz, bool* __restrict__ o_grav, bool* __restrict__ o_fly,
    bool* __restrict__ o_sit, float* __restrict__ packed) {
  extern __shared__ float smem[];
  const int Kc = n_centers * 27 * cap + n_os;
  const int K = kStatic + Kc;
  Ctx c;
  float* f = smem;
  c.c_pos = f;
  f += 3 * Kc;
  c.c_quat = f;
  f += 4 * Kc;
  c.c_prm = f;
  f += 4 * Kc;
  c.c_lv = f;
  f += 3 * Kc;
  c.c_av = f;
  f += 3 * Kc;
  c.c_bound = f;
  f += Kc;
  c.p_n = f;
  f += 3 * K;
  c.p_pen = f;
  f += K;
  c.p_pt = f;
  f += 3 * K;
  c.p_vel = f;
  f += 3 * K;
  c.p_val = f;
  f += K;
  c.s_red_v = f;
  f += 32;
  int* ip = reinterpret_cast<int*>(f);
  c.c_type = ip;
  ip += Kc;
  c.c_idx = ip;
  ip += Kc;
  c.c_ok = ip;
  ip += Kc;
  c.p_ok = ip;
  ip += K;
  c.s_red_i = ip;
  c.K = K;
  c.Kc = Kc;
  c.heights = heights;
  c.ox = hf_origin[0];
  c.oy = hf_origin[1];
  c.cw = *hf_cell_w;
  c.umax = static_cast<float>(hx - 1.001);
  c.vmax = static_cast<float>(hy - 1.001);
  c.hy = hy;
  c.flat = flat != 0;
  c.has_hf = *has_hf;
  c.tm = sbt::TriMeshView{tri_verts, tris, cell_tris,
                          tcap > 0 ? tri_origin[0] : 0.0f, tcap > 0 ? tri_origin[1] : 0.0f,
                          tcap > 0 ? *tri_cell_w : 1.0f, gx, gy, tcap};
  const float ez[3] = {0.0f, 0.0f, 1.0f};

  // ---- The tick's scalars and the velocity update (character.py:274-343).
  const float dt = scal[0];
  const float move[3] = {scal[1], scal[2], scal[3]};
  const bool jump = scal[4] > 0.0f, fly = scal[5] > 0.0f, sitting = scal[6] > 0.0f;
  const int exclude = __float_as_int(scal[7]);
  const float cyl_h = sitting ? 0.3f : 1.3f;
  const bool allow_sliding = sbt::dot3(move, move) > 0.0f;
  const bool grav_en = *ch_grav || allow_sliding || jump || fly;
  float vel[3] = {ch_vel[0], ch_vel[1], ch_vel[2]};
  float foot[3] = {ch_pos[0], ch_pos[1], ch_pos[2]};
  const float frac_sub = fminf(fmaxf((*water_z - foot[2]) / kEye, 0.0f), 1.0f);
  float foot_next[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) foot_next[k] = foot[k] + (vel[k] + move[k]) * dt;

  // ---- The candidate rows, gathered once (character.py:108-144).
  {
    const float half_h = 0.5f * cyl_h;
    const float up_r[3] = {0.0f, 0.0f, kR};
    int cells[3][3];
    for (int ci = 0; ci < n_centers; ++ci) {
      float fb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        fb[k] = ci == 0 ? foot[k] : (ci == 1 ? foot_next[k] : foot_next[k] - (k == 2 ? 0.5f : 0.0f));
#pragma unroll
      for (int k = 0; k < 3; ++k)
        cells[ci][k] = static_cast<int>(floorf(((fb[k] + up_r[k]) + ez[k] * half_h) * rcp_cell));
    }
    const int per_center = 27 * cap;
    for (int j = threadIdx.x; j < Kc; j += blockDim.x) {
      int cand;
      if (j < n_centers * per_center) {
        const int ci = j / per_center, rem = j % per_center;
        const int o = rem / cap, slot = rem % cap;
        const int cx = cells[ci][0] + o / 9 - 1, cy = cells[ci][1] + (o / 3) % 3 - 1,
                  cz = cells[ci][2] + o % 3 - 1;
        const unsigned hb = ((static_cast<unsigned>(cx) * 73856093u) ^
                             (static_cast<unsigned>(cy) * 19349663u) ^
                             (static_cast<unsigned>(cz) * 83492791u)) %
                            static_cast<unsigned>(num_buckets);
        cand = table[static_cast<int>(hb) * cap + slot];
      } else {
        cand = os_idx[j - n_centers * per_center];
      }
      const int b = max(cand, 0);
      const int lay = layer[b];
      c.c_idx[j] = cand;
      c.c_ok[j] = cand >= 0 && cand != exclude && alive[b] && (lay == 0 || lay == 1) && !sensor[b];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c.c_pos[3 * j + k] = pos[3 * b + k];
        c.c_lv[3 * j + k] = linvel[3 * b + k];
        c.c_av[3 * j + k] = angvel[3 * b + k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c.c_quat[4 * j + k] = quat[4 * b + k];
        c.c_prm[4 * j + k] = params[4 * b + k];
      }
      c.c_type[j] = shape_type[b];
      c.c_bound[j] = bound_radius[b];
    }
    __syncthreads();
  }

  // Ground probe at the current position.
  probe(c, foot, cyl_h);
  const Support s0 = support_info(c, foot);
  const bool supported = s0.supported;
  const float flat3[3] = {1.0f, 1.0f, 0.0f};
  float parallel[3], gvn[3], air_par[3], vw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) parallel[k] = frac_sub < 0.3f ? move[k] * flat3[k] : move[k];
  const bool on_ground_now = supported && (vel[2] - s0.gv[2]) < 0.1f;
  const float pl = norm3(parallel);
  const float scale = 8.0f / fmaxf(pl, 1e-9f);
  const float grav = grav_en ? (-9.81f + kGravWater * frac_sub) * dt : 0.0f;
  const float damp = grav_en ? 1.0f - fminf(2.0f * frac_sub * dt, 0.2f) : 1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gvn[k] = parallel[k] + s0.gv[k];
    air_par[k] = pl > 8.0f ? parallel[k] * scale : parallel[k];
    const float air = vel[k] + air_par[k] * dt;
    vw[k] = on_ground_now ? gvn[k] : air;
    vw[k] = vw[k] + ez[k] * grav;
    vw[k] = vw[k] * damp;
  }
  vw[2] = fmaxf(vw[2], -100.0f);
  const float speed = norm3(vel), mlen = norm3(move);
  float vnew[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dfly = mlen < 1e-4f ? 0.0f : move[k] / fmaxf(mlen, 1e-9f) * speed;
    const float vfly = vel[k] + (move[k] * 3.0f + (dfly - vel[k]) * 2.0f) * dt;
    vnew[k] = fly ? vfly : vw[k];
  }
  const bool do_jump = jump && supported;
  const float mdn = fminf(sbt::dot3(move, s0.gn), 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float up = ez[k] * 4.5f;
    const float jvw = move[k] - s0.gn[k] * mdn + s0.gv[k] + up;
    const float jvf = vnew[k] + up;
    vel[k] = do_jump ? (fly ? jvf : jvw) : vnew[k];
  }
  const bool static_ground = supported && sbt::dot3(s0.gv, s0.gv) < 1e-8f;
  const bool anti_slide = !allow_sliding && static_ground && !s0.steep && !do_jump && !fly;
  if (anti_slide) {
    const float up_only = vel[2] > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) vel[k] = vel[k] * ez[k] * up_only;
  }

  // ---- Collide and slide (character.py:346-382).
  const bool was_supported = supported;
  const float old_foot[3] = {foot[0], foot[1], foot[2]};
  const float dv_pre[3] = {vel[0], vel[1], vel[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) foot[k] = foot[k] + vel[k] * dt;
  for (int it = 0; it < 3; ++it) {
    probe(c, foot, cyl_h);
    for (int r = threadIdx.x; r < K; r += blockDim.x) c.p_val[r] = c.p_ok[r] ? c.p_pen[r] : -1e9f;
    __syncthreads();
    float deep;
    int di;
    block_argmax(c, c.p_val, deep, di);
    const bool push = deep > 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) foot[k] = foot[k] + (push ? c.p_n[3 * di + k] * deep : 0.0f);
    __syncthreads();
    for (int pass = 0; pass < 4; ++pass) {
      for (int r = threadIdx.x; r < K; r += blockDim.x) {
        const float* n = c.p_n + 3 * r;
        const float vn = sbt::dot3(n, vel) - sbt::dot3(n, c.p_vel + 3 * r);
        c.p_val[r] = (c.p_ok[r] && c.p_pen[r] > -0.01f) ? -vn : -1e9f;
      }
      __syncthreads();
      float viol;
      int k;
      block_argmax(c, c.p_val, viol, k);
      if (viol > 0.0f) {
        const float* n = c.p_n + 3 * k;
        const float vnk = sbt::dot3(n, vel) - sbt::dot3(n, c.p_vel + 3 * k);
#pragma unroll
        for (int q = 0; q < 3; ++q) vel[q] = vel[q] - n[q] * vnk;
      }
      __syncthreads();
    }
  }

  // ---- Stair walk (character.py:384-446).
  float desired_h[3], achieved_h[3], fwd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    desired_h[k] = (dv_pre[k] * dt) * flat3[k];
    achieved_h[k] = (foot[k] - old_foot[k]) * flat3[k];
  }
  const float desired_len = norm3(desired_h);
#pragma unroll
  for (int k = 0; k < 3; ++k) fwd[k] = desired_h[k] / fmaxf(desired_len, 1e-9f);
  const float achieved_len = fmaxf(sbt::dot3(achieved_h, fwd), 0.0f);
  const bool blocked = desired_len > 1e-5f && (achieved_len + 1e-4f < desired_len * 0.5f);
  const float step = fmaxf(desired_len - achieved_len, 0.02f);
  float up_foot[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) up_foot[k] = foot[k] + ez[k] * 0.4f + fwd[k] * step;
  const float pre_stair_z = foot[2];
  bool do_stairs = false;
  if (blocked && was_supported && !fly) {
    probe(c, up_foot, cyl_h);
    const bool clear_up = !any_ok_deeper(c, 0.01f);
    // The landing: the first of 9 depths with a contact (no later depth
    // changes the result).
    bool found = false, land_flat = false;
    float land_p[3] = {up_foot[0], up_foot[1], up_foot[2]}, land_deep = 0.0f;
    for (int i = 0; i < 9 && !found; ++i) {
      const float z = static_cast<float>(i + 1) * 0.05f;
      float p[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = up_foot[k] - z * ez[k];
      probe(c, p, cyl_h);
      const float deep = max_ok_pen(c);
      const Support s = support_info(c, p);
      if (deep > 0.0f && deep < 0.08f) {
        found = true;
        land_flat = s.supported && !s.steep;
        land_deep = deep;
#pragma unroll
        for (int k = 0; k < 3; ++k) land_p[k] = p[k];
      }
    }
    bool test_ok = false;
    if (clear_up && found && !land_flat) {
      // The forward test column, 0.15 ahead: its start must be clear and
      // some depth must be non-steep supported floor.
      float tp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) tp[k] = up_foot[k] + fwd[k] * 0.15f;
      probe(c, tp, cyl_h);
      const bool tclear = !any_ok_deeper(c, 0.01f);
      for (int i = 0; i < 9 && tclear && !test_ok; ++i) {
        const float z = static_cast<float>(i + 1) * 0.05f;
        float p[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] = (up_foot[k] - z * ez[k]) + fwd[k] * 0.15f;
        probe(c, p, cyl_h);
        const float deep = max_ok_pen(c);
        const Support s = support_info(c, p);
        test_ok = deep > 0.0f && deep < 0.08f && s.supported && !s.steep;
      }
    }
    do_stairs = clear_up && found && (land_flat || test_ok);
    if (do_stairs) {
#pragma unroll
      for (int k = 0; k < 3; ++k) foot[k] = land_p[k] + ez[k] * fmaxf(land_deep, 0.0f);
    }
  }

  // ---- Stick to floor (character.py:448-477).
  probe(c, foot, cyl_h);
  const Support s4 = support_info(c, foot);
  const bool moving_up = (foot[2] - old_foot[2]) / fmaxf(dt, 1e-9f) > 1e-6f;
  bool stuck = false;
  if (was_supported && !s4.supported && !moving_up && !fly && !do_jump) {
    const float zoffs[3] = {0.1f, 0.25f, 0.5f};
    for (int i = 0; i < 3 && !stuck; ++i) {
      float p[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = foot[k] - zoffs[i] * ez[k];
      probe(c, p, cyl_h);
      const Support s = support_info(c, p);
      const float deep = max_ok_pen(c);
      if (s.supported && !s.steep) {
        stuck = true;
#pragma unroll
        for (int k = 0; k < 3; ++k) foot[k] = p[k] + ez[k] * fmaxf(deep, 0.0f);
      }
    }
  }

  // ---- Final ground state, camera, outputs (character.py:479-523).
  probe(c, foot, cyl_h);
  const Support sf = support_info(c, foot);
  const bool on_ground = sf.supported && (vel[2] - sf.gv[2]) < 0.1f;
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    const int bid = r < kStatic ? -1 : c.c_idx[r - kStatic];
    packed[kHead + r] = (c.p_ok[r] && c.p_pen[r] > -0.01f && bid >= 0)
                            ? static_cast<float>(bid) : -1.0f;
  }
  if (threadIdx.x == 0) {
    const float dz = foot[2] - pre_stair_z;
    const float cz0 = *ch_cz;
    float cz = cz0 - 20.0f * dt * cz0;
    cz = fabsf(cz) < 1e-5f ? 0.0f : cz;
    cz = fminf(fmaxf(cz + ((do_stairs || stuck) ? dz : 0.0f), -0.3f), 0.3f);
    packed[0] = foot[0] - 0.0f * cz;
    packed[1] = foot[1] - 0.0f * cz;
    packed[2] = (foot[2] + kEye) - cz;
    packed[3] = 1.0f - 0.0f * cz;
    packed[4] = do_jump ? 1.0f : 0.0f;
    packed[5] = on_ground ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      packed[6 + k] = foot[k];
      packed[9 + k] = vel[k];
      packed[12 + k] = sf.gv[k];
      o_pos[k] = foot[k];
      o_vel[k] = vel[k];
      o_gn[k] = sf.gn[k];
      o_gv[k] = sf.gv[k];
    }
    *o_on_ground = on_ground;
    *o_cz = cz;
    *o_grav = grav_en;
    *o_fly = fly;
    *o_sit = sitting;
  }
}

}  // namespace

extern "C" int character_update(
    const float* ch_pos, const float* ch_vel, const bool* ch_on_ground, const float* ch_gn,
    const float* ch_gv, const float* ch_cz, const bool* ch_grav, const bool* ch_fly,
    const bool* ch_sit, const float* pos, const float* quat, const float* linvel,
    const float* angvel, const int* shape_type, const float* params, const float* bound_radius,
    const bool* alive, const int* layer, const bool* sensor, const int* table,
    const int* os_idx, const float* heights, const float* hf_origin, const float* hf_cell_w,
    const bool* has_hf, const float* water_z, const float* scal, const float* tri_verts,
    const int* tris, const int* cell_tris, const float* tri_origin, const float* tri_cell_w,
    int num_buckets, int cap, int n_os, int n_centers, int hx, int hy, int flat, int gx, int gy,
    int tcap, float rcp_cell, float* o_pos,
    float* o_vel, bool* o_on_ground, float* o_gn, float* o_gv, float* o_cz, bool* o_grav,
    bool* o_fly, bool* o_sit, float* packed, void* stream) {
  if (n_centers < 2 || n_centers > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int Kc = n_centers * 27 * cap + n_os;
  const int K = kStatic + Kc;
  const size_t bytes = sizeof(float) * (18 * (size_t)Kc + 11 * (size_t)K + 32) +
                       sizeof(int) * (3 * (size_t)Kc + (size_t)K + 32);
  cudaError_t err = cudaFuncSetAttribute(character_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  character_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      ch_pos, ch_vel, ch_on_ground, ch_gn, ch_gv, ch_cz, ch_grav, ch_fly, ch_sit, pos, quat,
      linvel, angvel, shape_type, params, bound_radius, alive, layer, sensor, table, os_idx,
      heights, hf_origin, hf_cell_w, has_hf, water_z, scal, tri_verts, tris, cell_tris,
      tri_origin, tri_cell_w, num_buckets, cap, n_os, n_centers, hx, hy, flat, gx, gy, tcap,
      rcp_cell, o_pos, o_vel, o_on_ground, o_gn, o_gv, o_cz, o_grav, o_fly, o_sit, packed);
  return static_cast<int>(cudaGetLastError());
}
