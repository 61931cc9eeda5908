// KL: the character controller's whole update, in one block.
//
// Replaces substrata_tpu/physics/character.py:character_update (:264-500)
// with _gather_capsule_candidates (:108), _capsule_probe (:147),
// _support_info (:245) and the packed readback of _player_update_packed
// (:504-523); plain twin:
// substrata_tpu_torch/kernels/character.py:character_packed_plain.
//
// What bounds it on the card: latency.  The bytes (the candidate rows, ~25
// KB) and the operations (~1 M) are small; the update is a chain of
// dependent probes (the ground, three slides, the stair walk's up to 20,
// stick-to-floor's 3, the final), each a block-wide step whose time is its
// slowest row (a capsule-box closed form: a 14-step ternary search).  The
// design shortens the chain and the steps:
// - One block of 512 threads, one launch per tick.  The block gathers the
//   candidate rows (the 27-cell neighbourhoods of two or three capsule
//   centres in the cell table, then the oversize slots: 550 rows at the
//   bench) and their bodies' fields into shared memory once.
// - A round probes up to 10 feet at once, in two passes: the threads stride
//   the (foot, row) pairs with the cheap tests (the heightfield rows, each
//   candidate's bounding sphere) and list the pairs that pass; then each
//   thread takes one listed pair and runs its own closed form from
//   closed_forms.cuh (~30 capsule-box searches a probe at the bench), so no
//   thread runs two while the others wait, and at 512 threads a search
//   keeps its state in registers.  A warp takes each (foot, sample) trimesh
//   row, its lanes the cell's triangles (trimesh.cuh:sphere_vs_tri, KB's
//   arithmetic), a shuffle reduction keeping the deepest, the lower slot on
//   ties.  The independent probes run in one round each: the stair walk's
//   up-foot and its 9 landing depths, then (where needed) the forward
//   column's start and its 9 depths, and stick-to-floor's 3 offsets; the
//   first depth that qualifies is then read in the reference's order.  A
//   walking tick takes 4 to 8 rounds where a probe at a time took up to 28.
// - Every argmax (the deepest contact, the support normal) is a 64-bit
//   shared-memory atomicMax on (the value, -0 ranked as +0; the complement
//   of the row), so ties go to the lower row as jnp.argmax does, folded into
//   the round: three barriers a round, none for the reductions.  The rows of
//   the probes the update reads again (the ground, the slides, the final)
//   stay in shared memory with the list of their touching rows; the four
//   velocity-cancel passes after each slide are computed by every thread
//   from that short list, with no barrier.  A probe at a foot already probed
//   (no push, no stair, no stick) reuses its rows.
// The scalar state (foot, velocity, flags) is computed identically by every
// thread, so the reference's two lax.conds are block-uniform branches: no
// host sync.
#include <cstring>

#include "trimesh.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxFeet = 10;   // probes a round
constexpr int kStatic = 6;
constexpr int kHead = 15;
constexpr float kR = 0.3f;
constexpr float kEye = 1.67f;
constexpr float kLower = static_cast<float>(0.3 * 1.05);
constexpr float kGravWater = static_cast<float>(9.81 * 1.1);
constexpr float kMaxSlopeCos = 0.6428f;
constexpr int kSphere = 0, kBox = 1, kCapsule = 2;
constexpr unsigned kFull = 0xffffffffu;

// An argmax key: the value's order-preserving bits above the complement of
// the row, so the larger value wins and, on ties, the lower row.
__device__ __forceinline__ unsigned long long argmax_key(float v, int row) {
  unsigned u = __float_as_uint(v + 0.0f);   // -0 ranks as +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(0x7fffffff - row);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_row(unsigned long long k) {
  return 0x7fffffff - static_cast<int>(static_cast<unsigned>(k & 0xffffffffull));
}

// Every row out of the reduction: the first row at -1e9 (the reference's
// argmax over -1e9-masked rows).
__device__ __forceinline__ unsigned long long empty_key() { return argmax_key(-1e9f, 0); }

struct Ctx {
  // candidate rows (Kc)
  float *c_pos, *c_quat, *c_prm, *c_lv, *c_av, *c_bound;
  int *c_type, *c_idx, *c_ok;
  // the stored probe's rows (K) and its touching rows (ok, pen > -0.01)
  float *p_n, *p_pen, *p_pt, *p_vel;
  int *p_ok, *touch_list;
  // a round's feet and, in two alternating buffers, its keys (per foot:
  // the deepest ok row, the touching row of largest normal z) and the
  // stored probe's touching count
  float* feet;
  unsigned long long* acc;
  int* touch_cnt;
  // a round's (foot, row) pairs that need a closed form
  int *work, *work_cnt;
  int K, Kc, round;
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

// The capsule's centre at `foot` and the static sample s (0 bottom, 1 middle,
// 2 top) of its segment (kernels/character.py:capsule_probe).
__device__ __forceinline__ void capsule_center(const float* foot, float cyl_h, float center[3]) {
  center[0] = foot[0] + 0.0f;
  center[1] = foot[1] + 0.0f;
  center[2] = foot[2] + (kR + 0.5f * cyl_h);
}

__device__ __forceinline__ void static_sample(const float center[3], float half_h, int si,
                                              float s[3]) {
  const float dz = si == 0 ? -half_h : (si == 2 ? half_h : 0.0f);
  s[0] = si == 1 ? center[0] : center[0] + 0.0f;
  s[1] = si == 1 ? center[1] : center[1] + 0.0f;
  s[2] = si == 1 ? center[2] : center[2] + dz;
}

// One row of one probe: kept (the stored probe), and folded into the foot's
// two keys and the touching list.
__device__ __forceinline__ void emit(const Ctx& c, unsigned long long* acc2, int* tcnt,
                                     float foot_z, int r, const float n[3], float pen,
                                     const float pt[3], const float vel[3], bool ok, bool store) {
  if (store) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      c.p_n[3 * r + q] = n[q];
      c.p_pt[3 * r + q] = pt[q];
      c.p_vel[3 * r + q] = vel[q];
    }
    c.p_pen[r] = pen;
    c.p_ok[r] = ok;
  }
  if (ok) {
    atomicMax(acc2, argmax_key(pen, r));
    const float lim = foot_z + kLower;
    if (pt[2] <= lim && pen > -0.02f) atomicMax(acc2 + 1, argmax_key(n[2], r));
    if (store && pen > -0.01f) c.touch_list[atomicAdd(tcnt, 1)] = r;
  }
}

// Whether candidate row j can touch the capsule at `center` (its
// bounding-sphere test: the closed form runs only where it passes).
__device__ __forceinline__ bool candidate_near(const Ctx& c, int j, const float center[3],
                                               float half_h) {
  const float d[3] = {c.c_pos[3 * j] - center[0], c.c_pos[3 * j + 1] - center[1],
                      c.c_pos[3 * j + 2] - center[2]};
  const float reach = c.c_bound[j] + half_h + kR + 0.6f;
  return c.c_ok[j] && sbt::dot3(d, d) <= reach * reach;
}

// Candidate row j against the capsule at `center`: the row's own closed
// form, its deepest valid manifold point.
__device__ void candidate_row(const Ctx& c, int j, const float center[3], float half_h,
                              float n[3], float& pen, float pt[3], float vel[3], bool& ok) {
  const float up_q[4] = {0.0f, 0.0f, 0.0f, 1.0f};
  const float pb[3] = {c.c_pos[3 * j], c.c_pos[3 * j + 1], c.c_pos[3 * j + 2]};
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
    const float he[3] = {st == kBox ? prm[0] : prm[1], st == kBox ? prm[1] : prm[2],
                         st == kBox ? prm[2] : prm[3]};
    sbt::capsule_box(center, up_q, kR, half_h, pb, qb, he, m);
  }
  // The deepest valid point, the first on ties (selected without indexing
  // the manifold by a variable, so that it stays in registers).
  float best = m.valid[0] ? m.pens[0] : -1e9f;
  pen = m.pens[0];
  ok = m.valid[0];
#pragma unroll
  for (int q = 0; q < 3; ++q) pt[q] = m.pts[0][q];
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const float v = m.valid[s] ? m.pens[s] : -1e9f;
    if (v > best) {
      best = v;
      pen = m.pens[s];
      ok = m.valid[s];
#pragma unroll
      for (int q = 0; q < 3; ++q) pt[q] = m.pts[s][q];
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) n[q] = m.n[q];
  const float av[3] = {c.c_av[3 * j], c.c_av[3 * j + 1], c.c_av[3 * j + 2]};
  const float rel[3] = {pt[0] - pb[0], pt[1] - pb[1], pt[2] - pb[2]};
  float w[3];
  sbt::cross_fma(av, rel, w);   // character.py:185's jnp.cross, contracted
#pragma unroll
  for (int q = 0; q < 3; ++q) vel[q] = c.c_lv[3 * j + q] + w[q];
}

// One round: the capsule probed at feet 0..M-1 (c.feet, written before the
// call by threads 0..M-1); with `store` (M == 1) the rows and the touching
// list are kept.  The threads first stride the (foot, row) pairs with the
// cheap tests (the heightfield rows, each candidate's bounding sphere) and
// list the pairs that need a closed form; after a barrier each thread takes
// one listed pair, so that no thread runs two capsule-box searches while
// others wait.  Afterwards `round_key` reads the round's keys.
__device__ void run_round(Ctx& c, int M, bool store, float cyl_h) {
  __syncthreads();   // the feet are written; the last round's readers are done
  const int b = c.round & 1;
  unsigned long long* acc = c.acc + b * 2 * kMaxFeet;
  int* tcnt = c.touch_cnt + b;
  const float half_h = 0.5f * cyl_h;
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  const float nz[3] = {0.0f, 0.0f, 1.0f};
  const int K = c.K;
  const bool use_tm = c.tm.cap > 0;
  for (int it = threadIdx.x; it < M * K; it += blockDim.x) {
    const int m = it / K, r = it - m * K;
    const float* foot = c.feet + 3 * m;
    float center[3];
    capsule_center(foot, cyl_h, center);
    if (r < 3) {
      float s[3], h, n[3];
      static_sample(center, half_h, r, s);
      hf_sample_normal(c, s[0], s[1], h, n);
      const float pen = (h - (s[2] - kR)) * n[2];
      const float pt[3] = {s[0], s[1], h};
      emit(c, acc + 2 * m, tcnt, foot[2], r, n, pen, pt, zero3, c.has_hf && pen > -0.05f, store);
    } else if (r < kStatic) {
      if (!use_tm)   // else a warp takes each trimesh row below
        emit(c, acc + 2 * m, tcnt, foot[2], r, nz, -1e9f, zero3, zero3, false, store);
    } else if (candidate_near(c, r - kStatic, center, half_h)) {
      c.work[atomicAdd(c.work_cnt, 1)] = it;
    } else {
      emit(c, acc + 2 * m, tcnt, foot[2], r, nz, -1e9f, zero3, zero3, false, store);
    }
  }
  if (use_tm) {
    // The trimesh rows (kernels/character.py:_trimesh_rows): a warp per
    // (foot, sample), its lanes over the cell's triangles.
    const int lane = threadIdx.x & 31;
    for (int task = threadIdx.x >> 5; task < M * 3; task += blockDim.x >> 5) {
      const int m = task / 3, si = task - m * 3;
      const float* foot = c.feet + 3 * m;
      float center[3], s[3];
      capsule_center(foot, cyl_h, center);
      static_sample(center, half_h, si, s);
      const int base = sbt::tri_cell(c.tm, s[0], s[1]);
      bool any = false;
      float bp = -1e9f, bpt[3] = {0.0f, 0.0f, 0.0f}, bn[3] = {0.0f, 0.0f, 1.0f};
      int bslot = 0x7fffffff;
      for (int slot = lane; slot < c.tm.cap; slot += 32) {
        const int t = c.tm.cell_tris[base + slot];
        if (t < 0) continue;   // a suffix of empty slots: masked, as the twin does
        float pt[3], n[3];
        const float pen = sbt::sphere_vs_tri(c.tm, s, kR, t, pt, n);
        if (!any || pen > bp) {
          any = true;
          bp = pen;
          bslot = slot;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            bpt[q] = pt[q];
            bn[q] = n[q];
          }
        }
      }
      int blane = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const bool oany = __shfl_xor_sync(kFull, static_cast<int>(any), off) != 0;
        const float op = __shfl_xor_sync(kFull, bp, off);
        const int os = __shfl_xor_sync(kFull, bslot, off);
        const int ol = __shfl_xor_sync(kFull, blane, off);
        if (oany && (!any || op > bp || (op == bp && os < bslot))) {
          any = true;
          bp = op;
          bslot = os;
          blane = ol;
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        bpt[q] = __shfl_sync(kFull, bpt[q], blane);
        bn[q] = __shfl_sync(kFull, bn[q], blane);
      }
      if (lane == 0) {
        if (!any) {   // no triangle: an invalid row
          bp = -1e9f;
          bpt[0] = bpt[1] = bpt[2] = 0.0f;
          bn[0] = bn[1] = 0.0f;
          bn[2] = 1.0f;
        }
        emit(c, acc + 2 * m, tcnt, foot[2], kStatic - 3 + si, bn, bp, bpt, zero3, bp > -0.05f,
             store);
      }
    }
  }
  __syncthreads();   // the work list is complete
  const int n_work = *c.work_cnt;
  for (int w = threadIdx.x; w < n_work; w += blockDim.x) {
    const int it = c.work[w];
    const int m = it / K, r = it - m * K;
    const float* foot = c.feet + 3 * m;
    float center[3], n[3], pen, pt[3], vel[3];
    bool ok;
    capsule_center(foot, cyl_h, center);
    candidate_row(c, r - kStatic, center, half_h, n, pen, pt, vel, ok);
    emit(c, acc + 2 * m, tcnt, foot[2], r, n, pen, pt, vel, ok, store);
  }
  __syncthreads();   // every row is in
  // Clear the other buffer and the work list for the next round.
  if (threadIdx.x < 2 * kMaxFeet) c.acc[(b ^ 1) * 2 * kMaxFeet + threadIdx.x] = empty_key();
  if (threadIdx.x == 2 * kMaxFeet) {
    c.touch_cnt[b ^ 1] = 0;
    *c.work_cnt = 0;
  }
  ++c.round;
}

// Key `which` (0: the deepest ok row, 1: the touching row of largest normal
// z) of foot m in the last round.
__device__ __forceinline__ unsigned long long round_key(const Ctx& c, int m, int which) {
  return c.acc[((c.round - 1) & 1) * 2 * kMaxFeet + 2 * m + which];
}

struct Support {
  bool supported, steep;
  float gn[3], gv[3];
};

// The stored probe, as the update reads it again: its keys, touching count
// and foot.
struct Stored {
  unsigned long long deep_key, support_key;
  int n_touch;
  float foot[3];
};

// A single-foot round whose rows stay (the ground, a slide, the final).
__device__ Stored probe_stored(Ctx& c, const float foot[3], float cyl_h) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c.feet[k] = foot[k];
  }
  run_round(c, 1, true, cyl_h);
  Stored s;
  s.deep_key = round_key(c, 0, 0);
  s.support_key = round_key(c, 0, 1);
  s.n_touch = c.touch_cnt[(c.round - 1) & 1];
#pragma unroll
  for (int k = 0; k < 3; ++k) s.foot[k] = foot[k];
  return s;
}

__device__ __forceinline__ bool same_foot(const float a[3], const float b[3]) {
  return __float_as_int(a[0]) == __float_as_int(b[0]) &&
         __float_as_int(a[1]) == __float_as_int(b[1]) &&
         __float_as_int(a[2]) == __float_as_int(b[2]);
}

// kernels/character.py:support_info on the stored probe.
__device__ Support support_of(const Ctx& c, const Stored& st) {
  Support s;
  s.supported = st.support_key != empty_key();
  const int gi = key_row(st.support_key);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.gn[k] = s.supported ? c.p_n[3 * gi + k] : (k == 2 ? 1.0f : 0.0f);
    s.gv[k] = s.supported ? c.p_vel[3 * gi + k] : 0.0f;
  }
  s.steep = s.gn[2] < kMaxSlopeCos;
  return s;
}

// The deepest ok row's depth of foot m in the last round (-1e9: none).
__device__ __forceinline__ float round_deep(const Ctx& c, int m) {
  return key_value(round_key(c, m, 0));
}

// Supported, and not on a steep slope, at foot m in the last round.
__device__ __forceinline__ bool round_flat_support(const Ctx& c, int m) {
  const unsigned long long k = round_key(c, m, 1);
  return k != empty_key() && !(key_value(k) < kMaxSlopeCos);
}

__device__ __forceinline__ float norm3(const float v[3]) { return sqrtf(sbt::dot3(v, v)); }

// The slide's four cancel passes over the stored probe's `nt` touching rows
// (ok, pen > -0.01; character.py:370-381): each pass removes the velocity
// into the row of largest violation (the lower row on ties) when positive.
// Every warp computes them whole, its lanes holding the rows and a shuffle
// reduction taking each argmax, so no barrier is needed; a row's
// n . (contact velocity) is the same every pass and is taken once.
__device__ void cancel_passes(const Ctx& c, int nt, float vel[3]) {
  const int lane = threadIdx.x & 31;
  const bool held = lane < nt;
  const int r0 = held ? c.touch_list[lane] : 0x7fffffff;
  float n0[3] = {0.0f, 0.0f, 0.0f}, c0 = 0.0f;
  if (held) {
#pragma unroll
    for (int q = 0; q < 3; ++q) n0[q] = c.p_n[3 * r0 + q];
    c0 = sbt::dot3(n0, c.p_vel + 3 * r0);
  }
  for (int pass = 0; pass < 4; ++pass) {
    float viol = -1e9f;
    int kb = 0x7fffffff;
    if (held) {
      const float v = -(sbt::dot3(n0, vel) - c0);
      if (v > viol || (v == viol && r0 < kb)) {
        viol = v;
        kb = r0;
      }
    }
    for (int q = 32 + lane; q < nt; q += 32) {   // past 32 touching rows
      const int r = c.touch_list[q];
      const float* n = c.p_n + 3 * r;
      const float v = -(sbt::dot3(n, vel) - sbt::dot3(n, c.p_vel + 3 * r));
      if (v > viol || (v == viol && r < kb)) {
        viol = v;
        kb = r;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, viol, off);
      const int ok = __shfl_xor_sync(kFull, kb, off);
      if (ov > viol || (ov == viol && ok < kb)) {
        viol = ov;
        kb = ok;
      }
    }
    if (viol > 0.0f) {
      // The row's normal and n . (contact velocity): from the lane that
      // holds it, else (a row past 32) from shared memory.
      const int src = kb < 0x7fffffff ? __ffs(__ballot_sync(kFull, held && r0 == kb)) - 1 : -1;
      float n[3], ck;
#pragma unroll
      for (int q = 0; q < 3; ++q) n[q] = __shfl_sync(kFull, n0[q], max(src, 0));
      ck = __shfl_sync(kFull, c0, max(src, 0));
      if (src < 0) {
#pragma unroll
        for (int q = 0; q < 3; ++q) n[q] = c.p_n[3 * kb + q];
        ck = sbt::dot3(n, c.p_vel + 3 * kb);
      }
      const float vnk = sbt::dot3(n, vel) - ck;
#pragma unroll
      for (int q = 0; q < 3; ++q) vel[q] = vel[q] - n[q] * vnk;
    }
  }
}



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
  extern __shared__ unsigned long long smem[];
  const int Kc = n_centers * 27 * cap + n_os;
  const int K = kStatic + Kc;
  Ctx c;
  c.acc = smem;
  float* f = reinterpret_cast<float*>(smem + 2 * 2 * kMaxFeet);
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
  c.feet = f;
  f += 3 * kMaxFeet;
  int* ip = reinterpret_cast<int*>(f);
  c.c_type = ip;
  ip += Kc;
  c.c_idx = ip;
  ip += Kc;
  c.c_ok = ip;
  ip += Kc;
  c.p_ok = ip;
  ip += K;
  c.touch_list = ip;
  ip += K;
  c.touch_cnt = ip;
  ip += 2;
  c.work_cnt = ip;
  ip += 1;
  c.work = ip;
  c.K = K;
  c.Kc = Kc;
  c.round = 0;
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
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2 * 2 * kMaxFeet; ++q) c.acc[q] = empty_key();
    c.touch_cnt[0] = c.touch_cnt[1] = 0;
    *c.work_cnt = 0;
  }

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
  float foot_next[3];  // one fma, as the jitted reference contracts it
#pragma unroll
  for (int k = 0; k < 3; ++k) foot_next[k] = __fmaf_rn(vel[k] + move[k], dt, foot[k]);

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
    // Two rows a pass, both table entries and then both rows' body fields
    // loaded before any is stored.
    for (int j0 = threadIdx.x; j0 < Kc; j0 += 2 * blockDim.x) {
      int cand[2], b[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * blockDim.x;
        cand[u] = -1;
        if (j < n_centers * per_center) {
          const int ci = j / per_center, rem = j % per_center;
          const int o = rem / cap, slot = rem % cap;
          cand[u] = table[sbt::cell_hash(cells[ci][0] + o / 9 - 1, cells[ci][1] + (o / 3) % 3 - 1,
                                         cells[ci][2] + o % 3 - 1, num_buckets) * cap + slot];
        } else if (j < Kc) {
          cand[u] = os_idx[j - n_centers * per_center];
        }
        b[u] = max(cand[u], 0);
      }
      float fp[2][17];
      int ft[2], fl[2];
      bool fa[2], fs[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int bu = b[u];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          fp[u][k] = pos[3 * bu + k];
          fp[u][3 + k] = linvel[3 * bu + k];
          fp[u][6 + k] = angvel[3 * bu + k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          fp[u][9 + k] = quat[4 * bu + k];
          fp[u][13 + k] = params[4 * bu + k];
        }
        ft[u] = shape_type[bu];
        fl[u] = layer[bu];
        fa[u] = alive[bu];
        fs[u] = sensor[bu];
      }
      float fb[2] = {bound_radius[b[0]], bound_radius[b[1]]};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * blockDim.x;
        if (j >= Kc) continue;
        const int cu = cand[u];
        c.c_idx[j] = cu;
        c.c_ok[j] = cu >= 0 && cu != exclude && fa[u] && (fl[u] == 0 || fl[u] == 1) && !fs[u];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          c.c_pos[3 * j + k] = fp[u][k];
          c.c_lv[3 * j + k] = fp[u][3 + k];
          c.c_av[3 * j + k] = fp[u][6 + k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          c.c_quat[4 * j + k] = fp[u][9 + k];
          c.c_prm[4 * j + k] = fp[u][13 + k];
        }
        c.c_type[j] = ft[u];
        c.c_bound[j] = fb[u];
      }
    }
  }

  // Ground probe at the current position (the round's first barrier
  // publishes the gathered rows).
  Stored cur = probe_stored(c, foot, cyl_h);
  const Support s0 = support_of(c, cur);
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

  // ---- Collide and slide (character.py:346-382): three probes, each
  // followed by the push out of the deepest contact and four cancel passes
  // over its touching rows (every thread, from the short list).
  const bool was_supported = supported;
  const float old_foot[3] = {foot[0], foot[1], foot[2]};
  const float dv_pre[3] = {vel[0], vel[1], vel[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) foot[k] = __fmaf_rn(vel[k], dt, foot[k]);
  for (int it = 0; it < 3; ++it) {
    cur = probe_stored(c, foot, cyl_h);
    const bool any_ok = cur.deep_key != empty_key();
    const int di = key_row(cur.deep_key);
    const float deep = any_ok ? c.p_pen[di] : -1e9f;
    const bool push = deep > 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) foot[k] = foot[k] + (push ? c.p_n[3 * di + k] * deep : 0.0f);
    cancel_passes(c, cur.n_touch, vel);
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
    // One round: the up-foot (foot 0) and the 9 landing depths (feet 1-9).
    if (threadIdx.x < 10) {
      const int i = threadIdx.x;
      const float z = static_cast<float>(i) * 0.05f;
#pragma unroll
      for (int k = 0; k < 3; ++k) c.feet[3 * i + k] = i == 0 ? up_foot[k] : up_foot[k] - z * ez[k];
    }
    run_round(c, 10, false, cyl_h);
    const bool clear_up = !(round_deep(c, 0) > 0.01f);
    // The landing: the first depth with a contact (no later depth changes
    // the result).
    bool found = false, land_flat = false;
    float land_p[3] = {up_foot[0], up_foot[1], up_foot[2]}, land_deep = 0.0f;
    for (int i = 0; i < 9 && !found; ++i) {
      const float deep = round_deep(c, 1 + i);
      if (deep > 0.0f && deep < 0.08f) {
        found = true;
        land_flat = round_flat_support(c, 1 + i);
        land_deep = deep;
        const float z = static_cast<float>(i + 1) * 0.05f;
#pragma unroll
        for (int k = 0; k < 3; ++k) land_p[k] = up_foot[k] - z * ez[k];
      }
    }
    bool test_ok = false;
    if (clear_up && found && !land_flat) {
      // The forward test column, 0.15 ahead, in one round: its start must
      // be clear and some depth must be non-steep supported floor.
      if (threadIdx.x < 10) {
        const int i = threadIdx.x;
        const float z = static_cast<float>(i) * 0.05f;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          c.feet[3 * i + k] = i == 0 ? up_foot[k] + fwd[k] * 0.15f
                                     : (up_foot[k] - z * ez[k]) + fwd[k] * 0.15f;
      }
      run_round(c, 10, false, cyl_h);
      const bool tclear = !(round_deep(c, 0) > 0.01f);
      for (int i = 0; i < 9 && tclear && !test_ok; ++i) {
        const float deep = round_deep(c, 1 + i);
        test_ok = deep > 0.0f && deep < 0.08f && round_flat_support(c, 1 + i);
      }
    }
    do_stairs = clear_up && found && (land_flat || test_ok);
    if (do_stairs) {
#pragma unroll
      for (int k = 0; k < 3; ++k) foot[k] = land_p[k] + ez[k] * fmaxf(land_deep, 0.0f);
    }
  }

  // ---- Stick to floor (character.py:448-477).
  if (!same_foot(foot, cur.foot)) cur = probe_stored(c, foot, cyl_h);
  const Support s4 = support_of(c, cur);
  const bool moving_up = (foot[2] - old_foot[2]) / fmaxf(dt, 1e-9f) > 1e-6f;
  bool stuck = false;
  if (was_supported && !s4.supported && !moving_up && !fly && !do_jump) {
    // One round: the 3 offsets.
    const float zoffs[3] = {0.1f, 0.25f, 0.5f};
    if (threadIdx.x < 3) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c.feet[3 * threadIdx.x + k] = foot[k] - zoffs[threadIdx.x] * ez[k];
    }
    run_round(c, 3, false, cyl_h);
    for (int i = 0; i < 3 && !stuck; ++i) {
      if (round_flat_support(c, i)) {
        stuck = true;
        const float deep = round_deep(c, i);
#pragma unroll
        for (int k = 0; k < 3; ++k) foot[k] = (foot[k] - zoffs[i] * ez[k]) + ez[k] * fmaxf(deep, 0.0f);
      }
    }
  }

  // ---- Final ground state, camera, outputs (character.py:479-523).
  if (!same_foot(foot, cur.foot)) cur = probe_stored(c, foot, cyl_h);
  const Support sf = support_of(c, cur);
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

constexpr int kMaxDevices = 64;
int g_smem_set[kMaxDevices];   // per device: the dynamic shared memory allowed so far

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/character.py:_launch): 32 input pointers (0 for an absent
// trimesh), 10 sizes, 1 / cell_size as a double, 10 output pointers.
extern "C" int character_update(const long long* a, void* stream) {
  auto f = [a](int i) { return reinterpret_cast<const float*>(a[i]); };
  auto n = [a](int i) { return reinterpret_cast<const int*>(a[i]); };
  auto b = [a](int i) { return reinterpret_cast<const bool*>(a[i]); };
  auto v = [a](int i) { return static_cast<int>(a[i]); };
  auto of = [a](int i) { return reinterpret_cast<float*>(a[i]); };
  auto ob = [a](int i) { return reinterpret_cast<bool*>(a[i]); };
  double rcp;
  memcpy(&rcp, a + 42, sizeof(double));
  const int cap = v(33), n_os = v(34), n_centers = v(35);
  if (n_centers < 2 || n_centers > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int Kc = n_centers * 27 * cap + n_os;
  const int K = kStatic + Kc;
  const size_t bytes = sizeof(unsigned long long) * 2 * 2 * kMaxFeet +
                       sizeof(float) * (18 * (size_t)Kc + 10 * (size_t)K + 3 * kMaxFeet) +
                       sizeof(int) * (3 * (size_t)Kc + 2 * (size_t)K + 3 + kMaxFeet * (size_t)Kc);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int>(bytes) > g_smem_set[dev]) {   // once per larger size, not per launch
    err = cudaFuncSetAttribute(character_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev] = static_cast<int>(bytes);
  }
  character_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      f(0), f(1), b(2), f(3), f(4), f(5), b(6), b(7), b(8), f(9), f(10), f(11), f(12), n(13),
      f(14), f(15), b(16), n(17), b(18), n(19), n(20), f(21), f(22), f(23), b(24), f(25), f(26),
      f(27), n(28), n(29), f(30), f(31), v(32), cap, n_os, n_centers, v(36), v(37), v(38), v(39),
      v(40), v(41), static_cast<float>(rcp), of(43), of(44), ob(45), of(46), of(47), of(48),
      ob(49), ob(50), ob(51), of(52));
  return static_cast<int>(cudaGetLastError());
}
