// Kernel KZ: every avatar's skeletal pose in one launch (K15).
//
// Replaces substrata_tpu/anim/pose.py:PoseKernel._pose (:182-241, jitted at
// :160); plain twin: substrata_tpu_torch/kernels/pose.py:pose_plain.
//
// One block per avatar, one thread per joint.  A thread samples its joint
// in clip A and clip B (two frames each, wrap for a looping clip, clamp
// otherwise; nlerp between the frames), cross-fades A -> B, applies its
// slot's override or its finger's grab curl, builds its local TRS matrix
// and post-multiplies its slot's procedural rotation, into shared memory.
// Forward kinematics walks the levels: at level l the joints of depth l
// take world = world[parent] @ local, then one __syncthreads.  Last, each
// thread writes its joint's object-space matrix, root @ it and it @ its
// inverse bind.  Every 4-term dot is ((a0 b0 + a1 b1) + a2 b2) + a3 b3 and
// nothing is contracted (-fmad=false), as the twin computes: the two are
// bit-equal.
//
// What bounds it: latency.  At 64 avatars x 64 joints it reads the bank
// rows it samples (4 x 28 B a joint) and writes 3 x 64 x 64 x 64 B.
#include "common.cuh"

namespace {

constexpr int kMaxJoints = 256;

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  return ((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3];
}

// _nlerp: hemisphere fix, lerp, divide by max(|q|, 1e-12) (NaN kept).
__device__ __forceinline__ void nlerp(const float* qa, const float* qb_in, float w, float* out) {
  const float d = dot4(qa, qb_in);
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float qb = d < 0.0f ? -qb_in[k] : qb_in[k];
    q[k] = qa[k] + (qb - qa[k]) * w;
  }
  float n = sqrtf(dot4(q, q));
  n = n < 1e-12f ? 1e-12f : n;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = q[k] / n;
}

// jnp.mod for floats (maths/fp.py:float_mod).
__device__ __forceinline__ float float_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = r + y;
  return r;
}

// Row-major 4x4 rotation of q, columns times s (s may be null), zero
// translation.
__device__ __forceinline__ void quat_mat4(const float* q, const float* s, float* m) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  m[0] = 1.0f - 2.0f * (y * y + z * z);
  m[1] = 2.0f * (x * y - w * z);
  m[2] = 2.0f * (x * z + w * y);
  m[4] = 2.0f * (x * y + w * z);
  m[5] = 1.0f - 2.0f * (x * x + z * z);
  m[6] = 2.0f * (y * z - w * x);
  m[8] = 2.0f * (x * z - w * y);
  m[9] = 2.0f * (y * z + w * x);
  m[10] = 1.0f - 2.0f * (x * x + y * y);
  if (s != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) m[i * 4 + k] = m[i * 4 + k] * s[k];
  }
  m[3] = m[7] = m[11] = 0.0f;
  m[12] = m[13] = m[14] = 0.0f;
  m[15] = 1.0f;
}

// o = a @ b (row-major 4x4); o must not alias a or b.
__device__ __forceinline__ void matmul4(const float* a, const float* b, float* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[i * 4 + j] = ((a[i * 4] * b[j] + a[i * 4 + 1] * b[4 + j]) + a[i * 4 + 2] * b[8 + j]) +
                     a[i * 4 + 3] * b[12 + j];
}

struct Bank {
  const float* rot;       // [rows, J * 4]
  const float* trans;     // [rows, J * 3]
  const float* n_frames;  // [C]
  const bool* looping;    // [C]
  int f_cap;
};

struct Params {
  const int* clip_a;
  const int* clip_b;
  const float* frame_a;
  const float* frame_b;
  const float* blend;
  const float* grab_l;
  const float* grab_r;
  const float* root;          // [A, 16]
  const float* override_rot;  // [A, S, 4]
  const float* post_rot;      // [A, S, 4]
  const bool* override_mask;  // [A, S]
  const bool* post_mask;      // [A, S]
};

struct Rig {
  const int* parent;
  const int* depth;
  const int* joint_slot;
  const int* joint_finger;
  const float* grab_quats;  // [2 * n_half, 4]
  int n_half;
  const float* rest_scale;    // [J, 3]
  const float* inverse_bind;  // [J, 16]
};

// One clip sampled at one joint: rotation q[4], translation t[3].
__device__ __forceinline__ void sample(const Bank& bk, int clip, float frame, int j, int nj,
                                       float* q, float* t) {
  const float nf = bk.n_frames[clip];
  const bool loop = bk.looping[clip];
  const float f0 = floorf(frame);
  const float frac = frame - f0;
  int row[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float f = k == 0 ? f0 : f0 + 1.0f;
    float c = f < 0.0f ? 0.0f : f;
    const float hi = nf - 1.0f;
    c = c > hi ? hi : c;
    const float wv = loop ? float_mod(f, nf) : c;
    row[k] = clip * bk.f_cap + static_cast<int>(wv);
  }
  const float* r0 = bk.rot + static_cast<size_t>(row[0]) * nj * 4 + j * 4;
  const float* r1 = bk.rot + static_cast<size_t>(row[1]) * nj * 4 + j * 4;
  nlerp(r0, r1, frac, q);
  const float* t0 = bk.trans + static_cast<size_t>(row[0]) * nj * 3 + j * 3;
  const float* t1 = bk.trans + static_cast<size_t>(row[1]) * nj * 3 + j * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t0[k] + (t1[k] - t0[k]) * frac;
}

__global__ void pose_kernel(Bank bk, Params p, Rig rig, int nj, int ns, int n_levels,
                            float* __restrict__ out, int na) {
  extern __shared__ float smem[];
  float* local = smem;              // [J, 16]
  float* world = smem + nj * 16;    // [J, 16]
  const int a = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < nj;
  if (active) {
    float qa[4], ta[3], qb[4], tb[3], q[4], t[3];
    sample(bk, p.clip_a[a], p.frame_a[a], j, nj, qa, ta);
    sample(bk, p.clip_b[a], p.frame_b[a], j, nj, qb, tb);
    const float w = p.blend[a];
    nlerp(qa, qb, w, q);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = ta[k] + (tb[k] - ta[k]) * w;
    const int s = rig.joint_slot[j];
    if (s >= 0 && p.override_mask[a * ns + s]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = p.override_rot[(a * ns + s) * 4 + k];
    }
    const int fi = rig.joint_finger[j];
    if (fi >= 0) {
      const float g = fi < rig.n_half ? p.grab_l[a] : p.grab_r[a];
      if (g > 1e-3f) {
        const float ident[4] = {0.0f, 0.0f, 0.0f, 1.0f};
        nlerp(ident, rig.grab_quats + fi * 4, g, q);
      }
    }
    float m[16];
    quat_mat4(q, rig.rest_scale + j * 3, m);
    m[3] = t[0];
    m[7] = t[1];
    m[11] = t[2];
    if (s >= 0 && p.post_mask[a * ns + s]) {
      float pm[16], o[16];
      quat_mat4(p.post_rot + (a * ns + s) * 4, nullptr, pm);
      matmul4(m, pm, o);
#pragma unroll
      for (int k = 0; k < 16; ++k) m[k] = o[k];
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) local[j * 16 + k] = m[k];
  }
  __syncthreads();
  const int dj = active ? rig.depth[j] : -1;
  const int par = active ? rig.parent[j] : -1;
  for (int l = 0; l < n_levels; ++l) {
    if (dj == l) {
      if (par < 0) {
#pragma unroll
        for (int k = 0; k < 16; ++k) world[j * 16 + k] = local[j * 16 + k];
      } else {
        float o[16];
        matmul4(world + par * 16, local + j * 16, o);
#pragma unroll
        for (int k = 0; k < 16; ++k) world[j * 16 + k] = o[k];
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const size_t plane = static_cast<size_t>(na) * nj * 16;
  const size_t base = (static_cast<size_t>(a) * nj + j) * 16;
  float wj[16], o[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    wj[k] = world[j * 16 + k];
    out[base + k] = wj[k];
  }
  matmul4(p.root + a * 16, wj, o);
#pragma unroll
  for (int k = 0; k < 16; ++k) out[plane + base + k] = o[k];
  matmul4(wj, rig.inverse_bind + j * 16, o);
#pragma unroll
  for (int k = 0; k < 16; ++k) out[2 * plane + base + k] = o[k];
}

}  // namespace

extern "C" int pose_avatars(const float* rot, const float* trans, const float* n_frames,
                            const bool* looping, int f_cap, const int* clip_a,
                            const int* clip_b, const float* frame_a, const float* frame_b,
                            const float* blend, const float* grab_l, const float* grab_r,
                            const float* root, const float* override_rot, const float* post_rot,
                            const bool* override_mask, const bool* post_mask, const int* parent,
                            const int* depth, const int* joint_slot, const int* joint_finger,
                            const float* grab_quats, int n_half, const float* rest_scale,
                            const float* inverse_bind, int na, int nj, int ns, int n_levels,
                            float* out, void* stream) {
  if (na == 0) return 0;
  if (nj > kMaxJoints) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Bank bk{rot, trans, n_frames, looping, f_cap};
  Params p{clip_a,   clip_b,       frame_a,  frame_b,       blend,    grab_l,
           grab_r,   root,         override_rot, post_rot, override_mask, post_mask};
  Rig rig{parent, depth, joint_slot, joint_finger, grab_quats, n_half, rest_scale,
          inverse_bind};
  const int threads = (nj + 31) / 32 * 32;
  const size_t shmem = static_cast<size_t>(nj) * 32 * sizeof(float);
  pose_kernel<<<na, threads, shmem, s>>>(bk, p, rig, nj, ns, n_levels, out, na);
  return static_cast<int>(cudaGetLastError());
}
