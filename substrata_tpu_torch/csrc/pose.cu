// Kernel KZ: every avatar's skeletal pose in one launch (K15).
//
// Replaces substrata_tpu/anim/pose.py:PoseKernel._pose (:182-241, jitted at
// :160); plain twin: substrata_tpu_torch/kernels/pose.py:pose_plain.
//
// One block per avatar, 16 lanes a joint.  The avatar's parameters (clips,
// frames, blend, grabs, root, the slots' overrides and post rotations) and
// the bank's frame counts and loop flags are staged in shared memory once,
// while the joint's rig rows and inverse-bind column, which do not depend on
// the avatar, are in flight.  The sampling is one thread a joint but for
// the clips: lanes 0 and 1 each load their clip's two bank rows at once and
// sample it (wrap for a looping clip, clamp otherwise; nlerp between the
// frames), and lane 0 takes clip B's sample by a shuffle, cross-fades A ->
// B, applies its slot's override or its finger's grab curl, builds its
// local TRS matrix and post-multiplies its slot's procedural rotation, into
// shared memory.  The matrix products run on the joint's 16 lanes, lane e
// computing element (e / 4, e % 4): forward kinematics
// walks the levels, at level l the joints of depth l taking world =
// world[parent] @ local, a dot4 a lane, then one __syncthreads (where J x 16
// exceeds the block's 1,024 threads, the joints go in groups within the
// level, before its barrier).  Last, the 16 lanes of a joint write its
// object-space matrix, root @ it and it @ its inverse bind, each a
// contiguous 64-byte row.  Every 4-term dot is ((a0 b0 + a1 b1) + a2 b2) +
// a3 b3 and nothing is contracted (-fmad=false), as the twin computes: the
// two are bit-equal.
//
// What bounds it: latency (the parameters' loads, then the bank rows', then
// the sampling's nlerps, then one dot4 and a barrier a level).  At 64 avatars x 64
// joints it reads the bank rows it samples (4 x 28 B a joint) and writes
// 3 x 64 x 64 x 64 B.
#include "common.cuh"

// One host buffer (kernels/pose.py:_PACK): the bank, the avatars'
// parameters, the rig, the output; then f_cap, n_half, A, J, S, n_levels
// and the bank's clip count.
struct PoseArgs {
  const float* rot;       // [rows, J * 4]
  const float* trans;     // [rows, J * 3]
  const float* n_frames;  // [C]
  const bool* looping;    // [C]
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
  const int* parent;
  const int* depth;
  const int* joint_slot;
  const int* joint_finger;
  const float* grab_quats;    // [2 * n_half, 4]
  const float* rest_scale;    // [J, 3]
  const float* inverse_bind;  // [J, 16]
  float* out;                 // [3, A, J, 16]
  long long f_cap, n_half, na, nj, ns, n_levels, n_clips;
};

namespace {

constexpr int kMaxJoints = 256;
constexpr int kMaxClips = 256;   // kernels/pose.py:MAX_CLIPS
constexpr int kMaxThreads = 1024;
constexpr int kSlots = 18;   // kernels/pose.py:NUM_SLOTS

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

// m = m @ b (row-major 4x4), a row at a time.
__device__ __forceinline__ void matmul4_inplace(float* m, const float* b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a0 = m[i * 4], a1 = m[i * 4 + 1], a2 = m[i * 4 + 2], a3 = m[i * 4 + 3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m[i * 4 + j] = ((a0 * b[j] + a1 * b[4 + j]) + a2 * b[8 + j]) + a3 * b[12 + j];
  }
}

// Element (r, c) of a @ b: row r of a (stride 1) times column c of b
// (stride 4), as matmul4 orders it.
__device__ __forceinline__ float elem4(const float* a_row, const float* b_col) {
  return ((a_row[0] * b_col[0] + a_row[1] * b_col[4]) + a_row[2] * b_col[8]) +
         a_row[3] * b_col[12];
}

// The avatar's parameters, staged once.
struct Avatar {
  float root[16];
  float over[kSlots * 4];
  float post[kSlots * 4];
  bool over_mask[kSlots];
  bool post_mask[kSlots];
  int clip[2];
  float frame[2];
  float blend, grab_l, grab_r;
  float nf[kMaxClips];   // the bank's frame counts and loop flags, all clips
  bool loop[kMaxClips];
};

// The bank rows of one clip at ``frame``, as the twin's _sample picks them:
// the two frames' rows and the fraction between them.
__device__ __forceinline__ void frame_rows(int clip, float frame, float nf, bool loop, int f_cap,
                                           int row[2], float& frac) {
  const float f0 = floorf(frame);
  frac = frame - f0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float f = k == 0 ? f0 : f0 + 1.0f;
    float c = f < 0.0f ? 0.0f : f;
    const float hi = nf - 1.0f;
    c = c > hi ? hi : c;
    const float wv = loop ? float_mod(f, nf) : c;
    row[k] = clip * f_cap + static_cast<int>(wv);
  }
}

// Joint jj's rig rows that its sampling lane reads: slot, finger, scale.
struct JointRig {
  int slot, finger;
  float scale[3];
};

__device__ __forceinline__ void load_rig(const PoseArgs& g, int jj, JointRig& jr) {
  jr.slot = g.joint_slot[jj];
  jr.finger = g.joint_finger[jj];
#pragma unroll
  for (int k = 0; k < 3; ++k) jr.scale[k] = g.rest_scale[jj * 3 + k];
}

__global__ void __launch_bounds__(kMaxThreads) pose_kernel(const PoseArgs g) {
  __shared__ Avatar av;
  __shared__ int s_depth[kMaxJoints], s_parent[kMaxJoints];
  extern __shared__ float smem[];
  const int nj = static_cast<int>(g.nj), ns = static_cast<int>(g.ns);
  float* local = smem;              // [J, 16]
  float* world = smem + nj * 16;    // [J, 16]
  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = nt >> 4;   // joints a pass: 16 lanes a joint
  const int e = tid & 15, r = e >> 2, c = e & 3;
  const int jj0 = tid >> 4;  // this lane's joint in the first pass

  // What does not depend on the avatar, in flight first: the levels, the
  // first pass's rig rows (its sampling lane) and inverse-bind column.
  if (tid < nj) {
    s_depth[tid] = g.depth[tid];
    s_parent[tid] = g.parent[tid];
  }
  JointRig rig0{-1, -1, {0.0f, 0.0f, 0.0f}};
  float ibc0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (jj0 < nj) {
    if (e == 0) load_rig(g, jj0, rig0);
#pragma unroll
    for (int m = 0; m < 4; ++m) ibc0[m] = g.inverse_bind[jj0 * 16 + m * 4 + c];
  }
  // The avatar's parameters and the bank's clip table (so a clip's frame
  // count is not a load behind the clip's), a word a thread.
  const int nc = static_cast<int>(g.n_clips);
  for (int i = tid; i < nc; i += nt) {
    av.nf[i] = g.n_frames[i];
    av.loop[i] = g.looping[i];
  }
  for (int i = tid; i < 16 + 10 * ns + 5; i += nt) {
    if (i < 16) {
      av.root[i] = g.root[a * 16 + i];
    } else if (i < 16 + 4 * ns) {
      av.over[i - 16] = g.override_rot[a * ns * 4 + i - 16];
    } else if (i < 16 + 8 * ns) {
      av.post[i - 16 - 4 * ns] = g.post_rot[a * ns * 4 + i - 16 - 4 * ns];
    } else if (i < 16 + 9 * ns) {
      av.over_mask[i - 16 - 8 * ns] = g.override_mask[a * ns + i - 16 - 8 * ns];
    } else if (i < 16 + 10 * ns) {
      av.post_mask[i - 16 - 9 * ns] = g.post_mask[a * ns + i - 16 - 9 * ns];
    } else {
      const int w = i - 16 - 10 * ns;
      if (w < 2) {
        av.clip[w] = w == 0 ? g.clip_a[a] : g.clip_b[a];
        av.frame[w] = w == 0 ? g.frame_a[a] : g.frame_b[a];
      } else if (w == 2) {
        av.blend = g.blend[a];
      } else if (w == 3) {
        av.grab_l = g.grab_l[a];
      } else if (w == 4) {
        av.grab_r = g.grab_r[a];
      }
    }
  }
  __syncthreads();

  // The sampling, a joint's lanes 0 and 1 its clips A and B, lane 0 the
  // rest of the joint's local matrix.
  const int f_cap = static_cast<int>(g.f_cap);
  const int side = e & 1;
  for (int j0 = 0; j0 < nj; j0 += per) {
    const int jj = j0 + jj0;
    const bool live = jj < nj;
    float q[4] = {0.0f, 0.0f, 0.0f, 1.0f}, t[3] = {0.0f, 0.0f, 0.0f};
    if (live && e < 2) {
      int rows[2];
      float frac;
      const int cl = av.clip[side];
      frame_rows(cl, av.frame[side], av.nf[cl], av.loop[cl], f_cap, rows, frac);
      // The two bank rows, issued together.
      float rot[2][4], tr[2][3];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* pr = g.rot + static_cast<size_t>(rows[k]) * nj * 4 + jj * 4;
        const float* pt = g.trans + static_cast<size_t>(rows[k]) * nj * 3 + jj * 3;
#pragma unroll
        for (int m = 0; m < 4; ++m) rot[k][m] = pr[m];
#pragma unroll
        for (int m = 0; m < 3; ++m) tr[k][m] = pt[m];
      }
      nlerp(rot[0], rot[1], frac, q);
#pragma unroll
      for (int m = 0; m < 3; ++m) t[m] = tr[0][m] + (tr[1][m] - tr[0][m]) * frac;
    }
    // Lane 0 takes lane 1's clip-B sample.
    float qb[4], tb[3];
#pragma unroll
    for (int m = 0; m < 4; ++m) qb[m] = __shfl_down_sync(0xffffffffu, q[m], 1);
#pragma unroll
    for (int m = 0; m < 3; ++m) tb[m] = __shfl_down_sync(0xffffffffu, t[m], 1);
    if (!live || e != 0) continue;
    JointRig jr = rig0;
    if (j0 > 0) load_rig(g, jj, jr);
    const float w = av.blend;
    float qj[4], tj[3];
    nlerp(q, qb, w, qj);
#pragma unroll
    for (int m = 0; m < 3; ++m) tj[m] = t[m] + (tb[m] - t[m]) * w;
    if (jr.slot >= 0 && av.over_mask[jr.slot]) {
#pragma unroll
      for (int m = 0; m < 4; ++m) qj[m] = av.over[jr.slot * 4 + m];
    }
    if (jr.finger >= 0) {
      const float gr = jr.finger < g.n_half ? av.grab_l : av.grab_r;
      if (gr > 1e-3f) {
        const float ident[4] = {0.0f, 0.0f, 0.0f, 1.0f};
        float gq[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) gq[m] = g.grab_quats[jr.finger * 4 + m];
        nlerp(ident, gq, gr, qj);
      }
    }
    float mat[16];
    quat_mat4(qj, jr.scale, mat);
    mat[3] = tj[0];
    mat[7] = tj[1];
    mat[11] = tj[2];
    if (jr.slot >= 0 && av.post_mask[jr.slot]) {
      float pm[16];
      quat_mat4(av.post + jr.slot * 4, nullptr, pm);
      matmul4_inplace(mat, pm);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) local[jj * 16 + k] = mat[k];
  }
  __syncthreads();

  // The products, 16 lanes a joint: lane e of joint jj computes element
  // (e / 4, e % 4).
  for (int l = 0; l < static_cast<int>(g.n_levels); ++l) {
    for (int j0 = 0; j0 < nj; j0 += per) {
      const int jj = j0 + jj0;
      if (jj < nj && s_depth[jj] == l) {
        const int par = s_parent[jj];
        world[jj * 16 + e] = par < 0 ? local[jj * 16 + e]
                                     : elem4(world + par * 16 + r * 4, local + jj * 16 + c);
      }
    }
    __syncthreads();
  }
  const size_t plane = static_cast<size_t>(g.na) * nj * 16;
  for (int j0 = 0; j0 < nj; j0 += per) {
    const int jj = j0 + jj0;
    if (jj >= nj) break;
    const size_t at = (static_cast<size_t>(a) * nj + jj) * 16 + e;
    const float* wj = world + jj * 16;
    float ibc[4] = {ibc0[0], ibc0[1], ibc0[2], ibc0[3]};
    if (j0 > 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) ibc[m] = g.inverse_bind[jj * 16 + m * 4 + c];
    }
    g.out[at] = wj[e];
    g.out[plane + at] = elem4(av.root + r * 4, wj + c);
    g.out[2 * plane + at] =
        ((wj[r * 4] * ibc[0] + wj[r * 4 + 1] * ibc[1]) + wj[r * 4 + 2] * ibc[2]) +
        wj[r * 4 + 3] * ibc[3];
  }
}

}  // namespace

extern "C" int pose_avatars(const PoseArgs* args, void* stream) {
  const PoseArgs g = *args;
  if (g.na == 0) return 0;
  if (g.nj < 1 || g.nj > kMaxJoints || g.ns < 0 || g.ns > kSlots || g.na > 0x7fffffffLL ||
      g.n_clips < 1 || g.n_clips > kMaxClips)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nj = static_cast<int>(g.nj);
  const int threads = min((nj * 16 + 31) / 32 * 32, kMaxThreads);
  const size_t shmem = static_cast<size_t>(nj) * 32 * sizeof(float);
  pose_kernel<<<static_cast<unsigned>(g.na), threads, shmem,
                static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
