// Kernels KW and KX: terrain height queries and chunk meshes (KW), and the
// vegetation scatter points (KX), K17.
//
// KW replaces substrata_tpu/physics/terrain.py:_eval_heights (:40),
// _eval_heights_normals (:45) and make_terrain_chunk (:54), through
// physics/state.py:Heightfield.sample (:188) / sample_with_normal (:208);
// KX replaces scatter_points_for_cells (:215-246).  Plain twins:
// substrata_tpu_torch/kernels/terrain.py.
//
// One thread per query point, per chunk vertex or triangle row, per
// (cell, point).  A sample reads its patch's four corners straight from
// the [HX, HY] heights: the reference's [HX, HY, 4] quad array (built by
// rolls, 16.8 MB a call at 1025^2, only to make one TPU gather) is not
// built.  The bilinear sum and the gradients contract as XLA contracts
// them (__fmaf_rn where the twin calls fp.fma); divisions by the cell
// width are true divisions.  KX runs threefry2x32 in registers: the cell's
// fold_in of its int32-wrapped hash, then four counter hashes a point
// under jax.random's partitionable layout (counter pair (0, i)).
//
// What bounds them: latency at these sizes (a clamp query is one point; a
// camera move builds a few dozen chunks of 289 vertices; a move's scatter
// is 9 x 64 points, the start's 81 x 64).  A heights call's time is its
// wrapper's host work more than its device time, so the heights launcher
// takes its arguments packed into one host buffer, the field's part fixed
// once per field (kernels/terrain.py:_FieldPlan).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The heightfield as the kernels take it: device pointers and the grid.
struct FieldArgs {
  const float* h;        // [HX, HY]
  const float* origin;   // [2]
  const float* cell_w;   // []
  int hx, hy;
};

struct Field {
  const float* h;
  int hy;
  float ox, oy, cw;
  float hx_max, hy_max;  // float32(HX - 1.001), float32(HY - 1.001)
};

__device__ __forceinline__ Field load_field(const FieldArgs& a) {
  Field f;
  f.h = a.h;
  f.hy = a.hy;
  f.ox = a.origin[0];
  f.oy = a.origin[1];
  f.cw = *a.cell_w;
  f.hx_max = __double2float_rn(static_cast<double>(a.hx) - 1.001);
  f.hy_max = __double2float_rn(static_cast<double>(a.hy) - 1.001);
  return f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// Height at (x, y); with n != nullptr also the unit normal.
__device__ __forceinline__ float sample(const Field& f, float x, float y, float* n) {
  const float u = clampf((x - f.ox) / f.cw, 0.0f, f.hx_max);
  const float v = clampf((y - f.oy) / f.cw, 0.0f, f.hy_max);
  const int i0 = static_cast<int>(floorf(u));
  const int j0 = static_cast<int>(floorf(v));
  const float fu = u - static_cast<float>(i0);
  const float fv = v - static_cast<float>(j0);
  const float* r0 = f.h + static_cast<size_t>(i0) * f.hy + j0;
  const float* r1 = r0 + f.hy;
  const float h00 = r0[0], h01 = r0[1], h10 = r1[0], h11 = r1[1];
  const float a = 1.0f - fu, b = 1.0f - fv;
  const float h = __fmaf_rn(h11 * fu, fv, __fmaf_rn(h01 * a, fv, __fmaf_rn(h00 * a, b,
                                                                         (h10 * fu) * b)));
  if (n != nullptr) {
    const float nx = -(__fmaf_rn(h11 - h01, fv, (h10 - h00) * b) / f.cw);
    const float ny = -(__fmaf_rn(h11 - h10, fu, (h01 - h00) * a) / f.cw);
    const float norm = sqrtf(__fmaf_rn(1.0f, 1.0f, __fmaf_rn(ny, ny, nx * nx)));
    n[0] = nx / norm;
    n[1] = ny / norm;
    n[2] = 1.0f / norm;
  }
  return h;
}

__global__ void heights_kernel(FieldArgs fa, const float* __restrict__ xy, int p, int with_n,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const Field f = load_field(fa);
  if (with_n) {
    float n[3];
    const float h = sample(f, xy[2 * i], xy[2 * i + 1], n);
    out[4 * i] = h;
    out[4 * i + 1] = n[0];
    out[4 * i + 2] = n[1];
    out[4 * i + 3] = n[2];
  } else {
    out[i] = sample(f, xy[2 * i], xy[2 * i + 1], nullptr);
  }
}

// Per leaf: (res+1)^2 vertices of 8 floats, then res^2 * 2 triangle rows
// of 3 int32.
__global__ void chunks_kernel(FieldArgs fa, const float* __restrict__ leaf_origin,
                              const float* __restrict__ leaf_width, int n_leaf, int res,
                              float inv_res, float* __restrict__ out) {
  const int n = res + 1;
  const int nv = n * n, nt = 2 * res * res;
  const int per_leaf = nv + nt;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_leaf) * per_leaf) return;
  const Field f = load_field(fa);
  const int leaf = static_cast<int>(t / per_leaf);
  const int k = static_cast<int>(t % per_leaf);
  float* base = out + static_cast<size_t>(leaf) * (nv * 8 + nt * 3);
  if (k < nv) {
    const int i = k / n, j = k % n;
    const float li = i == res ? 1.0f : static_cast<float>(i) * inv_res;
    const float lj = j == res ? 1.0f : static_cast<float>(j) * inv_res;
    const float w = leaf_width[leaf];
    const float lox = leaf_origin[2 * leaf], loy = leaf_origin[2 * leaf + 1];
    const float x = __fmaf_rn(li, w, lox);
    const float y = __fmaf_rn(lj, w, loy);
    float nrm[3];
    const float h = sample(f, x, y, nrm);
    float* o = base + k * 8;
    o[0] = x;
    o[1] = y;
    o[2] = h;
    o[3] = nrm[0];
    o[4] = nrm[1];
    o[5] = nrm[2];
    o[6] = (x - lox) / w;
    o[7] = (y - loy) / w;
  } else {
    const int r = k - nv;
    const int quad = r < res * res ? r : r - res * res;
    const int v00 = (quad / res) * n + quad % res;
    int* o = reinterpret_cast<int*>(base + nv * 8) + r * 3;
    o[0] = v00;
    if (r < res * res) {
      o[1] = v00 + n;
      o[2] = v00 + n + 1;
    } else {
      o[1] = v00 + n + 1;
      o[2] = v00 + 1;
    }
  }
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32, 20 rounds, as jax's lowering (prng.py:_threefry2x32_lowering).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t x1, uint32_t x2,
                                         uint32_t* o1, uint32_t* o2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x1 + ks[0], b = x2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a += b;
      b = rotl(b, rot[i % 2][k]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *o1 = a;
  *o2 = b;
}

__global__ void scatter_kernel(FieldArgs fa, const float* __restrict__ cells, int c, int k,
                               uint32_t key1, uint32_t key2, float sw, float max_slope,
                               float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c * k) return;
  const Field f = load_field(fa);
  const int ci = t / k, pi = t % k;
  const float ox = cells[2 * ci], oy = cells[2 * ci + 1];
  const uint32_t hash = static_cast<uint32_t>(static_cast<int>(ox)) * 73856093u ^
                        static_cast<uint32_t>(static_cast<int>(oy)) * 19349663u;
  uint32_t ck1, ck2;
  threefry(key1, key2, 0u, hash, &ck1, &ck2);
  float u[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t b1, b2;
    threefry(ck1, ck2, 0u, static_cast<uint32_t>(pi * 4 + m), &b1, &b2);
    u[m] = __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
  }
  const float x = __fmaf_rn(u[0], sw, ox);
  const float y = __fmaf_rn(u[1], sw, oy);
  float n[3];
  const float h = sample(f, x, y, n);
  float* o = out + static_cast<size_t>(t) * 6;
  o[0] = x;
  o[1] = y;
  o[2] = h;
  o[3] = __fmaf_rn(u[2], 0.8f, 0.6f);
  o[4] = u[3] * 6.2831855f;   // float32(2 pi)
  o[5] = n[2] > max_slope ? 1.0f : 0.0f;
}

}  // namespace

// ``a``: 9 slots of 8 bytes (kernels/terrain.py:_FIELD_PACK, _CALL_PACK) —
// heights, origin, cell_w, HX, HY, then xy, P, with_normals, out.
extern "C" int terrain_heights(const long long* a, void* stream) {
  const int p = static_cast<int>(a[6]);
  if (p == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  heights_kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      FieldArgs{reinterpret_cast<const float*>(a[0]), reinterpret_cast<const float*>(a[1]),
                reinterpret_cast<const float*>(a[2]), static_cast<int>(a[3]),
                static_cast<int>(a[4])},
      reinterpret_cast<const float*>(a[5]), p, static_cast<int>(a[7]),
      reinterpret_cast<float*>(a[8]));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int terrain_chunks(const float* heights, const float* origin, const float* cell_w,
                              const float* leaf_origin, const float* leaf_width, int hx, int hy,
                              int n_leaf, int res, float inv_res, float* out, void* stream) {
  const long long items = static_cast<long long>(n_leaf) *
                          ((res + 1) * (res + 1) + 2 * res * res);
  if (items == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunks_kernel<<<static_cast<unsigned>((items + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      FieldArgs{heights, origin, cell_w, hx, hy}, leaf_origin, leaf_width, n_leaf, res, inv_res,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int terrain_scatter(const float* heights, const float* origin, const float* cell_w,
                               const float* cells, int hx, int hy, int c, int k,
                               unsigned key1, unsigned key2, float sw, float max_slope,
                               float* out, void* stream) {
  if (c * k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scatter_kernel<<<(c * k + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      FieldArgs{heights, origin, cell_w, hx, hy}, cells, c, k, key1, key2, sw, max_slope, out);
  return static_cast<int>(cudaGetLastError());
}
