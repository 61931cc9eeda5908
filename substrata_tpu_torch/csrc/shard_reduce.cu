// Kernel KAE: the reductions over the shard axis that the reference does
// with psum across the mesh (K20a, K20b, K20d, K20e), on one card.
//
// Replaces substrata_tpu/parallel/spatial.py:spatial_world_step (:146; the
// [:L] slice and the two psums at :180-184) and spatial_world_step_2d
// (:263; :299-302), parallel/mesh.py:multi_world_step (:29; the psum of
// the awake counts at :50) and sharded_mix_block (:63; psum and clip at
// :85-88).  Plain twins: substrata_tpu_torch/kernels/shard_reduce.py.
//
// shard_keep_count: block 0 counts awake & alive over the kept rows of
//   every shard and sums the halo overflow counters (int32, one writer);
//   the other blocks copy shard s's first L rows of each stepped field
//   into rows [s L, (s + 1) L) of the sharded output, as bytes (32-bit words
//   where a field's rows are whole words).  The stepped shards are separate
//   allocations: a descriptor table of their field pointers, passed by value.
// shard_world_count: the sum of W int32 counts (one pointer each).
// shard_sum_clip: out[e] = clip(((b0[e] + b1[e]) + b2[e]) + ..., -1, 1) over
//   n stereo blocks in shard order, the twin's order, so the two agree bit
//   for bit; the clip passes NaN through as jnp.clip and torch.clamp do.
//
// What bounds them: bytes — the kept rows (133 bytes a body) once read and
// once written, the blocks once read; all are small enough that the launch
// sets their time.
#include "common.cuh"

namespace {

// The Keep table is passed by value: 8 x 24 pointers keep it under 2 KB.
constexpr int kMaxFields = 24;
constexpr int kMaxShards = 8;
constexpr int kMaxItems = 64;
constexpr int kThreads = 1024;
constexpr int kCopyBlocks = 8;

struct Keep {
  const char* src[kMaxShards][kMaxFields];
  char* dst[kMaxFields];
  int bytes[kMaxFields];
  int n;
};

struct Ptrs {
  const void* p[kMaxItems];
};

__global__ void __launch_bounds__(kThreads) keep_kernel(Keep k, int n_shards, int keep,
                                                        int alive_f, int awake_f,
                                                        const int* overflow, int n_overflow,
                                                        int* out) {
  __shared__ int warp_tot[32];
  if (blockIdx.x == 0) {
    int awake = 0;
    for (int s = 0; s < n_shards; ++s) {
      const bool* al = reinterpret_cast<const bool*>(k.src[s][alive_f]);
      const bool* aw = reinterpret_cast<const bool*>(k.src[s][awake_f]);
      for (int i = threadIdx.x; i < keep; i += blockDim.x) awake += (al[i] && aw[i]) ? 1 : 0;
    }
    int ov = 0;
    for (int i = threadIdx.x; i < n_overflow; i += blockDim.x) ov += overflow[i];
    awake = sbt::block_sum(awake, warp_tot);
    ov = sbt::block_sum(ov, warp_tot);
    if (threadIdx.x == 0) {
      out[0] = awake;
      out[1] = ov;
    }
    return;
  }
  const int s = (blockIdx.x - 1) / kCopyBlocks, part = (blockIdx.x - 1) % kCopyBlocks;
  for (int f = 0; f < k.n; ++f) {
    const int b = k.bytes[f];
    const char* src = k.src[s][f];
    char* dst = k.dst[f] + static_cast<long>(s) * keep * b;
    if (b % 4 == 0) {
      const long words = static_cast<long>(keep) * (b / 4);
      const long lo = words * part / kCopyBlocks, hi = words * (part + 1) / kCopyBlocks;
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
      uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
      for (long i = lo + threadIdx.x; i < hi; i += blockDim.x) dw[i] = sw[i];
    } else {
      const long n = static_cast<long>(keep) * b;
      const long lo = n * part / kCopyBlocks, hi = n * (part + 1) / kCopyBlocks;
      for (long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = src[i];
    }
  }
}

__global__ void world_count_kernel(Ptrs p, int n, int* out) {
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < n; ++w) total += *static_cast<const int*>(p.p[w]);
    out[0] = total;
  }
}

__global__ void sum_clip_kernel(Ptrs p, int n, int len, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float acc = static_cast<const float*>(p.p[0])[e];
  for (int k = 1; k < n; ++k) acc = acc + static_cast<const float*>(p.p[k])[e];
  out[e] = acc < -1.0f ? -1.0f : (acc > 1.0f ? 1.0f : acc);
}

}  // namespace

// src: host array of n_shards * n_fields device pointers (shard-major);
// dst: host array of n_fields; bytes: host array of bytes per row;
// overflow: device int32 [n_overflow]; out: device int32 [2] (awake,
// overflow).
extern "C" int shard_keep_count(const void* const* src, void* const* dst, const int* bytes,
                                int n_fields, int n_shards, int keep, int alive_f, int awake_f,
                                const int* overflow, int n_overflow, int* out, void* stream) {
  if (n_fields > kMaxFields || n_shards > kMaxShards || n_shards < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Keep k;
  k.n = n_fields;
  for (int f = 0; f < n_fields; ++f) {
    for (int s = 0; s < n_shards; ++s)
      k.src[s][f] = static_cast<const char*>(src[s * n_fields + f]);
    k.dst[f] = static_cast<char*>(dst[f]);
    k.bytes[f] = bytes[f];
  }
  keep_kernel<<<1 + n_shards * kCopyBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k, n_shards, keep, alive_f, awake_f, overflow, n_overflow, out);
  return static_cast<int>(cudaGetLastError());
}

// counts: host array of n device pointers to one int32 each.
extern "C" int shard_world_count(const void* const* counts, int n, int* out, void* stream) {
  if (n > kMaxItems || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Ptrs p;
  for (int w = 0; w < n; ++w) p.p[w] = counts[w];
  world_count_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(p, n, out);
  return static_cast<int>(cudaGetLastError());
}

// blocks: host array of n device pointers to float32 [len] each.
extern "C" int shard_sum_clip(const void* const* blocks, int n, int len, float* out,
                              void* stream) {
  if (n > kMaxItems || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Ptrs p;
  for (int k = 0; k < n; ++k) p.p[k] = blocks[k];
  const int threads = 256;
  sum_clip_kernel<<<(len + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p, n, len, out);
  return static_cast<int>(cudaGetLastError());
}
