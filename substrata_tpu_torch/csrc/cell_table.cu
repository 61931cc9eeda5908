// Kernel KP: the broadphase cell table (K1).
//
// Replaces substrata_tpu/physics/broadphase.py:build_cell_table (:70-112);
// plain twin: substrata_tpu_torch/kernels/cell_table.py:cell_table_plain.
//
// Launch 1, one thread per body: the cell floor(pos * fl(1/cell_size))
// (the reference's static division, folded by XLA into that multiply),
// the int32-wrapping hash and its uint32 modulo (broadphase.py:51-53), the
// trash bucket for dead and non-collidable bodies, and the entry (slot |
// MOVING/STATIC/SMALL bits); a grid-stride loop fills the table with -1.
//
// Launch 2, one block: a body's rank in its bucket is its position among
// that bucket's bodies in index order (jnp.argsort is stable), which
// decides which bodies overflow a full bucket and the order of the
// candidates K2, KH and KL read.  The block clears per-bucket counters in
// shared memory (the bench's 16,385 buckets: 64 KiB of the H100's 227
// KiB; global memory past that), then its first warp walks the bodies in
// index order, 32 at a time: __match_any_sync groups the lanes of one
// bucket, popc of the lower peers ranks them, and the group's highest lane
// advances the counter.  Bound: the serial walk (N / 32 dependent warp
// steps); the bytes are ~30 per body.
#include "common.cuh"

namespace {

constexpr int kTblMoving = 1 << 16, kTblStatic = 1 << 17, kTblSmall = 1 << 18;
constexpr int kStatic = 0;
constexpr int kThreads = 256;
constexpr int kWalkThreads = 1024;
constexpr int kMaxSharedCounters = 56 * 1024;   // 224 KiB

__global__ void cell_hash_kernel(const float* __restrict__ pos, const bool* __restrict__ alive,
                                 const bool* __restrict__ collidable,
                                 const bool* __restrict__ awake, const int* __restrict__ motion,
                                 const float* __restrict__ bound_radius, int n, int nb, int cap,
                                 float rcp_cell, float cell_size, int with_flags,
                                 int* __restrict__ cells, int* __restrict__ bucket,
                                 int* __restrict__ entry, int* __restrict__ table) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = (nb + 1) * cap;
  for (int k = tid; k < total; k += gridDim.x * blockDim.x) table[k] = -1;
  if (tid >= n) return;
  int c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = static_cast<int>(floorf(pos[tid * 3 + k] * rcp_cell));
    cells[tid * 3 + k] = c[k];
  }
  bucket[tid] = (alive[tid] && collidable[tid]) ? sbt::cell_hash(c[0], c[1], c[2], nb) : nb;
  int e = tid;
  if (with_flags) {
    const bool is_static = motion[tid] == kStatic;
    e |= (awake[tid] && !is_static) ? kTblMoving : 0;
    e |= is_static ? kTblStatic : 0;
    e |= (2.0f * bound_radius[tid] <= cell_size) ? kTblSmall : 0;
  }
  entry[tid] = e;
}

__global__ void cell_rank_kernel(const int* __restrict__ bucket, const int* __restrict__ entry,
                                 int n, int nb, int cap, int* __restrict__ global_cnt,
                                 int* __restrict__ table, int* __restrict__ overflow) {
  extern __shared__ int s_cnt[];
  int* cnt = global_cnt != nullptr ? global_cnt : s_cnt;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned lower = (1u << lane) - 1u;
  int over = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool live = i < n;
    const int h = live ? bucket[i] : nb;
    const unsigned act = __ballot_sync(0xffffffffu, live && h < nb);
    if (live && h < nb) {
      const unsigned peers = __match_any_sync(act, h);
      const int before = cnt[h];
      __syncwarp(act);
      const int rank = before + __popc(peers & lower);
      if (rank < cap)
        table[h * cap + rank] = entry[i];
      else
        ++over;
      if (lane == 31 - __clz(peers)) cnt[h] = before + __popc(peers);
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(0xffffffffu, over, o);
  if (lane == 0) *overflow = over;
}

}  // namespace

extern "C" int cell_table(const float* pos, const bool* alive, const bool* collidable,
                          const bool* awake, const int* motion, const float* bound_radius, int n,
                          int nb, int cap, float rcp_cell, float cell_size, int with_flags,
                          int* cells, int* scratch, int* table, int* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = (nb + 1) * cap;
  const int work = n > total ? n : total;
  const int blocks = (work + kThreads - 1) / kThreads;
  cell_hash_kernel<<<blocks > 0 ? blocks : 1, kThreads, 0, s>>>(
      pos, alive, collidable, awake, motion, bound_radius, n, nb, cap, rcp_cell, cell_size,
      with_flags, cells, scratch, scratch + n, table);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Counters in shared memory when they fit, else in the scratch's tail.
  const bool shared = nb <= kMaxSharedCounters;
  const size_t smem = shared ? static_cast<size_t>(nb) * sizeof(int) : 0;
  static size_t smem_set = 48 * 1024;   // the opt-in, raised once
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(cell_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cell_rank_kernel<<<1, kWalkThreads, smem, s>>>(scratch, scratch + n, n, nb, cap,
                                                  shared ? nullptr : scratch + 2 * n, table,
                                                  overflow);
  return static_cast<int>(cudaGetLastError());
}
