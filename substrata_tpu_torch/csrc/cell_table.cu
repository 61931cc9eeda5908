// Kernel KP: the broadphase cell table (K1).
//
// Replaces substrata_tpu/physics/broadphase.py:build_cell_table (:70-112);
// plain twin: substrata_tpu_torch/kernels/cell_table.py:cell_table_plain.
//
// Bucket h's row holds the entries of h's bodies in index order
// (jnp.argsort is stable), the first `cap` of them; the others overflow.  A
// body's place in the row is its rank: how many of h's bodies have a lower
// index.  Three launches, each spread over the card, none walking the
// bodies in order:
//
// 1. clear: zero the bucket counters, the overflow and the crowded count.
// 2. hash, one thread per body: the cell floor(pos * fl(1/cell_size)) (the
//    reference's static division, folded by XLA into that multiply), the
//    int32-wrapping hash and its uint32 modulo (broadphase.py:51-53), the
//    trash bucket for dead and non-collidable bodies, the entry (slot |
//    MOVING/STATIC/SMALL bits); a body in a real bucket draws a ticket
//    atomicAdd(count[h], 1), in no particular order.  Tickets below kList
//    write the body's index into h's list [h * kList + ticket]; the body
//    that draws ticket kList names h crowded.  A grid-stride loop fills the
//    table with -1.
// 3. rank.  One thread per body of a bucket with at most kList bodies: its
//    rank counts the list's indices below its own (Σ count² reads over the
//    buckets, ~6 bodies a bucket on the bench world); rank < cap writes
//    table[h * cap + rank], the rest count toward the overflow (a block
//    sum, one atomic).  A crowded bucket (every body in one cell, a pile)
//    takes a block instead: it reads the bucket ids in index order, 32
//    contiguous ids a thread and 8,192 a pass, a ballot-like bit mask per
//    thread, a block scan of their popcounts ranks the members, and it stops
//    at the pass that has found `cap` of them; it writes the row and adds
//    count - cap to the overflow.  No counter lives in shared memory, so
//    one path serves every bucket count.
//
// What bounds it: launch latency.  The bytes are ~40 a body plus the
// table's fill (~0.5 MB on the bench world: 0.15 µs at 3.35 TB/s); the
// three dependent launches take a few µs each whatever the size.
#include "common.cuh"

namespace {

constexpr int kTblMoving = 1 << 16, kTblStatic = 1 << 17, kTblSmall = 1 << 18;
constexpr int kStatic = 0;
constexpr int kThreads = 256;
constexpr int kList = 32;                   // a bucket's listed bodies before it is crowded
constexpr int kCrowdThreads = 256;
constexpr int kCrowdPass = kCrowdThreads * 32;
constexpr int kMaxCrowdBlocks = 128;

__global__ void cell_clear_kernel(int nb, int* __restrict__ count, int* __restrict__ overflow,
                                  int* __restrict__ n_crowded) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = tid; k < nb; k += gridDim.x * blockDim.x) count[k] = 0;
  if (tid == 0) {
    *overflow = 0;
    *n_crowded = 0;
  }
}

__global__ void cell_hash_kernel(const float* __restrict__ pos, const bool* __restrict__ alive,
                                 const bool* __restrict__ collidable,
                                 const bool* __restrict__ awake, const int* __restrict__ motion,
                                 const float* __restrict__ bound_radius, int n, int nb, int cap,
                                 float rcp_cell, float cell_size, int with_flags,
                                 int* __restrict__ cells, int* __restrict__ bucket,
                                 int* __restrict__ entry, int* __restrict__ count,
                                 int* __restrict__ list, int* __restrict__ crowded,
                                 int* __restrict__ n_crowded, int* __restrict__ table) {
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
  const int h = (alive[tid] && collidable[tid]) ? sbt::cell_hash(c[0], c[1], c[2], nb) : nb;
  bucket[tid] = h;
  int e = tid;
  if (with_flags) {
    const bool is_static = motion[tid] == kStatic;
    e |= (awake[tid] && !is_static) ? kTblMoving : 0;
    e |= is_static ? kTblStatic : 0;
    e |= (2.0f * bound_radius[tid] <= cell_size) ? kTblSmall : 0;
  }
  entry[tid] = e;
  if (h < nb) {
    const int ticket = atomicAdd(&count[h], 1);
    if (ticket < kList)
      list[h * kList + ticket] = tid;
    else if (ticket == kList)
      crowded[atomicAdd(n_crowded, 1)] = h;
  }
}

// One crowded bucket: its first `cap` bodies in index order.
__device__ void crowded_row(int h, const int* __restrict__ bucket, const int* __restrict__ entry,
                            int n, int cap, int* __restrict__ table, int* warp_tot) {
  int found = 0;
  for (int base = 0; base < n && found < cap; base += kCrowdPass) {
    const int lo = base + threadIdx.x * 32;
    unsigned mask = 0u;
    if (lo + 32 <= n && (reinterpret_cast<uintptr_t>(bucket + lo) & 15u) == 0u) {
      const int4* v = reinterpret_cast<const int4*>(bucket + lo);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 x = v[q];
        mask |= (x.x == h ? 1u : 0u) << (4 * q) | (x.y == h ? 1u : 0u) << (4 * q + 1) |
                (x.z == h ? 1u : 0u) << (4 * q + 2) | (x.w == h ? 1u : 0u) << (4 * q + 3);
      }
    } else {
      for (int k = 0; k < 32 && lo + k < n; ++k) mask |= (bucket[lo + k] == h ? 1u : 0u) << k;
    }
    int pass_total;
    int rank = found + sbt::block_exclusive_scan(__popc(mask), warp_tot, &pass_total);
    while (mask != 0u && rank < cap) {
      const int k = __ffs(static_cast<int>(mask)) - 1;
      table[h * cap + rank] = entry[lo + k];
      mask &= mask - 1u;
      ++rank;
    }
    found += pass_total;
  }
}

__global__ void __launch_bounds__(kThreads)
cell_rank_kernel(const int* __restrict__ bucket, const int* __restrict__ entry,
                 const int* __restrict__ count, const int* __restrict__ list,
                 const int* __restrict__ crowded, const int* __restrict__ n_crowded, int n,
                 int nb, int cap, int crowd_blocks, int* __restrict__ table,
                 int* __restrict__ overflow) {
  __shared__ int warp_tot[32];
  if (static_cast<int>(blockIdx.x) < crowd_blocks) {
    const int m = *n_crowded;
    for (int k = blockIdx.x; k < m; k += crowd_blocks) {
      const int h = crowded[k];
      crowded_row(h, bucket, entry, n, cap, table, warp_tot);
      if (threadIdx.x == 0) atomicAdd(overflow, max(count[h] - cap, 0));
    }
    return;
  }
  const int i = (blockIdx.x - crowd_blocks) * kThreads + threadIdx.x;
  int over = 0;
  if (i < n) {
    const int h = bucket[i];
    const int c = h < nb ? count[h] : kList + 1;
    if (c <= kList) {
      const int* mine = list + h * kList;
      int rank = 0;
      for (int k = 0; k < c; ++k) rank += mine[k] < i ? 1 : 0;
      if (rank < cap)
        table[h * cap + rank] = entry[i];
      else
        over = 1;
    }
  }
  over = sbt::block_sum(over, warp_tot);
  if (threadIdx.x == 0 && over > 0) atomicAdd(overflow, over);
}

}  // namespace

// scratch (kernels/cell_table.py:scratch_ints): bucket [n], entry [n],
// count [nb], n_crowded [1], crowded [n / (kList + 1) + 1], list
// [nb * kList].
extern "C" int cell_table(const float* pos, const bool* alive, const bool* collidable,
                          const bool* awake, const int* motion, const float* bound_radius, int n,
                          int nb, int cap, float rcp_cell, float cell_size, int with_flags,
                          int* cells, int* scratch, int* table, int* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bucket = scratch;
  int* entry = bucket + n;
  int* count = entry + n;
  int* n_crowded = count + nb;
  int* crowded = n_crowded + 1;
  const int max_crowded = n / (kList + 1);
  int* list = crowded + max_crowded + 1;
  cell_clear_kernel<<<max((nb + kThreads - 1) / kThreads, 1), kThreads, 0, s>>>(nb, count,
                                                                                overflow,
                                                                                n_crowded);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (nb + 1) * cap;
  const int work = n > total ? n : total;
  cell_hash_kernel<<<max((work + kThreads - 1) / kThreads, 1), kThreads, 0, s>>>(
      pos, alive, collidable, awake, motion, bound_radius, n, nb, cap, rcp_cell, cell_size,
      with_flags, cells, bucket, entry, count, list, crowded, n_crowded, table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int crowd_blocks = min(max_crowded, kMaxCrowdBlocks);
  const int body_blocks = (n + kThreads - 1) / kThreads;
  if (crowd_blocks + body_blocks == 0) return 0;
  cell_rank_kernel<<<crowd_blocks + body_blocks, kThreads, 0, s>>>(
      bucket, entry, count, list, crowded, n_crowded, n, nb, cap, crowd_blocks, table,
      overflow);
  return static_cast<int>(cudaGetLastError());
}
