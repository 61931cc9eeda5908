// Kernel KY: a flush of particle spawns scattered into the ring (K13's
// spawn scatter).
//
// Replaces substrata_tpu/physics/particles.py:_scatter_spawn (:139-156),
// which the reference calls once per 256-row chunk of a flush; plain twin:
// substrata_tpu_torch/kernels/spawn.py:spawn_rows_plain.
//
// One thread per row of the flush: row r lands at ring slot
// (cursor + r) % cap and writes its 13 fields (pos, vel, area, mass,
// restitution, width, dwidth_dt, opacity, dopacity_dt, theta, sprite type,
// die-on-hit, alive = true).  Rows of one flush take consecutive slots, so
// a slot named twice belongs to rows r and r + cap: only the last row of a
// slot writes (r + cap >= n), which is the reference's order (its later
// chunk overwrites the earlier one).  No two threads write one slot.
//
// What bounds it: bytes (64 B read and 61 B written a row).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowFloats = 16;

__global__ void spawn_kernel(float* __restrict__ pos, float* __restrict__ vel,
                             float* __restrict__ area, float* __restrict__ mass,
                             float* __restrict__ restitution, float* __restrict__ width,
                             float* __restrict__ dwidth_dt, float* __restrict__ opacity,
                             float* __restrict__ dopacity_dt, float* __restrict__ theta,
                             int* __restrict__ sprite_type, bool* __restrict__ die_on_hit,
                             bool* __restrict__ alive, const float* __restrict__ rows,
                             int cursor, int n, int cap) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n || r + cap < n) return;
  const int i = static_cast<int>((static_cast<long long>(cursor) + r) % cap);
  const float* row = rows + static_cast<size_t>(r) * kRowFloats;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[i * 3 + k] = row[k];
    vel[i * 3 + k] = row[3 + k];
  }
  area[i] = row[6];
  mass[i] = row[7];
  restitution[i] = row[8];
  width[i] = row[9];
  dwidth_dt[i] = row[10];
  opacity[i] = row[11];
  dopacity_dt[i] = row[12];
  theta[i] = row[13];
  sprite_type[i] = __float_as_int(row[14]);
  die_on_hit[i] = row[15] != 0.0f;
  alive[i] = true;
}

}  // namespace

extern "C" int spawn_rows(float* pos, float* vel, float* area, float* mass, float* restitution,
                          float* width, float* dwidth_dt, float* opacity, float* dopacity_dt,
                          float* theta, int* sprite_type, bool* die_on_hit, bool* alive,
                          const float* rows, int cursor, int n, int cap, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  spawn_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      pos, vel, area, mass, restitution, width, dwidth_dt, opacity, dopacity_dt, theta,
      sprite_type, die_on_hit, alive, rows, cursor, n, cap);
  return static_cast<int>(cudaGetLastError());
}
