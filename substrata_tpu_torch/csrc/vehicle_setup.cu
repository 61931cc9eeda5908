// KAB: the vehicles' pre-ray setup and their chassis velocity scatter.
//
// Replaces substrata_tpu/physics/vehicles/manager.py:vehicles_update
// :598-630 (the chassis gather, mass, world inverse inertia, up axis and
// the four suspension rays of each vehicle) and _apply_vehicle_deltas
// :664-673.  Plain twins: substrata_tpu_torch/kernels/vehicle_setup.py:
// vehicle_setup_plain and vehicle_scatter_plain.
//
// ``vehicle_setup``: one thread per vehicle writes ONE float32 buffer of
// 55 * V words laid out field by field, so that KH (the rays) and KJ (the
// chassis) read contiguous views: pos [V, 3], quat [V, 4], linvel [V, 3],
// angvel [V, 3], mass [V], world inverse inertia [V, 3, 3], then the rays'
// origins [V*4, 3], dirs [V*4, 3], max_ts [V*4] and the excluded body
// [V*4] (int32 bits).  A vehicle without a body (slot -1) reads body 0,
// as the reference's clamp does; its rays and deltas are masked later.
//
// ``vehicle_scatter``: one thread per vehicle adds its deltas to its
// chassis row in place and wakes the body (awake, sleep timer 0); slot -1
// writes nothing.  Slots are assumed unique (one controller per body, as
// ClientApp and the manager keep them): two vehicles naming one body would
// race on its row and one's deltas could be lost, where the reference sums
// them.
//
// The arithmetic is the twin's, operation for operation (maths/quat.py:
// rotate_vec and cross, maths/transform.py:world_inv_inertia, none of them
// fused), with -fmad=false; mass is the correctly rounded 1 / max(inv_mass,
// 1e-9).  What bounds it on the card: launch latency — 32 vehicles read
// ~140 B and write ~220 B each.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kWheels = 4;

__global__ void vehicle_setup_kernel(
    const int* __restrict__ body_slot, const float* __restrict__ y_fwd_quat,
    const float* __restrict__ wheel_attach, const float* __restrict__ wheel_radius,
    const float* __restrict__ sus_max, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ linvel,
    const float* __restrict__ angvel, const float* __restrict__ inv_mass,
    const float* __restrict__ inv_inertia, int V, float* __restrict__ out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const int slot = body_slot[v] < 0 ? 0 : body_slot[v];
  float* o_pos = out;
  float* o_quat = out + 3 * V;
  float* o_lin = out + 7 * V;
  float* o_ang = out + 10 * V;
  float* o_mass = out + 13 * V;
  float* o_iw = out + 14 * V;
  float* o_org = out + 23 * V;
  float* o_dir = out + 35 * V;
  float* o_max = out + 47 * V;
  int* o_excl = reinterpret_cast<int*>(out + 51 * V);

  const float p[3] = {pos[3 * slot], pos[3 * slot + 1], pos[3 * slot + 2]};
  const float q[4] = {quat[4 * slot], quat[4 * slot + 1], quat[4 * slot + 2],
                      quat[4 * slot + 3]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_pos[3 * v + k] = p[k];
    o_lin[3 * v + k] = linvel[3 * slot + k];
    o_ang[3 * v + k] = angvel[3 * slot + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) o_quat[4 * v + k] = q[k];
  const float im = inv_mass[slot];
  o_mass[v] = __fdiv_rn(1.0f, im < 1e-9f ? 1e-9f : im);

  // maths/transform.py:world_inv_inertia: sum over k of r[i][k] d[k] r[j][k].
  float r[3][3];
  sbt::quat_to_matrix(q, r);
  const float d[3] = {inv_inertia[3 * slot], inv_inertia[3 * slot + 1],
                      inv_inertia[3 * slot + 2]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o_iw[9 * v + 3 * i + j] = r[i][0] * d[0] * r[j][0] + r[i][1] * d[1] * r[j][1] +
                                r[i][2] * d[2] * r[j][2];

  // The up axis: (R(y^-1) x) x (R(y^-1) y) in object space, into the world.
  const float yq[4] = {-y_fwd_quat[4 * v], -y_fwd_quat[4 * v + 1], -y_fwd_quat[4 * v + 2],
                       y_fwd_quat[4 * v + 3]};
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  float rx[3], ry[3], up_os[3], up_w[3];
  sbt::rotate_vec(yq, ex, rx);
  sbt::rotate_vec(yq, ey, ry);
  sbt::cross_fma(rx, ry, up_os);   // manager.py:621's jnp.cross, contracted
  sbt::rotate_vec(q, up_os, up_w);
  const float ray_len = sus_max[v] + wheel_radius[v];
#pragma unroll
  for (int w = 0; w < kWheels; ++w) {
    const int row = v * kWheels + w;
    const float* a = wheel_attach + 3 * row;
    const float av[3] = {a[0], a[1], a[2]};
    float aw[3];
    sbt::rotate_vec(q, av, aw);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o_org[3 * row + k] = p[k] + aw[k];
      o_dir[3 * row + k] = -up_w[k];
    }
    o_max[row] = ray_len;
    o_excl[row] = slot;
  }
}

__global__ void vehicle_deltas_kernel(
    const int* __restrict__ slots, const float* __restrict__ dv, const float* __restrict__ dw,
    int V, int N, float* __restrict__ linvel, float* __restrict__ angvel,
    bool* __restrict__ awake, float* __restrict__ sleep_timer) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const int s = slots[v];
  if (s < 0 || s >= N) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    linvel[3 * s + k] = linvel[3 * s + k] + dv[3 * v + k];
    angvel[3 * s + k] = angvel[3 * s + k] + dw[3 * v + k];
  }
  awake[s] = true;
  sleep_timer[s] = 0.0f;
}

}  // namespace

extern "C" int vehicle_setup(const int* body_slot, const float* y_fwd_quat,
                             const float* wheel_attach, const float* wheel_radius,
                             const float* sus_max, const float* pos, const float* quat,
                             const float* linvel, const float* angvel, const float* inv_mass,
                             const float* inv_inertia, int V, float* out, void* stream) {
  if (V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vehicle_setup_kernel<<<(V + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      body_slot, y_fwd_quat, wheel_attach, wheel_radius, sus_max, pos, quat, linvel, angvel,
      inv_mass, inv_inertia, V, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vehicle_scatter(const int* slots, const float* dv, const float* dw, int V, int N,
                               float* linvel, float* angvel, bool* awake, float* sleep_timer,
                               void* stream) {
  if (V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vehicle_deltas_kernel<<<(V + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      slots, dv, dw, V, N, linvel, angvel, awake, sleep_timer);
  return static_cast<int>(cudaGetLastError());
}
