// Kernel KV: the strike wake and the sleep pass (K8's sleeping).
//
// Replaces substrata_tpu/physics/step.py:103-117 (the pre-solve strike
// wake), step.py:166-187 (the entry reductions and deep static contacts),
// integrate.py:update_sleeping (:103) and step.py:216-224 (the fast-wake
// rebuild); plain twin: substrata_tpu_torch/kernels/sleep.py.
//
// Strike wake, two launches: copy the awake flags, then one thread per
// pair sets a sleeping dynamic body awake when its partner is awake and
// faster than 0.5 m/s (the duplicate writes of true are idempotent).
// Sleep pass, one thread per body: its speeds, the wake test through its
// incidence-table slots (each slot's entry reduced over its wm rows on the
// spot: any valid, max impulse, max penetration; the counterpart's speeds
// read from the inputs), its static rows' depth, the timer, the kinematic
// rule and the velocity zeroing, then newly_awake / newly_asleep and the
// fast-wake flags (atomicOr).  Tail, one thread: steps_left = 0 after a
// fast wake.  Maxima propagate NaN as torch.max does.  Booleans and
// timers are exact; the thresholds square in float32, as the twin does.
//
// What bounds it: latency (a few hundred KB at the bench shapes).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDynamic = 2;
constexpr int kKinematic = 1;

__device__ __forceinline__ float len2(const float* v, int i) {
  const float x = v[i * 3], y = v[i * 3 + 1], z = v[i * 3 + 2];
  return (x * x + y * y) + z * z;
}

// torch.max: NaN wins.
__device__ __forceinline__ float max_nan(float m, float x) {
  return (x > m || x != x) ? x : m;
}

__global__ void sleep_strike_copy_kernel(const bool* __restrict__ awake, int n,
                                         bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = awake[i];
}

__global__ void sleep_strike_kernel(const bool* __restrict__ awake,
                                    const float* __restrict__ linvel,
                                    const bool* __restrict__ alive, const int* __restrict__ motion,
                                    const int* __restrict__ pa, const int* __restrict__ pb,
                                    const bool* __restrict__ pv, int p, bool* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p || !pv[k]) return;
  const int a = max(pa[k], 0), b = max(pb[k], 0);
  const bool strike_a = awake[a] && len2(linvel, a) > 0.25f;
  const bool strike_b = awake[b] && len2(linvel, b) > 0.25f;
  if (strike_b && alive[a] && motion[a] == kDynamic) out[a] = true;
  if (strike_a && alive[b] && motion[b] == kDynamic) out[b] = true;
}

struct SleepParams {
  const float* lin;       // sleep_lin_vel []
  const float* ang;       // sleep_ang_vel []
  const float* time;      // sleep_time []
};

__global__ void __launch_bounds__(kThreads)
sleep_pass_kernel(const bool* __restrict__ awake, const bool* __restrict__ prev_awake,
                  const float* __restrict__ timer, const bool* __restrict__ alive,
                  const int* __restrict__ motion, const float* __restrict__ linvel,
                  const float* __restrict__ angvel, const int* __restrict__ ca,
                  const int* __restrict__ cb, const bool* __restrict__ cvalid,
                  const float* __restrict__ cpen, const float* __restrict__ lam, int ls,
                  const bool* __restrict__ s_valid, const float* __restrict__ s_pen,
                  const int* __restrict__ table, const float* __restrict__ sign, SleepParams sp,
                  float dt, int n, int wm, int K, int CPB, bool* __restrict__ o_awake,
                  float* __restrict__ o_timer, float* __restrict__ o_lin, float* __restrict__ o_ang,
                  bool* __restrict__ newly_awake, bool* __restrict__ newly_asleep,
                  int* __restrict__ flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float slv = *sp.lin, sav = *sp.ang;
  const float slv2 = slv * slv, sav2 = sav * sav;
  const float fast_l = 4.0f * slv2, fast_a = 4.0f * sav2;
  const float lin2 = len2(linvel, i), ang2 = len2(angvel, i);
  const bool slow = (lin2 < slv2) && (ang2 < sav2);
  bool wake_hit = false, body_deep = false;
  for (int s = 0; s < CPB; ++s) {
    const int t = table[i * CPB + s];
    if (t < 0) continue;
    // The entry's reductions over its wm rows.
    bool e_valid = false;
    float e_imp = 0.0f, e_pen = 0.0f;
    for (int j = 0; j < wm; ++j) {
      const int r = t * wm + j;
      const bool v = cvalid[r];
      e_valid = e_valid || v;
      const float li = v ? lam[static_cast<size_t>(r) * ls] : 0.0f;
      const float pi = v ? cpen[r] : -1e9f;
      e_imp = j == 0 ? li : max_nan(e_imp, li);
      e_pen = j == 0 ? pi : max_nan(e_pen, pi);
    }
    const int other = sign[i * CPB + s] > 0.0f ? cb[t * wm] : ca[t * wm];
    bool other_active = false, other_fast = false;
    if (other >= 0) {
      const float ol = len2(linvel, other), oa = len2(angvel, other);
      const bool ow = awake[other];
      other_active = ow && !((ol < slv2) && (oa < sav2));
      other_fast = ow && ((ol > fast_l) || (oa > fast_a));
    }
    wake_hit = wake_hit || (e_valid && e_imp > 1e-4f && other_active) ||
               (e_valid && other_fast);
    body_deep = body_deep || (e_valid && e_pen > 0.1f);
  }
  for (int k = 0; k < K; ++k) {
    const int r = i * K + k;
    body_deep = body_deep || (s_valid[r] && s_pen[r] > 0.1f);
  }
  const bool aw = awake[i];
  const bool dyn = motion[i] == kDynamic && alive[i];
  const float new_timer = (slow && !wake_hit && !body_deep) ? timer[i] + dt : 0.0f;
  const bool asleep = dyn && (new_timer > *sp.time);
  const bool woken = dyn && !aw && wake_hit;
  bool new_awake = dyn ? (!asleep && (aw || woken)) : aw;
  if (alive[i] && motion[i] == kKinematic) new_awake = (lin2 + ang2) > 1e-10f;
  const bool sleeping = dyn && !new_awake;
  float lv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lv[k] = sleeping ? 0.0f : linvel[i * 3 + k];
    o_lin[i * 3 + k] = lv[k];
    o_ang[i * 3 + k] = sleeping ? 0.0f : angvel[i * 3 + k];
  }
  o_awake[i] = new_awake;
  o_timer[i] = new_timer;
  const bool pa = prev_awake[i];
  const bool na = new_awake && !pa;
  newly_awake[i] = na;
  newly_asleep[i] = pa && !new_awake;
  if (na) {
    const float speed = sqrtf((lv[0] * lv[0] + lv[1] * lv[1]) + lv[2] * lv[2]);
    if (speed != speed) atomicOr(&flags[1], 1);
    else if (speed > 1.0f) atomicOr(&flags[0], 1);
  }
}

__global__ void sleep_steps_kernel(const int* __restrict__ flags, const int* __restrict__ steps_in,
                                   int* __restrict__ steps_out) {
  // torch.max over the woken speeds is NaN if any is, and NaN > 1 is false.
  *steps_out = (flags[0] && !flags[1]) ? 0 : *steps_in;
}

}  // namespace

extern "C" int strike_wake(const bool* awake, const float* linvel, const bool* alive,
                           const int* motion, const int* pa, const int* pb, const bool* pv,
                           int n, int p, bool* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sleep_strike_copy_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(awake, n, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p == 0) return static_cast<int>(err);
  sleep_strike_kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      awake, linvel, alive, motion, pa, pb, pv, p, out);
  return static_cast<int>(cudaGetLastError());
}

// flags: 2 ints of scratch.
extern "C" int sleep_pass(const bool* awake, const bool* prev_awake, const float* timer,
                          const bool* alive, const int* motion, const float* linvel,
                          const float* angvel, const int* ca, const int* cb, const bool* cvalid,
                          const float* cpen, const float* lam, int ls, const bool* s_valid,
                          const float* s_pen, const int* table, const float* sign,
                          const float* sleep_lin, const float* sleep_ang,
                          const float* sleep_time, const int* steps_in, float dt, int n, int wm,
                          int K, int CPB, int* flags, bool* o_awake, float* o_timer, float* o_lin,
                          float* o_ang, bool* newly_awake, bool* newly_asleep, int* steps_out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  SleepParams sp{sleep_lin, sleep_ang, sleep_time};
  sleep_pass_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      awake, prev_awake, timer, alive, motion, linvel, angvel, ca, cb, cvalid, cpen, lam, ls,
      s_valid, s_pen, table, sign, sp, dt, n, wm, K, CPB, o_awake, o_timer, o_lin, o_ang,
      newly_awake, newly_asleep, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sleep_steps_kernel<<<1, 1, 0, s>>>(flags, steps_in, steps_out);
  return static_cast<int>(cudaGetLastError());
}
