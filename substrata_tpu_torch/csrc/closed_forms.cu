// KK: sphere, box and capsule closed-form contacts for one narrowphase bucket.
//
// Replaces substrata_tpu/physics/narrowphase.py:_CLOSED_FORM_KERNELS (:564-583)
// over a combo-code bucket, with the epilogue of pair_contacts (:729-775);
// plain twin: substrata_tpu_torch/kernels/closed_forms.py:closed_form_rows_plain.
//
// One thread per bucket slot, the combo code a launch argument (one launch
// per active closed-form bucket).  A thread gathers both bodies' pose and
// shape rows (2 x 44 bytes), runs its code's routine from closed_forms.cuh,
// prunes speculative points (narrowphase.py:739-742) and writes its `wm`
// rows (wm x 49 bytes) plus the touching flag.  What bounds it on the card:
// operations for the capsule-box codes (the 14-step ternary search costs
// ~1,600 dependent float operations per pair), bytes for the point contacts
// (~60 operations per 186 bytes).  The design keeps everything in registers,
// one pair per thread with no shared memory and no inter-thread traffic.
#include "closed_forms.cuh"

namespace {

__global__ void closed_form_rows_kernel(
    const int* __restrict__ ba, const int* __restrict__ bb, const bool* __restrict__ bvalid,
    const float* __restrict__ pos, const float* __restrict__ quat,
    const float* __restrict__ params, const float* __restrict__ fric,
    const float* __restrict__ rest, const bool* __restrict__ sensor, int cap, int code,
    int wm, int blocked, int* __restrict__ o_a, int* __restrict__ o_b,
    float* __restrict__ o_point, float* __restrict__ o_normal, float* __restrict__ o_pen,
    bool* __restrict__ o_valid, float* __restrict__ o_fric, float* __restrict__ o_rest,
    int* __restrict__ o_key, bool* __restrict__ o_touch) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cap) return;
  const bool pv = bvalid[p];
  const int a = ba[p];
  const int b = bb[p];
  float pa[3], qa[4], pra[4], pb[3], qb[4], prb[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pa[k] = pos[a * 3 + k];
    pb[k] = pos[b * 3 + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qa[k] = quat[a * 4 + k];
    qb[k] = quat[b * 4 + k];
    pra[k] = params[a * 4 + k];
    prb[k] = params[b * 4 + k];
  }
  sbt::Manifold m;
  sbt::closed_form(code, pa, qa, pra, pb, qb, prb, m);
  sbt::write_rows(m, p, pv, a, b, wm, blocked, fric, rest, sensor, o_a, o_b, o_point, o_normal,
                  o_pen, o_valid, o_fric, o_rest, o_key, o_touch);
}

}  // namespace

extern "C" int closed_form_rows(const int* ba, const int* bb, const bool* bvalid,
                                const float* pos, const float* quat, const float* params,
                                const float* fric, const float* rest, const bool* sensor,
                                int cap, int code, int wm, int blocked, int* o_a, int* o_b,
                                float* o_point, float* o_normal, float* o_pen, bool* o_valid,
                                float* o_fric, float* o_rest, int* o_key, bool* o_touch,
                                void* stream) {
  if (wm < 1 || wm > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (cap > 0) {
    const int threads = 128;
    const int blocks = (cap + threads - 1) / threads;
    closed_form_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        ba, bb, bvalid, pos, quat, params, fric, rest, sensor, cap, code, wm, blocked, o_a,
        o_b, o_point, o_normal, o_pen, o_valid, o_fric, o_rest, o_key, o_touch);
  }
  return static_cast<int>(cudaGetLastError());
}
