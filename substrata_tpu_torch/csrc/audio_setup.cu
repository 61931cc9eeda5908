// KAA: the audio mix's per-source setup and its epilogue, one thread per
// source.
//
// Replaces the per-source part of substrata_tpu/audio/mix.py:mix_block
// (:290-348 Doppler, fades, distance and occlusion gains, pan, low-pass
// cutoff; :376-392 the HRIR direction through audio/hrtf.py:
// quantize_direction :157; :433-444 the finished flag, the level meter and
// the alive mask).  Plain twins: substrata_tpu_torch/kernels/audio_setup.py:
// audio_setup_plain and audio_epilogue_plain.
//
// ``audio_setup`` reads the source state and the listener and writes every
// quantity of the block into ONE float32 buffer of (L + 9) * S words, laid
// out field by field so that each field is a contiguous view for KE and KF:
// eff_delta [S, L], then [S] each of dop_smooth, mute, gain, gl, gr, alpha,
// send_gain, dir_idx (int32 bits) and a flag word block whose bytes hold
// active [0, S) and use_lp [S, 2S).  ``audio_epilogue`` runs after KG: the
// smoothed level [S] and, in the next S words' bytes, finished [0, S) and
// alive [S, 2S).
//
// Rounding follows the jitted reference (found by comparing with it): the
// distance is sqrt of the fma chain of the dot product, correctly rounded;
// a division by a tensor divides; a division by a constant is a multiply by
// its float32 reciprocal (the HRIR bins); the low-pass coefficients are the
// three constants fc * 2 pi / 48000 divided once; the Doppler smoothing and
// the level meter are one fma each.  -fmad=false keeps everything else
// separately rounded.  atan2f, cosf and sinf are CUDA's.
//
// What bounds it on the card: launch latency.  512 sources read ~130 B and
// write ~52 B each (~0.1 MB, 28 ns at 3.35 TB/s) and do ~150 float
// operations each; the design is one pass, every intermediate in registers,
// each output word written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNAz = 16, kNEl = 3;
constexpr float kSpeedOfSound = 343.0f;
constexpr float kDeltaMax = 2.5f;
constexpr float kQuarterPi = 0.7853981633974483f;           // float32(pi / 4)
constexpr float kInvTwoPi = 0.15915493667125702f;           // float32(1) / float32(2 pi)
constexpr float kInvHalfPi = 0.6366197466850281f;           // float32(1) / float32(pi / 2)
constexpr float kStereoGain = 0.70710678f;

// torch.clamp: a NaN passes through.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return clamp_hi(clamp_lo(x, lo), hi);
}

// maths/fp.py:dot3: fma(a2, b2, fma(a1, b1, a0 b0)).
__device__ __forceinline__ float dot3f(const float a[3], const float b[3]) {
  return __fmaf_rn(a[2], b[2], __fmaf_rn(a[1], b[1], a[0] * b[0]));
}

// The low-pass coefficient of each cutoff: float32(fc * float32(2 pi)) / 48000.
__device__ __forceinline__ float lp_alpha(float fc) {
  return clampf(__fdiv_rn(fc * 6.2831855f, 48000.0f), 0.0f, 1.0f);
}

__global__ void audio_setup_kernel(
    const bool* __restrict__ alive, const bool* __restrict__ paused,
    const bool* __restrict__ finished, const bool* __restrict__ spatial,
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ delta, const float* __restrict__ doppler_factor,
    const float* __restrict__ mute_factor, const float* __restrict__ mute_target,
    const float* __restrict__ mute_rate, const float* __restrict__ volume,
    const float* __restrict__ num_occ, const float* __restrict__ l_pos,
    const float* __restrict__ l_vel, const float* __restrict__ l_right,
    const float* __restrict__ l_fwd, const float* __restrict__ l_up, float dop_alpha,
    float dt_block, int S, int L, int use_hrtf, float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const bool act = alive[s] && !paused[s] && !finished[s];
  const bool sp = spatial[s];
  const float to[3] = {pos[3 * s] - l_pos[0], pos[3 * s + 1] - l_pos[1],
                       pos[3 * s + 2] - l_pos[2]};
  const float dist = __fsqrt_rn(dot3f(to, to));
  const float dc = clamp_lo(dist, 1e-6f);
  const float dirn[3] = {__fdiv_rn(to[0], dc), __fdiv_rn(to[1], dc), __fdiv_rn(to[2], dc)};
  const float v[3] = {vel[3 * s], vel[3 * s + 1], vel[3 * s + 2]};
  const float lv[3] = {l_vel[0], l_vel[1], l_vel[2]};
  const float v_src = dot3f(v, dirn);
  const float v_lis = dot3f(lv, dirn);
  float doppler = clampf(__fdiv_rn(kSpeedOfSound - v_lis,
                                   clamp_lo(kSpeedOfSound - (-v_src), 1.0f)), 0.5f, 2.0f);
  if (!sp) doppler = 1.0f;
  const float df = doppler_factor[s];
  const float dop_smooth = __fmaf_rn(doppler - df, dop_alpha, df);
  for (int l = 0; l < L; ++l)
    out[s * L + l] = clampf(delta[s * L + l] * dop_smooth, 0.0f, kDeltaMax);

  const float mf = mute_factor[s], mr = mute_rate[s];
  const float mute = mf + clampf(mute_target[s] - mf, (-mr) * dt_block, mr * dt_block);
  const float dist_gain = clamp_hi(__fdiv_rn(1.0f, clamp_lo(dist, 1.0f)), 1.0f);
  const float nocc = num_occ[s];
  const float occ_gain = __fdiv_rn(1.0f, 1.0f + nocc);
  const float right[3] = {l_right[0], l_right[1], l_right[2]};
  const float fwd[3] = {l_fwd[0], l_fwd[1], l_fwd[2]};
  const float x = dot3f(to, right);
  const float y = dot3f(to, fwd);
  const float pan = clampf(__fdiv_rn(x, dc), -1.0f, 1.0f);
  const float theta = (pan + 1.0f) * kQuarterPi;
  const bool behind = y < 0.0f;
  const float gain = (volume[s] * mute) * (sp ? dist_gain * occ_gain : 1.0f);
  const bool occluded = nocc > 0.0f;
  const float actf = act ? 1.0f : 0.0f;
  float gl, gr, fc;
  bool use_lp;
  int dir_idx = 0;
  if (use_hrtf) {
    gl = (gain * (sp ? 1.0f : kStereoGain)) * actf;
    gr = gl;
    fc = occluded ? 800.0f : 20000.0f;
    use_lp = occluded;
    const float up[3] = {l_up[0], l_up[1], l_up[2]};
    const float zc = dot3f(to, up);
    // audio/hrtf.py:quantize_direction
    const float az = atan2f(x, y);
    const float el = atan2f(zc, clamp_lo(__fsqrt_rn(__fmaf_rn(x, x, y * y)), 1e-6f));
    float ra = rintf(az * kInvTwoPi * static_cast<float>(kNAz));
    float r = fmodf(ra, static_cast<float>(kNAz));
    if (r != 0.0f && r < 0.0f) r += static_cast<float>(kNAz);
    const float re = clampf(rintf((el + kQuarterPi) * kInvHalfPi * static_cast<float>(kNEl - 1)),
                            0.0f, static_cast<float>(kNEl - 1));
    dir_idx = static_cast<int>(r) * kNEl + static_cast<int>(re);
  } else {
    gl = (gain * (sp ? cosf(theta) : kStereoGain)) * actf;
    gr = (gain * (sp ? sinf(theta) : kStereoGain)) * actf;
    const bool shadow = behind && sp;
    fc = occluded ? 800.0f : (shadow ? 3000.0f : 20000.0f);
    use_lp = occluded || shadow;
  }
  float* f = out + static_cast<size_t>(L) * S;
  f[s] = dop_smooth;
  f[S + s] = mute;
  f[2 * S + s] = gain;
  f[3 * S + s] = gl;
  f[4 * S + s] = gr;
  f[5 * S + s] = lp_alpha(fc);
  f[6 * S + s] = (gain * actf) * (sp ? 1.0f : 0.0f);
  reinterpret_cast<int*>(f + 7 * S)[s] = dir_idx;
  bool* flags = reinterpret_cast<bool*>(f + 8 * S);
  flags[s] = act;
  flags[S + s] = use_lp;
}

__global__ void audio_epilogue_kernel(
    const bool* __restrict__ finished, const bool* __restrict__ looping,
    const bool* __restrict__ stream_mode, const bool* __restrict__ active,
    const float* __restrict__ new_heads, const int* __restrict__ buf_len,
    const float* __restrict__ level, const float* __restrict__ smoothed_level,
    const bool* __restrict__ alive, const bool* __restrict__ remove_on_finish, int S, int L,
    float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const bool fin = finished[s] ||
                   (!looping[s] && !stream_mode[s] && active[s] &&
                    new_heads[s * L] >= static_cast<float>(buf_len[s * L]) - 1.0f);
  out[s] = __fmaf_rn(level[s], 0.1f, smoothed_level[s] * 0.9f);
  bool* flags = reinterpret_cast<bool*>(out + S);
  flags[s] = fin;
  flags[S + s] = alive[s] && !(fin && remove_on_finish[s]);
}

}  // namespace

extern "C" int audio_setup(const bool* alive, const bool* paused, const bool* finished,
                           const bool* spatial, const float* pos, const float* vel,
                           const float* delta, const float* doppler_factor,
                           const float* mute_factor, const float* mute_target,
                           const float* mute_rate, const float* volume, const float* num_occ,
                           const float* l_pos, const float* l_vel, const float* l_right,
                           const float* l_fwd, const float* l_up, float dop_alpha,
                           float dt_block, int S, int L, int use_hrtf, float* out, void* stream) {
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  audio_setup_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      alive, paused, finished, spatial, pos, vel, delta, doppler_factor, mute_factor,
      mute_target, mute_rate, volume, num_occ, l_pos, l_vel, l_right, l_fwd, l_up, dop_alpha,
      dt_block, S, L, use_hrtf, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int audio_epilogue(const bool* finished, const bool* looping, const bool* stream_mode,
                              const bool* active, const float* new_heads, const int* buf_len,
                              const float* level, const float* smoothed_level, const bool* alive,
                              const bool* remove_on_finish, int S, int L, float* out,
                              void* stream) {
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  audio_epilogue_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      finished, looping, stream_mode, active, new_heads, buf_len, level, smoothed_level, alive,
      remove_on_finish, S, L, out);
  return static_cast<int>(cudaGetLastError());
}
