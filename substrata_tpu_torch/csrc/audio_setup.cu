// KAA: the audio mix's per-source setup (four warps a block of 32 sources,
// each warp one part of every source's setup).
//
// Replaces the per-source part of substrata_tpu/audio/mix.py:mix_block
// (:290-348 Doppler, fades, distance and occlusion gains, pan, low-pass
// cutoff; :376-392 the HRIR direction through audio/hrtf.py:
// quantize_direction :157).  Plain twin: substrata_tpu_torch/kernels/
// audio_setup.py:audio_setup_plain.  The mix's epilogue (:433-444, the
// finished flag, the level meter and the alive mask; twin
// audio_epilogue_plain) is written by KF's source blocks
// (csrc/audio_mix.cu), which hold the level it reads.
//
// ``audio_setup`` reads the source state and the listener and writes every
// quantity of the block into ONE float32 buffer of (L + 9) * S words, laid
// out field by field so that each field is a contiguous view for KE and KF:
// eff_delta [S, L], then [S] each of dop_smooth, mute, gain, gl, gr, alpha,
// send_gain, dir_idx (int32 bits) and a flag word block whose bytes hold
// active [0, S) and use_lp [S, 2S).
//
// Rounding follows the jitted reference (found by comparing with it): the
// distance is sqrt of the fma chain of the dot product, correctly rounded;
// a division by a tensor divides; a division by a constant is a multiply by
// its float32 reciprocal (the HRIR bins); the low-pass coefficients are the
// three constants fc * 2 pi / 48000 divided once; the Doppler smoothing is
// one fma.  -fmad=false keeps everything else
// separately rounded.  atan2f, cosf and sinf are CUDA's.
//
// What bounds it on the card: latency.  512 sources read ~130 B and write
// ~52 B each (~0.1 MB, 28 ns at 3.35 TB/s) and do ~150 float operations
// each, in four independent chains: the Doppler (a root, four divisions,
// the L delays), the gains (a root, two divisions), the direction (two
// atan2 and a root, or the pan's cos and sin) and the low-pass cutoff.
// The setup gives each chain a warp of its own (lanes of one warp on
// different paths would run the paths one after the other), so a source's
// four chains run at once on four warps of one block and 512 sources fill
// 16 blocks; each warp issues every load it needs before its first use,
// the values two chains need (the offset to the source, its distance) are
// computed on each with the same operations, and the gain reaches the
// direction warp through shared memory.  Each output word is written once.
#include <cstring>

#include "common.cuh"

namespace {

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

struct SetupArgs {
  const bool* alive;
  const bool* paused;
  const bool* finished;
  const bool* spatial;
  const float* pos;
  const float* vel;
  const float* delta;
  const float* doppler_factor;
  const float* mute_factor;
  const float* mute_target;
  const float* mute_rate;
  const float* volume;
  const float* num_occ;
  const float* l_pos;
  const float* l_vel;
  const float* l_right;
  const float* l_fwd;
  const float* l_up;
  float* out;
  float dop_alpha;
  float dt_block;
  int S;
  int L;
  int use_hrtf;
};

constexpr int kSetupSources = 32;          // a block's sources: one a lane
constexpr int kSetupThreads = 4 * kSetupSources;   // one warp a part
constexpr int kPrefetch = 4;               // layers whose delta loads go first

__device__ __forceinline__ void load3(const float* p, float v[3]) {
  v[0] = p[0];
  v[1] = p[1];
  v[2] = p[2];
}

__global__ void __launch_bounds__(kSetupThreads) audio_setup_kernel(const SetupArgs g) {
  __shared__ float s_gain[kSetupSources];
  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  const int S = g.S, L = g.L;
  const int s = blockIdx.x * kSetupSources + lane;
  const bool in = s < S;
  float* f = g.out + static_cast<size_t>(L) * S;
  bool* flags = reinterpret_cast<bool*>(f + 8 * S);
  // The direction warp's values across the barrier.
  float cs = 0.0f, sn = 0.0f, actf = 0.0f;
  bool sp = false;
  if (in && part == 0) {
    // The Doppler, its smoothing and the L playback rates.
    float ps[3], lp[3], v[3], lv[3], dl[kPrefetch];
    load3(g.pos + 3 * s, ps);
    load3(g.l_pos, lp);
    load3(g.vel + 3 * s, v);
    load3(g.l_vel, lv);
    sp = g.spatial[s];
    const float df = g.doppler_factor[s];
#pragma unroll
    for (int l = 0; l < kPrefetch; ++l) dl[l] = l < L ? g.delta[s * L + l] : 0.0f;
    const float to[3] = {ps[0] - lp[0], ps[1] - lp[1], ps[2] - lp[2]};
    const float dist = __fsqrt_rn(dot3f(to, to));
    const float dc = clamp_lo(dist, 1e-6f);
    const float dirn[3] = {__fdiv_rn(to[0], dc), __fdiv_rn(to[1], dc), __fdiv_rn(to[2], dc)};
    const float v_src = dot3f(v, dirn);
    const float v_lis = dot3f(lv, dirn);
    float doppler = clampf(__fdiv_rn(kSpeedOfSound - v_lis,
                                     clamp_lo(kSpeedOfSound - (-v_src), 1.0f)), 0.5f, 2.0f);
    if (!sp) doppler = 1.0f;
    const float dop_smooth = __fmaf_rn(doppler - df, g.dop_alpha, df);
#pragma unroll
    for (int l = 0; l < kPrefetch; ++l)
      if (l < L) g.out[s * L + l] = clampf(dl[l] * dop_smooth, 0.0f, kDeltaMax);
    for (int l = kPrefetch; l < L; ++l)
      g.out[s * L + l] = clampf(g.delta[s * L + l] * dop_smooth, 0.0f, kDeltaMax);
    f[s] = dop_smooth;
  } else if (in && part == 1) {
    // The fade, the distance and occlusion gains, the gain and the send.
    float ps[3], lp[3];
    load3(g.pos + 3 * s, ps);
    load3(g.l_pos, lp);
    const bool act = g.alive[s] && !g.paused[s] && !g.finished[s];
    sp = g.spatial[s];
    const float mf = g.mute_factor[s], mr = g.mute_rate[s], mt = g.mute_target[s];
    const float vol = g.volume[s], nocc = g.num_occ[s];
    const float to[3] = {ps[0] - lp[0], ps[1] - lp[1], ps[2] - lp[2]};
    const float dist = __fsqrt_rn(dot3f(to, to));
    const float mute = mf + clampf(mt - mf, (-mr) * g.dt_block, mr * g.dt_block);
    const float dist_gain = clamp_hi(__fdiv_rn(1.0f, clamp_lo(dist, 1.0f)), 1.0f);
    const float occ_gain = __fdiv_rn(1.0f, 1.0f + nocc);
    const float gain = (vol * mute) * (sp ? dist_gain * occ_gain : 1.0f);
    s_gain[lane] = gain;
    f[S + s] = mute;
    f[2 * S + s] = gain;
    f[6 * S + s] = (gain * (act ? 1.0f : 0.0f)) * (sp ? 1.0f : 0.0f);
    flags[s] = act;
  } else if (in && part == 2) {
    // The HRIR bin (audio/hrtf.py:quantize_direction), or the pan's cos
    // and sin; the channel gains after the barrier.
    float ps[3], lp[3], right[3], fwd[3], up[3];
    load3(g.pos + 3 * s, ps);
    load3(g.l_pos, lp);
    load3(g.l_right, right);
    load3(g.l_fwd, fwd);
    if (g.use_hrtf) load3(g.l_up, up);
    actf = g.alive[s] && !g.paused[s] && !g.finished[s] ? 1.0f : 0.0f;
    sp = g.spatial[s];
    const float to[3] = {ps[0] - lp[0], ps[1] - lp[1], ps[2] - lp[2]};
    const float x = dot3f(to, right);
    const float y = dot3f(to, fwd);
    int dir_idx = 0;
    if (g.use_hrtf) {
      const float zc = dot3f(to, up);
      const float az = atan2f(x, y);
      const float el = atan2f(zc, clamp_lo(__fsqrt_rn(__fmaf_rn(x, x, y * y)), 1e-6f));
      float ra = rintf(az * kInvTwoPi * static_cast<float>(kNAz));
      float r = fmodf(ra, static_cast<float>(kNAz));
      if (r != 0.0f && r < 0.0f) r += static_cast<float>(kNAz);
      const float re = clampf(rintf((el + kQuarterPi) * kInvHalfPi * static_cast<float>(kNEl - 1)),
                              0.0f, static_cast<float>(kNEl - 1));
      dir_idx = static_cast<int>(r) * kNEl + static_cast<int>(re);
    } else {
      const float dc = clamp_lo(__fsqrt_rn(dot3f(to, to)), 1e-6f);
      const float pan = clampf(__fdiv_rn(x, dc), -1.0f, 1.0f);
      const float theta = (pan + 1.0f) * kQuarterPi;
      cs = cosf(theta);
      sn = sinf(theta);
    }
    reinterpret_cast<int*>(f + 7 * S)[s] = dir_idx;
  } else if (in) {
    // The low-pass cutoff and its coefficient.
    const float nocc = g.num_occ[s];
    const bool occluded = nocc > 0.0f;
    float fc;
    bool use_lp;
    if (g.use_hrtf) {
      fc = occluded ? 800.0f : 20000.0f;
      use_lp = occluded;
    } else {
      float ps[3], lp[3], fwd[3];
      load3(g.pos + 3 * s, ps);
      load3(g.l_pos, lp);
      load3(g.l_fwd, fwd);
      sp = g.spatial[s];
      const float to[3] = {ps[0] - lp[0], ps[1] - lp[1], ps[2] - lp[2]};
      const bool shadow = dot3f(to, fwd) < 0.0f && sp;
      fc = occluded ? 800.0f : (shadow ? 3000.0f : 20000.0f);
      use_lp = occluded || shadow;
    }
    f[5 * S + s] = lp_alpha(fc);
    flags[S + s] = use_lp;
  }
  __syncthreads();
  if (in && part == 2) {
    const float gain = s_gain[lane];
    float gl, gr;
    if (g.use_hrtf) {
      gl = (gain * (sp ? 1.0f : kStereoGain)) * actf;
      gr = gl;
    } else {
      gl = (gain * (sp ? cs : kStereoGain)) * actf;
      gr = (gain * (sp ? sn : kStereoGain)) * actf;
    }
    f[3 * S + s] = gl;
    f[4 * S + s] = gr;
  }
}

}  // namespace

// One host buffer of 8-byte slots (kernels/audio_setup.py:_PACK): the 18
// input pointers (alive ... l_up), dop_alpha and dt_block as doubles, S, L,
// use_hrtf, out.
extern "C" int audio_setup(const long long* w, void* stream) {
  SetupArgs g;
  const void* in[18];
  for (int k = 0; k < 18; ++k) in[k] = reinterpret_cast<const void*>(w[k]);
  g.alive = static_cast<const bool*>(in[0]);
  g.paused = static_cast<const bool*>(in[1]);
  g.finished = static_cast<const bool*>(in[2]);
  g.spatial = static_cast<const bool*>(in[3]);
  g.pos = static_cast<const float*>(in[4]);
  g.vel = static_cast<const float*>(in[5]);
  g.delta = static_cast<const float*>(in[6]);
  g.doppler_factor = static_cast<const float*>(in[7]);
  g.mute_factor = static_cast<const float*>(in[8]);
  g.mute_target = static_cast<const float*>(in[9]);
  g.mute_rate = static_cast<const float*>(in[10]);
  g.volume = static_cast<const float*>(in[11]);
  g.num_occ = static_cast<const float*>(in[12]);
  g.l_pos = static_cast<const float*>(in[13]);
  g.l_vel = static_cast<const float*>(in[14]);
  g.l_right = static_cast<const float*>(in[15]);
  g.l_fwd = static_cast<const float*>(in[16]);
  g.l_up = static_cast<const float*>(in[17]);
  double d[2];
  memcpy(d, &w[18], sizeof d);
  g.dop_alpha = static_cast<float>(d[0]);
  g.dt_block = static_cast<float>(d[1]);
  g.S = static_cast<int>(w[20]);
  g.L = static_cast<int>(w[21]);
  g.use_hrtf = static_cast<int>(w[22]);
  g.out = reinterpret_cast<float*>(w[23]);
  if (g.S < 0 || g.L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (g.S == 0) return 0;
  audio_setup_kernel<<<(g.S + kSetupSources - 1) / kSetupSources, kSetupThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
