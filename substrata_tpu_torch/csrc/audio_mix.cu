// KE, KF, KG: the spatial audio mix of one block, as three launches.
//
// Replace the device program substrata_tpu/audio/mix.py:mix_block (:276)
// with _fetch_all (:201); plain twins in
// substrata_tpu_torch/kernels/audio_mix.py (audio_fetch_plain,
// audio_spatialise_plain, audio_downmix_reverb_plain).  Each kernel repeats
// its twin's float32 operations in the same order; a multiply-add is fused
// (__fmaf_rn) exactly where the twin calls maths/fp.py:fma, which is where
// the reference's compiler fuses it, and nowhere else (-fmad=false).
//
// KE audio_fetch: one thread per (source, frame), looping over the L
//   layers: the reference's index arithmetic (wrapped playhead, window row,
//   16-sample chunk and offset), two pool loads and the lerp, the range
//   mask, the layer's mix factor; a layer with buf_len 0 has gain 0 and is
//   skipped.  Threads b < L also write layer b's new playhead.
//   Bound: memory.  At the bench shapes (256 sources, 800 frames, one
//   active layer of rate <= 1.25) it reads ~1 KB of pool per source and
//   writes 0.8 MB of samples: ~0.6 us at 3.35 TB/s.  Neighbouring threads
//   read neighbouring pool samples, so the loads coalesce.
// KF audio_spatialise: one block per source.  The source's HRIR history and
//   block go to shared memory; one thread runs the one-pole low-pass over
//   the frames in order (the recurrence is serial: ~B dependent fmas, the
//   kernel's latency floor); then every thread takes frames of the 64-tap
//   FIR per ear from shared memory, the gain ramp and the reverb send, and
//   the block reduces the peak level.
//   Bound: the FIR, 2 x 64 fmas per (source, frame): 52 MFLOP at the bench
//   shapes, ~0.8 us at 67 TFLOP/s float32.
// KG audio_downmix_reverb: one thread per frame sums its column of the
//   [S, B] left, right and send arrays in source order (no atomics, so the
//   result is deterministic), then runs the 4-line FDN for that frame.
//   Every line delay is >= the block, but the longest (8191 samples) reads
//   what frame b + 1 writes, so the lines are read from one buffer and
//   written to another: with a room the grid covers the whole ring, and a
//   position that no frame writes is copied.  The write index stays on
//   the card.  Bound: memory, ~2.5 MB read at the bench shapes, ~0.8 us.
#include "common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxTaps = 64;
constexpr int kSpatialThreads = 256;

// jnp.mod on floats: fmod shifted into the divisor's sign.
__device__ __forceinline__ float float_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

__global__ void audio_fetch_kernel(
    const float* __restrict__ pool, const int* __restrict__ buf_offset,
    const int* __restrict__ buf_len, const float* __restrict__ playhead,
    const float* __restrict__ eff_delta, const float* __restrict__ mix_factor,
    const uint8_t* __restrict__ looping, const uint8_t* __restrict__ stream_mode,
    const float* __restrict__ stream_write_head, const uint8_t* __restrict__ active,
    float* __restrict__ samples, float* __restrict__ new_playhead, int L, int B, int nw,
    int n_rows, float li_max) {
  const int s = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool loop = looping[s] != 0, strm = stream_mode[s] != 0;
  if (b < L) {
    const int i = s * L + b;
    const float lenf = fmaxf(static_cast<float>(buf_len[i]), 1.0f);
    float nh = __fmaf_rn(eff_delta[i], static_cast<float>(B), playhead[i]);
    if (loop && !strm) nh = float_mod(nh, lenf);
    new_playhead[i] = nh;
  }
  if (b >= B) return;
  const float bf = static_cast<float>(b);
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int i = s * L + l;
    const int blen = buf_len[i];
    if (blen <= 0) continue;  // layer gain 0
    const float lenf = fmaxf(static_cast<float>(blen), 1.0f);
    const float p = playhead[i];
    const float ed = eff_delta[i];
    float ph = (loop || strm) ? float_mod(p, lenf) : p;
    ph = fmaxf(ph, 0.0f);
    const int ph_int = static_cast<int>(floorf(ph));
    const float ph_frac = ph - static_cast<float>(ph_int);
    const int start_i = buf_offset[i] + min(ph_int, max(blen - 1, 0));
    const int row0 = min(max(start_i >> 7, 0), n_rows - nw);
    float li = __fmaf_rn(ed, bf, ph_frac) + static_cast<float>(start_i - (row0 << 7));
    li = fminf(fmaxf(li, 0.0f), li_max);
    const int qi = static_cast<int>(floorf(li * 0.0625f));
    const float u = li - 16.0f * static_cast<float>(qi);
    const float k0 = floorf(u);
    const float w0 = 1.0f - fabsf(u - k0);
    const float w1 = 1.0f - fabsf(u - (k0 + 1.0f));
    const long long idx = (static_cast<long long>(row0) << 7) + 16 * qi + static_cast<int>(k0);
    float v = __fmaf_rn(pool[idx + 1], w1, pool[idx] * w0);
    bool in_range;
    if (strm) {
      in_range = __fmaf_rn(ed, bf, p) < stream_write_head[s] - 1.0f;
    } else {
      in_range = loop || (__fmaf_rn(ed, bf, ph) < lenf - 1.0f);
    }
    v = v * (in_range ? 1.0f : 0.0f);
    acc = (l == 0) ? v * mix_factor[i] : __fmaf_rn(v, mix_factor[i], acc);
  }
  samples[s * B + b] = acc * (active[s] ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kSpatialThreads) audio_spatialise_kernel(
    const float* __restrict__ samples, const float* __restrict__ lp_state,
    const float* __restrict__ alpha, const uint8_t* __restrict__ use_lp,
    const uint8_t* __restrict__ spatial, const float* __restrict__ hist,
    const float* __restrict__ bank, const int* __restrict__ dir_idx,
    const float* __restrict__ prev_gl, const float* __restrict__ prev_gr,
    const float* __restrict__ gl, const float* __restrict__ gr, const float* __restrict__ ramp,
    const float* __restrict__ gain, const float* __restrict__ send_gain,
    float* __restrict__ wl, float* __restrict__ wr, float* __restrict__ ws,
    float* __restrict__ lp_out, float* __restrict__ new_hist, float* __restrict__ level,
    int B, int T, int use_hrtf) {
  __shared__ float xs[kMaxBlock + kMaxTaps - 1];  // [history | block]
  __shared__ float hs[2 * kMaxTaps];
  __shared__ float red[kSpatialThreads];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int H = T - 1;
  for (int i = tid; i < H; i += blockDim.x) xs[i] = hist[s * H + i];
  for (int b = tid; b < B; b += blockDim.x) xs[H + b] = samples[s * B + b];
  if (use_hrtf) {
    const float* h = bank + static_cast<long long>(dir_idx[s]) * 2 * T;
    for (int k = tid; k < 2 * T; k += blockDim.x) hs[k] = h[k];
  }
  __syncthreads();
  if (tid == 0) {
    // y[n] = (1 - a) y[n-1] + a x[n]; the last y is kept either way.
    const float al = alpha[s];
    const float a = 1.0f - al;
    const bool lp = use_lp[s] != 0;
    float y = lp_state[s];
    for (int b = 0; b < B; ++b) {
      y = __fmaf_rn(a, y, al * xs[H + b]);
      if (lp) xs[H + b] = y;
    }
    lp_out[s] = y;
  }
  __syncthreads();
  const bool sp = spatial[s] != 0;
  const float pgl = prev_gl[s], pgr = prev_gr[s];
  const float dgl = gl[s] - pgl, dgr = gr[s] - pgr;
  const float sg = send_gain != nullptr ? send_gain[s] : 0.0f;
  float peak = 0.0f;
  for (int b = tid; b < B; b += blockDim.x) {
    const float x = xs[H + b];
    peak = fmaxf(peak, fabsf(x));
    float sl = x, sr = x;
    if (use_hrtf && sp) {
      sl = xs[H + b] * hs[0];
      sr = xs[H + b] * hs[T];
      for (int k = 1; k < T; ++k) {
        const float xv = xs[H + b - k];
        sl = __fmaf_rn(xv, hs[k], sl);
        sr = __fmaf_rn(xv, hs[T + k], sr);
      }
    }
    const float r = ramp[b];
    wl[s * B + b] = __fmaf_rn(dgl, r, pgl) * sl;
    wr[s * B + b] = __fmaf_rn(dgr, r, pgr) * sr;
    if (ws != nullptr) ws[s * B + b] = x * sg;
  }
  for (int i = tid; i < H; i += blockDim.x)
    new_hist[s * H + i] = use_hrtf ? xs[B + i] : xs[i];
  red[tid] = peak;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] = fmaxf(red[tid], red[tid + w]);
    __syncthreads();
  }
  if (tid == 0) level[s] = red[0] * gain[s];
}

__device__ __forceinline__ float clip1(float x) { return fminf(fmaxf(x, -1.0f), 1.0f); }

__device__ __forceinline__ float column_sum(const float* __restrict__ a, int S, int B, int f) {
  float acc = a[f];
  for (int s = 1; s < S; ++s) acc = acc + a[s * B + f];
  return acc;
}

__global__ void audio_downmix_kernel(
    const float* __restrict__ wl, const float* __restrict__ wr, const float* __restrict__ ws,
    const float* __restrict__ master_volume, const float* __restrict__ lines_in,
    const int* __restrict__ write_idx, const int* __restrict__ delays,
    const float* __restrict__ feedback, const float* __restrict__ wet, float* __restrict__ out,
    float* __restrict__ lines_out, int* __restrict__ write_idx_out, int S, int B, int D,
    int has_room) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const float mv = *master_volume;
  if (!has_room) {
    if (t >= B) return;
    out[2 * t] = clip1(column_sum(wl, S, B, t) * mv);
    out[2 * t + 1] = clip1(column_sum(wr, S, B, t) * mv);
    return;
  }
  if (t >= D) return;
  const int w = *write_idx;
  if (t == 0) write_idx_out[0] = (w + B) % D;
  const int f = ((t - w) % D + D) % D;  // the frame that writes ring position t
  if (f >= B) {
#pragma unroll
    for (int l = 0; l < 4; ++l) lines_out[l * D + t] = lines_in[l * D + t];
    return;
  }
  const float left = column_sum(wl, S, B, f);
  const float right = column_sum(wr, S, B, f);
  const float send = column_sum(ws, S, B, f);
  float taps[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int r = ((w - delays[l] + f) % D + D) % D;
    taps[l] = lines_in[l * D + r];
  }
  // Householder mix (kernels/audio_mix.py:FDN_MIX) and the per-line send.
  const float fb = *feedback;
  const float m[4] = {
      ((0.5f * taps[0] + 0.5f * taps[1]) + 0.5f * taps[2]) + 0.5f * taps[3],
      ((0.5f * taps[0] + -0.5f * taps[1]) + 0.5f * taps[2]) + -0.5f * taps[3],
      ((0.5f * taps[0] + 0.5f * taps[1]) + -0.5f * taps[2]) + -0.5f * taps[3],
      ((0.5f * taps[0] + -0.5f * taps[1]) + -0.5f * taps[2]) + 0.5f * taps[3]};
  const float in_gain[4] = {1.0f, 0.8f, 0.6f, 0.5f};
#pragma unroll
  for (int l = 0; l < 4; ++l) lines_out[l * D + t] = __fmaf_rn(send, in_gain[l], m[l] * fb);
  const float wv = *wet;
  const float wet_l = (taps[0] + taps[2]) * wv;
  const float wet_r = (taps[1] + taps[3]) * wv;
  out[2 * f] = clip1(__fmaf_rn(wet_l, mv, left * mv));
  out[2 * f + 1] = clip1(__fmaf_rn(wet_r, mv, right * mv));
}

}  // namespace

extern "C" int audio_fetch(const float* pool, const int* buf_offset, const int* buf_len,
                           const float* playhead, const float* eff_delta,
                           const float* mix_factor, const uint8_t* looping,
                           const uint8_t* stream_mode, const float* stream_write_head,
                           const uint8_t* active, float* samples, float* new_playhead, int S,
                           int L, int B, int nw, int n_rows, float li_max, void* stream) {
  if (S > 0 && B > 0) {
    const int threads = 128;
    const dim3 grid((B + threads - 1) / threads, S);
    audio_fetch_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        pool, buf_offset, buf_len, playhead, eff_delta, mix_factor, looping, stream_mode,
        stream_write_head, active, samples, new_playhead, L, B, nw, n_rows, li_max);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int audio_spatialise(const float* samples, const float* lp_state, const float* alpha,
                                const uint8_t* use_lp, const uint8_t* spatial,
                                const float* hist, const float* bank, const int* dir_idx,
                                const float* prev_gl, const float* prev_gr, const float* gl,
                                const float* gr, const float* ramp, const float* gain,
                                const float* send_gain, float* wl, float* wr, float* ws,
                                float* lp_out, float* new_hist, float* level, int S, int B,
                                int T, int use_hrtf, void* stream) {
  if (B > kMaxBlock || T > kMaxTaps || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    audio_spatialise_kernel<<<S, kSpatialThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        samples, lp_state, alpha, use_lp, spatial, hist, bank, dir_idx, prev_gl, prev_gr, gl,
        gr, ramp, gain, send_gain, wl, wr, ws, lp_out, new_hist, level, B, T, use_hrtf);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int audio_downmix_reverb(const float* wl, const float* wr, const float* ws,
                                    const float* master_volume, const float* lines_in,
                                    const int* write_idx, const int* delays,
                                    const float* feedback, const float* wet, float* out,
                                    float* lines_out, int* write_idx_out, int S, int B, int D,
                                    int has_room, void* stream) {
  if (S < 1 || (has_room && B > D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = has_room ? D : B;
  if (n > 0) {
    const int threads = 128;
    audio_downmix_kernel<<<(n + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        wl, wr, ws, master_volume, lines_in, write_idx, delays, feedback, wet, out, lines_out,
        write_idx_out, S, B, D, has_room);
  }
  return static_cast<int>(cudaGetLastError());
}
