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
// KF audio_spatialise: one block per source.  Every global load is issued
//   first, together (the block's samples, four a thread; the history; the
//   HRIR pair; the ramp; the source's scalars).  The window [history |
//   block] goes to shared memory with frame 0 at a fixed 16-byte boundary,
//   and beside it alpha x[b], the low-pass's inputs.  One thread runs the
//   one-pole low-pass over the frames in order (the recurrence is serial):
//   it loads its inputs 16 at a time a batch ahead of their fmas and, with
//   the low-pass on, writes y 4 at a time into the window, which it never
//   reads, so its chain is B dependent fmas (~2 us at B = 800), not a
//   shared-memory round trip a frame.  A source without the low-pass runs
//   its FIR beside the chain.  Each thread takes a run of 4 consecutive
//   frames of the 64-tap FIR per ear: one 16-byte load brings the 4 window
//   values entering at the next 4 taps, for all 4 frames of the run (a
//   warp's such loads are 512 contiguous bytes), two more the 4 taps'
//   coefficients, and the run's 8 chains hide the fma latency; the gain
//   ramps and the reverb send follow (16-byte stores where the rows
//   allow), and the level's max is a warp shuffle and one word a warp.
//   Thread 0 also writes KAA's epilogue from the level it computes: the
//   finished flag, the smoothed level and the alive mask (twin
//   audio_mix.py:audio_epilogue_plain; the reference's mix.py:320-323,
//   :434-444), its nine loads issued with the block's first ones.  The
//   epilogue is ~6 flops a source, far below a launch's floor, so it has
//   no launch of its own.
//   Bound: the FIR, 2 x 64 fmas per (source, frame): 52 MFLOP at the bench
//   shapes, ~0.8 us at 67 TFLOP/s float32; the bytes, ~3.4 MB, ~1.0 us.
// KG audio_downmix_reverb: the left, right and send sums of each frame over
//   its column of the [S, B] blocks, each folded in source order (the
//   twin's _index_sum: no tree, no atomics, so the result is the twin's to
//   the bit), then the 4-line FDN for that frame.  A block takes a tile of
//   kFrames = 16 frames: its 256 threads stage the tile's [S, 16] slices of
//   the three blocks in shared memory, 256 sources at a time, with
//   coalesced loads (a half-warp reads a row's 64 contiguous bytes; every
//   load of a chunk is in flight before any is folded), and 48 threads (one
//   per frame and sum) fold the chunk from shared memory.  16 frames give
//   50 blocks at B = 800 (the tick) and 16 at B = 256 (the client's render
//   blocks), where one thread per frame gave 7 and 2; a wider tile would
//   halve the blocks, a narrower one split the 32-byte sectors.  Then 16
//   threads run the FDN of the tile's frames.  Every line delay is >= the
//   block, but the longest (8191 samples) reads what frame b + 1 writes, so
//   the lines are read from one buffer and written to another: blocks past
//   the tiles copy the ring positions no frame writes.  The write index
//   stays on the card.  Bound: memory, ~2.7 MB read at the bench shapes,
//   ~0.8 us; the folds are S dependent adds a frame (~0.6 us at S = 256).
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

// KF's arguments, passed to the kernel by value.
struct SpatialiseArgs {
  const float *samples, *lp_state, *alpha;
  const uint8_t *use_lp, *spatial;
  const float *hist, *bank;
  const int* dir_idx;
  const float *prev_gl, *prev_gr, *gl, *gr, *ramp, *gain, *send_gain;
  float *wl, *wr, *ws, *lp_out, *new_hist, *level;
  int B, T, use_hrtf, vec4;
  // The folded epilogue: layer 0 of new_heads and buf_len at stride L,
  // the [S] fields, and its [2 S]-word buffer.
  const uint8_t *finished, *looping, *stream_mode, *active;
  const float* new_heads;
  const int* buf_len;
  const float* smoothed_level;
  const uint8_t *alive, *remove_on_finish;
  float* ep_out;
  int L;
};

constexpr int kRun = 4;                            // consecutive frames a thread's FIR takes
constexpr int kChainBatch = 16;                    // low-pass inputs loaded ahead of their fmas
constexpr int kChainThread = kSpatialThreads - 1;  // its FIR run starts at frame 1,020
constexpr int kFrameLoads = kMaxBlock / kSpatialThreads;
static_assert(kRun * kSpatialThreads >= kMaxBlock, "a FIR run for every frame");

// The one-pole low-pass y = fma(1 - alpha, y, alpha x[b]), frame by frame,
// by one thread.  Its inputs alpha x[b] are loaded 16 at a time, a batch
// ahead of their fmas, and with kStore the ys go 4 at a time into the
// window (16-byte aligned), which the chain never reads, so the dependent
// chain is the fmas alone.  Returns the last y.
template <bool kStore>
__device__ __forceinline__ float lowpass_chain(const float* bx, float* ys, int B, float y,
                                               float c) {
  const float4* in = reinterpret_cast<const float4*>(bx);
  float4* out = reinterpret_cast<float4*>(ys);
  float4 cur[kChainBatch / 4], nxt[kChainBatch / 4];
#pragma unroll
  for (int q = 0; q < kChainBatch / 4; ++q) cur[q] = in[q];
  int b = 0;
#pragma unroll 2
  for (; b + kChainBatch <= B; b += kChainBatch) {
#pragma unroll
    for (int q = 0; q < kChainBatch / 4; ++q) nxt[q] = in[(b + kChainBatch) / 4 + q];
#pragma unroll
    for (int q = 0; q < kChainBatch / 4; ++q) {
      float4 v;
      v.x = y = __fmaf_rn(c, y, cur[q].x);
      v.y = y = __fmaf_rn(c, y, cur[q].y);
      v.z = y = __fmaf_rn(c, y, cur[q].z);
      v.w = y = __fmaf_rn(c, y, cur[q].w);
      if (kStore) out[b / 4 + q] = v;
    }
#pragma unroll
    for (int q = 0; q < kChainBatch / 4; ++q) cur[q] = nxt[q];
  }
#pragma unroll
  for (int q = 0; q < kChainBatch / 4; ++q) {
    const float v[4] = {cur[q].x, cur[q].y, cur[q].z, cur[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (b + 4 * q + e < B) {
        y = __fmaf_rn(c, y, v[e]);
        if (kStore) ys[b + 4 * q + e] = y;
      }
    }
  }
  return y;
}

// Taps kc .. kc + n - 1 (n <= 4, kc a multiple of 4) of a FIR run whose
// frame r sits at run[r] (16-byte aligned): the 4 window values entering
// at taps kc + 1 .. kc + 4 come in one load, the 4 taps' coefficients in
// two, then the fmas run; w holds the run's window at tap kc and leaves
// holding it at tap kc + n.
__device__ __forceinline__ void fir_taps(const float* run, const float4* h4, int kc, int n,
                                         float w[kRun], float sl[kRun], float sr[kRun]) {
  const float4 e = *reinterpret_cast<const float4*>(run - kc - 4);
  const float4 ha = h4[kc / 2], hb = h4[kc / 2 + 1];
  const float enter[4] = {e.w, e.z, e.y, e.x};
  const float hl[4] = {ha.x, ha.z, hb.x, hb.z};
  const float hr[4] = {ha.y, ha.w, hb.y, hb.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < n) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        sl[r] = __fmaf_rn(w[r], hl[q], sl[r]);
        sr[r] = __fmaf_rn(w[r], hr[q], sr[r]);
      }
#pragma unroll
      for (int r = kRun - 1; r > 0; --r) w[r] = w[r - 1];
      w[0] = enter[q];
    }
  }
}

__global__ void __launch_bounds__(kSpatialThreads) audio_spatialise_kernel(
    const SpatialiseArgs a) {
  // The window [history | block]: frame 0 at the fixed, 16-byte aligned
  // word kMaxTaps of `win`, the history just before it.
  __shared__ __align__(16) float win[kMaxTaps + kMaxBlock];
  __shared__ __align__(16) float bx[kMaxBlock + kChainBatch];  // alpha x[b]
  __shared__ __align__(16) float2 hs[kMaxTaps];                // tap k: (left, right)
  __shared__ float s_peak[kSpatialThreads / 32];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, H = T - 1;
  float* const block = win + kMaxTaps;   // frame b at block[b]
  float* const xs = block - H;           // window index i at xs[i]
  // Every global load first, all in flight together.
  const float al = a.alpha[s];
  const bool lp = a.use_lp[s] != 0, sp = a.spatial[s] != 0;
  const float pgl = a.prev_gl[s], pgr = a.prev_gr[s];
  const float dgl = a.gl[s] - pgl, dgr = a.gr[s] - pgr;
  const float sg = a.send_gain != nullptr ? a.send_gain[s] : 0.0f;
  const int dir = a.use_hrtf ? a.dir_idx[s] : 0;
  // The epilogue's inputs, for thread 0, which writes the level: loads
  // only, no use before the level's reduction, so nothing here waits on
  // them (a compare right after a load would stall warp 0 before it
  // issues its samples' loads).
  uint8_t e_fin = 0, e_loop = 0, e_strm = 0, e_act = 0, e_alive = 0, e_rm = 0;
  float e_head = 0.0f, e_smooth = 0.0f;
  int e_len = 0;
  if (tid == 0) {
    e_fin = a.finished[s];
    e_loop = a.looping[s];
    e_strm = a.stream_mode[s];
    e_act = a.active[s];
    e_head = a.new_heads[static_cast<long long>(s) * a.L];
    e_len = a.buf_len[static_cast<long long>(s) * a.L];
    e_smooth = a.smoothed_level[s];
    e_alive = a.alive[s];
    e_rm = a.remove_on_finish[s];
  }
  float xin[kFrameLoads];
#pragma unroll
  for (int m = 0; m < kFrameLoads; ++m) {
    const int b = tid + kSpatialThreads * m;
    xin[m] = b < B ? a.samples[s * B + b] : 0.0f;
  }
  const float hv = tid < H ? a.hist[s * H + tid] : 0.0f;
  const int b0 = kRun * tid;
  float rp[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) rp[r] = a.ramp[min(b0 + r, B - 1)];
  if (a.use_hrtf && tid < T) {
    const float* h = a.bank + static_cast<long long>(dir) * 2 * T;
    hs[tid] = make_float2(h[tid], h[T + tid]);
  }
  if (tid < H) xs[tid] = hv;
#pragma unroll
  for (int m = 0; m < kFrameLoads; ++m) {
    const int b = tid + kSpatialThreads * m;
    if (b < B) {
      block[b] = xin[m];
      bx[b] = al * xin[m];
    }
  }
  __syncthreads();
  // The last thread runs the chain.  Without the low-pass the block's
  // signal is its input, so the FIR below runs beside the chain; with it,
  // the FIR waits for the filtered block.
  if (tid == kChainThread) {
    const float y0 = a.lp_state[s], c = 1.0f - al;
    a.lp_out[s] = lp ? lowpass_chain<true>(bx, block, B, y0, c)
                     : lowpass_chain<false>(bx, block, B, y0, c);
  }
  if (lp) __syncthreads();

  // The 64-tap FIR per ear over a run of kRun consecutive frames: each
  // window value loaded serves every frame of the run, and the run's
  // 2 x kRun chains are independent.  Each output keeps its twin's tap
  // order: tap 0's multiply (an fma onto -0, which rounds as the product,
  // zeros' signs included), then the fmas from k = 1.
  float peak = 0.0f;
  if (b0 < B) {
    const float* run = block + b0;
    const float4 xv = *reinterpret_cast<const float4*>(run);
    const float x[kRun] = {xv.x, xv.y, xv.z, xv.w};
    float sl[kRun], sr[kRun];
    if (a.use_hrtf && sp) {
      float w[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        w[r] = x[r];
        sl[r] = -0.0f;
        sr[r] = -0.0f;
      }
      const float4* h4 = reinterpret_cast<const float4*>(hs);
      int kc = 0;
      for (; kc + 4 <= T; kc += 4) fir_taps(run, h4, kc, 4, w, sl, sr);
      if (kc < T) fir_taps(run, h4, kc, T - kc, w, sl, sr);
    } else {
#pragma unroll
      for (int r = 0; r < kRun; ++r) sl[r] = sr[r] = x[r];
    }
    float ol[kRun], orr[kRun], os[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      ol[r] = __fmaf_rn(dgl, rp[r], pgl) * sl[r];
      orr[r] = __fmaf_rn(dgr, rp[r], pgr) * sr[r];
      os[r] = x[r] * sg;
      if (b0 + r < B) peak = fmaxf(peak, fabsf(x[r]));
    }
    const long long o = static_cast<long long>(s) * B + b0;
    if (a.vec4) {
      *reinterpret_cast<float4*>(a.wl + o) = make_float4(ol[0], ol[1], ol[2], ol[3]);
      *reinterpret_cast<float4*>(a.wr + o) = make_float4(orr[0], orr[1], orr[2], orr[3]);
      if (a.ws != nullptr)
        *reinterpret_cast<float4*>(a.ws + o) = make_float4(os[0], os[1], os[2], os[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (b0 + r < B) {
          a.wl[o + r] = ol[r];
          a.wr[o + r] = orr[r];
          if (a.ws != nullptr) a.ws[o + r] = os[r];
        }
      }
    }
  }
  if (tid < H) a.new_hist[s * H + tid] = a.use_hrtf ? xs[B + tid] : hv;
  // The level: a warp max by shuffles, one word a warp, one thread's max.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, o));
  if ((tid & 31) == 0) s_peak[tid >> 5] = peak;
  const float g = a.gain[s];
  __syncthreads();
  if (tid == 0) {
    float m = s_peak[0];
#pragma unroll
    for (int w = 1; w < kSpatialThreads / 32; ++w) m = fmaxf(m, s_peak[w]);
    const float level = m * g;
    a.level[s] = level;
    // audio_mix.py:audio_epilogue_plain: a non-looping source finishes
    // when layer 0 passes its end; the level meter; the alive mask.
    const bool fin = e_fin != 0 || (e_loop == 0 && e_strm == 0 && e_act != 0 &&
                                    e_head >= static_cast<float>(e_len) - 1.0f);
    const int S = gridDim.x;
    a.ep_out[s] = __fmaf_rn(level, 0.1f, e_smooth * 0.9f);
    bool* flags = reinterpret_cast<bool*>(a.ep_out + S);
    flags[s] = fin;
    flags[S + s] = e_alive != 0 && !(fin && e_rm != 0);
  }
}

__device__ __forceinline__ float clip1(float x) { return fminf(fmaxf(x, -1.0f), 1.0f); }

constexpr int kFrames = 16;          // frames a downmix tile
constexpr int kChunk = 256;          // sources staged at a time
constexpr int kMixThreads = 256;
constexpr int kCopyPer = 8;          // ring positions a copying thread

// The downmix's dynamic shared memory: the staged [3, kChunk, kFrames]
// slices (each padded by half a bank row, so the two sums a warp folds
// read different banks), then the tile's three sums.
constexpr int kStageStride = kChunk * kFrames + kFrames;
constexpr int kMixSmem = (3 * kStageStride + 3 * kFrames) * sizeof(float);

__global__ void __launch_bounds__(kMixThreads) audio_downmix_kernel(
    const float* __restrict__ wl, const float* __restrict__ wr, const float* __restrict__ ws,
    const float* __restrict__ master_volume, const float* __restrict__ lines_in,
    const int* __restrict__ write_idx, const int* __restrict__ delays,
    const float* __restrict__ feedback, const float* __restrict__ wet, float* __restrict__ out,
    float* __restrict__ lines_out, int* __restrict__ write_idx_out, int S, int B, int D,
    int has_room, int n_tiles) {
  extern __shared__ float smem[];
  float* stage = smem;                              // [3][kStageStride]
  float* sums = smem + 3 * kStageStride;            // [3][kFrames]
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= n_tiles) {
    // The ring positions no frame of this block writes, carried over.
    const int w = *write_idx;
    const int base = (blockIdx.x - n_tiles) * kMixThreads * kCopyPer;
#pragma unroll
    for (int k = 0; k < kCopyPer; ++k) {
      const int idx = base + k * kMixThreads + tid;
      if (idx >= 4 * D) break;
      const int t = idx % D;
      if (((t - w) % D + D) % D >= B) lines_out[idx] = lines_in[idx];
    }
    return;
  }
  const int f0 = blockIdx.x * kFrames;
  const int n_sums = has_room ? 3 : 2;
  const float* src[3] = {wl, wr, ws};
  // Folding thread tid < n_sums * kFrames: sum x = tid / kFrames of frame
  // f0 + tid % kFrames.
  const int fx = tid / kFrames, ff = tid % kFrames;
  const bool folds = tid < n_sums * kFrames && f0 + ff < B;
  float acc = 0.0f;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int cs = min(kChunk, S - s0);
    // Thread tid stages frame f0 + tid % kFrames of rows tid / kFrames,
    // + 16, ... of each sum: 3 x kChunk / 16 loads, all in flight before the
    // barrier.
    const int frame = f0 + ff;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      if (x < n_sums) {
        const float* a = src[x];
#pragma unroll 16
        for (int s = tid / kFrames; s < cs; s += kMixThreads / kFrames)
          stage[x * kStageStride + s * kFrames + ff] =
              frame < B ? a[static_cast<size_t>(s0 + s) * B + frame] : 0.0f;
      }
    }
    __syncthreads();
    if (folds) {
      const float* col = stage + fx * kStageStride + ff;
      int s = 0;
      if (s0 == 0) {
        acc = col[0];
        s = 1;
      }
#pragma unroll 16
      for (; s < cs; ++s) acc = acc + col[s * kFrames];
    }
    __syncthreads();
  }
  if (folds) sums[fx * kFrames + ff] = acc;
  __syncthreads();
  if (tid >= kFrames || f0 + tid >= B) return;
  const int f = f0 + tid;
  const float mv = *master_volume;
  const float left = sums[tid], right = sums[kFrames + tid];
  if (!has_room) {
    out[2 * f] = clip1(left * mv);
    out[2 * f + 1] = clip1(right * mv);
    return;
  }
  const int w = *write_idx;
  if (f == 0) write_idx_out[0] = (w + B) % D;
  const float send = sums[2 * kFrames + tid];
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
  const int t = (w + f) % D;                      // the ring position frame f writes
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
                                int T, int use_hrtf, const uint8_t* finished,
                                const uint8_t* looping, const uint8_t* stream_mode,
                                const uint8_t* active, const float* new_heads,
                                const int* buf_len, const float* smoothed_level,
                                const uint8_t* alive, const uint8_t* remove_on_finish,
                                float* ep_out, int L, void* stream) {
  if (B < 1 || B > kMaxBlock || T > kMaxTaps || T < 1 || ep_out == nullptr || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(wl) | reinterpret_cast<uintptr_t>(wr) |
                          reinterpret_cast<uintptr_t>(ws);
  const SpatialiseArgs a{samples, lp_state, alpha, use_lp, spatial, hist, bank, dir_idx,
                         prev_gl, prev_gr, gl, gr, ramp, gain, send_gain,
                         wl, wr, ws, lp_out, new_hist, level,
                         B, T, use_hrtf, (B % kRun == 0) && (bases % 16 == 0),
                         finished, looping, stream_mode, active, new_heads, buf_len,
                         smoothed_level, alive, remove_on_finish, ep_out, L};
  if (S > 0) {
    audio_spatialise_kernel<<<S, kSpatialThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/audio_mix.py:_DOWNMIX_PACK): wl, wr, ws, master_volume, lines,
// write_idx, delays, feedback, wet (0 without a room), out, lines_out,
// write_idx_out, S, B, D, has_room.
extern "C" int audio_downmix_reverb(const long long* a, void* stream) {
  auto p = [a](int k) { return reinterpret_cast<const float*>(a[k]); };
  const int S = static_cast<int>(a[12]), B = static_cast<int>(a[13]), D = static_cast<int>(a[14]);
  const int has_room = static_cast<int>(a[15]);
  if (S < 1 || B < 1 || (has_room && B > D)) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        audio_downmix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMixSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int n_tiles = (B + kFrames - 1) / kFrames;
  const int n_copy = has_room ? (4 * D + kMixThreads * kCopyPer - 1) / (kMixThreads * kCopyPer) : 0;
  audio_downmix_kernel<<<n_tiles + n_copy, kMixThreads, kMixSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      p(0), p(1), p(2), p(3), p(4), reinterpret_cast<const int*>(a[5]),
      reinterpret_cast<const int*>(a[6]), p(7), p(8), reinterpret_cast<float*>(a[9]),
      reinterpret_cast<float*>(a[10]), reinterpret_cast<int*>(a[11]), S, B, D, has_room, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
