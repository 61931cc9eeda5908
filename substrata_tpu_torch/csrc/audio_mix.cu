// KF, KG: the spatial audio mix of one block, as two launches after KAA's
// setup.
//
// Replace the device program substrata_tpu/audio/mix.py:mix_block (:276)
// with _fetch_all (:201); plain twins in
// substrata_tpu_torch/kernels/audio_mix.py (audio_fetch_plain chained into
// audio_spatialise_plain: fetch_spatialise_plain; audio_downmix_reverb_plain).
// Each kernel repeats its twin's float32 operations in the same order; a
// multiply-add is fused (__fmaf_rn) exactly where the twin calls
// maths/fp.py:fma, which is where the reference's compiler fuses it, and
// nowhere else (-fmad=false).
//
// KF audio_spatialise: one block per source, which fetches its own frames
//   (KE's work before, folded in: no [S, B] samples round trip through
//   device memory, no launch of its own).  Each of the 256 threads takes
//   frames b = tid + 256 m, m < 4, as the twin computes them: for each of
//   the L layers the wrapped playhead, the window row, the 16-sample chunk
//   and offset and the lerp weights, two pool loads (neighbouring frames
//   read neighbouring samples; only the ~ed x B samples the block reads,
//   not the reference's window of rows sized for DELTA_MAX), the range
//   mask; the layers summed in index order with their mix factors; the
//   active mask.  The [L] layers' scalars (the playhead's wrap, an fmodf,
//   and the window row) are computed once per block by lanes l < L into
//   shared memory behind one barrier (every thread computing them in
//   registers was slower on the card).  Every pool load of a thread, for
//   every frame and layer, is issued before the first lerp.  The kernel is
//   held to 64 registers a thread, so four blocks fit an SM and the
//   client's 512 sources run in one wave: the history, the HRIR pair and
//   the low-pass's coefficient are loaded with the layers', and what only
//   the FIR, the ramps and the epilogue read goes out behind the pool
//   loads, so it holds no registers across them.  Lanes l < L write layer
//   l's new playhead; thread 0 keeps layer 0's for the epilogue.  The
//   window [history | block] goes to shared memory with frame 0 at a fixed
//   16-byte boundary, and beside it alpha x[b], the low-pass's inputs.
//   One thread runs the one-pole low-pass over the frames in order (the recurrence is serial):
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
//   :434-444), its loads issued with the block's first ones.  The
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
#include <cstddef>
#include <cstring>

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

// KF's arguments (kernels/audio_mix.py:_SPATIALISE_PACK), passed to the
// kernel by value.
struct SpatialiseArgs {
  // The fetch: the pool and the [S, L] layers' fields, the [S] flags.
  const float* pool;
  const int *buf_offset, *buf_len;
  const float *playhead, *eff_delta, *mix_factor;
  const uint8_t *looping, *stream_mode;
  const float* stream_write_head;
  const uint8_t* active;
  // The spatialiser.
  const float *lp_state, *alpha;
  const uint8_t *use_lp, *spatial;
  const float *hist, *bank;
  const int* dir_idx;
  const float *prev_gl, *prev_gr, *gl, *gr, *ramp, *gain, *send_gain;
  // The folded epilogue's own [S] fields.
  const uint8_t* finished;
  const float* smoothed_level;
  const uint8_t *alive, *remove_on_finish;
  float *wl, *wr, *ws, *lp_out, *new_hist, *level, *ep_out, *new_playhead;
  int B, T, L, nw, n_rows, use_hrtf, vec4;
  float li_max;
};

constexpr int kMaxLayers = 3;   // the mix's layers (audio/mix.py:NUM_MIX_LAYERS)

// One (source, layer)'s fetch scalars: audio_mix.py:audio_fetch_plain's
// wrapped playhead and window row, in its order of operations.
struct LayerScalars {
  float ed, frac, off, ph, p, lenf, gain;
  int base;   // row0 << 7
};

__device__ __forceinline__ LayerScalars layer_scalars(const SpatialiseArgs& a, int i, bool wrap) {
  LayerScalars c;
  const int blen = a.buf_len[i];
  c.lenf = fmaxf(static_cast<float>(blen), 1.0f);
  c.p = a.playhead[i];
  c.ed = a.eff_delta[i];
  c.gain = a.mix_factor[i] * (blen > 0 ? 1.0f : 0.0f);
  float ph = wrap ? float_mod(c.p, c.lenf) : c.p;
  ph = fmaxf(ph, 0.0f);
  c.ph = ph;
  const int ph_int = static_cast<int>(floorf(ph));
  c.frac = ph - static_cast<float>(ph_int);
  const int start_i = a.buf_offset[i] + min(ph_int, max(blen - 1, 0));
  const int row0 = min(max(start_i >> 7, 0), a.n_rows - a.nw);
  c.base = row0 << 7;
  c.off = static_cast<float>(start_i - c.base);
  return c;
}

// A layer's playhead after the block (the reference's mix.py:268-270).
__device__ __forceinline__ float next_head(const LayerScalars& c, float blockf, bool loop,
                                           bool strm) {
  const float nh = __fmaf_rn(c.ed, blockf, c.p);
  return (loop && !strm) ? float_mod(nh, c.lenf) : nh;
}

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

// The in-window index arithmetic of one (layer, frame): the window
// position li, its 16-sample chunk qi and offset u, and u's floor k0.
struct Tap {
  float u, k0;
  int idx;
};

__device__ __forceinline__ Tap fetch_tap(const LayerScalars& c, float bf, float li_max) {
  float li = __fmaf_rn(c.ed, bf, c.frac) + c.off;
  li = fminf(fmaxf(li, 0.0f), li_max);
  const int qi = static_cast<int>(floorf(li * 0.0625f));
  Tap t;
  t.u = li - 16.0f * static_cast<float>(qi);
  t.k0 = floorf(t.u);
  t.idx = c.base + 16 * qi + static_cast<int>(t.k0);
  return t;
}

// The fetch of a thread's frames b = tid + 256 m of source s, as
// audio_mix.py:audio_fetch_plain computes them: for each layer the
// in-window position, its 16-sample chunk and offset, the lerp weights and
// the range mask; then the layers summed in index order with their gains,
// and the active mask.  Every pool load of every frame and layer is issued
// before the first lerp; the index arithmetic runs again for the lerp
// rather than holding its weights across the loads (registers, not time).
__device__ __forceinline__ void fetch_frames(const SpatialiseArgs& a, int tid,
                                             const LayerScalars (&c)[kMaxLayers], bool loop,
                                             bool strm, float swh, bool act,
                                             float (&xin)[kFrameLoads]) {
  const int L = a.L, B = a.B;
  float v0[kMaxLayers][kFrameLoads], v1[kMaxLayers][kFrameLoads];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
#pragma unroll
    for (int m = 0; m < kFrameLoads; ++m) {
      const int b = tid + kSpatialThreads * m;
      if (l < L && b < B) {
        const int idx = fetch_tap(c[l], static_cast<float>(b), a.li_max).idx;
        v0[l][m] = a.pool[idx];
        v1[l][m] = a.pool[idx + 1];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kFrameLoads; ++m) {
    const int b = tid + kSpatialThreads * m;
    const float bf = static_cast<float>(b);
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < L && b < B) {
        const Tap t = fetch_tap(c[l], bf, a.li_max);
        const float w0 = 1.0f - fabsf(t.u - t.k0);
        const float w1 = 1.0f - fabsf(t.u - (t.k0 + 1.0f));
        const bool in = strm ? __fmaf_rn(c[l].ed, bf, c[l].p) < swh - 1.0f
                             : (loop || __fmaf_rn(c[l].ed, bf, c[l].ph) < c[l].lenf - 1.0f);
        float v = __fmaf_rn(v1[l][m], w1, v0[l][m] * w0);
        v = v * (in ? 1.0f : 0.0f);
        acc = l == 0 ? v * c[l].gain : __fmaf_rn(v, c[l].gain, acc);
      }
    }
    xin[m] = b < B ? acc * (act ? 1.0f : 0.0f) : 0.0f;
  }
}

// Blocks an SM the register cap leaves room for: 4 x 256 threads at 64
// registers, one wave of the client's 512 sources on 132 SMs.
constexpr int kSpatialBlocksPerSm = 4;

__global__ void __launch_bounds__(kSpatialThreads, kSpatialBlocksPerSm) audio_spatialise_kernel(
    const SpatialiseArgs a) {
  // The window [history | block]: frame 0 at the fixed, 16-byte aligned
  // word kMaxTaps of `win`, the history just before it.
  __shared__ __align__(16) float win[kMaxTaps + kMaxBlock];
  __shared__ __align__(16) float bx[kMaxBlock + kChainBatch];  // alpha x[b]
  __shared__ __align__(16) float2 hs[kMaxTaps];                // tap k: (left, right)
  __shared__ float s_peak[kSpatialThreads / 32];
  __shared__ LayerScalars s_layer[kMaxLayers];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, H = T - 1, L = a.L;
  float* const block = win + kMaxTaps;   // frame b at block[b]
  float* const xs = block - H;           // window index i at xs[i]
  // The fetch's loads first, all in flight together: the source's flags
  // and layers (whose pool loads wait on them), the low-pass's coefficient,
  // the history and the HRIR pair.
  const bool loop = a.looping[s] != 0, strm = a.stream_mode[s] != 0, act = a.active[s] != 0;
  const float swh = a.stream_write_head[s];
  float head0 = 0.0f;
  if (tid < L) {
    const LayerScalars own = layer_scalars(a, s * L + tid, loop || strm);
    s_layer[tid] = own;
    const float nh = next_head(own, static_cast<float>(B), loop, strm);
    a.new_playhead[s * L + tid] = nh;
    head0 = nh;
  }
  const float al = a.alpha[s];
  const bool lp = a.use_lp[s] != 0;
  const int dir = a.use_hrtf ? a.dir_idx[s] : 0;
  const float hv = tid < H ? a.hist[s * H + tid] : 0.0f;
  if (a.use_hrtf && tid < T) {
    const float* h = a.bank + static_cast<long long>(dir) * 2 * T;
    hs[tid] = make_float2(h[tid], h[T + tid]);
  }
  if (tid < H) xs[tid] = hv;
  __syncthreads();
  LayerScalars c[kMaxLayers];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < L) c[l] = s_layer[l];
  }
  float xin[kFrameLoads];
  fetch_frames(a, tid, c, loop, strm, swh, act, xin);
  // What only the FIR, the ramps and the epilogue read: loaded behind the
  // pool loads, in flight through the barrier and the chain, so they hold
  // no registers across the fetch.
  const bool sp = a.spatial[s] != 0;
  const float pgl = a.prev_gl[s], pgr = a.prev_gr[s];
  const float dgl = a.gl[s] - pgl, dgr = a.gr[s] - pgr;
  const float sg = a.send_gain != nullptr ? a.send_gain[s] : 0.0f;
  const int b0 = kRun * tid;
  float rp[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) rp[r] = a.ramp[min(b0 + r, B - 1)];
  // The epilogue's own inputs, for thread 0, which writes the level.
  uint8_t e_fin = 0, e_alive = 0, e_rm = 0;
  float e_smooth = 0.0f;
  int e_len = 0;
  if (tid == 0) {
    e_fin = a.finished[s];
    e_len = a.buf_len[static_cast<long long>(s) * L];
    e_smooth = a.smoothed_level[s];
    e_alive = a.alive[s];
    e_rm = a.remove_on_finish[s];
  }
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
    const bool fin = e_fin != 0 || (!loop && !strm && act &&
                                    head0 >= static_cast<float>(e_len) - 1.0f);
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

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/audio_mix.py:_SPATIALISE_PACK): the fetch's pool, buf_offset,
// buf_len, playhead, eff_delta, mix_factor, looping, stream_mode,
// stream_write_head, active; lp_state, alpha, use_lp, spatial, hist, bank,
// dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain, send_gain (0: no send);
// the epilogue's finished, smoothed_level, alive, remove_on_finish; out
// wl, wr, ws, lp_out, new_hist, level, the epilogue's buffer,
// new_playhead; S, B, T, L, nw, n_rows, use_hrtf; li_max as a double.
extern "C" int audio_spatialise(const long long* v, void* stream) {
  SpatialiseArgs a;
  constexpr int kPtrs = 36;
  static_assert(offsetof(SpatialiseArgs, B) == kPtrs * sizeof(void*), "36 pointers first");
  memcpy(&a, v, kPtrs * sizeof(void*));
  const long long S = v[kPtrs];
  a.B = static_cast<int>(v[kPtrs + 1]);
  a.T = static_cast<int>(v[kPtrs + 2]);
  a.L = static_cast<int>(v[kPtrs + 3]);
  a.nw = static_cast<int>(v[kPtrs + 4]);
  a.n_rows = static_cast<int>(v[kPtrs + 5]);
  a.use_hrtf = static_cast<int>(v[kPtrs + 6]);
  double li_max;
  memcpy(&li_max, v + kPtrs + 7, sizeof(double));
  a.li_max = static_cast<float>(li_max);
  if (S < 0 || a.B < 1 || a.B > kMaxBlock || a.T > kMaxTaps || a.T < 1 || a.L < 1 ||
      a.L > kMaxLayers || a.nw < 1 || a.n_rows < a.nw)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.wl) | reinterpret_cast<uintptr_t>(a.wr) |
                          reinterpret_cast<uintptr_t>(a.ws);
  a.vec4 = (a.B % kRun == 0) && (bases % 16 == 0);
  if (S > 0) {
    audio_spatialise_kernel<<<static_cast<int>(S), kSpatialThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
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
