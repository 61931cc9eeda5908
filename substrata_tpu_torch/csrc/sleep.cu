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
//
// Sleep pass, one launch: G = min(CPB, 32) lanes a body (rounded up to a
// power of two; 32 / G bodies a warp), lane s taking incidence slots s, s +
// G, ...  A lane issues each level of its slot's chain at once: the table
// entry and its sign; the entry's wm rows' valid, impulse and penetration
// with both its bodies; then the counterpart's speeds and awake flag.  The
// body's own state and its static rows (split over the same lanes) load
// before any of it.  The slots' wake and deep tests are OR-ed over the
// body's lanes by one segment of a warp ballot, and the body's first lane
// runs the timer, the kinematic rule, the velocity zeroing, newly_awake /
// newly_asleep and the fast-wake flags.  Each block adds its flags and its
// ticket to the plan's word in one atomic; the last block writes
// steps_left = 0 after a fast wake (steps_left otherwise) and sets the word
// back to zero, so a call needs no memset, no fence and no tail launch.  Maxima propagate
// NaN as torch.max does.  Booleans and timers are exact; the thresholds
// square in float32, as the twin does.
//
// What bounds it: latency (a few hundred KB at the bench shapes: three
// dependent rounds of loads a slot).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
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

constexpr int kMaxWm = 8;   // kernels/sleep.py:MAX_WM

// The sleep pass's arguments (kernels/sleep.py:_PACK): the inputs, the
// plan's 64-bit ticket (zero between launches) and one output buffer: timer
// [N] f32, linvel and angvel [N, 3] f32, steps_left i32, then awake,
// newly_awake, newly_asleep [N] bool.
struct SleepArgs {
  const bool* awake;
  const bool* prev_awake;
  const float* timer;
  const bool* alive;
  const int* motion;
  const float* linvel;
  const float* angvel;
  const int* ca;
  const int* cb;
  const bool* cvalid;
  const float* cpen;
  const float* lam;
  const bool* s_valid;
  const float* s_pen;
  const int* table;
  const float* sign;
  const float* sleep_lin;
  const float* sleep_ang;
  const float* sleep_time;
  const int* steps_in;
  unsigned long long* ticket;
  char* out;
  long long ls;                  // lambda's stride between rows
  int n, wm, K, cpb, g_shift;    // G = 1 << g_shift lanes a body
  float dt;
};

__global__ void __launch_bounds__(kThreads) sleep_pass_kernel(const SleepArgs a) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int G = 1 << a.g_shift;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const int n = a.n, cpb = a.cpb, wm = a.wm, K = a.K;
  const int i = static_cast<int>(gt >> a.g_shift);
  const int o = static_cast<int>(gt & (G - 1));   // this lane's first slot
  const bool body = i < n;
  // Every load that waits on nothing, issued together: the thresholds,
  // the body's own state, its first table slot and static row on this
  // lane, and (thread 0) steps_left.
  const float slv = *a.sleep_lin, sav = *a.sleep_ang, stime = *a.sleep_time;
  const int steps_in = tid == 0 ? *a.steps_in : 0;
  float lin[3] = {0.0f, 0.0f, 0.0f}, ang[3] = {0.0f, 0.0f, 0.0f}, tm = 0.0f;
  bool aw = false, pa = false, al = false, sv = false;
  int mt = 0, t = -1;
  float sg = 0.0f, sp = 0.0f;
  if (body) {
    if (o < cpb) {
      t = a.table[static_cast<long long>(i) * cpb + o];
      sg = a.sign[static_cast<long long>(i) * cpb + o];
    }
    if (o < K) {
      sv = a.s_valid[static_cast<long long>(i) * K + o];
      sp = a.s_pen[static_cast<long long>(i) * K + o];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lin[c] = a.linvel[i * 3 + c];
      ang[c] = a.angvel[i * 3 + c];
    }
    aw = a.awake[i];
    pa = a.prev_awake[i];
    al = a.alive[i];
    mt = a.motion[i];
    tm = a.timer[i];
  }
  const float slv2 = slv * slv, sav2 = sav * sav;
  const float fast_l = 4.0f * slv2, fast_a = 4.0f * sav2;
  bool wake = false, deep = false;
  for (int s = o; body && s < cpb; s += G) {
    if (s != o) {
      const long long slot = static_cast<long long>(i) * cpb + s;
      t = a.table[slot];
      sg = a.sign[slot];
    }
    if (t < 0) continue;
    // The entry's wm rows and both its bodies, every load issued at once.
    bool v[kMaxWm];
    float l[kMaxWm], p[kMaxWm];
#pragma unroll
    for (int j = 0; j < kMaxWm; ++j) {
      if (j < wm) {
        const long long r = static_cast<long long>(t) * wm + j;
        v[j] = a.cvalid[r];
        l[j] = a.lam[r * a.ls];
        p[j] = a.cpen[r];
      }
    }
    // The counterpart: entry b's first row where this body is a, else a's.
    const int other = (sg > 0.0f ? a.cb : a.ca)[static_cast<long long>(t) * wm];
    bool e_valid = false;
    float e_imp = 0.0f, e_pen = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxWm; ++j) {
      if (j < wm) {
        e_valid = e_valid || v[j];
        const float li = v[j] ? l[j] : 0.0f;
        const float pi = v[j] ? p[j] : -1e9f;
        e_imp = j == 0 ? li : max_nan(e_imp, li);
        e_pen = j == 0 ? pi : max_nan(e_pen, pi);
      }
    }
    bool other_active = false, other_fast = false;
    if (other >= 0) {
      const float ol = len2(a.linvel, other), oa = len2(a.angvel, other);
      const bool ow = a.awake[other];
      other_active = ow && !((ol < slv2) && (oa < sav2));
      other_fast = ow && ((ol > fast_l) || (oa > fast_a));
    }
    wake = wake || (e_valid && e_imp > 1e-4f && other_active) || (e_valid && other_fast);
    deep = deep || (e_valid && e_pen > 0.1f);
  }
  // The static rows: the first on this lane loaded above, the rest (K > G).
  deep = deep || (sv && sp > 0.1f);
  for (int k = o + G; body && k < K; k += G) {
    const long long r = static_cast<long long>(i) * K + k;
    const bool v = a.s_valid[r];
    const float pen = a.s_pen[r];
    deep = deep || (v && pen > 0.1f);
  }
  // The body's G lanes: one segment of the warp's ballots.
  const unsigned seg = G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  const bool wake_hit = (__ballot_sync(kFull, wake) & seg) != 0u;
  const bool body_deep = (__ballot_sync(kFull, deep) & seg) != 0u;
  bool fast_w = false, nan_w = false;
  if (body && o == 0) {
    const float lin2 = (lin[0] * lin[0] + lin[1] * lin[1]) + lin[2] * lin[2];
    const float ang2 = (ang[0] * ang[0] + ang[1] * ang[1]) + ang[2] * ang[2];
    const bool slow = (lin2 < slv2) && (ang2 < sav2);
    const bool dyn = mt == kDynamic && al;
    const float new_timer = (slow && !wake_hit && !body_deep) ? tm + a.dt : 0.0f;
    const bool asleep = dyn && (new_timer > stime);
    const bool woken = dyn && !aw && wake_hit;
    bool new_awake = dyn ? (!asleep && (aw || woken)) : aw;
    if (al && mt == kKinematic) new_awake = (lin2 + ang2) > 1e-10f;
    const bool sleeping = dyn && !new_awake;
    float* o_timer = reinterpret_cast<float*>(a.out);
    float* o_lin = o_timer + n;
    float* o_ang = o_lin + 3 * static_cast<long long>(n);
    bool* o_awake = reinterpret_cast<bool*>(a.out) + 28LL * n + 4;
    float lv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lv[c] = sleeping ? 0.0f : lin[c];
      o_lin[i * 3 + c] = lv[c];
      o_ang[i * 3 + c] = sleeping ? 0.0f : ang[c];
    }
    o_timer[i] = new_timer;
    const bool na = new_awake && !pa;
    o_awake[i] = new_awake;
    o_awake[n + i] = na;
    o_awake[2LL * n + i] = pa && !new_awake;
    if (na) {
      const float speed = sqrtf((lv[0] * lv[0] + lv[1] * lv[1]) + lv[2] * lv[2]);
      nan_w = speed != speed;
      fast_w = !nan_w && speed > 1.0f;
    }
  }
  // The fast-wake flags: one OR a block, added with the block's ticket in
  // one 64-bit atomic (bits 0-23 the blocks done, 24-43 the blocks with a
  // fast wake, 44-63 those with a NaN one); the block that finds itself last
  // writes steps_left and sets the word back to zero for the next call.
  const int any_fast = __syncthreads_or(fast_w);
  const int any_nan = __syncthreads_or(nan_w);
  if (tid == 0) {
    const unsigned long long mine = 1ull | (any_fast ? 1ull << 24 : 0ull) |
                                    (any_nan ? 1ull << 44 : 0ull);
    const unsigned long long seen = atomicAdd(a.ticket, mine) + mine;
    if ((seen & 0xffffffull) == gridDim.x) {
      const bool fast = ((seen >> 24) & 0xfffffull) != 0, nan = (seen >> 44) != 0;
      // torch.max over the woken speeds is NaN if any is, and NaN > 1 is false.
      *reinterpret_cast<int*>(a.out + 28LL * n) = (fast && !nan) ? 0 : steps_in;
      *a.ticket = 0ull;
    }
  }
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

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/sleep.py:_PACK): SleepArgs' 22 pointers in order, lambda's row
// stride, N, wm, K, CPB, log2 of the lanes a body, dt as a double.
extern "C" int sleep_pass(const long long* v, void* stream) {
  auto ptr = [v](int k) { return reinterpret_cast<void*>(v[k]); };
  SleepArgs a;
  a.awake = static_cast<const bool*>(ptr(0));
  a.prev_awake = static_cast<const bool*>(ptr(1));
  a.timer = static_cast<const float*>(ptr(2));
  a.alive = static_cast<const bool*>(ptr(3));
  a.motion = static_cast<const int*>(ptr(4));
  a.linvel = static_cast<const float*>(ptr(5));
  a.angvel = static_cast<const float*>(ptr(6));
  a.ca = static_cast<const int*>(ptr(7));
  a.cb = static_cast<const int*>(ptr(8));
  a.cvalid = static_cast<const bool*>(ptr(9));
  a.cpen = static_cast<const float*>(ptr(10));
  a.lam = static_cast<const float*>(ptr(11));
  a.s_valid = static_cast<const bool*>(ptr(12));
  a.s_pen = static_cast<const float*>(ptr(13));
  a.table = static_cast<const int*>(ptr(14));
  a.sign = static_cast<const float*>(ptr(15));
  a.sleep_lin = static_cast<const float*>(ptr(16));
  a.sleep_ang = static_cast<const float*>(ptr(17));
  a.sleep_time = static_cast<const float*>(ptr(18));
  a.steps_in = static_cast<const int*>(ptr(19));
  a.ticket = static_cast<unsigned long long*>(ptr(20));
  a.out = static_cast<char*>(ptr(21));
  a.ls = v[22];
  a.n = static_cast<int>(v[23]);
  a.wm = static_cast<int>(v[24]);
  a.K = static_cast<int>(v[25]);
  a.cpb = static_cast<int>(v[26]);
  a.g_shift = static_cast<int>(v[27]);
  a.dt = static_cast<float>(*reinterpret_cast<const double*>(v + 28));
  if (a.n < 1 || a.wm < 1 || a.wm > kMaxWm || a.K < 0 || a.cpb < 0 || a.g_shift < 0 ||
      a.g_shift > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(a.n) << a.g_shift;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  // The ticket counts blocks in 24 bits and the flagged ones in 20.
  if (blocks >= (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  sleep_pass_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
