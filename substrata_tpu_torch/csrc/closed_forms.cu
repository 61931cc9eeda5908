// KK: sphere, box and capsule closed-form contacts for every closed-form
// bucket of a step, in one launch.
//
// Replaces substrata_tpu/physics/narrowphase.py:_CLOSED_FORM_KERNELS (:564-583)
// over the combo-code buckets, with the epilogue of pair_contacts (:729-775);
// plain twin: substrata_tpu_torch/kernels/closed_forms.py:closed_form_rows_plain.
//
// The bucket table (kernels/closed_forms.py:_Plan: each bucket's first
// block, and its code, width, slots and the offsets of its slots, rows and
// touching flags) rides in the launch's parameters, a record a bucket, so
// a block's first reads are the list of first blocks and its bucket's
// record, from the constant cache (a table in device memory put a
// dependent load round before the slots' loads).  Each block serves one
// bucket, so a
// warp never diverges on the combo code; grid = the sum over buckets of
// ceil(slots / 128).  A thread is a bucket slot.  A warp groups its slots
// by (a, b) (the intersection of __match_any_sync on a and on b: two
// 32-bit matches cost less than one on the 64-bit pair) and computes each
// distinct pair's manifold once: the group's lowest lane runs the closed
// form from closed_forms.cuh and the others take its live slots by
// shuffles (slot 0 and the normal; slot 1 too for the capsule-box codes;
// none where every slot of the warp is a pair of its own).  The epilogue stays
// per slot (the pv gate, the prune, a = -1 on empty blocked slots, the
// key, friction and restitution from the slot's own bodies, touching):
// write_rows, on each lane's own copy of the manifold.
//
// What bounds it on the card: the dependent chain of the capsule-box search
// (~1,600 float operations per distinct pair; a warp with a dozen distinct
// pairs runs them side by side in one chain's time) where buckets are
// nearly empty, bytes (~60 operations per 186 bytes) where they are full of
// point contacts, and a launch's fixed cost, which one launch a step pays
// once for every bucket.
#include <cstring>

#include "closed_forms.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBuckets = 8;   // a bucket a closed-form code at most
constexpr unsigned kFull = 0xffffffffu;

// One bucket's record (kernels/closed_forms.py:_BUCKET).
struct Bucket {
  long long in_off;
  long long row_off;
  long long touch_off;
  int code;
  int wm;
  int first;
  int slots;
};

struct Args {
  const int* ba;
  const int* bb;
  const bool* bvalid;
  const float* pos;
  const float* quat;
  const float* params;
  const float* fric;
  const float* rest;
  const bool* sensor;
  int* o_a;
  int* o_b;
  float* o_point;
  float* o_normal;
  float* o_pen;
  bool* o_valid;
  float* o_fric;
  float* o_rest;
  int* o_key;
  bool* o_touch;
  int blocked;
  int n_buckets;
  int first[kMaxBuckets];
  Bucket bucket[kMaxBuckets];
};

__device__ __forceinline__ void load_body(const float* __restrict__ pos,
                                          const float* __restrict__ quat,
                                          const float* __restrict__ params, int i, float p[3],
                                          float q[4], float pr[4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = pos[i * 3 + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] = quat[i * 4 + k];
    pr[k] = params[i * 4 + k];
  }
}

// The manifold's empty slots, as closed_forms.cuh:one_point leaves them:
// slots 2-3 for every closed form, slot 1 too but for the capsule-box
// codes (6, 9), whose slot 1 is the deeper endpoint.
__device__ __forceinline__ void empty_slots(sbt::Manifold& m, int first) {
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    if (s < first) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k) m.pts[s][k] = 0.0f;
    m.pens[s] = -1e9f;
    m.valid[s] = false;
  }
}

// Every lane takes lane ``src``'s manifold: slot 0 and the normal, and
// slot 1 where ``two`` (the capsule-box codes); the empty slots it holds
// already.
__device__ __forceinline__ void shuffle_manifold(sbt::Manifold& m, int src, bool two) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m.pts[0][k] = __shfl_sync(kFull, m.pts[0][k], src);
    m.n[k] = __shfl_sync(kFull, m.n[k], src);
  }
  m.pens[0] = __shfl_sync(kFull, m.pens[0], src);
  const int got = __shfl_sync(kFull, (m.valid[0] ? 1 : 0) | (m.valid[1] ? 2 : 0), src);
  m.valid[0] = got & 1;
  if (two) {
#pragma unroll
    for (int k = 0; k < 3; ++k) m.pts[1][k] = __shfl_sync(kFull, m.pts[1][k], src);
    m.pens[1] = __shfl_sync(kFull, m.pens[1], src);
    m.valid[1] = (got >> 1) & 1;
  }
}

__global__ void __launch_bounds__(kThreads) closed_form_buckets_kernel(const Args g) {
  // The block's bucket: the last whose first block is at or below it.
  const int bid = static_cast<int>(blockIdx.x);
  int k = g.n_buckets - 1;
  while (k > 0 && bid < g.first[k]) --k;
  const Bucket& bk = g.bucket[k];
  const int code = bk.code, wm = bk.wm;
  const long long in_off = bk.in_off, row_off = bk.row_off, touch_off = bk.touch_off;
  const int p = (bid - bk.first) * kThreads + static_cast<int>(threadIdx.x);
  const bool in = p < bk.slots;
  int a = -1, b = -1;
  bool pv = false;
  if (in) {
    a = g.ba[in_off + p];
    b = g.bb[in_off + p];
    pv = g.bvalid[in_off + p];
  }
  // The lanes holding this lane's (a, b); slots past the bucket (-1, -1)
  // group among themselves and compute nothing.
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(__match_any_sync(kFull, a) & __match_any_sync(kFull, b)) - 1;
  const unsigned live = __ballot_sync(kFull, in);
  const unsigned leaders = __ballot_sync(kFull, in && lane == leader);
  const bool two = code == 6 || code == 9;
  sbt::Manifold m;
  empty_slots(m, two ? 2 : 1);
  if (in && lane == leader) {
    float pa[3], qa[4], pra[4], pb[3], qb[4], prb[4];
    load_body(g.pos, g.quat, g.params, a, pa, qa, pra);
    load_body(g.pos, g.quat, g.params, b, pb, qb, prb);
    sbt::closed_form(code, pa, qa, pra, pb, qb, prb, m);
  }
  if (leaders != live) shuffle_manifold(m, leader, two);
  if (!in) return;
  // write_rows with the block's width as a constant: its loop over the
  // rows unrolls and the manifold stays in registers (a width read at run
  // time puts it in local memory, and every shuffle above through it).
#define KK_WRITE(W)                                                                          \
  sbt::write_rows(m, p, pv, a, b, W, g.blocked, g.fric, g.rest, g.sensor, g.o_a + row_off,   \
                  g.o_b + row_off, g.o_point + 3 * row_off, g.o_normal + 3 * row_off,        \
                  g.o_pen + row_off, g.o_valid + row_off, g.o_fric + row_off,                \
                  g.o_rest + row_off, g.o_key + row_off, g.o_touch + touch_off)
  switch (wm) {
    case 1: KK_WRITE(1); break;
    case 2: KK_WRITE(2); break;
    case 3: KK_WRITE(3); break;
    default: KK_WRITE(4); break;
  }
#undef KK_WRITE
}

}  // namespace

// One host buffer (kernels/closed_forms.py:_PACK, then _Plan.table): int64 words
// ba, bb, bvalid, pos, quat, params, fric, rest, sensor, out a, b, point,
// normal, pen, valid, fric, rest, key, touch; blocked, the number of
// buckets and of blocks; then the first blocks and the buckets' records
// (Args::first, Args::bucket).
extern "C" int closed_form_buckets(const long long* s, void* stream) {
  Args g;
  g.ba = reinterpret_cast<const int*>(s[0]);
  g.bb = reinterpret_cast<const int*>(s[1]);
  g.bvalid = reinterpret_cast<const bool*>(s[2]);
  g.pos = reinterpret_cast<const float*>(s[3]);
  g.quat = reinterpret_cast<const float*>(s[4]);
  g.params = reinterpret_cast<const float*>(s[5]);
  g.fric = reinterpret_cast<const float*>(s[6]);
  g.rest = reinterpret_cast<const float*>(s[7]);
  g.sensor = reinterpret_cast<const bool*>(s[8]);
  g.o_a = reinterpret_cast<int*>(s[9]);
  g.o_b = reinterpret_cast<int*>(s[10]);
  g.o_point = reinterpret_cast<float*>(s[11]);
  g.o_normal = reinterpret_cast<float*>(s[12]);
  g.o_pen = reinterpret_cast<float*>(s[13]);
  g.o_valid = reinterpret_cast<bool*>(s[14]);
  g.o_fric = reinterpret_cast<float*>(s[15]);
  g.o_rest = reinterpret_cast<float*>(s[16]);
  g.o_key = reinterpret_cast<int*>(s[17]);
  g.o_touch = reinterpret_cast<bool*>(s[18]);
  g.blocked = static_cast<int>(s[19]);
  const long long n_buckets = s[20], blocks = s[21];
  if (n_buckets < 1 || n_buckets > kMaxBuckets || blocks < 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  g.n_buckets = static_cast<int>(n_buckets);
  const char* table = reinterpret_cast<const char*>(s + 22);
  memcpy(g.first, table, sizeof g.first);
  memcpy(g.bucket, table + sizeof g.first, sizeof g.bucket);
  if (blocks > 0) {
    closed_form_buckets_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}
