// Kernel KAD: one halo exchange phase of the spatially sharded step, every
// shard of a leading shard axis on one card, in one launch (K20c).
//
// Replaces substrata_tpu/parallel/spatial.py:halo_exchange (:97) with
// _pack_halo (:86), and _axis_exchange (:238) for the 2-D tiles; plain
// twin: substrata_tpu_torch/kernels/halo.py:exchange_plain.  The mesh axis
// of the reference becomes the shard index d; ppermute becomes a write into
// the neighbour's ghost block of the combined buffer.
//
// Layout: every BodyState field is a contiguous [S * rows_in] array of rows
// (``src``); the output is [S * (rows_in + 2H)] (``dst``): shard d's rows
// first (copied), then H rows received from its low neighbour, then H from
// its high one.  A field is moved as bytes, so one descriptor table of
// (src, dst, bytes per row) carries all 23 fields and their mixed types.
//
// Blocks (d, 0) and (d, 1) pack shard d's high and low boundary: the mask
// alive & (c > hi_thr[a]) (resp. c < lo_thr[a]) on the coordinate ``axis``;
// its count M (overflow[d, dir] = max(M - H, 0)), the thresholds taken at
// the shard's position along the axis; then a block-wide
// exclusive scan gives every row its place in the stable order that
// argsort(~mask) gives (masked rows first, then the rest, each in index
// order), and a row placed below H is copied into the receiver's ghost
// block, with alive and awake cleared when it is not masked.  A shard at the
// end of its axis line has no receiver on that side (ppermute's missing
// link); its block instead writes zeros, in every field, into the ghost
// block that nothing reaches: that of the shard at the other end of the
// line.  Blocks (d, 2..) copy shard d's own rows, in 32-bit words where a
// field's rows are whole words.  No atomics: every output byte has one
// writer, so the result equals the twin's bit for bit.
//
// What bounds it: bytes (each row read once or twice and written once or
// twice: 133 bytes a body row), ~1 MB a 10,000-body phase, ~0.4 us at
// 3.35 TB/s; the scan walks each shard's rows serially per block, so with
// few shards the launch, not the card, sets its time.
#include "common.cuh"

namespace {

constexpr int kMaxFields = 32;
constexpr int kMaxShards = 64;
constexpr int kThreads = 1024;
constexpr int kCopyBlocks = 16;

struct Fields {
  const char* src[kMaxFields];
  char* dst[kMaxFields];
  int bytes[kMaxFields];
  int n;
};

struct Edges {
  float lo[kMaxShards];
  float hi[kMaxShards];
};

__device__ __forceinline__ bool is_masked(const float* pos, const bool* alive, long row,
                                          int axis, int dir, float thr) {
  if (!alive[row]) return false;
  const float c = pos[row * 3 + axis];
  return dir == 0 ? c > thr : c < thr;
}

__device__ void copy_row(const Fields& f, long src_row, long dst_row) {
  for (int k = 0; k < f.n; ++k) {
    const int b = f.bytes[k];
    const char* s = f.src[k] + src_row * b;
    char* o = f.dst[k] + dst_row * b;
    for (int j = 0; j < b; ++j) o[j] = s[j];
  }
}

__global__ void __launch_bounds__(kThreads) halo_kernel(Fields f, Edges e, const float* pos,
                                                        const bool* alive, int alive_f,
                                                        int awake_f, int rows_in, int halo,
                                                        int axis, int stride, int n_axis,
                                                        int* overflow) {
  __shared__ int warp_tot[32];
  const int d = blockIdx.x;
  const int rows_out = rows_in + 2 * halo;
  const long base = static_cast<long>(d) * rows_in;

  if (blockIdx.y >= 2) {
    // Shard d's own rows, as one contiguous range of bytes per field.
    const int part = blockIdx.y - 2, parts = gridDim.y - 2;
    for (int k = 0; k < f.n; ++k) {
      const int b = f.bytes[k];
      const char* s = f.src[k] + base * b;
      char* o = f.dst[k] + static_cast<long>(d) * rows_out * b;
      if (b % 4 == 0) {
        const long words = static_cast<long>(rows_in) * (b / 4);
        const long lo = words * part / parts, hi = words * (part + 1) / parts;
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(s);
        uint32_t* ow = reinterpret_cast<uint32_t*>(o);
        for (long i = lo + threadIdx.x; i < hi; i += blockDim.x) ow[i] = sw[i];
      } else {
        const long n = static_cast<long>(rows_in) * b;
        const long lo = n * part / parts, hi = n * (part + 1) / parts;
        for (long i = lo + threadIdx.x; i < hi; i += blockDim.x) o[i] = s[i];
      }
    }
    return;
  }

  const int dir = blockIdx.y;  // 0: the high boundary, sent up; 1: the low one, sent down
  const int ap = (d / stride) % n_axis;
  const float thr = dir == 0 ? e.hi[ap] : e.lo[ap];
  const bool linked = dir == 0 ? ap < n_axis - 1 : ap > 0;
  const int recv = dir == 0 ? d + stride : d - stride;
  const long ghost0 = dir == 0 ? rows_in : rows_in + halo;  // the receiver's block

  // Pass 1: the masked count.
  int m = 0;
  for (int i = threadIdx.x; i < rows_in; i += blockDim.x)
    m += is_masked(pos, alive, base + i, axis, dir, thr) ? 1 : 0;
  const int total = sbt::block_sum(m, warp_tot);
  if (threadIdx.x == 0) overflow[d * 2 + dir] = max(total - halo, 0);

  if (!linked) {
    // The ghost block no neighbour fills: the other end of this axis line.
    const int zero_shard = dir == 0 ? d - (n_axis - 1) * stride : d + (n_axis - 1) * stride;
    const long row0 = static_cast<long>(zero_shard) * rows_out + ghost0;
    for (int k = 0; k < f.n; ++k) {
      const long n = static_cast<long>(halo) * f.bytes[k];
      char* o = f.dst[k] + row0 * f.bytes[k];
      for (long i = threadIdx.x; i < n; i += blockDim.x) o[i] = 0;
    }
    return;
  }

  // Pass 2: each row's place in the stable order; the first H rows go out.
  const long dst0 = static_cast<long>(recv) * rows_out + ghost0;
  int carry = 0;
  for (int c0 = 0; c0 < rows_in; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const bool in = i < rows_in;
    const bool mk = in && is_masked(pos, alive, base + i, axis, dir, thr);
    int chunk = 0;
    const int before = carry + sbt::block_exclusive_scan(mk ? 1 : 0, warp_tot, &chunk);
    if (in) {
      const int place = mk ? before : total + (i - before);
      if (place < halo) {
        copy_row(f, base + i, dst0 + place);
        if (!mk) {
          f.dst[alive_f][dst0 + place] = 0;
          f.dst[awake_f][dst0 + place] = 0;
        }
      }
    }
    carry += chunk;
  }
}

}  // namespace

// src, dst: host arrays of n_fields device pointers; bytes: host array of
// bytes per row; lo_thr, hi_thr: host arrays of n_axis float32
// thresholds, by position along the axis; overflow: device int32
// [n_shards, 2].
extern "C" int halo_exchange(const void* const* src, void* const* dst, const int* bytes,
                             int n_fields, const float* pos, const bool* alive, int alive_f,
                             int awake_f, const float* lo_thr, const float* hi_thr,
                             int n_shards, int rows_in, int halo, int axis, int stride,
                             int n_axis, int* overflow, void* stream) {
  if (n_fields > kMaxFields || n_axis > kMaxShards || halo > rows_in)
    return static_cast<int>(cudaErrorInvalidValue);
  Fields f;
  f.n = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    f.src[k] = static_cast<const char*>(src[k]);
    f.dst[k] = static_cast<char*>(dst[k]);
    f.bytes[k] = bytes[k];
  }
  Edges e;
  for (int a = 0; a < n_axis; ++a) {
    e.lo[a] = lo_thr[a];
    e.hi[a] = hi_thr[a];
  }
  const dim3 grid(n_shards, 2 + kCopyBlocks);
  halo_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, e, pos, alive, alive_f, awake_f, rows_in, halo, axis, stride, n_axis, overflow);
  return static_cast<int>(cudaGetLastError());
}
