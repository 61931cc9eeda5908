// Kernel KR: Winter script evaluation (K16).
//
// Replaces the jitted batch evaluation of
// substrata_tpu/scripting/winter.py (ObjectScriptsEvaluator._get_jitted
// :817-829; bench.py's winter_eval :200-207).  Twin: kernels/winter.py
// (winter_eval_plain), which interprets the same instruction list
// (scripting/lower.py) over [B] tensors.
//
// One thread per instance; one launch covers every (source) program of a
// call through a segment table (code offset, length, first instance,
// count) and a block table (segment, first instance of the block).  A
// block stages its segment's instructions in shared memory, kChunk at a
// time, and its threads read them uniformly (no divergence: the code is
// straight-line).  The register file is a device scratch buffer laid out
// [R, B]: register r of instance i at regs[r * B + i], so a warp touches
// 32 neighbouring words per operand.  Bound: instruction issue and the
// scratch traffic; at the bench's 512 instances, launch latency.
//
// Built with -fmad=false: a multiply-add rounds once only where the list
// says ffma (__fmaf_rn).  The transcendentals are CUDA's precise sinf,
// cosf, expf, ... (no fast-math), the functions torch's CUDA ops call.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Op codes: the order of scripting/lower.py:OPS (a test compares the two).
enum Op : int {
  kConstF, kConstI, kConstB,
  kFAdd, kFSub, kFMul, kFDiv, kFFma, kFNeg, kFAbs, kFFloor, kFCeil, kFTrunc,
  kFSqrt, kFSin, kFCos, kFTan, kFAsin, kFAcos, kFAtan, kFAtan2, kFExp, kFLog,
  kFPow, kFMod, kFMin, kFMax,
  kIAdd, kISub, kIMul, kIMod, kINeg, kIAbs, kIMin, kIMax,
  kI2F, kF2I, kB2I, kB2F, kF2B, kI2B,
  kFLt, kFLe, kFEq, kFNe, kILt, kILe, kIEq, kINe,
  kAnd, kOr, kXor, kNot, kSel, kOut,
};

constexpr int kThreads = 128;   // kernels/winter.py:THREADS
constexpr int kChunk = 1024;    // instructions staged at a time (20 KiB)

__device__ __forceinline__ float f_min(float x, float y) {
  return isnan(y) ? y : (isnan(x) ? x : (x < y ? x : y));
}

__device__ __forceinline__ float f_max(float x, float y) {
  return isnan(y) ? y : (isnan(x) ? x : (x > y ? x : y));
}

// jnp.mod on floats: fmod moved into the divisor's sign (maths/fp.py:float_mod).
__device__ __forceinline__ float f_mod(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) ? r + y : r;
}

// jnp.mod on int32 (XLA: x % 0 == 0, x % -1 == 0).
__device__ __forceinline__ int i_mod(int x, int y) {
  if (y == 0 || y == -1) return 0;
  const int r = x % y;
  return (r != 0 && ((r < 0) != (y < 0))) ? r + y : r;
}

// float -> int32 as XLA converts: truncate, saturate, NaN -> 0.
__device__ __forceinline__ int f2i(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x < -2147483648.0f) return INT32_MIN;
  return static_cast<int>(truncf(x));
}

__global__ void __launch_bounds__(kThreads) winter_kernel(
    const int* __restrict__ code, const int* __restrict__ segs, const int* __restrict__ blks,
    const float* __restrict__ time, const int* __restrict__ idx,
    const int* __restrict__ ninst, uint32_t* __restrict__ regs, int B,
    float* __restrict__ out) {
  __shared__ int prog[kChunk * 5];
  const int seg = blks[2 * blockIdx.x];
  const int i = blks[2 * blockIdx.x + 1] + threadIdx.x;
  const int off = segs[4 * seg], n_instr = segs[4 * seg + 1];
  const bool live = i < segs[4 * seg + 2] + segs[4 * seg + 3];
  uint32_t* rg = regs + i;
  if (live) {
    rg[0] = __float_as_uint(time[i]);
    rg[B] = static_cast<uint32_t>(idx[i]);
    rg[2 * B] = static_cast<uint32_t>(ninst[i]);
  }
  const size_t sB = static_cast<size_t>(B);
  for (int c0 = 0; c0 < n_instr; c0 += kChunk) {
    const int nc = min(kChunk, n_instr - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < nc * 5; k += blockDim.x)
      prog[k] = code[static_cast<size_t>(off + c0) * 5 + k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nc; ++j) {
      const int* ins = prog + 5 * j;
      const int op = ins[0], dst = ins[1], a = ins[2], b = ins[3], c = ins[4];
      if (op == kOut) {
        out[static_cast<size_t>(i) * 6 + dst] = __uint_as_float(rg[a * sB]);
        continue;
      }
      if (op <= kConstB) {
        rg[dst * sB] = static_cast<uint32_t>(a);
        continue;
      }
      const uint32_t ua = rg[a * sB];
      const uint32_t ub = (op == kFFma || op == kSel || (op >= kFAdd && op <= kFDiv) ||
                           op == kFAtan2 || (op >= kFPow && op <= kIMod) ||
                           op == kIMin || op == kIMax || (op >= kFLt && op <= kXor))
                              ? rg[b * sB] : 0u;
      const float x = __uint_as_float(ua), y = __uint_as_float(ub);
      const int xi = static_cast<int>(ua), yi = static_cast<int>(ub);
      uint32_t r;
      switch (op) {
        case kFAdd: r = __float_as_uint(x + y); break;
        case kFSub: r = __float_as_uint(x - y); break;
        case kFMul: r = __float_as_uint(x * y); break;
        case kFDiv: r = __float_as_uint(x / y); break;
        case kFFma: r = __float_as_uint(__fmaf_rn(x, y, __uint_as_float(rg[c * sB]))); break;
        case kFNeg: r = __float_as_uint(-x); break;
        case kFAbs: r = __float_as_uint(fabsf(x)); break;
        case kFFloor: r = __float_as_uint(floorf(x)); break;
        case kFCeil: r = __float_as_uint(ceilf(x)); break;
        case kFTrunc: r = __float_as_uint(truncf(x)); break;
        case kFSqrt: r = __float_as_uint(sqrtf(x)); break;
        case kFSin: r = __float_as_uint(sinf(x)); break;
        case kFCos: r = __float_as_uint(cosf(x)); break;
        case kFTan: r = __float_as_uint(tanf(x)); break;
        case kFAsin: r = __float_as_uint(asinf(x)); break;
        case kFAcos: r = __float_as_uint(acosf(x)); break;
        case kFAtan: r = __float_as_uint(atanf(x)); break;
        case kFAtan2: r = __float_as_uint(atan2f(x, y)); break;
        case kFExp: r = __float_as_uint(expf(x)); break;
        case kFLog: r = __float_as_uint(logf(x)); break;
        case kFPow: r = __float_as_uint(powf(x, y)); break;
        case kFMod: r = __float_as_uint(f_mod(x, y)); break;
        case kFMin: r = __float_as_uint(f_min(x, y)); break;
        case kFMax: r = __float_as_uint(f_max(x, y)); break;
        case kIAdd: r = ua + ub; break;
        case kISub: r = ua - ub; break;
        case kIMul: r = ua * ub; break;
        case kIMod: r = static_cast<uint32_t>(i_mod(xi, yi)); break;
        case kINeg: r = 0u - ua; break;
        case kIAbs: r = xi < 0 ? 0u - ua : ua; break;
        case kIMin: r = static_cast<uint32_t>(min(xi, yi)); break;
        case kIMax: r = static_cast<uint32_t>(max(xi, yi)); break;
        case kI2F: r = __float_as_uint(static_cast<float>(xi)); break;
        case kF2I: r = static_cast<uint32_t>(f2i(x)); break;
        case kB2I: r = ua; break;
        case kB2F: r = __float_as_uint(ua ? 1.0f : 0.0f); break;
        case kF2B: r = x != 0.0f; break;
        case kI2B: r = xi != 0; break;
        case kFLt: r = x < y; break;
        case kFLe: r = x <= y; break;
        case kFEq: r = x == y; break;
        case kFNe: r = x != y; break;
        case kILt: r = xi < yi; break;
        case kILe: r = xi <= yi; break;
        case kIEq: r = xi == yi; break;
        case kINe: r = xi != yi; break;
        case kAnd: r = ua & ub; break;
        case kOr: r = ua | ub; break;
        case kXor: r = ua ^ ub; break;
        case kNot: r = ua ^ 1u; break;
        case kSel: r = ua ? ub : rg[c * sB]; break;
        default: r = 0u; break;
      }
      rg[dst * sB] = r;
    }
  }
}

}  // namespace

extern "C" int winter_eval(const int* code, const int* segs, const int* blks, int n_blocks,
                           const float* time, const int* idx, const int* ninst,
                           uint32_t* regs, int B, float* out, void* stream) {
  if (n_blocks > 0)
    winter_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        code, segs, blks, time, idx, ninst, regs, B, out);
  return static_cast<int>(cudaGetLastError());
}
