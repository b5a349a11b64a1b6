// Row RMSNorm for Hopper (sm_90a), weightless and weighted.
//
// Replaces the TPU kernel of ltx_tpu/kernels/rms_norm.py (rms_norm_pallas:
// _rms_kernel, _rms_kernel_weighted): over the last axis of a (rows, d) array,
//     y = T( (f32(x) * rsqrt(mean(f32(x)^2) + eps)) [* f32(w)] )
// with the statistics in f32 and one rounding to x's type T (bf16 or f32) at
// the end. The multiply order is the reference's: (x * inv) * w, each product
// rounded in f32 (__fmul_rn), never x * (inv * w).
//
// What bounds it on an H100: bytes. A row is read once and written once (the
// weight is d values shared by every row and stays in cache), two flops a
// value: far below the card's ~295 flop/byte balance point, so the least time
// is 2 * rows * d * sizeof(T) bytes at 3.35 TB/s.
//
// What the design does about it. The TPU kernel takes 256-row blocks through
// VMEM and pads the rows to the block; here a row belongs to a group of 32 to
// 256 threads (as many rows to a 256-thread block as fit), rows need no
// padding, and a thread moves 16 bytes at a time, neighbouring threads on
// neighbouring addresses. Each thread keeps up to four 16-byte pieces of its
// row in registers as f32, so x is read from device memory once: the sum of
// squares runs over the registers, goes through warp shuffles and one
// shared-memory exchange between the group's warps (every thread of the group
// adds the same partial sums in the same order, so the row has one inverse),
// and the second pass scales the registers and stores. A row wider than the
// registers hold (d > 4 * 256 * 16 bytes / sizeof(T)) re-reads its tail, which
// the block itself has just read. No atomics: the result does not change from
// run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kCache = 4;      // 16-byte pieces of a row a thread keeps

// N values of type T at p (N * sizeof(T) is 8, 16 or 32 bytes, p aligned to
// it or to 16) -> f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out);

template <>
__device__ __forceinline__ void load_f32<float, 4>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_f32<float, 8>(const float* p, float* out) {
  load_f32<float, 4>(p, out);
  load_f32<float, 4>(p + 4, out + 4);
}

// a bf16 is the high half of its f32
__device__ __forceinline__ void widen_pair(uint32_t word, float* out) {
  out[0] = __uint_as_float(word << 16);
  out[1] = __uint_as_float(word & 0xFFFF0000u);
}

template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 4>(const __nv_bfloat16* p,
                                                           float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  widen_pair(v.x, out);
  widen_pair(v.y, out + 2);
}

template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                           float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  widen_pair(v.x, out);
  widen_pair(v.y, out + 2);
  widen_pair(v.z, out + 4);
  widen_pair(v.w, out + 6);
}

// N f32 values -> type T at p, each rounded to nearest even, 16 bytes a store.
__device__ __forceinline__ void store_from_f32(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, const float* v) {
  uint32_t words[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 pair = __halves2bfloat162(__float2bfloat16_rn(v[2 * j]),
                                             __float2bfloat16_rn(v[2 * j + 1]));
    words[j] = *reinterpret_cast<uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}

// One 16-byte piece of a row: (v * inv) [* w], rounded once, stored.
template <typename TX, typename TW, bool kWeighted>
__device__ __forceinline__ void scale_and_store(TX* yr, const TW* w, int piece,
                                                const float* v, float inv) {
  constexpr int kVec = 16 / sizeof(TX);
  float out[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) out[j] = __fmul_rn(v[j], inv);
  if constexpr (kWeighted) {
    float wf[kVec];
    load_f32<TW, kVec>(w + piece * kVec, wf);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = __fmul_rn(out[j], wf[j]);
  }
  store_from_f32(yr + piece * kVec, out);
}

// `group` threads a row (a power of two from 32 to kThreads), kThreads / group
// rows a block. TW is the weight's type; kWeighted false ignores w.
template <typename TX, typename TW, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                TX* __restrict__ y, long long rows, int d, float eps, int group) {
  constexpr int kVec = 16 / sizeof(TX);  // values in one 16-byte piece
  __shared__ float partial[kThreads / 32];

  const int lane = threadIdx.x % group;
  const long long row =
      (long long)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const bool live = row < rows;
  const int pieces = d / kVec;
  const TX* xr = x + (live ? row : 0) * d;
  TX* yr = y + (live ? row : 0) * d;

  float cached[kCache][kVec];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const int piece = lane + c * group;
    if (live && piece < pieces) {
      load_f32<TX, kVec>(xr + piece * kVec, cached[c]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += cached[c][j] * cached[c][j];
    }
  }
  for (int piece = lane + kCache * group; live && piece < pieces; piece += group) {
    float v[kVec];
    load_f32<TX, kVec>(xr + piece * kVec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) sum += v[j] * v[j];
  }

  // the row's sum: within each warp by shuffles, then across the group's warps
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, offset);
  }
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = sum;
  __syncthreads();
  const int first_warp = (threadIdx.x / group) * (group / 32);
  float total = 0.0f;
  for (int i = 0; i < group / 32; ++i) total += partial[first_warp + i];
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));
  if (!live) return;

#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const int piece = lane + c * group;
    if (piece < pieces) {
      scale_and_store<TX, TW, kWeighted>(yr, w, piece, cached[c], inv);
    }
  }
  for (int piece = lane + kCache * group; piece < pieces; piece += group) {
    float v[kVec];
    load_f32<TX, kVec>(xr + piece * kVec, v);
    scale_and_store<TX, TW, kWeighted>(yr, w, piece, v, inv);
  }
}

template <typename TX, typename TW, bool kWeighted>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const int pieces = d / kVec;
  int group = 32;  // two pieces a thread where the row is wide enough
  while (group < kThreads && group * 2 < pieces) group *= 2;
  const int rows_per_block = kThreads / group;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  rms_norm_kernel<TX, TW, kWeighted>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<TX*>(y), rows, d, eps, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y (rows, d) contiguous, of one type: x_bf16 1 for bf16, 0 for f32. w
// (d,) or null for the weightless form; w_bf16 1 for a bf16 weight, 0 for f32.
// All pointers 16-byte aligned; d % 128 == 0. Returns the CUDA error of the
// launch.
extern "C" int ltx_rms_norm(const void* x, const void* w, void* y,
                            long long rows, int d, float eps, int x_bf16,
                            int w_bf16, void* stream) {
  if (rows <= 0 || d <= 0 || d % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (x_bf16) {
    if (w == nullptr) return launch<bf16, bf16, false>(x, w, y, rows, d, eps, s);
    if (w_bf16) return launch<bf16, bf16, true>(x, w, y, rows, d, eps, s);
    return launch<bf16, float, true>(x, w, y, rows, d, eps, s);
  }
  if (w == nullptr) return launch<float, float, false>(x, w, y, rows, d, eps, s);
  if (w_bf16) return launch<float, bf16, true>(x, w, y, rows, d, eps, s);
  return launch<float, float, true>(x, w, y, rows, d, eps, s);
}
