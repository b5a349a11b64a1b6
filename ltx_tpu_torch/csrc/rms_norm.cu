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
// weight is d values shared by every row), two flops a value: far below the
// card's ~295 flop/byte balance point, so the least time is
// 2 * rows * d * sizeof(T) bytes at 3.35 TB/s. To come near it the card must
// keep about 25 KB a streaming multiprocessor (SM) in flight (3.35 TB/s over
// 132 SMs times ~1 us of DRAM latency), and no SM may be left with a tail of
// rows while the others idle.
//
// What the design does about it. The TPU kernel takes 256-row blocks through
// VMEM, one grid step at a time. Here the grid is persistent: two CTAs an SM
// (one where rows are too wide for that), never more CTAs than rows. CTA c
// owns rows c, c + G, c + 2G, ... (G the grid), so the SMs' shares differ by
// at most one row a CTA; the CTA's warps (up to eight) take its rows in turn,
// warp w the CTA's rows w, w + W, .... A warp is the unit of work, with its
// own ring of S stages in shared memory, one row a stage: its lane 0 issues a
// 1-D bulk asynchronous copy (cp.async.bulk, no tensor map) of each of the
// warp's rows into a stage, S rows ahead, completing on that stage's
// mbarrier. Where every warp takes one row or a few (the north star's 1536
// rows), the rings hold them all and the whole input is in flight at once;
// at the two-stage path's 18432 rows, S - 1 rows a warp, 128 KB an SM, are
// in flight while the warp works on one. The warp waits for its stage's
// phase, sums the squares from shared memory (16-byte reads; lane l takes
// the 16-byte pieces l, l + 32, ... in order, one fma a value into one of
// eight (bf16) or four (f32) accumulators by the value's place in the piece,
// so that no chain of dependent fmas is longer than the lane's pieces; then
// the accumulators in order), adds the 32 lane sums by a butterfly of
// shuffles (a + b == b + a, so every lane ends with the same bits), scales
// the row from shared memory and stores 16 bytes a lane to global memory,
// then refills the stage with its row S ahead. No __syncthreads after the
// start, no exchange between warps, no atomics. The weight goes into shared
// memory by one bulk copy a CTA, issued ahead of the rows.
//
// A row's output depends only on its own values, d and eps: not on how many
// rows were launched, where the row lies or which warp took it. A row too
// wide for the rings (beyond ~19000 f32 values with an f32 weight where a
// warp takes more than one row) goes through them in chunks of a multiple
// of 512 bytes, twice: the first pass sums, the second scales (the weight
// then comes from global memory). A chunk starts on a multiple of 32
// pieces, so every lane sums the same pieces in the same order as it would
// over the whole row: both forms give the same bits.
//
// Stores: 16-byte vector stores from registers beat writing the scaled row
// back into its stage and storing it with one bulk copy at every path shape
// (scripts/rms_norm_variants.py). The launch geometry (grid, warps, stages,
// stage bytes, chunks) is chosen by the caller
// (ltx_tpu_torch/kernels/rms_norm.py::geometry, which the CPU tests emulate)
// and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// the mbarriers at the start: the weight's, then 8 bytes a stage
constexpr int kBarBytes = 1152;
constexpr int kMaxWarps = 8;       // warps a CTA
constexpr int kMaxStages = 16;     // stages a warp
constexpr int kMaxSmem = 232448;   // shared memory a CTA may hold on an H100

// N values of type T at p (N * sizeof(T) is 8, 16 or 32 bytes, p aligned to
// it or to 16; shared or global memory) -> f32.
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

// 16 bytes of f32 values -> type T at p, each rounded to nearest even.
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

// acc[j] plus the squares of value j of this lane's pieces (lane, lane +
// 32, ... below `pieces`) of the 16-byte pieces at src, one fma a value, in
// order: kVec independent chains, not one.
template <typename TX>
__device__ __forceinline__ void square_sums(const TX* src, int pieces, int lane,
                                            float (&acc)[16 / sizeof(TX)]) {
  constexpr int kVec = 16 / sizeof(TX);
#pragma unroll 4
  for (int p = lane; p < pieces; p += 32) {
    float v[kVec];
    load_f32<TX, kVec>(src + p * kVec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = __fmaf_rn(v[j], v[j], acc[j]);
  }
}

// the lane's sum: acc[0] + acc[1] + ... in order
template <int N>
__device__ __forceinline__ float lane_total(const float (&acc)[N]) {
  float s = acc[0];
#pragma unroll
  for (int j = 1; j < N; ++j) s = __fadd_rn(s, acc[j]);
  return s;
}

// the 32 lanes' sums, in every lane, by a butterfly of shuffles
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xFFFFFFFFu, s, offset));
  }
  return s;
}

__device__ __forceinline__ float row_inverse(float total, int d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));
}

// this lane's pieces of a row (or chunk) at src: (v * inv) [* w], rounded
// once, 16 bytes a store to dst; w and dst start at src's first value.
template <typename TX, typename TW, bool kWeighted>
__device__ __forceinline__ void scale_store(const TX* src, const TW* w, TX* dst, int pieces,
                                            int lane, float inv) {
  constexpr int kVec = 16 / sizeof(TX);
#pragma unroll 4
  for (int p = lane; p < pieces; p += 32) {
    float v[kVec];
    load_f32<TX, kVec>(src + p * kVec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __fmul_rn(v[j], inv);
    if constexpr (kWeighted) {
      float wf[kVec];
      load_f32<TW, kVec>(w + p * kVec, wf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = __fmul_rn(v[j], wf[j]);
    }
    store_from_f32(dst + p * kVec, v);
  }
}

__host__ __device__ constexpr long long round_up_128(long long n) { return (n + 127) / 128 * 128; }

// blockDim.x / 32 warps, each with `stages` stages of stage_bytes; a row is
// one stage (chunks == 1) or `chunks` stages read twice. Shared memory:
// the mbarriers (kBarBytes), the weight (whole rows and weighted only), then
// each warp's ring. `stages` may be 1 where no warp takes a second row.
template <typename TX, typename TW, bool kWeighted>
__global__ void __launch_bounds__(kMaxWarps * 32)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
                long long rows, int d, float eps, int stages, int stage_bytes, int chunks) {
  constexpr int kVec = 16 / sizeof(TX);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long grid = gridDim.x, cta = blockIdx.x;
  const long long row_bytes = static_cast<long long>(d) * sizeof(TX);
  const bool whole = chunks == 1;
  const long long w_bytes = kWeighted && whole ? round_up_128(d * sizeof(TW)) : 0;
  const uint32_t w_bar = smem_u32(smem);
  const uint32_t bars = w_bar + 8u + 8u * warp * stages;
  unsigned char* ring = smem + kBarBytes + w_bytes +
                        static_cast<long long>(warp) * stages * stage_bytes;
  const uint32_t ring_u32 = smem_u32(ring);

  // this warp's rows: first_row + i * row_step, i < my_rows; each row one
  // item (whole) or 2 * chunks items (the chunks of the sum, then of the
  // scale), taken in order, item t in stage t % stages
  const long long cta_rows = cta < rows ? (rows - 1 - cta) / grid + 1 : 0;
  const long long my_rows = cta_rows > warp ? (cta_rows - 1 - warp) / warps + 1 : 0;
  const int per_row = whole ? 1 : 2 * chunks;
  const long long items = my_rows * per_row;
  const long long first_row = cta + grid * warp;
  const long long row_step = grid * warps;

  auto issue = [&](long long t) {  // lane 0: item t's bytes into its stage
    const uint32_t s = static_cast<uint32_t>(t % stages);
    const long long chunk = whole ? 0 : (t % per_row) % chunks;
    const long long offset = chunk * stage_bytes;
    const long long left = row_bytes - offset;
    const uint32_t bytes = static_cast<uint32_t>(left < stage_bytes ? left : stage_bytes);
    const char* src = reinterpret_cast<const char*>(x) +
                      (first_row + (t / per_row) * row_step) * row_bytes + offset;
    mbar_expect_tx(bars + 8u * s, bytes);
    bulk_load(ring_u32 + s * static_cast<uint32_t>(stage_bytes), src, bytes, bars + 8u * s);
  };

  // the weight first (one bulk copy, ahead of the rows), then each warp's
  // first rows
  const bool w_staged = kWeighted && whole;
  if (w_staged && threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(d * sizeof(TW));
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(w_bar, bytes);
    bulk_load(w_bar + kBarBytes, w, bytes, w_bar);
  }
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long t = 0; t < items && t < stages; ++t) issue(t);
  }
  __syncthreads();  // every barrier initialised
  const TW* wr = w;
  if (w_staged) {
    mbar_wait(w_bar, 0);
    wr = reinterpret_cast<const TW*>(smem + kBarBytes);
  }

  const int row_pieces = d / kVec;
  const int stage_pieces = stage_bytes / 16;
  float acc[kVec], inv = 0.0f;
  for (long long t = 0; t < items; ++t) {
    const uint32_t s = static_cast<uint32_t>(t % stages);
    mbar_wait(bars + 8u * s, static_cast<uint32_t>((t / stages) & 1));
    const TX* src = reinterpret_cast<const TX*>(ring + static_cast<long long>(s) * stage_bytes);
    TX* out = y + (first_row + (t / per_row) * row_step) * d;
    if (whole) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
      square_sums(src, row_pieces, lane, acc);
      inv = row_inverse(warp_sum(lane_total(acc)), d, eps);
      scale_store<TX, TW, kWeighted>(src, wr, out, row_pieces, lane, inv);
    } else {
      const int k = static_cast<int>(t % per_row), chunk = k % chunks;
      const int first = chunk * stage_pieces;  // the chunk's first piece
      const int pieces = min(stage_pieces, row_pieces - first);
      if (k < chunks) {  // the first pass: the sum
        if (chunk == 0) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
        }
        square_sums(src, pieces, lane, acc);
        if (chunk == chunks - 1) inv = row_inverse(warp_sum(lane_total(acc)), d, eps);
      } else {  // the second pass: scale and store
        scale_store<TX, TW, kWeighted>(src, kWeighted ? wr + first * kVec : wr,
                                       out + first * kVec, pieces, lane, inv);
      }
    }
    // every lane's reads of the stage are done (its stores used them)
    // before lane 0 hands the stage to the next copy
    __syncwarp();
    if (lane == 0 && t + stages < items) issue(t + stages);
  }
}

template <typename TX, typename TW, bool kWeighted>
int launch(const void* x, const void* w, void* y, long long rows, int d, float eps, int grid,
           int warps, int stages, int stage_bytes, int chunks, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(d) * sizeof(TX);
  const bool whole = chunks == 1;
  const long long w_bytes = kWeighted && whole ? round_up_128(d * sizeof(TW)) : 0;
  const long long smem =
      kBarBytes + w_bytes + static_cast<long long>(warps) * stages * stage_bytes;
  if (grid < 1 || warps < 1 || warps > kMaxWarps || stages < 1 || stages > kMaxStages ||
      stage_bytes < 16 || stage_bytes % 16 || smem > kMaxSmem || chunks < 1 ||
      (whole ? stage_bytes < row_bytes
             : stage_bytes % 512 || static_cast<long long>(chunks) * stage_bytes < row_bytes ||
                   static_cast<long long>(chunks - 1) * stage_bytes >= row_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the shared-memory limit raised once per device, not at every launch
  static unsigned allowed = 0;  // one bit a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (bit == 0u || !(allowed & bit)) {
    err = cudaFuncSetAttribute(rms_norm_kernel<TX, TW, kWeighted>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= bit;
  }
  rms_norm_kernel<TX, TW, kWeighted><<<grid, warps * 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(y), rows, d, eps,
      stages, stage_bytes, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y (rows, d) contiguous, of one type: x_bf16 1 for bf16, 0 for f32. w
// (d,) or null for the weightless form; w_bf16 1 for a bf16 weight, 0 for f32.
// All pointers 16-byte aligned; d % 128 == 0. grid CTAs of `warps` warps,
// each warp `stages` stages of stage_bytes, a row in `chunks` stages
// (kernels/rms_norm.py::geometry). Returns the CUDA error of the launch.
extern "C" int ltx_rms_norm(const void* x, const void* w, void* y, long long rows, int d,
                            float eps, int x_bf16, int w_bf16, int grid, int warps,
                            int stages, int stage_bytes, int chunks, void* stream) {
  if (rows <= 0 || d <= 0 || d % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (x_bf16) {
    if (w == nullptr) {
      return launch<bf16, bf16, false>(x, w, y, rows, d, eps, grid, warps, stages, stage_bytes,
                                       chunks, s);
    }
    if (w_bf16) {
      return launch<bf16, bf16, true>(x, w, y, rows, d, eps, grid, warps, stages, stage_bytes,
                                      chunks, s);
    }
    return launch<bf16, float, true>(x, w, y, rows, d, eps, grid, warps, stages, stage_bytes,
                                     chunks, s);
  }
  if (w == nullptr) {
    return launch<float, float, false>(x, w, y, rows, d, eps, grid, warps, stages, stage_bytes,
                                       chunks, s);
  }
  if (w_bf16) {
    return launch<float, bf16, true>(x, w, y, rows, d, eps, grid, warps, stages, stage_bytes,
                                     chunks, s);
  }
  return launch<float, float, true>(x, w, y, rows, d, eps, grid, warps, stages, stage_bytes,
                                    chunks, s);
}
