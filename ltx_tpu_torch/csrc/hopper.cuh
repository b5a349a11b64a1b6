// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): shared-memory addresses,
// mbarriers, TMA tile loads, wgmma descriptors and products, and the host's
// cached TMA tensor maps of (B, H, T, D) bf16 views.
//
// Tiles are rows (queries or keys) by D bf16 values, stored as Swizzle<D>
// boxes of kRowBytes-wide rows in TMA's swizzled layout, which is wgmma's
// canonical layout of the same swizzle: 128-byte rows (64 columns) for D >=
// 64, so a D = 128 tile is two boxes; 64 and 32 bytes for D = 32 and 16.
// Every box starts on a 1024-byte boundary, so descriptors carry base
// offset 0.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int D>
struct Swizzle {
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;  // the swizzle span
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = D / kBoxCols;      // 2 at D = 128, else 1
  static constexpr int kBoxSteps = kBoxCols / 16;  // 16-column k steps in a box
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom
  // wgmma descriptor layout code: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1u : kRowBytes == 64 ? 2u : 3u;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (d, t, h, b) into shared memory, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
        "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout; base offset 0 (every tile
// starts on a 1024-byte boundary)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers that an asynchronous wgmma writes or reads at this point of
// the program, so that the compiler neither reads them earlier nor reuses
// them before it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

#define ACC8(a, i)                                                                   \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),        \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// S (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), both K-major in shared
// memory; accumulate = 0 overwrites S
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// S (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both K-major in shared
// memory; accumulate = 0 overwrites S
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// O (64 x N, f32) += A (64 x 16, bf16 pairs in registers) B (16 x N), B in
// shared memory in its MN-major (keys x N) layout (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 16) {
    wgmma_rs_m64n16k16(d, a, desc_b);
  } else if constexpr (N == 32) {
    wgmma_rs_m64n32k16(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_rs_m64n64k16(d, a, desc_b);
  } else {
    wgmma_rs_m64n128k16(d, a, desc_b);
  }
}

#undef ACC8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) -> one register holding two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Tensor maps, cached by pointer, shape and strides: a clip launches the
// kernel hundreds of times over the same few buffers, and a map depends on
// nothing else. One small cache per host thread.
struct MapKey {
  const void* ptr;
  long long shape[4];    // d, t, h, b
  long long strides[3];  // t, h, b, elements
  int rows;              // the box's rows
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rows != o.rows) return false;
    for (int i = 0; i < 4; ++i) if (shape[i] != o.shape[i]) return false;
    for (int i = 0; i < 3; ++i) if (strides[i] != o.strides[i]) return false;
    return true;
  }
};

struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};

constexpr int kMapSlots = 32;
thread_local MapSlot map_cache[kMapSlots];
thread_local int map_next = 0;

// the (d, t, h, b) map of a (b, h, t, d) bf16 view with element strides
// (sb, sh, st, 1), boxes of `rows` rows x Swizzle<D>::kBoxCols, zero fill out
// of bounds
template <int D>
cudaError_t tensor_map(CUtensorMap* out, const void* ptr, int t, int heads, int batch,
                       const long long* strides, int rows = 128) {
  const MapKey key{ptr, {D, t, heads, batch}, {strides[2], strides[1], strides[0]}, rows};
  for (int i = 0; i < kMapSlots; ++i) {
    if (map_cache[i].used && map_cache[i].key == key) {
      *out = map_cache[i].map;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Swizzle<D>::kBoxCols),
                            static_cast<cuuint32_t>(rows), 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUresult res = encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              Swizzle<D>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  MapSlot& slot = map_cache[map_next];
  map_next = (map_next + 1) % kMapSlots;
  slot.key = key;
  slot.map = *out;
  slot.used = true;
  return cudaSuccess;
}

}  // namespace
