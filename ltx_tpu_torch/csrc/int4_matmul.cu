// int4 weight-only linears for Hopper (sm_90a): the fused dequant-and-matmul
// kernel and the one-pass dequant, sharing one dequant function.
//
// Replaces the TPU kernels of ltx_tpu/kernels/quantization.py:
//   * int4_matmul_kernel  <- _int4_matmul_kernel / _int4_matmul_2d (int4_matmul):
//       Y (M, N) bf16 = X (M, K) bf16 @ dequant(W), f32 accumulation;
//   * dequant_int4_kernel <- _dequant_int4_kernel / dequant_int4_pallas:
//       dense (K, N) bf16 = dequant(W), for the big-M route (M >= 8192) that
//       follows it with one plain product.
// W is (K/2, N) uint8 in block-plane packing: within each 256-row block of K,
// byte row r holds the code of row r in its low nibble and of row r + 128 in
// its high nibble (one plane of the whole K when 256 does not divide K:
// `half` below). scale and bias are (K/group, N) f32, and
//     w = bf16( (q * scale[k / group]) + bias[k / group] )
// with the product and the sum each rounded in f32 (__fmul_rn, __fadd_rn:
// never contracted into an FMA), then rounded to bf16 to nearest even. That
// is torch's arithmetic for `q * scale + bias` then `.to(bfloat16)`, so
// dequant_int4 equals its plain version bit for bit.
//
// What bounds them on an H100. The fused product at the DiT's shapes (M =
// 1024-1536 rows, K and N of 4096 and 16384) does 2MKN flops on about
// 2MK + KN/2 + 2MN bytes: over 600 flops per byte, above the card's ~295
// flop/byte balance point, so the limit is the tensor cores (989 TFLOP/s bf16
// dense). The dequant alone moves 2.6 bytes per weight and does ~2 flops: it
// is bound by the 3.35 TB/s of device memory.
//
// What the design does about it. int4_matmul_kernel: Hopper's tensor cores
// have no int4 product, so each K tile of packed codes is read from device
// memory once per block, dequantized by the block into shared memory as bf16
// (transposed, n-major, so the B fragments load as 32-bit k pairs), and fed
// to mma.sync m16n8k16 with f32 accumulators held in registers across the
// whole K loop (the TPU kernel's sequential k grid). A K tile is 64 byte rows
// of one plane, that is 128 rows of K: both nibbles of every byte read are
// used. One block of 8 warps owns a 128 x 128 tile of Y; rows past M load as
// zeros and are not stored (no padding copy). This first version does not
// use wgmma, TMA or a pipelined ring, so it stays well below the card's peak.
// dequant_int4_kernel: one thread per byte row and 8 columns, coalesced 8-byte
// loads and 16-byte stores of two bf16 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One code and its group's scale and bias -> the bf16 weight. Both kernels
// use this and nothing else for the affine.
__device__ __forceinline__ __nv_bfloat16 dequant_code(uint32_t q, float scale,
                                                      float bias) {
  return __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(static_cast<float>(q), scale), bias));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Fused dequant + matmul
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;        // rows of Y per block
constexpr int kBlockN = 128;        // columns of Y per block
constexpr int kTileBytes = 64;      // packed byte rows per K tile
constexpr int kTileK = 2 * kTileBytes;  // rows of K per tile: both nibbles
constexpr int kPack = 256;          // the block-plane packing block
constexpr int kHalf = kPack / 2;
constexpr int kThreads = 256;       // 8 warps: 4 along M x 2 along N
constexpr int kPad = 8;             // bf16 row padding: conflict-free fragments
constexpr int kStride = kTileK + kPad;  // of sX and sWt rows
constexpr size_t kSmemBytes =
    (size_t)(kBlockM + kBlockN) * kStride * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (m, k) bf16, w_q4 (k/2, n) u8, scale/bias (k/group, n) f32, y (m, n)
// bf16. k % 256 == 0, n % 128 == 0, group even. Grid: (ceil(m/128), n/128).
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ w_q4,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int m, int k, int n,
                   int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // sX: the X tile, (row, local k); sWt: the dequantized W tile transposed,
  // (column, local k). Local k < 64 is the tile's low-nibble rows of K,
  // local k >= 64 its high-nibble rows, 128 further down K.
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sWt = sX + kBlockM * kStride;

  const int m0 = blockIdx.x * kBlockM;
  const int n0 = blockIdx.y * kBlockN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the group
  const int wm = (warp & 3) * 32;   // this warp's 32 rows of the tile
  const int wn = (warp >> 2) * 64;  // and 64 columns

  // the dequant work of a thread: byte-row pair p (rows 2p, 2p+1 of the
  // tile), 4 columns from 4*cc; 8 lanes along p and 4 along cc per warp
  const int pair = (lane & 7) + 8 * (warp & 3);
  const int cc0 = (lane >> 3) + 4 * (warp >> 2);

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int num_tiles = k / kTileK;
  for (int t = 0; t < num_tiles; ++t) {
    const int r0 = t * kTileBytes;                        // first byte row
    const int lo_base = (r0 / kHalf) * kPack + r0 % kHalf;  // its low-nibble K row
    const int hi_base = lo_base + kHalf;
    __syncthreads();  // every warp is done with the previous tile

    // X tile: 128 rows x (64 low + 64 high) K columns, 16-byte chunks
    for (int i = tid; i < kBlockM * (kTileK / 8); i += kThreads) {
      const int r = i / (kTileK / 8), c = (i % (kTileK / 8)) * 8;
      const int gk = c < kTileBytes ? lo_base + c : hi_base + (c - kTileBytes);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) {
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + gk);
      }
      *reinterpret_cast<uint4*>(sX + r * kStride + c) = v;
    }

    // W tile: dequantize 64 byte rows x 128 columns into sWt
    {
      const int k_lo = lo_base + 2 * pair;  // rows k_lo, k_lo + 1 share a group
      const int k_hi = hi_base + 2 * pair;
      const size_t row = (size_t)(r0 + 2 * pair) * n;
      const size_t glo = (size_t)(k_lo / group) * n;
      const size_t ghi = (size_t)(k_hi / group) * n;
#pragma unroll
      for (int it = 0; it < kBlockN / 4 / 8; ++it) {
        const int col = 4 * (cc0 + 8 * it);
        const int gc = n0 + col;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(w_q4 + row + gc);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(w_q4 + row + n + gc);
        const float4 s_lo = *reinterpret_cast<const float4*>(scale + glo + gc);
        const float4 z_lo = *reinterpret_cast<const float4*>(bias + glo + gc);
        const float4 s_hi = *reinterpret_cast<const float4*>(scale + ghi + gc);
        const float4 z_hi = *reinterpret_cast<const float4*>(bias + ghi + gc);
        const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
        const float zl[4] = {z_lo.x, z_lo.y, z_lo.z, z_lo.w};
        const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
        const float zh[4] = {z_hi.x, z_hi.y, z_hi.z, z_hi.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t q0 = (b0 >> (8 * j)) & 0xFFu;  // byte row 2p
          const uint32_t q1 = (b1 >> (8 * j)) & 0xFFu;  // byte row 2p + 1
          __nv_bfloat16* dst = sWt + (col + j) * kStride + 2 * pair;
          *reinterpret_cast<uint32_t*>(dst) =
              pack2(dequant_code(q0 & 0xFu, sl[j], zl[j]),
                    dequant_code(q1 & 0xFu, sl[j], zl[j]));
          *reinterpret_cast<uint32_t*>(dst + kTileBytes) =
              pack2(dequant_code(q0 >> 4, sh[j], zh[j]),
                    dequant_code(q1 >> 4, sh[j], zh[j]));
        }
      }
    }
    __syncthreads();

    // 8 k steps of 16: 2 x 8 mma per warp each
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ap = sX + (wm + mt * 16 + g) * kStride + kk * 16 + 2 * t4;
        a[mt][0] = ld_u32(ap);
        a[mt][1] = ld_u32(ap + 8 * kStride);
        a[mt][2] = ld_u32(ap + 8);
        a[mt][3] = ld_u32(ap + 8 * kStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* bp = sWt + (wn + nt * 8 + g) * kStride + kk * 16 + 2 * t4;
        const uint32_t b0 = ld_u32(bp), b1 = ld_u32(bp + 8);
        mma_16816(acc[0][nt], a[0], b0, b1);
        mma_16816(acc[1][nt], a[1], b0, b1);
      }
    }
  }

  // one rounding to bf16; rows past M are not stored
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row0 = m0 + wm + mt * 16 + g;
    const int row1 = row0 + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * t4;
      if (row0 < m) {
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row0 * n + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (row1 < m) {
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row1 * n + col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// One-pass dequant
// ---------------------------------------------------------------------------

constexpr int kDequantThreads = 256;

// w_q4 (k/2, n) u8, scale/bias (k/group, n) f32 -> w (k, n) bf16; half is
// the packing plane's byte rows (128, or k/2 for one plane); n % 8 == 0.
__global__ void __launch_bounds__(kDequantThreads)
dequant_int4_kernel(const uint8_t* __restrict__ w_q4,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ w, int k, int n, int group,
                    int half) {
  const int chunks = n / 8;
  const long long idx = (long long)blockIdx.x * kDequantThreads + threadIdx.x;
  if (idx >= (long long)(k / 2) * chunks) return;
  const int r = static_cast<int>(idx / chunks);
  const int c = static_cast<int>(idx % chunks) * 8;
  const int k_lo = (r / half) * 2 * half + r % half;
  const int k_hi = k_lo + half;

  const uint2 packed = *reinterpret_cast<const uint2*>(w_q4 + (size_t)r * n + c);
  const uint32_t words[2] = {packed.x, packed.y};
  const float* s_lo = scale + (size_t)(k_lo / group) * n + c;
  const float* z_lo = bias + (size_t)(k_lo / group) * n + c;
  const float* s_hi = scale + (size_t)(k_hi / group) * n + c;
  const float* z_hi = bias + (size_t)(k_hi / group) * n + c;
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t q0 = (words[j / 2] >> (16 * (j % 2))) & 0xFFu;  // column 2j
    const uint32_t q1 = (words[j / 2] >> (16 * (j % 2) + 8)) & 0xFFu;  // 2j + 1
    lo[j] = pack2(dequant_code(q0 & 0xFu, s_lo[2 * j], z_lo[2 * j]),
                  dequant_code(q1 & 0xFu, s_lo[2 * j + 1], z_lo[2 * j + 1]));
    hi[j] = pack2(dequant_code(q0 >> 4, s_hi[2 * j], z_hi[2 * j]),
                  dequant_code(q1 >> 4, s_hi[2 * j + 1], z_hi[2 * j + 1]));
  }
  *reinterpret_cast<uint4*>(w + (size_t)k_lo * n + c) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(w + (size_t)k_hi * n + c) =
      make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

}  // namespace

// x (m, k) bf16, w_q4 (k/2, n) uint8, scale and bias (k/group, n) f32, y
// (m, n) bf16; all contiguous and 16-byte aligned; k % 256 == 0, n % 128 ==
// 0, group even and dividing k. Returns the CUDA error of the launch.
extern "C" int ltx_int4_matmul(const void* x, const void* w_q4,
                               const void* scale, const void* bias, void* y,
                               int m, int k, int n, int group, void* stream) {
  if (m <= 0 || k % kPack != 0 || n % kBlockN != 0 || group <= 0 ||
      group % 2 != 0 || k % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      int4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kBlockM - 1) / kBlockM, n / kBlockN);
  int4_matmul_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w_q4),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), m, k, n, group);
  return static_cast<int>(cudaGetLastError());
}

// w_q4 (k/2, n) uint8, scale and bias (k/group, n) f32 -> w (k, n) bf16; all
// contiguous and 16-byte aligned; n % 8 == 0; half = 128 when 256 divides k,
// else k/2. Returns the CUDA error of the launch.
extern "C" int ltx_dequant_int4(const void* w_q4, const void* scale,
                                const void* bias, void* w, int k, int n,
                                int group, int half, void* stream) {
  if (k <= 0 || n <= 0 || n % 8 != 0 || half <= 0 || (k / 2) % half != 0 ||
      group <= 0 || k % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = (long long)(k / 2) * (n / 8);
  const unsigned blocks =
      static_cast<unsigned>((threads + kDequantThreads - 1) / kDequantThreads);
  dequant_int4_kernel<<<blocks, kDequantThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(w_q4), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(w), k, n,
      group, half);
  return static_cast<int>(cudaGetLastError());
}
