// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel ltx_tpu/kernels/flash_attention.py::flash_attention
// (_flash_kernel / _bias_free_kernel): out = softmax(scale * Q K^T + key_bias) V
// over q (B, H, Tq, D), k and v (B, H, Tk, D), with an optional f32 key bias
// (B, Tk) broadcast over heads and queries.
//
// Numerics follow the TPU kernel: Q K^T is exact bf16 products accumulated in
// f32, the scale is applied in f32, the bias is added in f32, the running max,
// sum and output accumulator are f32, P is rounded to bf16 before the P V
// product (f32 accumulation), the row sum uses the f32 P, and a row whose sum
// is 0 writes 0. Keys past Tk get a logit of -1e30, as the TPU's padded keys
// do; the ragged Tq/Tk tails are masked here, not padded by the caller.
//
// What bounds it on an H100: at the DiT's 1536-5280 tokens with D=128 the
// attention does about T/2 flops per byte of Q, K, V and O, far above the
// card's ~295 flop/byte balance point, so it is compute-bound: the limit is
// the tensor cores (989 TFLOP/s bf16 dense through wgmma). This first kernel
// stays simple: it uses the warp-level mma.sync m16n8k16 bf16 instruction
// (f32 accumulate) rather than scalar FMA, keeps S and P in registers so the
// (Tq, Tk) logits never reach device memory, and streams K/V tiles through
// shared memory with padded rows so the fragment loads are free of bank
// conflicts. It does not use wgmma, TMA, cp.async pipelining or warp
// specialisation, so it stays well below the card's peak; those come later.
//
// Layout: one thread block of 4 warps owns 64 query rows of one (batch, head);
// each warp owns 16 rows. The block loops over K/V in tiles of 64 keys: K is
// staged row-major, V transposed, so both B operands load as 32-bit pairs.
//
// With kStats the same kernel also writes each row's final softmax
// statistics, replacing _stats_kernel / _stats_kernel_bias_free: m, the max
// of the scaled, biased logits (-1e30 pad logits included, as on the TPU),
// and l, the sum of exp(logit - m), both f32 (batch_heads, tq). The
// differentiable attention takes lse = m + log(l) from them for the backward
// (csrc/flash_attention_bwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragment loads
constexpr float kNegInf = -1e30f;  // the TPU kernel's pad logit (not -inf)

template <int D>
struct Smem {
  static constexpr int kQStride = D + kPad;
  static constexpr int kKStride = D + kPad;
  static constexpr int kVtStride = kBlockN + kPad;
  static constexpr int kQElems = kBlockM * kQStride;
  static constexpr int kKElems = kBlockN * kKStride;
  static constexpr int kVtElems = D * kVtStride;
  static constexpr size_t kBytes =
      (kQElems + kKElems + kVtElems) * sizeof(__nv_bfloat16) +
      kBlockN * sizeof(float);
};

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) -> one register holding two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, bool kHasBias, bool kStats>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int heads, int tq, int tk, float scale) {
  using S = Smem<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + S::kQElems;
  __nv_bfloat16* sVt = sK + S::kKElems;
  float* sBias = reinterpret_cast<float*>(sVt + S::kVtElems);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const __nv_bfloat16* qg = q + (size_t)bh * tq * D;
  const __nv_bfloat16* kg = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * tk * D;
  __nv_bfloat16* og = o + (size_t)bh * tq * D;
  const float* bias_row = kHasBias ? bias + (size_t)(bh / heads) * tk : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the group

  // Q tile -> shared memory; rows past Tq are zero and never stored
  for (int i = tid; i < kBlockM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < tq) {
      val = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * S::kQStride + c) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, held for the whole loop
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* qw = sQ + warp * 16 * S::kQStride;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qf[kk][0] = ld_u32(qw + g * S::kQStride + c);
      qf[kk][1] = ld_u32(qw + (g + 8) * S::kQStride + c);
      qf[kk][2] = ld_u32(qw + g * S::kQStride + c + 8);
      qf[kk][3] = ld_u32(qw + (g + 8) * S::kQStride + c + 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // running max and sum of rows g and g + 8
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < tk; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < tk) {
        kv = *reinterpret_cast<const uint4*>(kg + (size_t)(n0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vg + (size_t)(n0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(sK + r * S::kKStride + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * S::kVtStride + r] = ve[j];
    }
    if (kHasBias) {
      for (int i = tid; i < kBlockN; i += kThreads) {
        sBias[i] = (n0 + i < tk) ? bias_row[n0 + i] : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys, eight 16x8 accumulators
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = sK + (j * 8 + g) * S::kKStride + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[j], qf[kk], ld_u32(kp + kk * 16), ld_u32(kp + kk * 16 + 8));
      }
    }

    // scale and bias in f32, mask the ragged tail, online softmax
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if (kHasBias) x += sBias[col];
        if (n0 + col >= tk) x = kNegInf;
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(tile_max[r]));
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        row_sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quad_sum(row_sum[r]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V with P rounded to bf16; the S accumulators of key columns
    // [16kk, 16kk + 16) are exactly the A fragment of that k step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp =
            sVt + (n * 8 + g) * S::kVtStride + kk * 16 + 2 * t4;
        mma_16816(acc[n], pa, ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

  // normalise (a row whose sum is 0 writes 0) and store rows below Tq
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float l0 = l_run[0] == 0.f ? 1.f : l_run[0];
  const float l1 = l_run[1] == 0.f ? 1.f : l_run[1];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row0 < tq) {
      *reinterpret_cast<uint32_t*>(og + (size_t)row0 * D + col) =
          pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    }
    if (row1 < tq) {
      *reinterpret_cast<uint32_t*>(og + (size_t)row1 * D + col) =
          pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
    }
  }
  // the quad's four threads hold the same row statistics: one writes them
  if (kStats && t4 == 0) {
    if (row0 < tq) {
      m_out[(size_t)bh * tq + row0] = m_run[0];
      l_out[(size_t)bh * tq + row0] = l_run[0];
    }
    if (row1 < tq) {
      m_out[(size_t)bh * tq + row1] = m_run[1];
      l_out[(size_t)bh * tq + row1] = l_run[1];
    }
  }
}

template <int D, bool kHasBias, bool kStats>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* m, void* l,
                   int batch_heads, int heads, int tq, int tk, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, kHasBias, kStats>;
  const int smem = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlockM - 1) / kBlockM, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), heads, tq, tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, void* o, void* m, void* l,
                     int batch_heads, int heads, int tq, int tk, float scale,
                     cudaStream_t stream) {
  const bool stats = m != nullptr;
  if (bias != nullptr) {
    return stats ? launch<D, true, true>(q, k, v, bias, o, m, l, batch_heads,
                                         heads, tq, tk, scale, stream)
                 : launch<D, true, false>(q, k, v, bias, o, m, l, batch_heads,
                                          heads, tq, tk, scale, stream);
  }
  return stats ? launch<D, false, true>(q, k, v, bias, o, m, l, batch_heads,
                                        heads, tq, tk, scale, stream)
               : launch<D, false, false>(q, k, v, bias, o, m, l, batch_heads,
                                         heads, tq, tk, scale, stream);
}

}  // namespace

// q, o: (batch_heads, tq, head_dim) bf16; k, v: (batch_heads, tk, head_dim)
// bf16; bias: NULL or (batch_heads / heads, tk) f32; m, l: both NULL, or
// both (batch_heads, tq) f32 for the softmax statistics. All contiguous,
// 16-byte aligned. Returns the CUDA error of the launch (0 on success).
extern "C" int ltx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* m, void* l,
                                       int batch_heads, int heads, int tq,
                                       int tk, int head_dim, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((m == nullptr) != (l == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (head_dim) {
    case 16:
      return dispatch<16>(q, k, v, bias, o, m, l, batch_heads, heads, tq, tk,
                          scale, s);
    case 32:
      return dispatch<32>(q, k, v, bias, o, m, l, batch_heads, heads, tq, tk,
                          scale, s);
    case 64:
      return dispatch<64>(q, k, v, bias, o, m, l, batch_heads, heads, tq, tk,
                          scale, s);
    case 128:
      return dispatch<128>(q, k, v, bias, o, m, l, batch_heads, heads, tq, tk,
                           scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
