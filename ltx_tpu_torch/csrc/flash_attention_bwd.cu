// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in and out.
//
// Replaces the TPU kernels of ltx_tpu/kernels/flash_attention.py::
// _flash_backward: _bwd_dq_kernel / _bwd_dq_kernel_bias_free (dQ) and
// _bwd_dkv_kernel / _bwd_dkv_kernel_bias_free (dK, dV), with their shared
// tile _bwd_tile. For q, dO (B, H, Tq, D), k, v (B, H, Tk, D), an optional
// f32 key bias (B, Tk), lse = m + log(l) from the forward's statistics and
// delta = rowsum(dO * O) (both f32 (B, H, Tq), delta computed by the caller):
//
//   P  = exp(scale * Q K^T + bias - lse)      recomputed tile by tile
//   dV = P^T dO
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K,   dK = dS^T Q
//
// Numerics: Q K^T and dO V^T are exact bf16 products summed in f32; P, dS and
// the scale/bias/lse arithmetic are f32; P and dS are rounded to bf16 for the
// dV, dQ and dK products (f32 accumulation), as FlashAttention-2 does; the
// reference keeps them f32, and ltx_tpu_torch/checks.py states the tolerance
// that follows. Keys past Tk and queries past Tq get P = 0 explicitly (their
// rows are loaded as zeros and never stored), so a key the bias masks with
// -1e30 or -10000 gets P = 0 and exactly zero dK and dV.
//
// What bounds it on an H100: the five products cost 10 * B*H*Tq*Tk*D flops
// (this split recomputes Q K^T and dO V^T in both kernels: 14 *) against
// O((Tq + Tk) * D) bytes, so at the DiT's 1024-1536 keys it is compute-bound
// (tensor cores, 989 TFLOP/s bf16 dense). Like the forward this first version
// uses warp-level mma.sync m16n8k16 and keeps the (Tq, Tk) tiles in
// registers; no wgmma, TMA or pipelined loads yet.
//
// Design, the TPU's split translated to blocks that run in no order: no
// block writes what another block writes, so there are no atomics and the
// result is deterministic.
//   dq kernel:  one block of 4 warps per (batch*head, 64 queries); each warp
//               owns 16 query rows and loops over all keys in tiles of 64,
//               dQ accumulated in registers.
//   dkv kernel: one block of 4 warps per (batch*head, 64 keys); each warp
//               owns 16 key rows and loops over all queries in tiles of 32,
//               dK and dV accumulated in registers (2 x 16 x D f32 a warp, the
//               reason for the short query tile).
// Operands that an mma.sync B fragment needs as pairs along the summed axis
// are staged transposed in shared memory (K for dQ; Q and dO for dK and dV);
// rows are padded by 8 bf16 so fragment loads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;              // bf16 row padding
constexpr float kNegInf = -1e30f;    // the TPU kernel's pad logit

// dq kernel tiles
constexpr int kDqRows = 64;          // queries per block (16 a warp)
constexpr int kDqKeys = 64;          // keys per loop step
// dkv kernel tiles
constexpr int kKvRows = 64;          // keys per block (16 a warp)
constexpr int kKvQueries = 32;       // queries per loop step

template <int D>
struct DqSmem {
  static constexpr int kRowStride = D + kPad;       // sQ, sdO, sK, sV
  static constexpr int kKtStride = kDqKeys + kPad;  // sKt (D rows)
  static constexpr int kQElems = kDqRows * kRowStride;
  static constexpr int kKElems = kDqKeys * kRowStride;
  static constexpr int kKtElems = D * kKtStride;
  static constexpr size_t kBytes =
      (2 * kQElems + 2 * kKElems + kKtElems) * sizeof(__nv_bfloat16) +
      kDqKeys * sizeof(float);
};

template <int D>
struct KvSmem {
  static constexpr int kRowStride = D + kPad;          // sK, sV, sQ, sdO
  static constexpr int kTStride = kKvQueries + kPad;   // sQt, sdOt (D rows)
  static constexpr int kKElems = kKvRows * kRowStride;
  static constexpr int kQElems = kKvQueries * kRowStride;
  static constexpr int kTElems = D * kTStride;
  static constexpr size_t kBytes =
      (2 * kKElems + 2 * kQElems + 2 * kTElems) * sizeof(__nv_bfloat16) +
      2 * kKvQueries * sizeof(float);
};

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// The A fragment of rows [0, 16) x columns [c0, c0 + 16) of a row-major
// shared tile whose rows are `stride` apart.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t,
                                       int stride, int c0, int g, int t4) {
  const int c = c0 + 2 * t4;
  a[0] = ld_u32(t + g * stride + c);
  a[1] = ld_u32(t + (g + 8) * stride + c);
  a[2] = ld_u32(t + g * stride + c + 8);
  a[3] = ld_u32(t + (g + 8) * stride + c + 8);
}

// Rows [r0, r0 + rows) of a (n, D) bf16 matrix into a row-major shared tile
// (zeros past n); with `t` non-null also transposed into t[d * tstride + r].
template <int D>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, int r0,
                                           int n, int rows, __nv_bfloat16* dst,
                                           int stride, __nv_bfloat16* t,
                                           int tstride, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
    if (t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) t[(c + j) * tstride + r] = e[j];
    }
  }
}

template <int D, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ dq,
                    int heads, int tq, int tk, float scale) {
  using S = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + S::kQElems;
  __nv_bfloat16* sK = sdO + S::kQElems;
  __nv_bfloat16* sV = sK + S::kKElems;
  __nv_bfloat16* sKt = sV + S::kKElems;
  float* sBias = reinterpret_cast<float*>(sKt + S::kKtElems);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const __nv_bfloat16* qg = q + (size_t)bh * tq * D;
  const __nv_bfloat16* dog = dout + (size_t)bh * tq * D;
  const __nv_bfloat16* kg = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * tk * D;
  const float* bias_row = kHasBias ? bias + (size_t)(bh / heads) * tk : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  stage_rows<D>(qg, q0, tq, kDqRows, sQ, S::kRowStride, nullptr, 0, tid);
  stage_rows<D>(dog, q0, tq, kDqRows, sdO, S::kRowStride, nullptr, 0, tid);

  // this thread's two query rows
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < tq;
    lse_r[r] = in ? lse[(size_t)bh * tq + row[r]] : 0.f;
    delta_r[r] = in ? delta[(size_t)bh * tq + row[r]] : 0.f;
  }
  const __nv_bfloat16* qw = sQ + warp * 16 * S::kRowStride;
  const __nv_bfloat16* dow = sdO + warp * 16 * S::kRowStride;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int n0 = 0; n0 < tk; n0 += kDqKeys) {
    __syncthreads();  // every warp is done with the previous key tile
    stage_rows<D>(kg, n0, tk, kDqKeys, sK, S::kRowStride, sKt, S::kKtStride, tid);
    stage_rows<D>(vg, n0, tk, kDqKeys, sV, S::kRowStride, nullptr, 0, tid);
    if (kHasBias) {
      for (int i = tid; i < kDqKeys; i += kThreads) {
        sBias[i] = (n0 + i < tk) ? bias_row[n0 + i] : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys each
    float s[kDqKeys / 8][4], dp[kDqKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qw, S::kRowStride, kk * 16, g, t4);
      load_a(da, dow, S::kRowStride, kk * 16, g, t4);
#pragma unroll
      for (int j = 0; j < kDqKeys / 8; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * S::kRowStride + kk * 16 + 2 * t4;
        const __nv_bfloat16* vp = sV + (j * 8 + g) * S::kRowStride + kk * 16 + 2 * t4;
        mma_16816(s[j], qa, ld_u32(kp), ld_u32(kp + 8));
        mma_16816(dp[j], da, ld_u32(vp), ld_u32(vp + 8));
      }
    }

    // P and dS in f32; dS replaces S
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        const int r = e >> 1;
        float x = s[j][e] * scale;
        if (kHasBias) x += sBias[col];
        const float p = (n0 + col < tk) ? expf(x - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;
      }
    }

    // dQ += dS K with dS rounded to bf16; B = K^T pairs along keys (sKt)
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* kp = sKt + (n * 8 + g) * S::kKtStride + kk * 16 + 2 * t4;
        mma_16816(acc[n], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }
  }

  __nv_bfloat16* dqg = dq + (size_t)bh * tq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row[0] < tq) {
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row[0] * D + col) =
          pack_bf16(acc[n][0], acc[n][1]);
    }
    if (row[1] < tq) {
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row[1] * D + col) =
          pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

template <int D, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int heads, int tq, int tk, float scale) {
  using S = KvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + S::kKElems;
  __nv_bfloat16* sQ = sV + S::kKElems;
  __nv_bfloat16* sdO = sQ + S::kQElems;
  __nv_bfloat16* sQt = sdO + S::kQElems;
  __nv_bfloat16* sdOt = sQt + S::kTElems;
  float* sLse = reinterpret_cast<float*>(sdOt + S::kTElems);
  float* sDelta = sLse + kKvQueries;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKvRows;
  const __nv_bfloat16* qg = q + (size_t)bh * tq * D;
  const __nv_bfloat16* dog = dout + (size_t)bh * tq * D;
  const __nv_bfloat16* kg = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * tk * D;
  const float* lse_g = lse + (size_t)bh * tq;
  const float* delta_g = delta + (size_t)bh * tq;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  stage_rows<D>(kg, k0, tk, kKvRows, sK, S::kRowStride, nullptr, 0, tid);
  stage_rows<D>(vg, k0, tk, kKvRows, sV, S::kRowStride, nullptr, 0, tid);

  // this thread's two key rows and their bias (keys past Tk never store)
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float bias_r[2] = {0.f, 0.f};
  if (kHasBias) {
    const float* bias_row = bias + (size_t)(bh / heads) * tk;
#pragma unroll
    for (int r = 0; r < 2; ++r) bias_r[r] = key[r] < tk ? bias_row[key[r]] : kNegInf;
  }
  const __nv_bfloat16* kw = sK + warp * 16 * S::kRowStride;
  const __nv_bfloat16* vw = sV + warp * 16 * S::kRowStride;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int m0 = 0; m0 < tq; m0 += kKvQueries) {
    __syncthreads();  // every warp is done with the previous query tile
    stage_rows<D>(qg, m0, tq, kKvQueries, sQ, S::kRowStride, sQt, S::kTStride, tid);
    stage_rows<D>(dog, m0, tq, kKvQueries, sdO, S::kRowStride, sdOt, S::kTStride,
                  tid);
    for (int i = tid; i < kKvQueries; i += kThreads) {
      const bool in = m0 + i < tq;
      sLse[i] = in ? lse_g[m0 + i] : 0.f;
      sDelta[i] = in ? delta_g[m0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries each
    float st[kKvQueries / 8][4], dpt[kKvQueries / 8][4];
#pragma unroll
    for (int j = 0; j < kKvQueries / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, kw, S::kRowStride, kk * 16, g, t4);
      load_a(va, vw, S::kRowStride, kk * 16, g, t4);
#pragma unroll
      for (int j = 0; j < kKvQueries / 8; ++j) {
        const __nv_bfloat16* qp = sQ + (j * 8 + g) * S::kRowStride + kk * 16 + 2 * t4;
        const __nv_bfloat16* dp = sdO + (j * 8 + g) * S::kRowStride + kk * 16 + 2 * t4;
        mma_16816(st[j], ka, ld_u32(qp), ld_u32(qp + 8));
        mma_16816(dpt[j], va, ld_u32(dp), ld_u32(dp + 8));
      }
    }

    // P^T replaces S^T, dS^T replaces dP^T (f32)
#pragma unroll
    for (int j = 0; j < kKvQueries / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);  // query within the tile
        float x = st[j][e] * scale;
        if (kHasBias) x += bias_r[e >> 1];
        const float p = (m0 + col < tq) ? expf(x - sLse[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDelta[col]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16; B operands
    // pairs along queries (sdOt, sQt)
#pragma unroll
    for (int kk = 0; kk < kKvQueries / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(st[2 * kk][0], st[2 * kk][1]),
          pack_bf16(st[2 * kk][2], st[2 * kk][3]),
          pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]),
      };
      const uint32_t sa[4] = {
          pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* op = sdOt + (n * 8 + g) * S::kTStride + kk * 16 + 2 * t4;
        const __nv_bfloat16* qp = sQt + (n * 8 + g) * S::kTStride + kk * 16 + 2 * t4;
        mma_16816(dv_acc[n], pa, ld_u32(op), ld_u32(op + 8));
        mma_16816(dk_acc[n], sa, ld_u32(qp), ld_u32(qp + 8));
      }
    }
  }

  __nv_bfloat16* dkg = dk + (size_t)bh * tk * D;
  __nv_bfloat16* dvg = dv + (size_t)bh * tk * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] < tk) {
        *reinterpret_cast<uint32_t*>(dkg + (size_t)key[r] * D + col) =
            pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvg + (size_t)key[r] * D + col) =
            pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  int batch_heads, heads, tq, tk;
  float scale;
};

template <int D, bool kHasBias>
cudaError_t launch_dq(const Args& a, __nv_bfloat16* dq, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D, kHasBias>;
  const int smem = static_cast<int>(DqSmem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kDqRows - 1) / kDqRows, a.batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                           a.delta, a.bias, dq, a.heads, a.tq,
                                           a.tk, a.scale);
  return cudaGetLastError();
}

template <int D, bool kHasBias>
cudaError_t launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D, kHasBias>;
  const int smem = static_cast<int>(KvSmem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + kKvRows - 1) / kKvRows, a.batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                           a.delta, a.bias, dk, dv, a.heads,
                                           a.tq, a.tk, a.scale);
  return cudaGetLastError();
}

// one launch: the dq kernel when dq is given, else the dkv kernel
template <int D>
cudaError_t dispatch(const Args& a, void* dq, void* dk, void* dv,
                     cudaStream_t stream) {
  auto* dq_ = static_cast<__nv_bfloat16*>(dq);
  auto* dk_ = static_cast<__nv_bfloat16*>(dk);
  auto* dv_ = static_cast<__nv_bfloat16*>(dv);
  if (dq != nullptr) {
    return a.bias != nullptr ? launch_dq<D, true>(a, dq_, stream)
                             : launch_dq<D, false>(a, dq_, stream);
  }
  return a.bias != nullptr ? launch_dkv<D, true>(a, dk_, dv_, stream)
                           : launch_dkv<D, false>(a, dk_, dv_, stream);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* bias, void* dq,
        void* dk, void* dv, int batch_heads, int heads, int tq, int tk,
        int head_dim, float scale, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(bias),
               batch_heads, heads, tq, tk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return dispatch<16>(a, dq, dk, dv, s);
    case 32: return dispatch<32>(a, dq, dk, dv, s);
    case 64: return dispatch<64>(a, dq, dk, dv, s);
    case 128: return dispatch<128>(a, dq, dk, dv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout, dq: (batch_heads, tq, head_dim) bf16; k, v: (batch_heads, tk,
// head_dim) bf16; lse, delta: (batch_heads, tq) f32; bias: NULL or
// (batch_heads / heads, tk) f32. All contiguous, 16-byte aligned. Each
// returns the CUDA error of its one launch (0 on success).
extern "C" int ltx_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* bias, void* dq,
                                          int batch_heads, int heads, int tq,
                                          int tk, int head_dim, float scale,
                                          void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, dout, lse, delta, bias, dq, nullptr, nullptr,
             batch_heads, heads, tq, tk, head_dim, scale, stream);
}

// dk, dv: (batch_heads, tk, head_dim) bf16; the rest as above.
extern "C" int ltx_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           const void* bias, void* dk, void* dv,
                                           int batch_heads, int heads, int tq,
                                           int tk, int head_dim, float scale,
                                           void* stream) {
  if (dk == nullptr || dv == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(q, k, v, dout, lse, delta, bias, nullptr, dk, dv, batch_heads,
             heads, tq, tk, head_dim, scale, stream);
}
