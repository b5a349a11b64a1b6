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
// the scale/bias/lse arithmetic are f32 (P = exp2 of the logit in log2 units,
// scale * log2(e), bias and lse times log2(e), as the forward); P and dS are
// rounded to bf16 for the dV, dQ and dK products (f32 accumulation), as
// FlashAttention-2 does; the reference keeps them f32, and
// ltx_tpu_torch/checks.py states the tolerance that follows. Keys past Tk get
// P = 0 explicitly in the dq kernel. Queries past Tq get lse = +inf, so P =
// exp2(-inf) = 0 and dS = 0 (their Q and dO rows are TMA's zeros, never
// NaN). A key the bias masks with -1e30 gets P = 0 and exactly zero dK and dV.
//
// What bounds it on an H100: the five products cost 10 * B*H*Tq*Tk*D flops
// against O((Tq + Tk) * D) bytes, so at the DiT's 1024-1536 keys it is
// compute-bound (tensor cores, 989 TFLOP/s bf16 dense), reachable only
// through wgmma. The split into a query-stationary dq kernel and a
// key-stationary dkv kernel is the reference's own, and keeps the result
// deterministic: no block writes what another block writes, so there are no
// atomics. Its cost: Q K^T and dO V^T are computed in both kernels, 14 flops
// per (q, k, d) instead of the 10 of one fused kernel with atomic f32 dQ
// (FlashAttention-3's backward), so the pair's bound at the DiT's
// self-attention is the dq kernel's 6 plus the dkv kernel's 8 units.
//
// Both kernels have the shape of the forward (flash_attention_fwd.cu): a
// block of three warpgroups; warpgroup 0 is the producer (setmaxnreg 24):
// one thread issues the TMA loads, into mbarrier-guarded rings with "full"
// barriers (the copy's transaction bytes) and "empty" barriers (one arrival
// per consumer warp). Warpgroups 1 and 2 are the consumers (setmaxnreg 240),
// 64 rows each. Every product is a wgmma: the two that recompute S and dP
// read both operands from shared memory, K-major (no transposed copies); the
// three gradient products take P or dS from registers and read their B
// operand in its natural (rows x D) layout with wgmma's transpose bit.
//   dq kernel:  a block per (128 queries, batch * head), query tiles fastest.
//               Q and dO are loaded once; K and V stream through a ring of
//               three stages of 64 keys. Per tile: S = Q K^T and dP = dO V^T
//               (m64n64k16 each), then P and dS in f32, dS packed to bf16 as
//               the A fragments of dQ += dS K (m64nDk16, K read MN-major).
//               The dQ product of tile n - 1 is queued behind tile n's S and
//               dP and runs while tile n's dS is computed. The key bias goes
//               through shared memory a tile ahead, one key a thread, as in
//               the forward; lse and delta are per row: registers.
//   dkv kernel: a block per (128 keys, batch * head). K and V are loaded
//               once; Q, dO and the tile's lse and delta (written by the
//               producer's first warp, which then arrives on the full
//               barrier beside the TMA bytes) stream through a ring of three
//               stages of 64 queries. Per tile: S^T = K Q^T and dP^T = V dO^T
//               (m64n64k16), P^T and dS^T in f32, both packed to bf16 as A
//               fragments of dV += P^T dO and dK += dS^T Q (m64nDk16, dO and Q
//               read MN-major). The key bias is per row of S^T: registers.
//               dK and dV hold 2 x D / 2 f32 registers a thread, which is
//               why the query tile stays at 64.
//
// Fragment map. wgmma's f32 accumulator of a 64 x N tile gives the thread
// with lane = 4 g + t4 of warp w, element [4 j + 2 r + e], row 16 w + g + 8 r
// and column 8 j + 2 t4 + e. The A fragment of a 64 x 16 k step kk in
// registers is (row g, cols 16 kk + 2 t4 + {0, 1}), (row g + 8, the same),
// (row g, cols + 8), (row g + 8, cols + 8): exactly accumulator elements
// [8 kk + 2 r'] and [8 kk + 2 r' + 1] for r' = 0..3, so packing the pairs of
// an S-shaped accumulator gives the A operand of the next product. In the
// dq kernel rows are queries and columns keys (lse, delta by row, bias by
// column); in the dkv kernel S^T's rows are keys and its columns queries
// (bias by row, lse and delta by column): the P^T hand-off is the forward's
// P hand-off transposed in meaning, not in registers.
//
// Layouts: q, k, v and dO are (B, H, T, D) views with a dense last dim, other
// strides multiples of 16 bytes and a 16-byte aligned base
// (kernels/flash_attention.py::kernel_strides); dQ, dK and dV are written in
// the layouts of q, k and v. One block per (tile, batch * head) on grid.x:
// no limit on batch * heads below 2**31 blocks.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDqRows = 128;   // queries per dq block, 64 per consumer
constexpr int kDqKeys = 64;    // keys per K/V tile
constexpr int kDqStages = 3;   // depth of the K/V ring
constexpr int kKvRows = 128;   // keys per dkv block, 64 per consumer
constexpr int kKvQueries = 64;  // queries per Q/dO tile
constexpr int kKvStages = 3;   // depth of the Q/dO ring

// a tile of kRows rows by D in shared memory: Swizzle<D>::kBoxes boxes of
// kRows x kRowBytes
template <int D, int kRows>
struct Box : Swizzle<D> {
  using Swizzle<D>::kRowBytes;
  using Swizzle<D>::kBoxes;
  static constexpr int kBoxBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
};

template <int D>
struct DqSmem {
  using QB = Box<D, kDqRows>;
  using KB = Box<D, kDqKeys>;
  static constexpr int kQ = 0;
  static constexpr int kDO = QB::kTileBytes;
  static constexpr int kK = 2 * QB::kTileBytes;
  static constexpr int kV = kK + kDqStages * KB::kTileBytes;
  // 1 + 4 * kDqStages barriers of 8 bytes
  static constexpr int kBar = kV + kDqStages * KB::kTileBytes;
  // the key bias of a tile, log2 units: two slots for each consumer
  static constexpr int kBias = kBar + 128;
  // + slack to align the base to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int kSmemBytes = kBias + 2 * 2 * kDqKeys * 4 + 1024;
};

template <int D>
struct KvSmem {
  using KB = Box<D, kKvRows>;
  using QB = Box<D, kKvQueries>;
  static constexpr int kK = 0;
  static constexpr int kV = KB::kTileBytes;
  static constexpr int kQ = 2 * KB::kTileBytes;
  static constexpr int kDO = kQ + kKvStages * QB::kTileBytes;
  // per stage: lse (log2 units) and delta of the tile's queries, f32
  static constexpr int kStats = kDO + kKvStages * QB::kTileBytes;
  // 1 + 2 * kKvStages barriers of 8 bytes
  static constexpr int kBar = kStats + kKvStages * 2 * kKvQueries * 4;
  static constexpr int kSmemBytes = kBar + 128 + 1024;
};

struct Params {
  const float* lse;    // (batch * heads, tq) f32
  const float* delta;  // (batch * heads, tq) f32
  const float* bias;   // (batch, tk) f32, or null
  __nv_bfloat16* out0;  // dQ (dq kernel) or dK (dkv kernel)
  __nv_bfloat16* out1;  // dV (dkv kernel)
  long long o0_sb, o0_sh, o0_st, o1_sb, o1_sh, o1_st;  // their strides, elements
  int heads, tq, tk;
  int tiles;  // the block tiles of one head: query tiles (dq) or key tiles (dkv)
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e)
};

// the lse of a query past Tq: P = exp2(logit - inf) = 0
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// the S-shaped accumulator of 64 columns, in bf16 pairs, as the A fragments
// of four 16-deep k steps (the fragment map in the note above)
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
  }
}

// a thread's two rows (row0 and row0 + 8) of a 64 x D accumulator to a
// (T, D) view with row stride `st`, rows below `n`
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long st, int row0, int n,
                                           const float (&acc)[D / 2], int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      __nv_bfloat16* orow = out + row * st + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool kHasBias>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = DqSmem<D>;
  using QB = typename L::QB;
  using KB = typename L::KB;
  constexpr int S = kDqStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ;
  const uint32_t s_do = base + L::kDO;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  // barriers: Q and dO full; for each stage K full, V full, K empty, V empty
  const uint32_t qd_full = base + L::kBar;
  const uint32_t k_full = qd_full + 8;
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;

  const int q_tile = blockIdx.x % p.tiles;
  const int bh = blockIdx.x / p.tiles;
  const int batch = bh / p.heads;
  const int head = bh % p.heads;
  const int q0 = q_tile * kDqRows;
  const int n_tiles = (p.tk + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * QB::kTileBytes);
      for (int x = 0; x < QB::kBoxes; ++x) {
        tma_load(s_q + x * QB::kBoxBytes, &tm_q, qd_full, x * QB::kBoxCols, q0, head, batch);
        tma_load(s_do + x * QB::kBoxBytes, &tm_do, qd_full, x * QB::kBoxCols, q0, head, batch);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % S;
        // the first pass finds every stage empty: parity 1 of a fresh barrier
        const uint32_t free_parity = ((n / S) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, free_parity);
        mbar_expect_tx(k_full + 8 * s, KB::kTileBytes);
        for (int x = 0; x < KB::kBoxes; ++x) {
          tma_load(s_k + s * KB::kTileBytes + x * KB::kBoxBytes, &tm_k, k_full + 8 * s,
                   x * KB::kBoxCols, n * kDqKeys, head, batch);
        }
        mbar_wait(v_empty + 8 * s, free_parity);
        mbar_expect_tx(v_full + 8 * s, KB::kTileBytes);
        for (int x = 0; x < KB::kBoxes; ++x) {
          tma_load(s_v + s * KB::kTileBytes + x * KB::kBoxBytes, &tm_v, v_full + 8 * s,
                   x * KB::kBoxCols, n * kDqKeys, head, batch);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int consumer = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  // this consumer's 64 rows of the Q and dO tiles, in every box
  const uint32_t q_rows = s_q + consumer * 64 * QB::kRowBytes;
  const uint32_t do_rows = s_do + consumer * 64 * QB::kRowBytes;
  const float* bias_row = kHasBias ? p.bias + static_cast<size_t>(batch) * p.tk : nullptr;
  float* const bias_slots = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                     L::kBias) + consumer * 2 * kDqKeys;

  // this thread's two query rows: lse in log2 units (+inf past Tq, so that
  // P = 0 there) and delta
  const int row0 = q0 + consumer * 64 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < p.tq;
    lse2[r] = in ? p.lse[static_cast<size_t>(bh) * p.tq + row] * kLog2e : pos_inf();
    dlt[r] = in ? p.delta[static_cast<size_t>(bh) * p.tq + row] : 0.f;
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  // S = Q K^T and dP = dO V^T of tile n, 64 rows x 64 keys each, f32, both
  // operands K-major in shared memory: issued as one group, not waited for
  float sacc[32], dpacc[32];
  auto issue_s_dp = [&](int n) {
    const uint32_t k_tile = s_k + (n % S) * KB::kTileBytes;
    const uint32_t v_tile = s_v + (n % S) * KB::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % QB::kBoxSteps) * 32;
      const uint32_t qo = (kk / QB::kBoxSteps) * QB::kBoxBytes + col;
      const uint32_t ko = (kk / QB::kBoxSteps) * KB::kBoxBytes + col;
      wgmma_ss_m64n64k16(sacc, smem_desc(q_rows + qo, 16, QB::kGroupBytes, QB::kLayout),
                         smem_desc(k_tile + ko, 16, QB::kGroupBytes, QB::kLayout), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % QB::kBoxSteps) * 32;
      const uint32_t qo = (kk / QB::kBoxSteps) * QB::kBoxBytes + col;
      const uint32_t ko = (kk / QB::kBoxSteps) * KB::kBoxBytes + col;
      wgmma_ss_m64n64k16(dpacc, smem_desc(do_rows + qo, 16, QB::kGroupBytes, QB::kLayout),
                         smem_desc(v_tile + ko, 16, QB::kGroupBytes, QB::kLayout), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K of tile n, dS in registers, K read as the K x N operand in
  // its (keys x D) layout: issued, not waited for
  uint32_t dsf[4][4];
  auto issue_dq = [&](int n) {
    const uint32_t k_tile = s_k + (n % S) * KB::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      wgmma_rs<D>(dq_acc, dsf[kk], smem_desc(k_tile + kk * 16 * KB::kRowBytes, KB::kBoxBytes,
                                             KB::kGroupBytes, KB::kLayout));
    }
    wgmma_commit();
  };
  // the key bias through shared memory, as the forward: each of the first
  // 64 threads fetches one key of the next tile while this one runs, writes
  // its key of tile n into slot n % 2 at the top of tile n, then the
  // warpgroup syncs; slot n % 2 was last read by tile n - 2's dS, which every
  // thread finished before tile n - 1's sync
  float bias_next = 0.f;
  auto fetch_bias = [&](int n) {
    const int col = n * kDqKeys + tid;
    bias_next = tid < kDqKeys && n < n_tiles && col < p.tk ? __ldg(bias_row + col) * kLog2e : 0.f;
  };
  auto stage_bias = [&](int n) {
    if constexpr (kHasBias) {
      if (tid < kDqKeys) bias_slots[(n % 2) * kDqKeys + tid] = bias_next;
      fetch_bias(n + 1);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + consumer) : "memory");
    }
  };
  // S -> dS in place: P = exp2(S scale log2e + bias - lse), 0 on keys past
  // Tk; dS = P (dP - delta) scale, all f32
  auto compute_ds = [&](int n) {
    const int k0 = n * kDqKeys;
    const bool tail = k0 + kDqKeys > p.tk;
    const float* bias_tile = bias_slots + (n % 2) * kDqKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 bias2 = make_float2(0.f, 0.f);
      if constexpr (kHasBias) bias2 = *reinterpret_cast<const float2*>(bias_tile + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = sacc[4 * j + e] * p.scale_log2;
        if constexpr (kHasBias) x += (e & 1) ? bias2.y : bias2.x;
        float prob = fast_exp2(x - lse2[r]);
        if (tail && k0 + 8 * j + 2 * t4 + (e & 1) >= p.tk) prob = 0.f;
        sacc[4 * j + e] = prob * (dpacc[4 * j + e] - dlt[r]) * p.scale;
      }
    }
  };
  // this warp is done with K (V) of tile n: its stage may be loaded again
  auto release = [&](uint32_t empty, int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (n % S));
  };
  auto parity = [](int n) { return static_cast<uint32_t>((n / S) & 1); };

  // Tile n's S and dP run while tile n - 1's dQ product is queued behind
  // them, and tile n's dS is computed while that product runs:
  //   for n: issue S_n, dP_n; issue dQ += dS_{n-1} K_{n-1}; wait S_n, dP_n;
  //          release V_n; dS_n; wait dQ; release K_{n-1}; pack dS_n;
  //   dQ += dS_last K_last.
  if constexpr (kHasBias) fetch_bias(0);
  mbar_wait(qd_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    stage_bias(n);
    mbar_wait(k_full + 8 * (n % S), parity(n));
    mbar_wait(v_full + 8 * (n % S), parity(n));
    wgmma_fence();
    issue_s_dp(n);
    if (n > 0) {
      issue_dq(n - 1);
      wgmma_wait<1>();  // S_n and dP_n done; dQ of tile n - 1 may still run
    } else {
      wgmma_wait<0>();
    }
    pin(sacc);
    pin(dpacc);
    release(v_empty, n);
    compute_ds(n);
    if (n > 0) {
      wgmma_wait<0>();
      pin(dq_acc);
      pin(dsf);
      release(k_empty, n - 1);
    }
    pack_frags(dsf, sacc);
  }
  if (n_tiles > 0) {
    wgmma_fence();
    issue_dq(n_tiles - 1);
    wgmma_wait<0>();
    pin(dq_acc);
    pin(dsf);
    release(k_empty, n_tiles - 1);
  }

  store_rows<D>(p.out0 + batch * p.o0_sb + head * p.o0_sh, p.o0_st, row0, p.tq, dq_acc, t4);
}

template <int D, bool kHasBias>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = KvSmem<D>;
  using KB = typename L::KB;
  using QB = typename L::QB;
  constexpr int S = kKvStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  const uint32_t s_q = base + L::kQ;
  const uint32_t s_do = base + L::kDO;
  float* const stats = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                L::kStats);
  // barriers: K and V full; for each stage Q/dO/stats full, Q/dO/stats empty
  const uint32_t kv_full = base + L::kBar;
  const uint32_t qd_full = kv_full + 8;
  const uint32_t qd_empty = qd_full + 8 * S;

  const int k_tile = blockIdx.x % p.tiles;
  const int bh = blockIdx.x / p.tiles;
  const int batch = bh / p.heads;
  const int head = bh % p.heads;
  const int k0 = k_tile * kKvRows;
  const int m_tiles = (p.tq + kKvQueries - 1) / kKvQueries;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(qd_full + 8 * s, 32);  // the producer's first warp, lane 0 with the bytes
      mbar_init(qd_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KB::kTileBytes);
        for (int x = 0; x < KB::kBoxes; ++x) {
          tma_load(s_k + x * KB::kBoxBytes, &tm_k, kv_full, x * KB::kBoxCols, k0, head, batch);
          tma_load(s_v + x * KB::kBoxBytes, &tm_v, kv_full, x * KB::kBoxCols, k0, head, batch);
        }
      }
      const float* lse = p.lse + static_cast<size_t>(bh) * p.tq;
      const float* delta = p.delta + static_cast<size_t>(bh) * p.tq;
      for (int m = 0; m < m_tiles; ++m) {
        const int s = m % S;
        mbar_wait(qd_empty + 8 * s, ((m / S) & 1) ^ 1);
        // the tile's lse (log2 units, +inf past Tq: P = 0 there) and delta,
        // two queries a lane, published by this lane's arrival
        float* st = stats + s * 2 * kKvQueries;
        for (int i = lane; i < kKvQueries; i += 32) {
          const int row = m * kKvQueries + i;
          const bool in = row < p.tq;
          st[i] = in ? lse[row] * kLog2e : pos_inf();
          st[kKvQueries + i] = in ? delta[row] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(qd_full + 8 * s, 2 * QB::kTileBytes);
          for (int x = 0; x < QB::kBoxes; ++x) {
            tma_load(s_q + s * QB::kTileBytes + x * QB::kBoxBytes, &tm_q, qd_full + 8 * s,
                     x * QB::kBoxCols, m * kKvQueries, head, batch);
            tma_load(s_do + s * QB::kTileBytes + x * QB::kBoxBytes, &tm_do, qd_full + 8 * s,
                     x * QB::kBoxCols, m * kKvQueries, head, batch);
          }
        } else {
          mbar_arrive(qd_full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int consumer = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  // this consumer's 64 rows of the K and V tiles, in every box
  const uint32_t k_rows = s_k + consumer * 64 * KB::kRowBytes;
  const uint32_t v_rows = s_v + consumer * 64 * KB::kRowBytes;
  // this thread's two keys and their bias (log2 units; keys past Tk are
  // never stored)
  const int key0 = k0 + consumer * 64 + warp * 16 + g;
  float bias2[2] = {0.f, 0.f};
  if constexpr (kHasBias) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      bias2[r] = key < p.tk ? p.bias[static_cast<size_t>(batch) * p.tk + key] * kLog2e : 0.f;
    }
  }

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float sacc[32], dpacc[32];
  uint32_t pf[4][4], dsf[4][4];

  // Per query tile m: S^T and dP^T (one group), wait; P^T and dS^T in f32;
  // pack; dV and dK (one group), wait; release the stage. The two consumers
  // keep the tensor cores busy between each other's waits.
  mbar_wait(kv_full, 0);
  for (int m = 0; m < m_tiles; ++m) {
    const int s = m % S;
    mbar_wait(qd_full + 8 * s, static_cast<uint32_t>((m / S) & 1));
    const uint32_t q_tile = s_q + s * QB::kTileBytes;
    const uint32_t do_tile = s_do + s * QB::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % KB::kBoxSteps) * 32;
      const uint32_t ko = (kk / KB::kBoxSteps) * KB::kBoxBytes + col;
      const uint32_t qo = (kk / KB::kBoxSteps) * QB::kBoxBytes + col;
      wgmma_ss_m64n64k16(sacc, smem_desc(k_rows + ko, 16, KB::kGroupBytes, KB::kLayout),
                         smem_desc(q_tile + qo, 16, KB::kGroupBytes, KB::kLayout), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % KB::kBoxSteps) * 32;
      const uint32_t ko = (kk / KB::kBoxSteps) * KB::kBoxBytes + col;
      const uint32_t qo = (kk / KB::kBoxSteps) * QB::kBoxBytes + col;
      wgmma_ss_m64n64k16(dpacc, smem_desc(v_rows + ko, 16, KB::kGroupBytes, KB::kLayout),
                         smem_desc(do_tile + qo, 16, KB::kGroupBytes, KB::kLayout), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(sacc);
    pin(dpacc);

    // S^T -> P^T and dP^T -> dS^T in place; rows are keys, columns queries
    const float* st = stats + s * 2 * kKvQueries;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(st + kKvQueries + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * p.scale_log2;
        if constexpr (kHasBias) x += bias2[e >> 1];
        const float prob = fast_exp2(x - ((e & 1) ? l2.y : l2.x));
        sacc[4 * j + e] = prob;
        dpacc[4 * j + e] = prob * (dpacc[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
      }
    }
    pack_frags(pf, sacc);
    pack_frags(dsf, dpacc);

    // dV += P^T dO and dK += dS^T Q, dO and Q read as the K x N operand in
    // their (queries x D) layout
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKvQueries / 16; ++kk) {
      wgmma_rs<D>(dv_acc, pf[kk], smem_desc(do_tile + kk * 16 * QB::kRowBytes, QB::kBoxBytes,
                                            QB::kGroupBytes, QB::kLayout));
    }
#pragma unroll
    for (int kk = 0; kk < kKvQueries / 16; ++kk) {
      wgmma_rs<D>(dk_acc, dsf[kk], smem_desc(q_tile + kk * 16 * QB::kRowBytes, QB::kBoxBytes,
                                             QB::kGroupBytes, QB::kLayout));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
    pin(pf);
    pin(dsf);
    __syncwarp();
    if (lane == 0) mbar_arrive(qd_empty + 8 * s);
  }

  store_rows<D>(p.out0 + batch * p.o0_sb + head * p.o0_sh, p.o0_st, key0, p.tk, dk_acc, t4);
  store_rows<D>(p.out1 + batch * p.o1_sb + head * p.o1_sh, p.o1_st, key0, p.tk, dv_acc, t4);
}

// ---- host side ----

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  void *out0, *out1;  // dQ, or dK and dV
  int batch, heads, tq, tk;
  // q, k, v, dO, out0[, out1]: (sb, sh, st) each, elements
  const long long* strides;
  float scale;
  cudaStream_t stream;
};

// the four tensor maps (q and dO with boxes of q_rows rows, k and v of
// k_rows) and the kernel's parameters
template <int D>
cudaError_t prepare(const Args& a, int q_rows, int k_rows, CUtensorMap (&maps)[4], Params& p) {
  cudaError_t err;
  if ((err = tensor_map<D>(&maps[0], a.q, a.tq, a.heads, a.batch, a.strides, q_rows)) !=
          cudaSuccess ||
      (err = tensor_map<D>(&maps[1], a.k, a.tk, a.heads, a.batch, a.strides + 3, k_rows)) !=
          cudaSuccess ||
      (err = tensor_map<D>(&maps[2], a.v, a.tk, a.heads, a.batch, a.strides + 6, k_rows)) !=
          cudaSuccess ||
      (err = tensor_map<D>(&maps[3], a.dout, a.tq, a.heads, a.batch, a.strides + 9, q_rows)) !=
          cudaSuccess) {
    return err;
  }
  p.lse = a.lse;
  p.delta = a.delta;
  p.bias = a.bias;
  p.out0 = static_cast<__nv_bfloat16*>(a.out0);
  p.out1 = static_cast<__nv_bfloat16*>(a.out1);
  p.o0_sb = a.strides[12];
  p.o0_sh = a.strides[13];
  p.o0_st = a.strides[14];
  p.o1_sb = a.out1 != nullptr ? a.strides[15] : 0;
  p.o1_sh = a.out1 != nullptr ? a.strides[16] : 0;
  p.o1_st = a.out1 != nullptr ? a.strides[17] : 0;
  p.heads = a.heads;
  p.tq = a.tq;
  p.tk = a.tk;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  return cudaSuccess;
}

template <int D, bool kHasBias>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<D, kHasBias>;
  const int smem = DqSmem<D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  Params p;
  if ((err = prepare<D>(a, kDqRows, kDqKeys, maps, p)) != cudaSuccess) return err;
  p.tiles = (a.tq + kDqRows - 1) / kDqRows;
  const long long blocks = static_cast<long long>(p.tiles) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(maps[0], maps[1], maps[2],
                                                                      maps[3], p);
  return cudaGetLastError();
}

template <int D, bool kHasBias>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<D, kHasBias>;
  const int smem = KvSmem<D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  Params p;
  if ((err = prepare<D>(a, kKvQueries, kKvRows, maps, p)) != cudaSuccess) return err;
  p.tiles = (a.tk + kKvRows - 1) / kKvRows;
  const long long blocks = static_cast<long long>(p.tiles) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(maps[0], maps[1], maps[2],
                                                                      maps[3], p);
  return cudaGetLastError();
}

// one launch: the dkv kernel when out1 (dV) is given, else the dq kernel
template <int D>
cudaError_t dispatch(const Args& a) {
  if (a.out1 != nullptr) {
    return a.bias != nullptr ? launch_dkv<D, true>(a) : launch_dkv<D, false>(a);
  }
  return a.bias != nullptr ? launch_dq<D, true>(a) : launch_dq<D, false>(a);
}

int run(const Args& a, int head_dim) {
  switch (head_dim) {
    case 16: return static_cast<int>(dispatch<16>(a));
    case 32: return static_cast<int>(dispatch<32>(a));
    case 64: return static_cast<int>(dispatch<64>(a));
    case 128: return static_cast<int>(dispatch<128>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout, dq: (batch, heads, tq, head_dim) bf16; k, v: (batch, heads, tk,
// head_dim) bf16; each a view with a dense last dim and the element strides
// (sb, sh, st) in `strides` (q, k, v, dout, dq: 15 values), every stride a
// multiple of 8 elements and every base 16-byte aligned; lse, delta:
// (batch, heads, tq) f32, contiguous; bias: NULL or (batch, tk) f32,
// contiguous. Returns the CUDA error of its one launch (0 on success).
extern "C" int ltx_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* bias, void* dq, int batch, int heads,
                                          int tq, int tk, int head_dim,
                                          const long long* strides, float scale,
                                          void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(bias), dq, nullptr, batch, heads, tq, tk, strides,
               scale, static_cast<cudaStream_t>(stream)};
  return run(a, head_dim);
}

// dk, dv: (batch, heads, tk, head_dim) bf16 views; strides: q, k, v, dout,
// dk, dv (18 values); the rest as above.
extern "C" int ltx_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, const void* bias, void* dk,
                                           void* dv, int batch, int heads, int tq, int tk,
                                           int head_dim, const long long* strides, float scale,
                                           void* stream) {
  if (dk == nullptr || dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(bias), dk, dv, batch, heads, tq, tk, strides, scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, head_dim);
}
