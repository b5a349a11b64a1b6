// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel ltx_tpu/kernels/flash_attention.py::flash_attention
// (_flash_kernel / _bias_free_kernel): out = softmax(scale * Q K^T + key_bias) V
// over q (B, H, Tq, D), k and v (B, H, Tk, D), with an optional f32 key bias
// (B, Tk) broadcast over heads and queries. With kStats it also replaces
// _stats_kernel / _stats_kernel_bias_free: it writes each row's softmax
// statistics m (the max of the scaled, biased logits) and l (the sum of
// exp(logit - m)), both f32 (B, H, Tq) in natural-log units; the
// differentiable attention takes lse = m + log(l) from them for the backward
// (csrc/flash_attention_bwd.cu).
//
// Numerics follow the TPU kernel: Q K^T is exact bf16 products accumulated in
// f32, scale and bias are applied in f32, the running max, sum and output
// accumulator are f32, P is rounded to bf16 before the P V product (f32
// accumulation), the row sum uses the f32 P, and a row whose sum is 0 writes
// 0. Keys past Tk get the pad logit -1e30, as the TPU's padded keys do. The
// softmax runs in log2 units (logits times log2(e), exp2), and m is written
// back in natural-log units.
//
// What bounds it on an H100: at the DiT's 1536-9216 tokens with D = 128 the
// attention does about T/2 flops per byte of Q, K, V and O, far above the
// card's ~295 flop/byte balance point, so the bound is the tensor cores (989
// TFLOP/s bf16 dense), reachable only through wgmma. The design is
// FlashAttention-3's forward (Shah et al., 2024), simplified:
//   * warp specialisation: a block of three warpgroups owns 128 query rows of
//     one (batch, head). Warpgroup 0 is the producer: one thread issues every
//     TMA load, and the warpgroup gives its registers away (setmaxnreg 24).
//     Warpgroups 1 and 2 are the consumers, 64 query rows each, with 240
//     registers a thread for the S and O accumulators;
//   * TMA loads of Q (once) and of K and V in tiles of 128 keys into a ring of
//     two stages, each stage with "full" mbarriers for K and for V (the
//     transaction bytes of the copy) and "empty" mbarriers for K and for V
//     that the eight consumer warps arrive on when they are done with one, so
//     loads run ahead of the products and a K stage is refilled as soon as
//     its Q K^T is done. The tiles are 128-byte swizzled (64 or 32 bytes for
//     D = 32, 16): a 128-wide bf16 row is two swizzle atoms, so a D = 128
//     tile is two 64-column boxes. TMA zero-fills rows past Tq and Tk, and
//     takes any (B, H, T) strides that are multiples of 16 bytes;
//   * wgmma for both products: S = Q K^T with both operands in shared memory
//     (m64n128k16, K-major), and O += P V with P in registers: the f32
//     accumulator fragment of S, rounded to bf16 pairs, is exactly the A
//     fragment of the next product, and V is read in its natural (keys x D)
//     layout with wgmma's transpose bit. The blocks of one head run next to
//     each other, so its K and V stay in L2.
//   * in each consumer, tile n's softmax overlaps tile n - 1's P V: both
//     products are issued, the softmax waits only for Q K^T (wgmma's commit
//     groups), and O is rescaled once P V is done. The key bias of a tile
//     goes through shared memory, fetched a tile ahead one key a thread, so
//     that S, O and P (160 registers a thread) leave room under 240.
// The two consumers also interleave on the tensor cores by themselves; FA3's
// explicit ping-pong between them is not done.
//
// Head dim 72 (SigLIP's 16 heads of 72): wgmma's k step is 16 bf16 values
// and the swizzled tiles are 64 columns wide, so a 72-wide head runs in the
// D = 128 tiles (template parameter DD = 72, the data's width). The tensor
// maps are 72 wide: TMA fills the tile's columns 72..127 with zeros, so the
// rows keep their 144-byte strides and SigLIP's (B, T, H * 72) projections go
// in as views, without a padded copy. Q K^T runs 5 of the 8 k steps (columns
// 0..79, the last 8 zero), P V the full 128-wide product (its columns past 72
// are zero), and the epilogue stores 72 columns: 0.81 of D = 128's products
// for 0.56 of its useful work.
//
// Layouts: q, k, v and o are (B, H, T, DD) views with a dense last dim, other
// strides multiples of 16 bytes and a 16-byte aligned base (the wrapper's
// rule, kernels/flash_attention.py::kernel_strides). The grid is one block
// per (query tile, batch * head), query tiles fastest.

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // depth of the K/V ring
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;              // the TPU kernel's pad logit
constexpr float kNegInf2 = kNegInf * kLog2e;   // the same in log2 units

// Shared-memory layout of one head dim. Every tile is 128 rows (queries or
// keys) by D, stored as kBoxes boxes of 128 rows x kRowBytes, each box in
// TMA's swizzled layout, which is wgmma's canonical one of the same swizzle
// (hopper.cuh).
template <int D>
struct Tile : Swizzle<D> {
  using Swizzle<D>::kRowBytes;
  using Swizzle<D>::kBoxes;
  static constexpr int kBoxBytes = 128 * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBarriers = 1 + 4 * kStages;
  // the key bias of a tile, log2 units: two slots for each consumer
  static constexpr int kBias = kBar + 128;
  // + slack to align the base to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int kSmemBytes = kBias + 2 * 2 * kBlockN * 4 + 1024;
};

struct Params {
  const float* bias;  // (batch, tk) f32, or null
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_st;  // o's strides, elements
  float* m;  // (batch * heads, tq) f32, or null
  float* l;
  int heads, tq, tk, q_tiles;
  float scale_log2;  // scale * log2(e)
};


// kRawProbs (the check of the P hand-off alone, `ltx_flash_fwd_pv_check`):
// no softmax, P = bf16(S) and O = P V, one tile of 128 keys. D is the
// tile's width, DD <= D the data's (a multiple of 8).
template <int D, int DD, bool kHasBias, bool kStats, bool kRawProbs>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + T::kQ;
  const uint32_t s_k = base + T::kK;
  const uint32_t s_v = base + T::kV;
  // barriers: Q full; for each stage K full, V full, K empty, V empty
  const uint32_t q_full = base + T::kBar;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int q_tile = blockIdx.x % p.q_tiles;
  const int bh = blockIdx.x / p.q_tiles;
  const int batch = bh / p.heads;
  const int head = bh % p.heads;
  const int q0 = q_tile * kBlockM;
  const int n_tiles = (p.tk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(q_full, T::kTileBytes);
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load(s_q + x * T::kBoxBytes, &tm_q, q_full, x * T::kBoxCols, q0, head, batch);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        // the first pass finds every stage empty: parity 1 of a fresh barrier
        const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, free_parity);
        mbar_expect_tx(k_full + 8 * s, T::kTileBytes);
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(s_k + s * T::kTileBytes + x * T::kBoxBytes, &tm_k, k_full + 8 * s,
                   x * T::kBoxCols, n * kBlockN, head, batch);
        }
        mbar_wait(v_empty + 8 * s, free_parity);
        mbar_expect_tx(v_full + 8 * s, T::kTileBytes);
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(s_v + s * T::kTileBytes + x * T::kBoxBytes, &tm_v, v_full + 8 * s,
                   x * T::kBoxCols, n * kBlockN, head, batch);
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
  const int g = lane / 4;   // accumulator row group
  const int t4 = lane % 4;  // thread within the group
  // this consumer's 64 rows of the Q tile, in every box
  const uint32_t q_rows = s_q + consumer * 64 * T::kRowBytes;
  const float* bias_row = kHasBias ? p.bias + static_cast<size_t>(batch) * p.tk : nullptr;
  float* const bias_slots = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                     T::kBias) + consumer * 2 * kBlockN;

  // O accumulator, wgmma's f32 fragment of a 64 x D tile: element
  // [4j + 2i + e] is row g + 8i (of this warp's 16), column 8j + 2 t4 + e
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  // running max (log2 units) of rows g and g + 8; this thread's share of
  // their sums, reduced over the quad at the end
  float m_run[2] = {kNegInf2, kNegInf2};
  float l_run[2] = {0.f, 0.f};

  // S = Q K^T of tile n, 64 rows x 128 keys, f32: issued, not waited for;
  // the k steps cover the data's DD columns (the tile's others are zero)
  auto issue_s = [&](float (&sacc)[64], int n) {
    const uint32_t k_tile = s_k + (n % kStages) * T::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < (DD + 15) / 16; ++kk) {
      const uint32_t off = (kk / T::kBoxSteps) * T::kBoxBytes + (kk % T::kBoxSteps) * 32;
      wgmma_ss_m64n128k16(sacc, smem_desc(q_rows + off, 16, T::kGroupBytes, T::kLayout),
                          smem_desc(k_tile + off, 16, T::kGroupBytes, T::kLayout), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile n, V read as the K x N operand in its (keys x D)
  // layout: issued, not waited for
  auto issue_pv = [&](const uint32_t (&pf)[8][4], int n) {
    const uint32_t v_tile = s_v + (n % kStages) * T::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_rs<D>(o_acc, pf[kk], smem_desc(v_tile + kk * 16 * T::kRowBytes, T::kBoxBytes,
                                           T::kGroupBytes, T::kLayout));
    }
    wgmma_commit();
  };
  // The key bias goes through shared memory, not 32 registers a thread:
  // each thread fetches one key of the next tile while this one runs, and
  // at the top of tile n writes its key of tile n into slot n % 2, then the
  // warpgroup syncs (a named barrier). Slot n % 2 was last read by tile
  // n - 2's softmax, which every thread finished before tile n - 1's sync.
  float bias_next = 0.f;  // this thread's key of the next tile, log2 units
  auto fetch_bias = [&](int n) {
    const int col = n * kBlockN + tid;
    bias_next = n < n_tiles && col < p.tk ? __ldg(bias_row + col) * kLog2e : 0.f;
  };
  auto stage_bias = [&](int n) {
    if constexpr (kHasBias) {
      bias_slots[(n % 2) * kBlockN + tid] = bias_next;
      fetch_bias(n + 1);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + consumer) : "memory");
    }
  };
  // the online softmax of tile n in place: S -> the unnormalised f32 P,
  // the running max and sums updated; returns through alpha the factor of
  // the earlier tiles' O rows. Logits in log2 units: scale and bias in
  // f32, the ragged tail -1e30.
  auto softmax = [&](float (&sacc)[64], int n, float (&alpha)[2]) {
    const int k0 = n * kBlockN;
    const bool tail = k0 + kBlockN > p.tk;
    const float* bias_tile = bias_slots + (n % 2) * kBlockN;
    float tile_max[2] = {kNegInf2, kNegInf2};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2 bias2 = make_float2(0.f, 0.f);
      if constexpr (kHasBias) bias2 = *reinterpret_cast<const float2*>(bias_tile + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * p.scale_log2;
        if constexpr (kHasBias) x += (e & 1) ? bias2.y : bias2.x;
        if (tail && k0 + 8 * j + 2 * t4 + (e & 1) >= p.tk) x = kNegInf2;
        sacc[4 * j + e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(tile_max[r]));
      alpha[r] = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sacc[i] = fast_exp2(sacc[i] - m_run[(i >> 1) & 1]);
      row_sum[(i >> 1) & 1] += sacc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + row_sum[r];
  };
  // P in bf16 as the A fragments of O += P V: the S accumulators of key
  // columns [16kk, 16kk + 16) are exactly the A fragment of k step kk
  auto pack_p = [&](uint32_t (&pf)[8][4], const float (&sacc)[64]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
      }
    }
  };
  // this warp is done with K (V) of tile n: its stage may be loaded again
  auto release = [&](uint32_t empty, int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (n % kStages));
  };
  auto parity = [](int n) { return static_cast<uint32_t>((n / kStages) & 1); };

  // Tile n's Q K^T runs on the tensor cores while tile n - 1's P V is
  // queued behind it and tile n's softmax waits only for the first:
  //   S_0; softmax_0;
  //   for n >= 1: issue S_n, issue P_{n-1} V_{n-1}; wait S_n; release K_n;
  //               softmax_n; wait P V; release V_{n-1}; rescale O by alpha_n;
  //   P_last V_last.
  // K and V have their own empty barriers, so the producer refills a K
  // stage as soon as its Q K^T is done.
  float sacc[64];
  uint32_t pf[8][4];
  float alpha[2];
  if constexpr (kHasBias) fetch_bias(0);
  stage_bias(0);
  mbar_wait(q_full, 0);
  mbar_wait(k_full, parity(0));
  wgmma_fence();
  issue_s(sacc, 0);
  wgmma_wait<0>();
  pin(sacc);
  release(k_empty, 0);
  if constexpr (!kRawProbs) softmax(sacc, 0, alpha);  // O is still 0: no rescale
  pack_p(pf, sacc);
  for (int n = 1; n < n_tiles; ++n) {
    stage_bias(n);
    mbar_wait(k_full + 8 * (n % kStages), parity(n));
    mbar_wait(v_full + 8 * ((n - 1) % kStages), parity(n - 1));
    wgmma_fence();
    issue_s(sacc, n);
    issue_pv(pf, n - 1);
    wgmma_wait<1>();  // S_n done; P_{n-1} V_{n-1} may still run
    pin(sacc);
    release(k_empty, n);
    softmax(sacc, n, alpha);
    wgmma_wait<0>();
    pin(o_acc);
    pin(pf);
    release(v_empty, n - 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
    pack_p(pf, sacc);
  }
  mbar_wait(v_full + 8 * ((n_tiles - 1) % kStages), parity(n_tiles - 1));
  wgmma_fence();
  issue_pv(pf, n_tiles - 1);
  wgmma_wait<0>();
  pin(o_acc);
  pin(pf);
  release(v_empty, n_tiles - 1);

  // normalise (a row whose sum is 0 writes 0) and store rows below Tq
  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = kRawProbs ? 1.f : quad_sum(l_run[r]);
  }
  const int row0 = q0 + consumer * 64 + warp * 16 + g;
  const float div[2] = {l_row[0] == 0.f ? 1.f : l_row[0], l_row[1] == 0.f ? 1.f : l_row[1]};
  __nv_bfloat16* ob = p.o + batch * p.o_sb + head * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.tq) {
      __nv_bfloat16* orow = ob + row * p.o_st + 2 * t4;
#pragma unroll
      for (int j = 0; j < DD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o_acc[4 * j + 2 * r] / div[r], o_acc[4 * j + 2 * r + 1] / div[r]);
      }
      // the quad's four threads hold the same row statistics: one writes them
      if (kStats && t4 == 0) {
        p.m[static_cast<size_t>(bh) * p.tq + row] = m_run[r] * kLn2;
        p.l[static_cast<size_t>(bh) * p.tq + row] = l_row[r];
      }
    }
  }
}

// ---- host side ----

struct Args {
  const void *q, *k, *v;
  const void* bias;
  void* o;
  void *m, *l;
  int batch, heads, tq, tk;
  const long long* strides;  // q, k, v, o: (sb, sh, st) each, elements
  float scale;
  cudaStream_t stream;
};

template <int D, int DD, bool kHasBias, bool kStats, bool kRawProbs>
cudaError_t launch(const Args& a) {
  auto kernel = flash_fwd_kernel<D, DD, kHasBias, kStats, kRawProbs>;
  const int smem = Tile<D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq_map, tk_map, tv_map;
  if ((err = tensor_map<D>(&tq_map, a.q, a.tq, a.heads, a.batch, a.strides, 128, DD)) !=
          cudaSuccess ||
      (err = tensor_map<D>(&tk_map, a.k, a.tk, a.heads, a.batch, a.strides + 3, 128, DD)) !=
          cudaSuccess ||
      (err = tensor_map<D>(&tv_map, a.v, a.tk, a.heads, a.batch, a.strides + 6, 128, DD)) !=
          cudaSuccess) {
    return err;
  }
  Params p;
  p.bias = static_cast<const float*>(a.bias);
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.o_sb = a.strides[9];
  p.o_sh = a.strides[10];
  p.o_st = a.strides[11];
  p.m = static_cast<float*>(a.m);
  p.l = static_cast<float*>(a.l);
  p.heads = a.heads;
  p.tq = a.tq;
  p.tk = a.tk;
  p.q_tiles = (a.tq + kBlockM - 1) / kBlockM;
  p.scale_log2 = a.scale * kLog2e;
  const long long blocks = static_cast<long long>(p.q_tiles) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(tq_map, tk_map, tv_map,
                                                                      p);
  return cudaGetLastError();
}

template <int D, int DD = D>
cudaError_t dispatch(const Args& a) {
  const bool stats = a.m != nullptr;
  if (a.bias != nullptr) {
    return stats ? launch<D, DD, true, true, false>(a) : launch<D, DD, true, false, false>(a);
  }
  return stats ? launch<D, DD, false, true, false>(a) : launch<D, DD, false, false, false>(a);
}

}  // namespace

// q, o: (batch, heads, tq, head_dim) bf16, head_dim 16, 32, 64, 72 or 128;
// k, v: (batch, heads, tk, head_dim) bf16, each a view with a dense last dim and the element strides
// (sb, sh, st) in `strides` (q, k, v, o: 12 values), every stride a multiple
// of 8 elements and every base 16-byte aligned; bias: NULL or (batch, tk)
// f32, contiguous; m, l: both NULL, or both (batch, heads, tq) f32,
// contiguous, for the softmax statistics. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ltx_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, void* m, void* l, int batch,
                                       int heads, int tq, int tk, int head_dim,
                                       const long long* strides, float scale, void* stream) {
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, o, m, l, batch, heads, tq, tk, strides, scale,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16: return static_cast<int>(dispatch<16>(a));
    case 32: return static_cast<int>(dispatch<32>(a));
    case 64: return static_cast<int>(dispatch<64>(a));
    case 72: return static_cast<int>(dispatch<128, 72>(a));
    case 128: return static_cast<int>(dispatch<128>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The P hand-off alone, for its check: o = bf16(bf16(q k^T) v) over one
// (1, 1, 128, 128) tile each of q, k, v (contiguous, bf16): the S
// accumulators of the first product, rounded to bf16, as the register A
// operand of the second, with no softmax between.
extern "C" int ltx_flash_fwd_pv_check(const void* q, const void* k, const void* v, void* o,
                                      void* stream) {
  const long long strides[12] = {128 * 128, 128 * 128, 128, 128 * 128, 128 * 128, 128,
                                 128 * 128, 128 * 128, 128, 128 * 128, 128 * 128, 128};
  const Args a{q, k, v, nullptr, o, nullptr, nullptr, 1, 1, 128, 128, strides, 1.f,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<128, 128, false, false, true>(a));
}
