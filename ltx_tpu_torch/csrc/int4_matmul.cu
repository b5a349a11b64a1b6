// int4 weight-only linears for Hopper (sm_90a): the fused dequant-and-matmul
// kernel and the one-pass dequant, sharing one dequant function.
//
// Replaces the TPU kernels of ltx_tpu/kernels/quantization.py:
//   * int4_matmul_kernel  <- _int4_matmul_kernel / _int4_matmul_2d (int4_matmul):
//       Y (M, N) bf16 = X (M, K) bf16 @ dequant(W), f32 accumulation;
//   * dequant_int4_kernel <- _dequant_int4_kernel / dequant_int4_pallas:
//       dense (K, N) bf16 = dequant(W), for the big-M route (M >= 8192) and
//       the straight-through backward, which follow it with a plain product.
// W is (K/2, N) uint8 in block-plane packing: within each 256-row block of K,
// byte row r holds the code of row r in its low nibble and of row r + 128 in
// its high nibble (one plane of the whole K when 256 does not divide K:
// `half` below). scale and bias are (K/group, N) f32, and
//     w = bf16( (q * scale[k / group]) + bias[k / group] )
// with the product and the sum each rounded in f32, then rounded to bf16 to
// nearest even. That is torch's arithmetic for `q * scale + bias` then
// `.to(bfloat16)`, so dequant_int4 equals its plain version bit for bit.
// Both kernels take it from `dequant8` and nothing else. It forms q as a
// float exactly (the bits 0x4B00000q are 2**23 + q) and rounds q * scale
// with one fused multiply-add, fma(2**23 + q, scale, -2**23 * scale): the
// unrounded value is exactly q * scale, rounded once, so it is __fmul_rn(q,
// scale) bit for bit (for |scale| < 2**104, where -2**23 * scale is exact);
// then __fadd_rn adds the bias, and one conversion rounds each pair to bf16.
//
// What bounds them on an H100. The fused product at the DiT's shapes (M =
// 1024-1536 rows, K and N of 4096 and 16384) does 2MKN flops on about
// 2MK + KN/2 + 8KN/group + 2MN bytes: over 600 flops per byte, above the
// card's ~295 flop/byte balance point, so the limit is the tensor cores (989
// TFLOP/s bf16 dense), reached only through wgmma. Hopper has no int4
// product, so each weight is dequantized on the CUDA cores once for every
// block of rows that uses it: about 4 instructions a weight, which must run
// while the tensor cores work. The dequant alone moves 2.6 bytes per weight
// and does ~2 flops: it is bound by the 3.35 TB/s of device memory.
//
// int4_matmul_kernel, the design. A block of three warpgroups owns a tile of
// 256 rows of Y by 128 columns; it walks K in stages of 64 packed byte rows,
// that is 128 rows of K: the stage's 64 low-plane rows and the 64 high-plane
// rows 128 further down, so both nibbles of every code byte read are used.
// The stage's two planes are two half-stages h = 2s and 2s + 1.
//   * Warpgroup 0 is the producer: one thread issues TMA loads into two
//     rings with full and empty mbarriers: for each half-stage one
//     64-column, 128-byte-swizzled box of X (its plane's K columns, 256
//     rows; rows past M are zero-filled; kXSlots deep), and for each stage
//     the 64 x 128 box of packed codes with, where every group holds whole
//     half-stages, each plane's row of scale and bias (bulk copies;
//     kCodeSlots deep). It gives its registers away (setmaxnreg 24).
//   * Warpgroups 1 and 2 are the consumers, 128 rows of Y each as two
//     64-row wgmma slabs, with the f32 accumulators (128 a thread) in
//     registers across the whole K. The 256 consumer threads dequantize
//     half-stage h + 1 together (each thread 8 columns of 4 rows, its codes
//     read before any store, 16-byte stores) into one of three bf16 tiles
//     of 64 K rows x 128, stored N-contiguous in the 128-byte swizzled layout
//     that wgmma reads as an MN-major B operand (the transpose bit, as the
//     flash forward reads V), while the tensor cores run half-stage h's
//     eight m64n128k16 products (SS: X's box the K-major A operand). A
//     consumer waits only for h - 1's products before the next half-stage,
//     so h's stay queued on the tensor cores through the named barrier that
//     hands the next tile over.
//   * 256-row tiles halve the dequant per product against 128-row ones (each
//     weight is dequantized once per 256 rows), which sets the pace: the
//     path's N = 4096 linears give 192 blocks (1.45 waves of 132 SMs), still
//     faster than 384 blocks of 128 x 128, which dequantize as much per
//     block.
//   * Tensor maps are encoded on the host at every launch and passed as
//     __grid_constant__ arguments: the DiT has 480 int4 weights, more than
//     any small cache, and X changes with every call. The kernel's
//     shared-memory attribute is set once per device.
// On an H100 the products alone and the dequant alone each take about two
// thirds of the kernel's time (scripts/int4_matmul_variants.py): a
// half-stage moves ~157 KB through the SM's shared memory (the products'
// operands 96 KB, TMA 37 KB, the dequant 24 KB), which holds the kernel
// near 0.44 of the tensor cores' bound at the FF shapes.
// Sum order: each wgmma k step adds 16 products of one plane's K rows to
// the f32 accumulator; a stage's 4 low-plane k steps come before its 4
// high-plane ones, stages in order of the packed rows.
//
// dequant_int4_kernel: a thread owns 16 (or 8) columns and a run of byte
// rows; it keeps each plane's group of scale and bias in registers (loaded
// with 16-byte loads once a group), reads 16 code bytes at a time and
// writes the low- and high-plane rows, 128 K rows apart, with 16-byte
// stores.

#include "hopper.cuh"

namespace {

// Eight codes (one per byte, 0..15, in the low nibbles of q0 (columns 0-3)
// and q1 (4-7)) and their columns' scale, -2**23 * scale and bias -> eight
// bf16 weights, column 0 in the low half of .x. Both kernels dequantize
// through this function only (the file's note).
__device__ __forceinline__ uint4 dequant8(uint32_t q0, uint32_t q1, const float (&s)[8],
                                          const float (&c)[8], const float (&b)[8]) {
  float w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // 2**23 + q: the code byte under the exponent bits of 2**23
    const float f = __uint_as_float(__byte_perm(i < 4 ? q0 : q1, 0x4B000000u, 0x7440u + (i & 3)));
    w[i] = __fadd_rn(__fmaf_rn(f, s[i], c[i]), b[i]);
  }
  uint4 out;
  out.x = pack_bf16(w[0], w[1]);
  out.y = pack_bf16(w[2], w[3]);
  out.z = pack_bf16(w[4], w[5]);
  out.w = pack_bf16(w[6], w[7]);
  return out;
}

// scale, -2**23 * scale and bias of 8 columns (16-byte aligned) of one group
struct Affine {
  float s[8], c[8], b[8];
};

// scale and bias of 8 columns -> their Affine (16-byte aligned pointers)
__device__ __forceinline__ void make_affine(Affine& a, const float4* scale, const float4* bias) {
  const float4 s0 = scale[0], s1 = scale[1], b0 = bias[0], b1 = bias[1];
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.s[i] = sv[i];
    a.c[i] = -8388608.0f * sv[i];
    a.b[i] = bv[i];
  }
}

__device__ __forceinline__ void load_affine(Affine& a, const float* scale, const float* bias) {
  const float4 sv[2] = {__ldg(reinterpret_cast<const float4*>(scale)),
                        __ldg(reinterpret_cast<const float4*>(scale) + 1)};
  const float4 bv[2] = {__ldg(reinterpret_cast<const float4*>(bias)),
                        __ldg(reinterpret_cast<const float4*>(bias) + 1)};
  make_affine(a, sv, bv);
}

// ---------------------------------------------------------------------------
// Fused dequant + matmul
// ---------------------------------------------------------------------------

constexpr int kPack = 256;             // the block-plane packing block
constexpr int kHalf = kPack / 2;
constexpr int kBlockM = 256;           // rows of Y per block: 128 a consumer
constexpr int kBlockN = 128;           // columns of Y per block
constexpr int kSlabs = 2;              // 64-row wgmma slabs per consumer
constexpr int kStageRows = 64;         // packed byte rows per stage
constexpr int kStageK = 2 * kStageRows;  // K rows per stage: both planes
constexpr int kXSlots = 4;             // depth of the X ring, in half-stages
constexpr int kCodeSlots = 3;          // depth of the codes ring, in stages
constexpr int kWBuffers = 3;           // bf16 weight tiles, one per half-stage
constexpr int kThreads = 384;          // producer + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;

// shared memory, from a 1024-byte aligned base
constexpr int kXBox = kBlockM * 128;          // X: 256 rows x 64 bf16 K columns
constexpr int kCodes8 = kStageRows * kBlockN;  // u8 codes of a stage
// then, where every group holds whole half-stages, each plane's scale and
// bias rows: f32 [plane][scale | bias][kBlockN]
constexpr int kAffine = 4 * kBlockN * 4;
constexpr int kCodeStage = kCodes8 + kAffine;
constexpr int kWBox = kStageRows * 128;        // 64 K rows x 64 bf16 columns
constexpr int kWTile = (kBlockN / 64) * kWBox;  // one plane's bf16 weights
constexpr int kXOff = 0;
constexpr int kCodesOff = kXOff + kXSlots * kXBox;
constexpr int kWOff = kCodesOff + kCodeSlots * kCodeStage;
constexpr int kBarOff = kWOff + kWBuffers * kWTile;
// X full / empty, codes full / empty barriers; + slack to align the base
// to 1024 bytes (the 128-byte swizzle's period)
constexpr int kSmemBytes = kBarOff + 16 * (kXSlots + kCodeSlots) + 1024;
// the dequant: a thread 8 columns of kRowsPerThread rows of a half-stage
constexpr int kLanesPerRow = kBlockN / 8;
constexpr int kRowStep = kConsumers / kLanesPerRow;
constexpr int kRowsPerThread = kStageRows / kRowStep;

struct Params {
  const float* scale;  // (k / group, n)
  const float* bias;
  __nv_bfloat16* y;    // (m, n)
  int m, n, k, group;
};

#define ACC8(a, i)                                                                   \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),        \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// D (64 x 128, f32) (+)= A (64 x 16, K-major) B (16 x 128, MN-major: the
// transpose bit), both in shared memory; accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_tb_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef ACC8

// the first K row of a stage's low plane (its high plane is 128 further)
__device__ __forceinline__ int stage_k0(int s) {
  return (s / 2) * kPack + (s % 2) * kStageRows;
}

// x (m, k) bf16 through tm_x (boxes of 64 K x 256 rows, 128-byte swizzle),
// w_q4 (k/2, n) u8 through tm_w (boxes of 128 x 64 byte rows), y (m, n)
// bf16. k % 256 == 0, n % 128 == 0, group even. Grid: (ceil(m/256), n/128).
__global__ void __launch_bounds__(kThreads, 1)
int4_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t x_full = base + kBarOff;
  const uint32_t x_empty = x_full + 8 * kXSlots;
  const uint32_t c_full = x_empty + 8 * kXSlots;
  const uint32_t c_empty = c_full + 8 * kCodeSlots;

  const int m0 = blockIdx.x * kBlockM;
  const int n0 = blockIdx.y * kBlockN;
  const int n_stages = p.k / kStageK;
  const int n_halves = 2 * n_stages;
  // every group holds whole half-stages (64 K rows from a multiple of 64):
  // the producer brings each half-stage's one row of scale and bias
  const bool whole_groups = p.group % kStageRows == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kXSlots; ++i) {
      mbar_init(x_full + 8 * i, 1);
      mbar_init(x_empty + 8 * i, kConsumerWarps);
    }
    for (int i = 0; i < kCodeSlots; ++i) {
      mbar_init(c_full + 8 * i, 1);
      mbar_init(c_empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps both rings full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int s = 0; s < n_stages; ++s) {
        // the first pass finds every slot empty: parity 1 of a fresh barrier
        const int cs = s % kCodeSlots;
        const uint32_t slot = base + kCodesOff + cs * kCodeStage;
        mbar_wait(c_empty + 8 * cs, ((s / kCodeSlots) & 1) ^ 1);
        mbar_expect_tx(c_full + 8 * cs, whole_groups ? kCodeStage : kCodes8);
        tma_load_2d(slot, &tm_w, c_full + 8 * cs, n0, s * kStageRows);
        if (whole_groups) {
          for (int plane = 0; plane < 2; ++plane) {
            const size_t row = static_cast<size_t>((stage_k0(s) + plane * kHalf) / p.group) * p.n;
            const uint32_t dst = slot + kCodes8 + plane * 2 * kBlockN * 4;
            bulk_load(dst, p.scale + row + n0, kBlockN * 4, c_full + 8 * cs);
            bulk_load(dst + kBlockN * 4, p.bias + row + n0, kBlockN * 4, c_full + 8 * cs);
          }
        }
        for (int plane = 0; plane < 2; ++plane) {
          const int h = 2 * s + plane;
          const int xs = h % kXSlots;
          mbar_wait(x_empty + 8 * xs, ((h / kXSlots) & 1) ^ 1);
          mbar_expect_tx(x_full + 8 * xs, kXBox);
          tma_load_2d(base + kXOff + xs * kXBox, &tm_x, x_full + 8 * xs,
                      stage_k0(s) + plane * kHalf, m0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 128 rows of Y each, and half the dequant ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ct = threadIdx.x - 128;  // 0..255
  const int consumer = ct / 128;
  const int warp = (ct % 128) / 32;
  const int lane = ct % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;

  // this thread's dequant share: 8 columns, rows row0 + kRowStep * i
  const int col8 = ct % kLanesPerRow;
  const int row0 = ct / kLanesPerRow;
  const float* const scale_cols = p.scale + n0 + 8 * col8;
  const float* const bias_cols = p.bias + n0 + 8 * col8;
  // the swizzled 16-byte slot of (row, col8) in a W buffer: box col8 / 8,
  // chunk col8 % 8 of the row, XOR the row's place in its 8-row atom
  auto w_offset = [&](int r) {
    return (col8 / 8) * kWBox + r * 128 + (((col8 % 8) ^ (r & 7)) << 4);
  };
  auto group_of = [&](int h, int r) {
    return (stage_k0(h / 2) + (h & 1) * kHalf + r) / p.group;
  };
  // half-stage h's codes (plane h & 1 of stage h / 2) -> W buffer h % 3;
  // after the high plane the warp frees the stage's codes. All the rows'
  // codes are read before the first store (the compiler cannot move a
  // shared load above a shared store it might alias). Scale and bias come
  // from the stage's shared slot; only groups narrower than a half-stage
  // load them from global memory, row by row (a global load in flight
  // across a wgmma fence stalls it).
  auto dequant = [&](int h) {
    const int s = h / 2;
    const int cs = s % kCodeSlots;
    if ((h & 1) == 0) mbar_wait(c_full + 8 * cs, (s / kCodeSlots) & 1);
    const unsigned char* codes = smem + kCodesOff + cs * kCodeStage + 8 * col8;
    unsigned char* w = smem + kWOff + (h % kWBuffers) * kWTile;
    const int shift = 4 * (h & 1);
    uint2 q[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      q[i] = *reinterpret_cast<const uint2*>(codes + (row0 + kRowStep * i) * kBlockN);
    }
    Affine cur;
    if (whole_groups) {
      const float* affine = reinterpret_cast<const float*>(
          smem + kCodesOff + cs * kCodeStage + kCodes8) + (h & 1) * 2 * kBlockN + 8 * col8;
      make_affine(cur, reinterpret_cast<const float4*>(affine),
                  reinterpret_cast<const float4*>(affine + kBlockN));
    }
    auto store = [&](int i) {
      const int r = row0 + kRowStep * i;
      *reinterpret_cast<uint4*>(w + w_offset(r)) =
          dequant8((q[i].x >> shift) & 0x0F0F0F0Fu, (q[i].y >> shift) & 0x0F0F0F0Fu, cur.s,
                   cur.c, cur.b);
    };
    if (whole_groups) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) store(i);
    } else {  // groups narrower than a half-stage, or across two
      int g_cur = -1;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int grp = group_of(h, row0 + kRowStep * i);
        if (grp != g_cur) {
          load_affine(cur, scale_cols + static_cast<size_t>(grp) * p.n,
                      bias_cols + static_cast<size_t>(grp) * p.n);
          g_cur = grp;
        }
        store(i);
      }
    }
    fence_proxy_async();
    if (h & 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(c_empty + 8 * cs);
    }
  };

  // written first by the first products (accumulate = 0), never by other
  // instructions while products run: ptxas would serialize the wgmmas
  float acc[kSlabs][kBlockN / 2];

  // Half-stage h: sync (W buffer h % 3 written by all; every wgmma of h - 2
  // done); issue h's products on its X box; dequantize h + 1 into the next
  // buffer while they run; wait for h - 1's products, which frees h - 1's
  // X box. The tensor cores always hold the next products queued.
  dequant(0);
  for (int h = 0; h < n_halves; ++h) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int xs = h % kXSlots;
    mbar_wait(x_full + 8 * xs, (h / kXSlots) & 1);
    const uint32_t x_rows = base + kXOff + xs * kXBox + consumer * kSlabs * 64 * 128;
    const uint32_t w_tile = base + kWOff + (h % kWBuffers) * kWTile;
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) pin(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageRows / 16; ++kk) {
      const uint64_t desc_b = smem_desc(w_tile + kk * 16 * 128, kWBox, 1024, 1);
#pragma unroll
      for (int j = 0; j < kSlabs; ++j) {
        wgmma_tb_m64n128k16(acc[j], smem_desc(x_rows + j * 64 * 128 + kk * 32, 16, 1024, 1),
                            desc_b, h > 0 || kk > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) pin(acc[j]);
    if (h + 1 < n_halves) dequant(h + 1);
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) pin(acc[j]);
    if (h >= 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty + 8 * ((h - 1) % kXSlots));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) pin(acc[j]);

  // one rounding to bf16; rows past M are not stored. Element [4c + 2i + e]
  // of a slab's accumulator is row g + 8i of this warp's 16, column 8c +
  // 2 t4 + e
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + (consumer * kSlabs + j) * 64 + warp * 16 + g + 8 * i;
      if (row < p.m) {
        __nv_bfloat16* yrow = p.y + static_cast<size_t>(row) * p.n + n0 + 2 * t4;
#pragma unroll
        for (int c = 0; c < kBlockN / 8; ++c) {
          *reinterpret_cast<uint32_t*>(yrow + 8 * c) =
              pack_bf16(acc[j][4 * c + 2 * i], acc[j][4 * c + 2 * i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// One-pass dequant
// ---------------------------------------------------------------------------

constexpr int kDequantThreads = 256;

// w_q4 (k/2, n) u8, scale/bias (k/group, n) f32 -> w (k, n) bf16; half is
// the packing plane's byte rows (128, or k/2 for one plane). A thread owns
// kCols (16 or 8) columns and `run` byte rows; n % kCols == 0.
template <int kCols>
__global__ void __launch_bounds__(kDequantThreads)
dequant_int4_kernel(const uint8_t* __restrict__ w_q4, const float* __restrict__ scale,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ w, int k,
                    int n, int group, int half, int run) {
  constexpr int kParts = kCols / 8;
  const int chunks = n / kCols;
  const long long idx = static_cast<long long>(blockIdx.x) * kDequantThreads + threadIdx.x;
  const int rows = k / 2;
  const long long runs = (rows + run - 1) / run;
  if (idx >= runs * chunks) return;
  const int c = static_cast<int>(idx % chunks) * kCols;
  const int r0 = static_cast<int>(idx / chunks) * run;
  const int r1 = min(r0 + run, rows);

  Affine lo[kParts], hi[kParts];
  int g_lo = -1, g_hi = -1;
  // unrolled so that several rows' code loads are in flight at once
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const int k_lo = (r / half) * 2 * half + r % half;
    const int k_hi = k_lo + half;
    if (k_lo / group != g_lo) {
      g_lo = k_lo / group;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        load_affine(lo[part], scale + static_cast<size_t>(g_lo) * n + c + 8 * part,
                    bias + static_cast<size_t>(g_lo) * n + c + 8 * part);
      }
    }
    if (k_hi / group != g_hi) {
      g_hi = k_hi / group;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        load_affine(hi[part], scale + static_cast<size_t>(g_hi) * n + c + 8 * part,
                    bias + static_cast<size_t>(g_hi) * n + c + 8 * part);
      }
    }
    uint32_t q[2 * kParts];
    if constexpr (kParts == 2) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w_q4 + static_cast<size_t>(r) * n + c));
      q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(w_q4 + static_cast<size_t>(r) * n + c));
      q[0] = v.x; q[1] = v.y;
    }
    uint4* out_lo = reinterpret_cast<uint4*>(w + static_cast<size_t>(k_lo) * n + c);
    uint4* out_hi = reinterpret_cast<uint4*>(w + static_cast<size_t>(k_hi) * n + c);
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const uint32_t a = q[2 * part], b = q[2 * part + 1];
      out_lo[part] = dequant8(a & 0x0F0F0F0Fu, b & 0x0F0F0F0Fu, lo[part].s, lo[part].c,
                              lo[part].b);
      out_hi[part] = dequant8((a >> 4) & 0x0F0F0F0Fu, (b >> 4) & 0x0F0F0F0Fu, hi[part].s,
                              hi[part].c, hi[part].b);
    }
  }
}

// ---- host side ----

// the 2-D map of a row-major (rows, cols) tensor with `elem_bytes` a value,
// boxes of box_cols x box_rows, zero fill out of bounds
cudaError_t tensor_map_2d(CUtensorMap* out, const void* ptr, CUtensorMapDataType type,
                          int elem_bytes, long long rows, long long cols, int box_cols,
                          int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                            static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult res = encode(out, type, 2, const_cast<void*>(ptr), dims, stride, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kSms = 132;

cudaError_t launch_int4_matmul(const void* x, const void* w_q4, const Params& p,
                               cudaStream_t stream) {
  // cudaFuncSetAttribute once per device, not at every launch
  static unsigned allowed = 0;  // one bit a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (bit == 0u || !(allowed & bit)) {
    err = cudaFuncSetAttribute(int4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed |= bit;
  }
  CUtensorMap tm_x, tm_w;
  if ((err = tensor_map_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.m, p.k, 64,
                           kBlockM, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = tensor_map_2d(&tm_w, w_q4, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.k / 2, p.n,
                           kBlockN, kStageRows, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess) {
    return err;
  }
  const dim3 grid((p.m + kBlockM - 1) / kBlockM, p.n / kBlockN);
  int4_matmul_kernel<<<grid, kThreads, kSmemBytes, stream>>>(tm_x, tm_w, p);
  return cudaGetLastError();
}

}  // namespace

// x (m, k) bf16, w_q4 (k/2, n) uint8, scale and bias (k/group, n) f32, y
// (m, n) bf16; all contiguous and 16-byte aligned; k % 256 == 0, n % 128 ==
// 0, group even and dividing k. Returns the CUDA error of the launch.
extern "C" int ltx_int4_matmul(const void* x, const void* w_q4, const void* scale,
                               const void* bias, void* y, int m, int k, int n, int group,
                               void* stream) {
  if (m <= 0 || k % kPack != 0 || n % 128 != 0 || group <= 0 || group % 2 != 0 ||
      k % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const float*>(scale), static_cast<const float*>(bias),
                 static_cast<__nv_bfloat16*>(y), m, n, k, group};
  return static_cast<int>(launch_int4_matmul(x, w_q4, p, static_cast<cudaStream_t>(stream)));
}

// w_q4 (k/2, n) uint8, scale and bias (k/group, n) f32 -> w (k, n) bf16; all
// contiguous and 16-byte aligned; n % 8 == 0; half = 128 when 256 divides k,
// else k/2. Returns the CUDA error of the launch.
extern "C" int ltx_dequant_int4(const void* w_q4, const void* scale, const void* bias, void* w,
                                int k, int n, int group, int half, void* stream) {
  if (k <= 0 || n <= 0 || n % 8 != 0 || half <= 0 || (k / 2) % half != 0 || group <= 0 ||
      k % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = n % 16 == 0 ? 16 : 8;
  const long long chunks = n / cols;
  const int rows = k / 2;
  // runs of 32 byte rows, shorter where that leaves fewer than two blocks an SM
  int run = 32;
  auto blocks = [&](int r) {
    return ((rows + r - 1) / r * chunks + kDequantThreads - 1) / kDequantThreads;
  };
  while (run > 4 && blocks(run) < 2 * kSms) run /= 2;
  const long long n_blocks = blocks(run);
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* codes = static_cast<const uint8_t*>(w_q4);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(w);
  if (cols == 16) {
    dequant_int4_kernel<16><<<static_cast<unsigned>(n_blocks), kDequantThreads, 0, s>>>(
        codes, sc, bi, out, k, n, group, half, run);
  } else {
    dequant_int4_kernel<8><<<static_cast<unsigned>(n_blocks), kDequantThreads, 0, s>>>(
        codes, sc, bi, out, k, n, group, half, run);
  }
  return static_cast<int>(cudaGetLastError());
}
