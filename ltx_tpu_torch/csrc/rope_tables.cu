// Split-RoPE cos/sin tables for Hopper (sm_90a), built on the card.
//
// Replaces no TPU kernel: the JAX package builds these tables on the host in
// float64 numpy (ltx_tpu/ops/rope.py::precompute_freqs_cis), and the port
// did the same in ltx_tpu_torch/ops/rope.py, then copied the f32 result to
// the card. At 6144 tokens that host build took most of a second a denoise
// loop while the card idled. This kernel computes the same tables from the
// f32 position grid:
//
//     scaled[d, t] = (f64(grid[d, t]) / max_pos[d]) * 2 - 1
//     freq[t, f]   = idx[f / n_pos] * scaled[f % n_pos, t]
//     table[t, c]  = c < pad ? (1, 0) : f32(cos, sin(freq[t, c - pad]))
//
// written as (num_heads, T, per_head) with c = head * per_head + j, the
// layout ops.rope.apply_rope_split reads. idx is the frequency vector
// theta^t_k * pi/2 of _freq_indices_f64, computed on the host as before.
//
// Same values as the host build. The division, the product by 2 (exact),
// the subtraction and the product by idx are each one correctly rounded
// IEEE float64 operation on both sides, taken here with the _rn intrinsics
// in the reference's order, so that no contraction into an fma can change
// them: the argument of cos and sin is bit for bit numpy's. Only the float64
// cos and sin differ (libdevice within 2 ulp, the host's libm within a few),
// and rounding to f32 drops 29 bits: an f32 value differs only where the
// float64 one lies within a few of its ulps of an f32 rounding boundary, by
// one f32 ulp. No fast-math: the build flags of kernels/build.py.
//
// What bounds it on an H100: the f32 writes, 8 bytes an element of the
// padded (T, dim / 2) table (100.7 MB at 6144 tokens and dim 4096: 30 us at
// 3.35 TB/s). FP64 sincos (a few tens of FP64 operations an element, against
// the card's 34 TFLOP/s of FP64 outside the tensor cores) comes second; the
// inputs (the grid, a few KB of frequencies) stay in L1 and L2.
//
// What the design does about it. One thread an element (t, c), neighbouring
// threads on neighbouring columns c: where dim / 2 and per_head are
// multiples of 32, as at every path width, a warp's stores are one
// contiguous run of 32 floats of one head's row in each table. A thread reads
// its grid value and its frequency through the read-only cache (a warp
// touches n_pos grid values and at most 32 frequencies). No shared memory,
// no synchronisation; the float64 values live only in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rope_tables_kernel(const float* __restrict__ grid, const double* __restrict__ idx,
                       const double* __restrict__ max_pos, float* __restrict__ cos_out,
                       float* __restrict__ sin_out, unsigned seq_len, unsigned n_pos,
                       unsigned pad, unsigned half, unsigned per_head) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= seq_len * half) return;
  const unsigned t = i / half;
  const unsigned c = i - t * half;
  float cv = 1.0f;
  float sv = 0.0f;
  if (c >= pad) {
    const unsigned f = c - pad;
    const unsigned k = f / n_pos;
    const unsigned d = f - k * n_pos;
    const double g = static_cast<double>(__ldg(grid + d * seq_len + t));
    const double scaled = __dadd_rn(__dmul_rn(__ddiv_rn(g, __ldg(max_pos + d)), 2.0), -1.0);
    const double x = __dmul_rn(__ldg(idx + k), scaled);
    double s, co;
    sincos(x, &s, &co);
    cv = __double2float_rn(co);
    sv = __double2float_rn(s);
  }
  const unsigned h = c / per_head;
  const size_t o = (static_cast<size_t>(h) * seq_len + t) * per_head + (c - h * per_head);
  cos_out[o] = cv;
  sin_out[o] = sv;
}

}  // namespace

// grid (n_pos, seq_len) f32, idx (num_indices) f64, max_pos (n_pos) f64, all
// on the card; cos_out and sin_out (half / per_head, seq_len, per_head) f32,
// half = pad + num_indices * n_pos, a multiple of per_head. Launches on
// `stream`; returns the CUDA error of the launch.
extern "C" int ltx_rope_tables(const void* grid, const void* idx, const void* max_pos,
                               void* cos_out, void* sin_out, long long seq_len, int n_pos,
                               int num_indices, int pad, int per_head, void* stream) {
  const long long half = pad + static_cast<long long>(num_indices) * n_pos;
  if (seq_len <= 0 || n_pos <= 0 || num_indices <= 0 || pad < 0 || per_head <= 0 ||
      half % per_head != 0 || seq_len * half >= (1LL << 31) - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned elements = static_cast<unsigned>(seq_len * half);
  const unsigned blocks = (elements + kThreads - 1) / kThreads;
  rope_tables_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<const double*>(idx),
      static_cast<const double*>(max_pos), static_cast<float*>(cos_out),
      static_cast<float*>(sin_out), static_cast<unsigned>(seq_len), static_cast<unsigned>(n_pos),
      static_cast<unsigned>(pad), static_cast<unsigned>(half),
      static_cast<unsigned>(per_head));
  return static_cast<int>(cudaGetLastError());
}
