// N2: Restormer's bias-free LayerNorm, for Hopper (sm_90a).
//
//   y = x * rsqrt(var_c(x) + eps) * w
//
// over the C channels of each pixel of a channels-last [B, C, H, W] tensor,
// read as the row-major [B*H*W, C] matrix it is in memory. Replaces no TPU
// kernel: the JAX package has no Restormer. The port's composition
// (msid_tpu_torch/models/restormer.py, bias_free_norm) makes five passes over
// each row (an fp32 copy, the variance, rsqrt, two strided multiplies): ~18
// bytes moved an element in bf16, at PyTorch's reduce and unvectorised
// elementwise rates.
//
// Bound: bytes. x is read once and y written once (4 bytes an element in
// bf16, 8 in fp32); w is C elements, read once a CTA and kept in registers.
// What the design does about it:
//   * a group of G = C / (3 VEC) lanes owns a row (VEC elements a 16-byte
//     vector), each lane three vectors of it: lane j of the group holds
//     vectors j, j + G, j + 2G, so each load and store of a warp covers
//     32 / G neighbouring rows in runs of G * 16 contiguous bytes;
//   * the row stays in registers: its sum, then its sum of squares about
//     the mean, are reduced across the group by shuffles; no shared memory;
//   * the CTAs walk the row tiles in a grid-stride loop with the grid sized
//     to the CTAs the card holds resident (4 of 256 threads an SM at the 64
//     registers of the bf16 instances), so each SM keeps ~48 KB of loads in
//     flight: three independent 16-byte loads a lane. Two or four rows a
//     lane at once, or a cap on registers for more CTAs, measured no faster
//     (PERF.md, N2);
//   * one template instance a width (48, 96, 192, 384: C = 48 * 2^k, so G is
//     a power of two) and dtype pair, so every loop over a row is unrolled.
//
// Numerics: fp32 accumulation. The variance is taken about the row's own
// mean in a second pass over the registers, biased (over C), as
// torch.var(correction=0) takes it; E[x^2] - E[x]^2 would cancel on rows
// whose mean is far above their spread, which Restormer's residual stream
// carries. x * rstd * w is computed in fp32 and rounded once to the output
// dtype (x's, or fp32 where x is bf16 and w fp32, as torch's promotion gives
// the composition's). Deterministic: a fixed order of shuffles, no atomics.
//
// Capture-safe: it launches on the stream it is given, allocates nothing and
// does not synchronise; the residency query runs once per instance, at the
// first (eager) call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 3;     // 16-byte vectors of a row a lane holds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements of T at p (16-byte aligned, N * sizeof(T) a multiple of 16),
// as floats, and back.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  constexpr int E = 16 / sizeof(T);
  static_assert(N % E == 0, "whole 16-byte vectors");
#pragma unroll
  for (int q = 0; q < N / E; ++q) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) v[q * E + i] = to_float(e[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  constexpr int E = 16 / sizeof(T);
  static_assert(N % E == 0, "whole 16-byte vectors");
#pragma unroll
  for (int q = 0; q < N / E; ++q) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = from_float<T>(v[q * E + i]);
    reinterpret_cast<uint4*>(p)[q] = u;
  }
}

// The sum of v over the aligned group of G lanes, the same bits in each.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x [rows, C] of T, w [C] of W, y [rows, C] of O. CTA b takes the tiles of
// kThreads / G rows starting at (b + k * gridDim.x) * tile; inside a tile,
// lane group s (threadIdx.x / G) takes row s.
template <typename T, typename W, typename O, int C>
__global__ void __launch_bounds__(kThreads)
    bias_free_norm_rows(const T* __restrict__ x, const W* __restrict__ w, O* __restrict__ y,
                        long long rows, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int G = C / (kPer * VEC);
  static_assert(G * kPer * VEC == C && G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "C = 3 * VEC * G with G a power of two up to a warp");
  constexpr long long kTile = kThreads / G;

  const int lane = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  float wf[kPer][VEC];
#pragma unroll
  for (int k = 0; k < kPer; ++k) load<W, VEC>(w + (lane + k * G) * VEC, wf[k]);

  for (long long base = blockIdx.x * kTile; base < rows; base += gridDim.x * kTile) {
    const long long row = base + slot;
    float v[kPer][VEC];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (row < rows) {
        load<T, VEC>(x + row * C + (lane + k * G) * VEC, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[k][i] = 0.0f;
      }
    }
    // Every lane reaches the shuffles: a row past the end reduces zeros.
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += v[k][i];
    const float mean = group_sum<G>(s) / static_cast<float>(C);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[k][i] - mean;
        q = fmaf(d, d, q);
      }
    const float rstd = rsqrtf(group_sum<G>(q) / static_cast<float>(C) + eps);
    if (row >= rows) continue;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = v[k][i] * rstd * wf[k][i];
      store<O, VEC>(y + row * C + (lane + k * G) * VEC, o);
    }
  }
}

template <typename T, typename W, typename O, int C>
cudaError_t launch_rows(const void* x, const void* w, void* y, long long rows, float eps,
                        int sms, cudaStream_t stream) {
  constexpr long long kTile = kThreads / (C / (kPer * (16 / static_cast<int>(sizeof(T)))));
  auto kernel = bias_free_norm_rows<T, W, O, C>;
  static const int resident = [kernel] {   // CTAs an SM holds at once, asked once
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess)
      n = 1;
    return n > 0 ? n : 1;
  }();
  const long long tiles = (rows + kTile - 1) / kTile;
  const long long most = static_cast<long long>(sms) * resident;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                                        static_cast<O*>(y), rows, eps);
  return cudaGetLastError();
}

template <typename T, typename W, typename O>
cudaError_t by_width(int C, const void* x, const void* w, void* y, long long rows, float eps,
                     int sms, cudaStream_t stream) {
  switch (C) {
    case 48: return launch_rows<T, W, O, 48>(x, w, y, rows, eps, sms, stream);
    case 96: return launch_rows<T, W, O, 96>(x, w, y, rows, eps, sms, stream);
    case 192: return launch_rows<T, W, O, 192>(x, w, y, rows, eps, sms, stream);
    case 384: return launch_rows<T, W, O, 384>(x, w, y, rows, eps, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y = x * rsqrt(var_c(x) + eps) * w over rows x C (one launch). kinds: 0 x,
// w and y bf16; 1 all fp32; 2 x bf16, w and y fp32. Every pointer 16-byte
// aligned; sms the card's SM count. Returns the launch error, or
// cudaErrorInvalidValue for a width or kind with no instance.
extern "C" int msid_bias_free_norm(const void* x, const void* w, void* y, int kinds, int C,
                                   long long rows, float eps, int sms, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  switch (kinds) {
    case 0: return by_width<bf16, bf16, bf16>(C, x, w, y, rows, eps, sms, stream);
    case 1: return by_width<float, float, float>(C, x, w, y, rows, eps, sms, stream);
    case 2: return by_width<bf16, float, float>(C, x, w, y, rows, eps, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}
