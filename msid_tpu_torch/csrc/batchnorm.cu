// N1: train-mode BatchNorm of the decoder's norms, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses it into the convs around it. In PyTorch the same arithmetic
// (msid_tpu_torch/models/blocks.py, Norm._train_batch_norm) is about ten fp32
// passes forward and twice that backward, ~134 bytes moved an element. This
// set computes it in six launches (ops/cuda_norm.py drives them) and keeps
// flax's numerics: moments as sums of x and x^2 in fp32, the biased variance
// E[x^2] - mean^2 clamped at 0, the running statistics updated with it:
//
//   forward   reduce(x)         -> per CTA, per channel: sum x, sum x^2      [P, 2C]
//             finalize_forward  -> mean, rstd = rsqrt(var + eps),
//                                  scale = w * rstd, shift = b - mean * scale [4, C]
//                                  running += momentum * (batch - running)
//             pointwise(x)      -> y = x * scale + shift, in x's dtype
//   backward  reduce(x, dy)     -> per CTA, per channel: sum dy, sum dy * (x - mean)
//             finalize_backward -> dw = rstd * sum dy (x - mean), db = sum dy,
//                                  k = w * rstd, cc = k * db / M, b2 = k * rstd * dw / M
//             pointwise(x, dy)  -> dx = k * dy - cc - (x - mean) * b2, in x's dtype
//
// Bound: bytes. Forward reads x twice and writes y; backward reads x and dy
// twice and writes dx: 16 bytes an element in bf16 (the second reads of a
// small stage come from L2). Every pass streams 16-byte vectors, and nothing
// but the bf16 x is kept for the backward.
//
// Deterministic: no atomics. A CTA reduces a contiguous chunk of rows into
// registers, then through shared memory in a fixed order into one row of
// the [P, 2C] workspace; the finalize kernels sum the P rows in a fixed
// order. So the same input gives the same bits on every call.
//
// Layout: the NHWC-contiguous [M, C] view of a channels-last tensor, which is
// what every train-mode norm of the repo's decoders sees (an NCHW tensor keeps
// the composition; nothing is copied). A thread owns VEC channels (16 bytes)
// of a row; the R = threads / (C / VEC) row slots of a CTA read T * VEC
// contiguous elements a step, so a warp's loads are one contiguous run, and
// the thread's channels never change, so its sums and coefficients stay in
// registers. The CTA's shape follows C alone (no per-model path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kUnroll = 4;            // independent 16-byte loads a thread keeps in flight
constexpr int kMaxThreads = 512;      // a rows CTA: C / VEC row slots, at most 512
constexpr int kMaxRedFloats = 2048;   // R * C of a rows CTA (ops/cuda_norm.py keeps it so)
constexpr int kFinalizeRows = 8;      // partial rows a finalize CTA sums at once

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

// VEC elements of T at p as floats, and back: one 16-byte access when
// VEC * sizeof(T) == 16, else one element.
template <typename T, int VEC>
struct Io {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte vectors or single elements");

  __device__ __forceinline__ static void load(const T* p, float (&v)[VEC]) {
    if constexpr (VEC == 1) {
      v[0] = to_float(*p);
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = to_float(e[i]);
    }
  }

  __device__ __forceinline__ static void store(T* p, const float (&v)[VEC]) {
    if constexpr (VEC == 1) {
      *p = from_float<T>(v[0]);
    } else {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(v[i]);
      *reinterpret_cast<uint4*>(p) = u;
    }
  }
};

// Forward: s1 += x, s2 += x^2. Backward: s1 += dy, s2 += dy * (x - mean).
template <int VEC, bool kBackward>
__device__ __forceinline__ void accumulate(const float (&v)[VEC], const float (&g)[VEC],
                                           const float (&m)[VEC], float (&s1)[VEC],
                                           float (&s2)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (kBackward) {
      s1[i] += g[i];
      s2[i] = fmaf(g[i], v[i] - m[i], s2[i]);
    } else {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
}

// Forward: y = x * a + b. Backward: dx = a * dy - b - (x - mean) * e.
template <int VEC, bool kBackward>
__device__ __forceinline__ void combine(const float (&v)[VEC], const float (&g)[VEC],
                                        const float (&a)[VEC], const float (&b)[VEC],
                                        const float (&e)[VEC], const float (&m)[VEC],
                                        float (&o)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (kBackward) {
      o[i] = fmaf(m[i] - v[i], e[i], fmaf(a[i], g[i], -b[i]));
    } else {
      o[i] = fmaf(v[i], a[i], b[i]);
    }
  }
}

// rows: CTA blockIdx.x takes rows [blockIdx.x * per, + per) of the [rows, C]
// view; thread t owns channels [(t % V) * VEC, + VEC) of rows t / V, + R, ...
template <typename T, int VEC, bool kBackward>
__global__ void __launch_bounds__(kMaxThreads)
    reduce_rows(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ mean, float* __restrict__ partial, long long rows,
                int C, long long per) {
  __shared__ float red[2 * kMaxRedFloats];
  const int V = C / VEC;
  const int R = blockDim.x / V;
  const int t = threadIdx.x;
  const int c0 = (t % V) * VEC;
  const long long row0 = blockIdx.x * per;
  const long long row1 = min(rows, row0 + per);

  float m[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m[i] = kBackward ? mean[c0 + i] : 0.0f;
    s1[i] = 0.0f;
    s2[i] = 0.0f;
  }
  long long row = row0 + t / V;
  for (; row + (kUnroll - 1) * R < row1; row += kUnroll * R) {
    float v[kUnroll][VEC], g[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (row + u * R) * C + c0;
      Io<T, VEC>::load(x + off, v[u]);
      if constexpr (kBackward) Io<T, VEC>::load(dy + off, g[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<VEC, kBackward>(v[u], g[u], m, s1, s2);
  }
  for (; row < row1; row += R) {
    float v[VEC], g[VEC];
    Io<T, VEC>::load(x + row * C + c0, v);
    if constexpr (kBackward) Io<T, VEC>::load(dy + row * C + c0, g);
    accumulate<VEC, kBackward>(v, g, m, s1, s2);
  }

  const int slot = (t / V) * C + c0;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[slot + i] = s1[i];
    red[R * C + slot + i] = s2[i];
  }
  __syncthreads();
  float* out = partial + blockIdx.x * 2LL * C;
  for (int c = t; c < C; c += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < R; ++r) {
      a += red[r * C + c];
      b += red[R * C + r * C + c];
    }
    out[c] = a;
    out[C + c] = b;
  }
}

template <typename T, int VEC, bool kBackward>
__global__ void __launch_bounds__(kMaxThreads)
    pointwise_rows(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ out,
                   const float* __restrict__ pa, const float* __restrict__ pb,
                   const float* __restrict__ pe, const float* __restrict__ mean,
                   long long rows, int C, long long per) {
  const int V = C / VEC;
  const int R = blockDim.x / V;
  const int t = threadIdx.x;
  const int c0 = (t % V) * VEC;
  const long long row0 = blockIdx.x * per;
  const long long row1 = min(rows, row0 + per);

  float a[VEC], b[VEC], e[VEC], m[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = pa[c0 + i];
    b[i] = pb[c0 + i];
    e[i] = kBackward ? pe[c0 + i] : 0.0f;
    m[i] = kBackward ? mean[c0 + i] : 0.0f;
  }
  long long row = row0 + t / V;
  for (; row + (kUnroll - 1) * R < row1; row += kUnroll * R) {
    float v[kUnroll][VEC], g[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (row + u * R) * C + c0;
      Io<T, VEC>::load(x + off, v[u]);
      if constexpr (kBackward) Io<T, VEC>::load(dy + off, g[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float o[VEC];
      combine<VEC, kBackward>(v[u], g[u], a, b, e, m, o);
      Io<T, VEC>::store(out + (row + u * R) * C + c0, o);
    }
  }
  for (; row < row1; row += R) {
    float v[VEC], g[VEC], o[VEC];
    Io<T, VEC>::load(x + row * C + c0, v);
    if constexpr (kBackward) Io<T, VEC>::load(dy + row * C + c0, g);
    combine<VEC, kBackward>(v, g, a, b, e, m, o);
    Io<T, VEC>::store(out + row * C + c0, o);
  }
}

// The two columns (c, C + c) of the [parts, 2C] workspace summed over its
// rows in a fixed order: row slices p = ty (mod 8) per thread, then the 8
// slices in order. Valid in thread (tx, 0).
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial, int parts,
                                             int C, int c, float& a, float& b) {
  __shared__ float cols[2][kFinalizeRows][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  a = 0.0f;
  b = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (int p = ty; p < parts; p += kFinalizeRows) {
      a += partial[p * 2LL * C + c];
      b += partial[p * 2LL * C + C + c];
    }
  }
  cols[0][ty][tx] = a;
  cols[1][ty][tx] = b;
  __syncthreads();
  if (ty == 0) {
    a = 0.0f;
    b = 0.0f;
#pragma unroll
    for (int r = 0; r < kFinalizeRows; ++r) {
      a += cols[0][r][tx];
      b += cols[1][r][tx];
    }
  }
}

// stats: [4, C] fp32 = mean, rstd, scale, shift.
__global__ void __launch_bounds__(32 * kFinalizeRows)
    finalize_forward(const float* __restrict__ partial, int parts, int C, float count,
                     const float* __restrict__ weight, const float* __restrict__ bias,
                     float* __restrict__ running_mean, float* __restrict__ running_var,
                     float momentum, float eps, float* __restrict__ stats) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sx, sxx;
  sum_partials(partial, parts, C, c, sx, sxx);
  if (threadIdx.y != 0 || c >= C) return;
  const float mean = sx / count;
  float var = sxx / count - mean * mean;
  var = var < 0.0f ? 0.0f : var;   // a comparison: a NaN stays NaN, as in clamp_min
  const float rstd = rsqrtf(var + eps);
  const float scale = weight[c] * rstd;
  stats[c] = mean;
  stats[C + c] = rstd;
  stats[2 * C + c] = scale;
  stats[3 * C + c] = bias[c] - mean * scale;
  running_mean[c] += momentum * (mean - running_mean[c]);
  running_var[c] += momentum * (var - running_var[c]);
}

// grads: [5, C] fp32 = dw, db, k, cc, b2 (the last three are dx's coefficients).
__global__ void __launch_bounds__(32 * kFinalizeRows)
    finalize_backward(const float* __restrict__ partial, int parts, int C, float count,
                      const float* __restrict__ weight, const float* __restrict__ stats,
                      float* __restrict__ grads) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sdy, sdyc;
  sum_partials(partial, parts, C, c, sdy, sdyc);
  if (threadIdx.y != 0 || c >= C) return;
  const float rstd = stats[C + c];
  const float dw = sdyc * rstd;
  const float k = weight[c] * rstd;
  grads[c] = dw;
  grads[C + c] = sdy;
  grads[2 * C + c] = k;
  grads[3 * C + c] = k * sdy / count;
  grads[4 * C + c] = k * rstd * dw / count;
}

// f(T{}, integral_constant<VEC>) for the element type and vector width.
template <typename F>
cudaError_t dispatch(int bf16, int vec, F&& f) {
  if (bf16)
    return vec ? f(__nv_bfloat16{}, std::integral_constant<int, 8>{})
               : f(__nv_bfloat16{}, std::integral_constant<int, 1>{});
  return vec ? f(float{}, std::integral_constant<int, 4>{})
             : f(float{}, std::integral_constant<int, 1>{});
}

}  // namespace

// The forward over x's rows x C: reduce into work [parts, 2C], finalize into
// stats = work + parts * 2C ([4, C]: mean, rstd, scale, shift; the running
// statistics updated), apply into y. CTA p takes rows [p * per, + per) with
// `threads` threads. vec: 16-byte vectors (C a multiple of 16 / sizeof(T),
// every pointer 16-byte aligned), else single elements. Returns the first
// launch error.
extern "C" int msid_bn_forward(const void* x, void* y, float* work, const float* weight,
                               const float* bias, float* running_mean, float* running_var,
                               int bf16, int vec, long long rows, int C, int parts,
                               long long per, int threads, float momentum, float eps,
                               cudaStream_t stream) {
  float* stats = work + parts * 2LL * C;
  cudaError_t err = dispatch(bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    reduce_rows<T, decltype(v)::value, false><<<parts, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, nullptr, work, rows, C, per);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  finalize_forward<<<(C + 31) / 32, dim3(32, kFinalizeRows), 0, stream>>>(
      work, parts, C, static_cast<float>(rows), weight, bias, running_mean, running_var,
      momentum, eps, stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return dispatch(bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    pointwise_rows<T, decltype(v)::value, false><<<parts, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(y), stats + 2 * C, stats + 3 * C,
        nullptr, nullptr, rows, C, per);
    return cudaGetLastError();
  });
}

// The backward from the forward's stats: reduce x and dy into work [parts,
// 2C], finalize into grads = work + parts * 2C ([5, C]: dw, db, k, cc, b2),
// then dx (skipped when dx is null).
extern "C" int msid_bn_backward(const void* x, const void* dy, void* dx, const float* stats,
                                float* work, const float* weight, int bf16, int vec,
                                long long rows, int C, int parts, long long per, int threads,
                                cudaStream_t stream) {
  float* grads = work + parts * 2LL * C;
  cudaError_t err = dispatch(bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    reduce_rows<T, decltype(v)::value, true><<<parts, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), stats, work, rows, C, per);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  finalize_backward<<<(C + 31) / 32, dim3(32, kFinalizeRows), 0, stream>>>(
      work, parts, C, static_cast<float>(rows), weight, stats, grads);
  if ((err = cudaGetLastError()) != cudaSuccess || dx == nullptr) return err;
  return dispatch(bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    pointwise_rows<T, decltype(v)::value, true><<<parts, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
        grads + 2 * C, grads + 3 * C, grads + 4 * C, stats, rows, C, per);
    return cudaGetLastError();
  });
}
