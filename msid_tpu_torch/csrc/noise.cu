// K2: fused sensor corruption of an NHWC batch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_noise_kernel` of `apply_sensor_noise_pallas`
// (msid_tpu/ops/pallas_noise.py:78-194). Per sample b of x [B, H, W, C]:
//
//   alive_c = u(b, c) >= p_dead                   per (sample, band)
//   gate    = u(b, C) <  p_stripe                 per sample
//   stripe  = sigma_stripe * N(0,1)               per (sample, w, c)
//   y = x * (1 + sigma_s * n1)                    speckle
//   y = y * alive_c                               dead band
//   y = y + n2 * sd_c,  sd_c = sqrt(t2 * w_c * w_c + g2 * alive_c),  w_c = 1 + c / max(C-1, 1)
//   y = y + gate * stripe[w, c]
//   out = clamp(y, -3, 3) in x's dtype
//
// one combined normal for the Gaussian and thermal terms, as the TPU kernel
// draws it (it drops the sigma_g * sigma_s cross term).
//
// Randomness: counter-based Philox4x32-10 with key = the 64-bit seed.
// Counters are (index, sub-stream, b, stream): stream 0 holds the
// per-sample draws (index q of sub-stream 0 gives uniforms 4q..4q+3: band
// c's dead-band uniform is number c, the stripe gate's is number C;
// sub-stream 1, index w*C + c, gives that stripe's normal), stream 1 the
// per-element draws (index p gives elements 2p and 2p+1 of the sample, two
// normals each). Every draw depends on (seed, b, position) only, so any
// grid gives the same output bit for bit. Uniforms take the top 23 bits,
// u = (k + 0.5) * 2^-23, exact in fp32 and never 0 or 1; normals are
// Box-Muller pairs (cos and sin of one angle) with the accurate logf,
// sqrtf and sincospif: the approximate lg2/sin lose the 1e-6 the output is
// held to. Built without --use_fast_math.
//
// Bound: bytes, if the instructions keep up. Each element is read once and
// written once (8 bytes for fp32, 0.0732 ms for [64,192,192,13] at 3.35
// TB/s). The first version spent ~150-200 instructions an element (two
// Philox calls a group with the key schedule recomputed, a run-time `%` of
// the band, an IEEE division and a sqrtf of the variance) and issued one
// 16-byte load a thread before waiting on it: 27% of the bytes bound. This
// one:
//   * computes a band table per CTA: alive_c and sd_c for the C bands, so
//     the per-element `%`, division and square root go; a thread carries
//     its band and stripe index from one group of 4 to its next by adding,
//     never by `%`;
//   * computes Philox's round keys once per thread, one `mul.wide.u32` per
//     product (hi and lo in one IMAD.WIDE) and one three-input XOR per word
//     (LOP3): ~4 instructions a round;
//   * builds each uniform from the bits, 1 + k * 2^-23 minus 1 - 2^-24
//     (both exact), so no integer-to-float conversion shares the pipe of
//     logf's and sqrtf's special-function ops;
//   * has one element loop for a gated sample and one for the rest (the
//     gate is the same for a whole CTA), so the plain loop carries no
//     stripe index. chip_smoke.py counts the SASS instructions of one pass
//     of the loop the run takes, in the library it built, and gives the
//     issue bound beside the bytes bound.
// Measured on the H100 and not kept: the flagship's 13 bands at compile
// time, each thread taking one whole period of lcm(4, 13) = 52 elements
// with its 13 vector loads in flight and the band table in registers
// (fewer instructions an element, but 1.5x slower in fp32: each thread
// loads, then runs ~5,600 instructions, then stores, with nothing to
// overlap); staging chunks through shared memory by bulk copies,
// double-buffered; an L2 prefetch of a thread's next data.
//
// Layout: grid (chunks, B); CTA x of sample b takes the groups of 4
// elements [x * per, (x+1) * per) of the sample, about 8 CTAs an SM in all
// (ops/cuda_noise.py: launch_shape). The CTA draws its sample's masks, gate
// and (only if the gate is set) stripes and its band table into shared
// memory first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

// Dynamic shared memory of the kernel: the sample's tables.
extern __shared__ float dyn_smem[];

struct Words {
  uint32_t w[4];
};

// The ten round keys of a seed, computed once per thread.
struct Keys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ Keys round_keys(uint32_t k0, uint32_t k1) {
  Keys k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0 + static_cast<uint32_t>(r) * kW0;
    k.k1[r] = k1 + static_cast<uint32_t>(r) * kW1;
  }
  return k;
}

// hi and lo words of m * c in one IMAD.WIDE.U32.
__device__ __forceinline__ void mul_wide(uint32_t m, uint32_t c, uint32_t& hi, uint32_t& lo) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(m), "r"(c));
  lo = static_cast<uint32_t>(p);
  hi = static_cast<uint32_t>(p >> 32);
}

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, const Keys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mul_wide(kM0, c0, hi0, lo0);
    mul_wide(kM1, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ k.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k.k1[r];
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// (k + 0.5) * 2^-23 for the top 23 bits k of w: 1 + k * 2^-23 is exact, and
// subtracting 1 - 2^-24 from a value in [1, 2) is exact (Sterbenz).
__device__ __forceinline__ float uniform(uint32_t w) {
  return __uint_as_float(0x3F800000u | (w >> 9)) - 0.999999940395355224609375f;
}

// Two independent N(0, 1) from two words: r*cos(2*pi*u2), r*sin(2*pi*u2).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& n1,
                                           float& n2) {
  const float r = sqrtf(-2.0f * logf(uniform(a)));
  float s, c;
  sincospif(2.0f * uniform(b), &s, &c);
  n1 = r * c;
  n2 = r * s;
}

__device__ __forceinline__ float clamp3(float v) {
  // Comparisons, not fminf/fmaxf: a NaN stays NaN, as in torch.clamp.
  return v < -3.0f ? -3.0f : (v > 3.0f ? 3.0f : v);
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&lo);
    q.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

struct Params {
  int n;           // elements per sample, H*W*C
  int wc;          // W*C: the period of the stripe pattern
  int c;           // bands
  int per_cta;     // groups of 4 elements per CTA
  uint32_t k0, k1; // the seed
  float p_dead, speckle, g2, t2, p_stripe, stripe_sigma, cm1;
};

// The sample's tables in shared memory, and whether its stripes are on.
struct Tables {
  float* alive;    // [C]
  float* sd;       // [C]
  float* stripe;   // [W*C], drawn only if the gate is set
  bool gate;
};

// Bytes of the tables: alive and sd per band, the gate, the stripes.
inline size_t table_bytes(int c, int wc) {
  return static_cast<size_t>(2 * c + 1 + wc) * sizeof(float);
}

// Draw sample b's dead bands, gate and (if gated) stripes, compute its band
// table, and write its masks (CTA 0 of the sample). Ends with the CTA synced.
__device__ Tables sample_tables(float* smem, float* __restrict__ masks, const Params& p,
                                const Keys& keys, uint32_t b) {
  Tables t;
  t.alive = smem;
  t.sd = smem + p.c;
  float* gate_s = smem + 2 * p.c;
  t.stripe = gate_s + 1;
  const int tid = threadIdx.x;
  for (int q = tid; 4 * q < p.c + 1; q += blockDim.x) {
    const Words w = philox(q, 0, b, 0, keys);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      const float u = uniform(w.w[r]);
      if (j < p.c) t.alive[j] = u >= p.p_dead ? 1.0f : 0.0f;
      else if (j == p.c) gate_s[0] = u < p.p_stripe ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  for (int c = tid; c < p.c; c += blockDim.x) {
    const float weight = 1.0f + static_cast<float>(c) / p.cm1;
    t.sd[c] = sqrtf(p.t2 * weight * weight + p.g2 * t.alive[c]);
  }
  t.gate = gate_s[0] != 0.0f;
  if (t.gate) {  // uniform across the CTA
    for (int i = tid; i < p.wc; i += blockDim.x) {
      const Words w = philox(i, 1, b, 0, keys);
      float n1, n2;
      box_muller(w.w[0], w.w[1], n1, n2);
      t.stripe[i] = n1 * p.stripe_sigma;
    }
  }
  if (masks != nullptr && blockIdx.x == 0) {
    for (int j = tid; j <= p.c; j += blockDim.x)
      masks[b * (p.c + 1) + j] = j < p.c ? t.alive[j] : gate_s[0];
  }
  __syncthreads();
  return t;
}

// One element: speckle, dead band, the combined normal, the stripe, clamp.
__device__ __forceinline__ float compose(float v, float n1, float n2, float a, float sd,
                                         float speckle) {
  float y = v * (1.0f + n1 * speckle);
  y = y * a;
  return y + n2 * sd;
}

// Groups of 4 elements (VEC: whole and aligned, one vector load and store
// each), any band count, any n. The band and the stripe index are carried
// from a thread's group to its next by adding the stride, never by `%`.
// One pass of the loop is one group (not unrolled: chip_smoke.py counts its
// instructions).
template <typename T, bool VEC, bool GATE>
__device__ __forceinline__ void group_loop(const T* __restrict__ x, T* __restrict__ out,
                                           const Params& p, const Keys& keys,
                                           const Tables& t, uint32_t b) {
  const size_t base = static_cast<size_t>(b) * p.n;
  const T* xs = x + base;
  T* os = out + base;
  const int groups = (p.n + 3) / 4;
  const int g1 = min(groups, (blockIdx.x + 1) * p.per_cta);
  int g = blockIdx.x * p.per_cta + threadIdx.x;
  // Band and stripe index of this thread's first element, and how far they
  // move from one of its groups to the next (4 * blockDim elements).
  int band = (4 * g) % p.c;
  int wc0 = GATE ? (4 * g) % p.wc : 0;
  const int band_step = (4 * blockDim.x) % p.c;
  const int wc_step = GATE ? (4 * blockDim.x) % p.wc : 0;
#pragma unroll 1
  for (; g < g1; g += blockDim.x) {
    const int e0 = 4 * g;
    float v[4];
    if (VEC) {
      Io<T>::load4(xs + e0, v);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = e0 + r < p.n ? Io<T>::load1(xs + e0 + r) : 0.0f;
    }
    const Words wa = philox(2 * g, 0, b, 1, keys);
    const Words wb = philox(2 * g + 1, 0, b, 1, keys);
    const uint32_t words[8] = {wa.w[0], wa.w[1], wa.w[2], wa.w[3],
                               wb.w[0], wb.w[1], wb.w[2], wb.w[3]};
    int c = band, wc = wc0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float n1, n2;
      box_muller(words[2 * r], words[2 * r + 1], n1, n2);
      float y = compose(v[r], n1, n2, t.alive[c], t.sd[c], p.speckle);
      if (GATE) {
        y = y + t.stripe[wc];
        if (++wc == p.wc) wc = 0;
      }
      v[r] = clamp3(y);
      if (++c == p.c) c = 0;
    }
    if (VEC) {
      Io<T>::store4(os + e0, v);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (e0 + r < p.n) Io<T>::store1(os + e0 + r, v[r]);
    }
    band += band_step;
    while (band >= p.c) band -= p.c;
    if (GATE) {
      wc0 += wc_step;
      while (wc0 >= p.wc) wc0 -= p.wc;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
noise_group_kernel(const T* __restrict__ x, T* __restrict__ out,
                   float* __restrict__ masks, Params p) {
  const uint32_t b = blockIdx.y;
  const Keys keys = round_keys(p.k0, p.k1);
  const Tables t = sample_tables(dyn_smem, masks, p, keys, b);
  if (t.gate) group_loop<T, VEC, true>(x, out, p, keys, t, b);
  else group_loop<T, VEC, false>(x, out, p, keys, t, b);
}

template <typename T>
int launch(void (*kernel)(const T*, T*, float*, Params), const void* x, void* out,
           float* masks, const Params& p, int b, int chunks, cudaStream_t stream) {
  const size_t smem = table_bytes(p.c, p.wc);
  const cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(chunks, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), masks, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* x, void* out, float* masks, const Params& p, int vec, int b,
                 int chunks, cudaStream_t stream) {
  return vec ? launch(noise_group_kernel<T, true>, x, out, masks, p, b, chunks, stream)
             : launch(noise_group_kernel<T, false>, x, out, masks, p, b, chunks, stream);
}

}  // namespace

// x, out: [B, n] contiguous, fp32 (dtype 0) or bf16 (dtype 1). masks:
// [B, C+1] fp32 (alive per band, then the gate) or null. vec: n % 4 == 0
// and x, out aligned to a group of 4. CTA x of sample b takes the groups of
// 4 elements [x * per_cta, (x+1) * per_cta). Returns the CUDA error code of
// the launch (0 on success).
extern "C" int msid_noise_forward(const void* x, void* out, float* masks,
                                  int dtype, int vec, int b, int n, int wc,
                                  int c, int chunks, int per_cta,
                                  unsigned int k0, unsigned int k1,
                                  float p_dead, float speckle, float g2,
                                  float t2, float p_stripe, float stripe_sigma,
                                  void* stream) {
  Params p;
  p.n = n;
  p.wc = wc;
  p.c = c;
  p.per_cta = per_cta;
  p.k0 = k0;
  p.k1 = k1;
  p.p_dead = p_dead;
  p.speckle = speckle;
  p.g2 = g2;
  p.t2 = t2;
  p.p_stripe = p_stripe;
  p.stripe_sigma = stripe_sigma;
  p.cm1 = static_cast<float>(c > 1 ? c - 1 : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(x, out, masks, p, vec, b, chunks, s);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(x, out, masks, p, vec, b, chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
