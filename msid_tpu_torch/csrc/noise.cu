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
//   y = y + n2 * sqrt(t2 * w_c * w_c + g2 * alive_c),  w_c = 1 + c / max(C-1, 1)
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
// Box-Muller pairs (cos and sin of one angle). The TPU's Irwin-Hall(12)
// would cost 12 Philox words per normal here, where transcendentals are
// cheap and random words are not. Built without --use_fast_math.
//
// Bound: bytes. Each element is read once and written once (8 bytes for
// fp32); the ~20 Philox integer operations and one log/sqrt/sincospi per
// element stay under the card's issue rate, so the pass should run near
// the 3.35 TB/s of HBM3.
//
// Layout: grid (chunks, B), one CTA per (sample, block of elements). The
// CTA draws its sample's masks, gate and (only if the gate is set) stripes
// into shared memory, then walks its block in groups of 4 elements with
// 16-byte (fp32) or 8-byte (bf16) loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

__device__ __forceinline__ float uniform(uint32_t w) {
  return (static_cast<float>(w >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
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
  int groups_per_cta;
  uint32_t k0, k1; // the seed
  float p_dead, speckle, g2, t2, p_stripe, stripe_sigma, cm1;
};

// VEC: every group of 4 elements is whole and aligned (n % 4 == 0 and the
// pointers are aligned), so it moves with one vector load and store.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
noise_kernel(const T* __restrict__ x, T* __restrict__ out,
             float* __restrict__ masks, Params p) {
  extern __shared__ float smem[];
  float* alive = smem;              // [C]
  float* gate_s = smem + p.c;       // [1]
  float* stripe = smem + p.c + 1;   // [W*C], drawn only if the gate is set
  const uint32_t b = blockIdx.y;
  const int tid = threadIdx.x;

  for (int q = tid; 4 * q < p.c + 1; q += blockDim.x) {
    const Words w = philox(q, 0, b, 0, p.k0, p.k1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      const float u = uniform(w.w[r]);
      if (j < p.c) alive[j] = u >= p.p_dead ? 1.0f : 0.0f;
      else if (j == p.c) gate_s[0] = u < p.p_stripe ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  const bool gate = gate_s[0] != 0.0f;
  if (gate) {  // uniform across the CTA
    for (int i = tid; i < p.wc; i += blockDim.x) {
      const Words w = philox(i, 1, b, 0, p.k0, p.k1);
      float n1, n2;
      box_muller(w.w[0], w.w[1], n1, n2);
      stripe[i] = n1 * p.stripe_sigma;
    }
    __syncthreads();
  }
  if (masks != nullptr && blockIdx.x == 0) {
    for (int j = tid; j <= p.c; j += blockDim.x)
      masks[b * (p.c + 1) + j] = j < p.c ? alive[j] : gate_s[0];
  }

  const size_t base = static_cast<size_t>(b) * p.n;
  const T* xs = x + base;
  T* os = out + base;
  const int groups = (p.n + 3) / 4;
  const int g0 = blockIdx.x * p.groups_per_cta;
  const int g1 = min(groups, g0 + p.groups_per_cta);
  for (int g = g0 + tid; g < g1; g += blockDim.x) {
    const int e0 = 4 * g;
    float v[4];
    if (VEC) {
      Io<T>::load4(xs + e0, v);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = e0 + r < p.n ? Io<T>::load1(xs + e0 + r) : 0.0f;
    }
    const Words wa = philox(2 * g, 0, b, 1, p.k0, p.k1);
    const Words wb = philox(2 * g + 1, 0, b, 1, p.k0, p.k1);
    const uint32_t words[8] = {wa.w[0], wa.w[1], wa.w[2], wa.w[3],
                               wb.w[0], wb.w[1], wb.w[2], wb.w[3]};
    int wc = e0 % p.wc;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float n1, n2;
      box_muller(words[2 * r], words[2 * r + 1], n1, n2);
      const int c = wc % p.c;
      const float a = alive[c];
      float y = v[r] * (1.0f + n1 * p.speckle);
      y = y * a;
      const float weight = 1.0f + static_cast<float>(c) / p.cm1;
      const float var = p.t2 * weight * weight + p.g2 * a;
      y = y + n2 * sqrtf(var);
      if (gate) y = y + stripe[wc];
      v[r] = clamp3(y);
      if (++wc == p.wc) wc = 0;
    }
    if (VEC) {
      Io<T>::store4(os + e0, v);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (e0 + r < p.n) Io<T>::store1(os + e0 + r, v[r]);
    }
  }
}

template <typename T, bool VEC>
int launch(const void* x, void* out, float* masks, const Params& p, int b,
           int chunks, size_t smem, cudaStream_t stream) {
  auto kernel = noise_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(chunks, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), masks, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [B, n] contiguous, fp32 (dtype 0) or bf16 (dtype 1). masks:
// [B, C+1] fp32 (alive per band, then the gate) or null. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int msid_noise_forward(const void* x, void* out, float* masks,
                                  int dtype, int vec, int b, int n, int wc,
                                  int c, int chunks, int groups_per_cta,
                                  unsigned int k0, unsigned int k1,
                                  float p_dead, float speckle, float g2,
                                  float t2, float p_stripe, float stripe_sigma,
                                  void* stream) {
  Params p;
  p.n = n;
  p.wc = wc;
  p.c = c;
  p.groups_per_cta = groups_per_cta;
  p.k0 = k0;
  p.k1 = k1;
  p.p_dead = p_dead;
  p.speckle = speckle;
  p.g2 = g2;
  p.t2 = t2;
  p.p_stripe = p_stripe;
  p.stripe_sigma = stripe_sigma;
  p.cm1 = static_cast<float>(c > 1 ? c - 1 : 1);
  const size_t smem = static_cast<size_t>(c + 1 + wc) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float, true>(x, out, masks, p, b, chunks, smem, s)
               : launch<float, false>(x, out, masks, p, b, chunks, smem, s);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(x, out, masks, p, b, chunks, smem, s)
               : launch<__nv_bfloat16, false>(x, out, masks, p, b, chunks, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
