// Fused eval-mode decoder ResidualBlock for Hopper (sm_90a), NHWC bf16.
//
// Replaces the TPU kernel `fused_residual_block_v3` (`_resblock_kernel_v3`)
// of msid_tpu/ops/pallas_decoder.py. It computes, for x [B,H,W,C] bf16,
// HWIO weights w1, w2 [3,3,C,C] bf16 and the folded BN affine
// aff = (a1, b1, a2, b2) [4,C] fp32:
//
//   h = gelu_tanh(conv3x3(x, w1) * a1 + b1)   (fp32 accumulation)
//   h = 0 outside the image; h rounded to bf16
//   y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + float(x))  -> bf16
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): one block
// is 2 * 2 * 9 * C^2 * H * W operations, 3.06 GFLOP per 192x192 tile at
// every decoder stage (C=384@24^2 ... C=48@192^2), i.e. ~3.1 us per tile
// on the tensor cores. The activation traffic is one read of x and one
// write of y: 2 * H * W * C * 2 bytes, ~0.9 MB (C=384) to ~7.1 MB (C=48)
// per tile (~0.3 to ~2.1 us), plus 18 * C^2 * 2 bytes of weights per
// launch. So at B >= 1 the bound is tensor-core time.
//
// Design (first version: simple and right; not yet at that bound):
//   * one CTA per (sample, TH x TW output tile); CTAs are independent and
//     run in any order, unlike the TPU kernel's sequential row grid;
//   * the (TH+4) x (TW+4) x C halo tile of x is loaded once into shared
//     memory (zeros outside the image);
//   * conv1 is an implicit GEMM over the (TH+2) x (TW+2) h region with
//     M = pixels, N = C, K = 9C, on bf16 mma.sync m16n8k16 tensor cores
//     with fp32 accumulators; its epilogue applies the affine and GELU,
//     zeroes h outside the image, rounds to bf16 and writes h to shared
//     memory only -- h never goes to device memory, which is the point of
//     the TPU kernel (one read and one write of the activation);
//   * conv2 reads h from shared memory, adds the residual from the x tile
//     and writes the bf16 output;
//   * weights are pre-transposed by the caller to [tap][Cout][Cin] so a
//     B fragment is one 32-bit load; they stream from L2 (at most
//     2 x 2.65 MB at C=384) through L1.
// The pixel pitch in shared memory is C + 8 elements, which makes the
// A-fragment loads of a warp free of bank conflicts for every supported C.
// Moving toward the tensor-core bound is later work: wgmma with the tiles
// in swizzled shared memory, weights staged by TMA, warp specialisation,
// and clusters sharing the h halo so that small images fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 4;               // m16 tiles per warp unit: 64 pixels
constexpr int kNT = 6;               // n8 tiles per warp unit: 48 channels
constexpr int kUnitM = 16 * kMT;
constexpr int kUnitN = 8 * kNT;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's share of a 3x3 conv as an implicit GEMM: output rows
// [m0, m0 + 64) of a region `out_w` pixels wide holding `m_count` pixels,
// output channels [n0, n0 + 48). Row p of A is the 3x3 neighbourhood of
// region pixel p in `src`, a shared-memory tile `src_w` pixels wide whose
// pixel (r + ky, c + kx) is tap (ky, kx) of region pixel (r, c).
template <int C>
__device__ __forceinline__ void conv3x3_unit(const bf16* src, int src_w,
                                             int out_w, int m_count, int m0,
                                             int n0,
                                             const bf16* __restrict__ wt,
                                             float (&acc)[kMT][kNT][4]) {
  constexpr int P = C + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  int base[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = m0 + i * 16 + g + h * 8;
      if (p >= m_count) p = 0;  // padding row: computed, never stored
      const int r = p / out_w;
      const int c = p - r * out_w;
      base[i][h] = (r * src_w + c) * P + t * 2;
    }
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    const int toff = (ky * src_w + kx) * P;
    const bf16* wtap = wt + (size_t)tap * C * C + (size_t)(n0 + g) * C + t * 2;
#pragma unroll 2
    for (int k = 0; k < C; k += 16) {
      uint32_t a[kMT][4];
      uint32_t b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const bf16* s0 = src + base[i][0] + toff + k;
        const bf16* s1 = src + base[i][1] + toff + k;
        a[i][0] = lds32(s0);
        a[i][1] = lds32(s1);
        a[i][2] = lds32(s0 + 8);
        a[i][3] = lds32(s1 + 8);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* wp = wtap + (size_t)j * 8 * C + k;
        b[j][0] = ldg32(wp);
        b[j][1] = ldg32(wp + 8);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
}

template <int C, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
                    const bf16* __restrict__ w2t,
                    const float* __restrict__ aff, bf16* __restrict__ out,
                    int H, int W) {
  static_assert(C % kUnitN == 0, "C must be a multiple of 48");
  constexpr int P = C + 8;       // pixel pitch in shared memory (elements)
  constexpr int XH = TH + 4, XW = TW + 4;   // x halo tile
  constexpr int HH = TH + 2, HW = TW + 2;   // h tile
  constexpr int M1 = HH * HW;
  constexpr int M2 = TH * TW;
  constexpr int NCH = C / kUnitN;
  constexpr int VEC = C / 8;     // 16-byte vectors per pixel

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + XH * XW * P;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const bf16* xn = x + (size_t)n * H * W * C;

  for (int idx = threadIdx.x; idx < XH * XW * VEC; idx += kThreads) {
    const int pix = idx / VEC;
    const int v = idx - pix * VEC;
    const int r = pix / XW;
    const int c = pix - r * XW;
    const int gy = y0 - 2 + r;
    const int gx = x0 - 2 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = __ldg(reinterpret_cast<const uint4*>(
                      xn + ((size_t)gy * W + gx) * C) + v);
    *reinterpret_cast<uint4*>(xs + pix * P + v * 8) = val;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[kMT][kNT][4];

  // conv1 -> h (shared memory only).
  constexpr int U1 = ((M1 + kUnitM - 1) / kUnitM) * NCH;
  for (int u = warp; u < U1; u += kWarps) {
    const int m0 = (u / NCH) * kUnitM;
    const int n0 = (u % NCH) * kUnitN;
    conv3x3_unit<C>(xs, XW, HW, M1, m0, n0, w1t, acc);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + i * 16 + g + h * 8;
        if (p >= M1) continue;
        const int r = p / HW;
        const int c = p - r * HW;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + c;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int co = n0 + j * 8 + t * 2;
          float v0 = 0.0f, v1 = 0.0f;
          if (inside) {
            v0 = gelu_tanh(fmaf(acc[i][j][2 * h], __ldg(aff + co), __ldg(aff + C + co)));
            v1 = gelu_tanh(fmaf(acc[i][j][2 * h + 1], __ldg(aff + co + 1),
                                __ldg(aff + C + co + 1)));
          }
          *reinterpret_cast<__nv_bfloat162*>(hs + p * P + co) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // conv2 + residual -> out.
  bf16* on = out + (size_t)n * H * W * C;
  constexpr int U2 = ((M2 + kUnitM - 1) / kUnitM) * NCH;
  for (int u = warp; u < U2; u += kWarps) {
    const int m0 = (u / NCH) * kUnitM;
    const int n0 = (u % NCH) * kUnitN;
    conv3x3_unit<C>(hs, HW, TW, M2, m0, n0, w2t, acc);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + i * 16 + g + h * 8;
        if (p >= M2) continue;
        const int r = p / TW;
        const int c = p - r * TW;
        const int gy = y0 + r;
        const int gx = x0 + c;
        if (gy >= H || gx >= W) continue;
        const bf16* res = xs + ((r + 2) * XW + c + 2) * P;
        bf16* dst = on + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int co = n0 + j * 8 + t * 2;
          const float v0 = fmaf(acc[i][j][2 * h], __ldg(aff + 2 * C + co),
                                __ldg(aff + 3 * C + co)) +
                           __bfloat162float(res[co]);
          const float v1 = fmaf(acc[i][j][2 * h + 1], __ldg(aff + 2 * C + co + 1),
                                __ldg(aff + 3 * C + co + 1)) +
                           __bfloat162float(res[co + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + co) =
              __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
        }
      }
    }
  }
}

template <int C, int TH, int TW>
cudaError_t launch(const void* x, const void* w1t, const void* w2t,
                   const void* aff, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  constexpr int P = C + 8;
  constexpr size_t smem =
      (size_t)((TH + 4) * (TW + 4) + (TH + 2) * (TW + 2)) * P * sizeof(bf16);
  static_assert(smem <= 232448, "tile does not fit in shared memory");
  auto kernel = resblock_kernel<C, TH, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1t),
      static_cast<const bf16*>(w2t), static_cast<const float*>(aff),
      static_cast<bf16*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace

// x, out: [B,H,W,C] bf16 contiguous; w1t, w2t: [9][C][C] bf16 laid out as
// [tap][Cout][Cin]; aff: [4][C] fp32. Returns the cudaError_t of the launch.
// Tile sizes per C keep the x and h tiles under ~190 KB of shared memory.
extern "C" int msid_resblock_forward(const void* x, const void* w1t,
                                     const void* w2t, const void* aff,
                                     void* out, int B, int H, int W, int C,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 48:
      return (int)launch<48, 16, 32>(x, w1t, w2t, aff, out, B, H, W, s);
    case 96:
      return (int)launch<96, 16, 16>(x, w1t, w2t, aff, out, B, H, W, s);
    case 192:
      return (int)launch<192, 8, 16>(x, w1t, w2t, aff, out, B, H, W, s);
    case 384:
      return (int)launch<384, 8, 8>(x, w1t, w2t, aff, out, B, H, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
