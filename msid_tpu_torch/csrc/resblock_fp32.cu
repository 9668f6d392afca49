// Fused eval-mode decoder ResidualBlock for Hopper (sm_90a), NHWC fp32.
//
// Replaces the TPU kernel `fused_residual_block` (v1, `_resblock_kernel`)
// of msid_tpu/ops/pallas_decoder.py. It computes, for x [B,H,W,C] fp32,
// HWIO weights w1, w2 [3,3,C,C] fp32 and the folded BN affine
// aff = (a1, b1, a2, b2) [4,C] fp32, entirely in fp32 (no TF32):
//
//   h = gelu_tanh(conv3x3(x, w1) * a1 + b1)   h = 0 outside the image
//   y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + x)
//
// Bound on an H100 SXM (66.9 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s HBM): one block is 2 * 2 * 9 * C^2 * H * W operations, 3.06
// GFLOP per 192x192 tile at every flagship decoder stage, i.e. ~46 us per
// tile on the FMA units, against 2 * H * W * C * 4 bytes (1.8 MB at C=384
// to 14.2 MB at C=48 per tile, ~0.5 to ~4.2 us) of activation traffic. So
// the bound is FMA throughput at every width.
//
// Design (simple and right first; not yet at that bound):
//   * one cluster of G CTAs (256 threads each) per (sample, TH x TW output
//     tile); tile and G are chosen by the caller (ops/cuda_decoder.py).
//     Clusters are independent, and conv1's one-pixel halo of h is
//     recomputed per tile rather than carried between tiles;
//   * output channels go in blocks of NB = TN * CG (64, 32 or 16, chosen to
//     divide C), and CTA r of a cluster owns blocks r, r + G, ...: it
//     computes those channels of h over the (TH+2) x (TW+2) region
//     (conv1) and of the output over the tile (conv2). So a tile's work
//     is spread over G SMs, which matters where there are few tiles (C=384
//     at B=1: 16 tiles);
//   * h stays in fp32 in shared memory, each CTA holding its own channel
//     blocks, and never goes to device memory. After a cluster barrier,
//     conv2 stages each chunk of 8 input channels of h from the owning
//     CTA's shared memory (distributed shared memory), as conv1 stages x;
//   * the (TH+4) x (TW+4) halo tile of x does not fit beside h in fp32
//     (12 * 12 * 384 * 4 B = 221 KB at C=384), so it is staged through
//     shared memory 8 input channels at a time, with the matching
//     [9][8][NB] slice of the weights;
//   * each conv is an implicit GEMM (pixels x output channels, K = 9C) on
//     plain fp32 FFMA: a thread keeps up to 4 slots x 2 pixels x TN output
//     channels in registers and reads each staged value once per FMA row;
//     any C works (channels past C are zeros);
//   * the residual is read from x in device memory in the epilogue.
// Staged chunks and h have an odd pitch, so the scalar loads of the pixels
// a warp shares fall in different banks. Moving toward the FMA bound is
// later work: double-buffered staging with cp.async, larger register
// tiles, 3xTF32 splitting on the tensor cores.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTM = 2;      // pixels per thread per slot
constexpr int kSlots = 4;   // pixel slots per thread
constexpr int kKC = 8;      // input channels per staged chunk
constexpr int kMaxSmem = 232448;
constexpr int kMaxCluster = 8;  // portable cluster size

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

// Pitch of a CTA's h: its channel blocks (at most ceil(blocks / G) of NB)
// plus one float.
__host__ __device__ inline int h_pitch(int C, int NB, int G) {
  const int blocks = (C + NB - 1) / NB;
  return (blocks + G - 1) / G * NB + 1;
}

// Shared memory of one CTA in floats: the staged weights [9][kKC][NB], its
// h [(TH+2)(TW+2)][pitch] and the staged chunk of x (conv1) or h (conv2)
// [(TH+4)(TW+4)][kKC+1].
__host__ __device__ inline size_t smem_floats(int C, int TH, int TW, int NB, int G) {
  return (size_t)9 * kKC * NB + (size_t)(TH + 2) * (TW + 2) * h_pitch(C, NB, G) +
         (size_t)(TH + 4) * (TW + 4) * (kKC + 1);
}

// Output channel of register column j of a thread in channel group g:
// float4 groups of CG threads are contiguous, so a warp's weight loads
// cover consecutive 16-byte words.
template <int CG>
__device__ __forceinline__ int out_channel(int nb, int g, int j) {
  return nb + (j >> 2) * 4 * CG + 4 * g + (j & 3);
}

// Source pixel index (r * src_w + c) of each of a thread's region pixels
// (region `out_w` wide, `m` pixels); 0 for padding pixels, which are
// computed and never stored.
template <int NPG>
__device__ __forceinline__ void region_offsets(int (&off)[kSlots][kTM], int pg,
                                               int m, int out_w, int src_w) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int p = (s * NPG + pg) * kTM + i;
      int o = 0;
      if (p < m) {
        const int r = p / out_w;
        o = r * src_w + (p - r * out_w);
      }
      off[s][i] = o;
    }
  }
}

// acc += the 3x3 conv of one staged chunk of kKC input channels. `src` is
// a shared-memory tile `src_w` pixels wide with `pitch` floats per pixel,
// already offset to the chunk's first channel; `wcol` is the staged
// [9][kKC][NB] weight slice offset to this thread's first float4 column.
template <int TN, int CG>
__device__ __forceinline__ void accumulate(const float* __restrict__ src,
                                           int pitch, int src_w,
                                           const int (&off)[kSlots][kTM],
                                           int ns, const float* __restrict__ wcol,
                                           float (&acc)[kSlots][kTM][TN]) {
  constexpr int NB = TN * CG;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3;
    const int toff = ky * src_w + (tap - ky * 3);
    int base[kSlots][kTM];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int i = 0; i < kTM; ++i) base[s][i] = (off[s][i] + toff) * pitch;
    const float* wt = wcol + tap * kKC * NB;
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      float b[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(wt + k * NB + q * 4 * CG);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < ns) {
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float a = src[base[s][i] + k];
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[s][i][j] = fmaf(a, b[j], acc[s][i][j]);
          }
        }
      }
    }
  }
}

// Stage w[tap][kc + k][nb + n] into ws[(tap * kKC + k) * NB + n], zeros
// outside [0, C).
template <int NB>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w,
                                              int C, int kc, int nb) {
  for (int idx = threadIdx.x; idx < 9 * kKC * NB; idx += kThreads) {
    const int n = idx % NB;
    const int t = idx / NB;
    const int k = t % kKC;
    const int tap = t / kKC;
    const int ci = kc + k;
    const int co = nb + n;
    ws[idx] = (ci < C && co < C) ? __ldg(w + ((size_t)tap * C + ci) * C + co) : 0.0f;
  }
}

template <int TN, int CG>
__global__ void __launch_bounds__(kThreads)
    resblock_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                         const float* __restrict__ w2, const float* __restrict__ aff,
                         float* __restrict__ out, int H, int W, int C, int TH,
                         int TW, int G) {
  constexpr int NB = TN * CG;
  constexpr int NPG = kThreads / CG;
  constexpr int SLOT = NPG * kTM;
  constexpr int SP = kKC + 1;  // pitch of a staged chunk
  const int XW = TW + 4, XH = TH + 4;
  const int HW = TW + 2, HH = TH + 2;
  const int M1 = HH * HW, M2 = TH * TW;
  const int P = h_pitch(C, NB, G);
  const int blocks = (C + NB - 1) / NB;

  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* hs = ws + 9 * kKC * NB;
  float* st = hs + (size_t)M1 * P;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int cgi = tid % CG;
  const int pg = tid / CG;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = (blockIdx.x / G) * TW;
  const float* xn = x + (size_t)n * H * W * C;
  float* on = out + (size_t)n * H * W * C;
  const float* wcol = ws + 4 * cgi;

  int off[kSlots][kTM];
  float acc[kSlots][kTM][TN];

  // conv1 over the (TH+2) x (TW+2) region -> this CTA's blocks of h.
  region_offsets<NPG>(off, pg, M1, HW, XW);
  const int ns1 = (M1 + SLOT - 1) / SLOT;
  for (int bi = rank; bi < blocks; bi += G) {
    const int nb = bi * NB;
    float* hb = hs + (bi / G) * NB;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[s][i][j] = 0.0f;
    for (int kc = 0; kc < C; kc += kKC) {
      __syncthreads();
      for (int idx = tid; idx < XH * XW * kKC; idx += kThreads) {
        const int k = idx % kKC;
        const int pix = idx / kKC;
        const int r = pix / XW;
        const int gy = y0 - 2 + r;
        const int gx = x0 - 2 + (pix - r * XW);
        const int ci = kc + k;
        st[pix * SP + k] = (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < C)
                               ? __ldg(xn + ((size_t)gy * W + gx) * C + ci)
                               : 0.0f;
      }
      stage_weights<NB>(ws, w1, C, kc, nb);
      __syncthreads();
      accumulate<TN, CG>(st, SP, XW, off, ns1, wcol, acc);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int p = (s * NPG + pg) * kTM + i;
        if (p >= M1) continue;
        const int r = p / HW;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + (p - r * HW);
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int co = out_channel<CG>(nb, cgi, j);
          if (co >= C) continue;
          hb[p * P + co - nb] =
              inside ? gelu_tanh(fmaf(acc[s][i][j], __ldg(aff + co), __ldg(aff + C + co)))
                     : 0.0f;
        }
      }
    }
  }

  // Every CTA of the cluster has written its blocks of h.
  cluster.sync();

  // conv2 over the TH x TW tile, + residual -> out.
  region_offsets<NPG>(off, pg, M2, TW, HW);
  const int ns2 = (M2 + SLOT - 1) / SLOT;
  for (int bi = rank; bi < blocks; bi += G) {
    const int nb = bi * NB;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[s][i][j] = 0.0f;
    for (int kc = 0; kc < C; kc += kKC) {
      // A chunk of kKC channels lies in one block (NB is a multiple of kKC).
      const int src = kc / NB;
      const float* hsrc =
          cluster.map_shared_rank(hs, src % G) + (src / G) * NB + (kc - src * NB);
      __syncthreads();
      for (int idx = tid; idx < M1 * kKC; idx += kThreads) {
        const int k = idx % kKC;
        const int pix = idx / kKC;
        st[pix * SP + k] = kc + k < C ? hsrc[pix * P + k] : 0.0f;
      }
      stage_weights<NB>(ws, w2, C, kc, nb);
      __syncthreads();
      accumulate<TN, CG>(st, SP, HW, off, ns2, wcol, acc);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int p = (s * NPG + pg) * kTM + i;
        if (p >= M2) continue;
        const int r = p / TW;
        const int gy = y0 + r;
        const int gx = x0 + (p - r * TW);
        if (gy >= H || gx >= W) continue;
        const size_t pix = ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int co = out_channel<CG>(nb, cgi, j);
          if (co >= C) continue;
          const float v = fmaf(acc[s][i][j], __ldg(aff + 2 * C + co),
                               __ldg(aff + 3 * C + co)) +
                          __ldg(xn + pix + co);
          on[pix + co] = gelu_tanh(v);
        }
      }
    }
  }

  // Keep this CTA's h alive until every CTA of the cluster has read it.
  cluster.sync();
}

template <int TN, int CG>
cudaError_t launch(const float* x, const float* w1, const float* w2,
                   const float* aff, float* out, int B, int H, int W, int C,
                   int TH, int TW, int G, cudaStream_t stream) {
  constexpr int SLOT = kThreads / CG * kTM;
  if (TH < 1 || TW < 1 || G < 1 || G > kMaxCluster ||
      (TH + 2) * (TW + 2) > kSlots * SLOT)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(C, TH, TW, TN * CG, G) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = resblock_fp32_kernel<TN, CG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + TW - 1) / TW * G, (H + TH - 1) / TH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w1, w2, aff, out, H, W, C, TH, TW, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, out: [B,H,W,C] fp32 contiguous; w1, w2: [3,3,C,C] fp32 HWIO
// contiguous; aff: [4][C] fp32. TH x TW is the output tile of one cluster
// of G (1..8) CTAs and NB (64, 32 or 16) the output-channel block; the
// caller chooses all three (ops/cuda_decoder.py: fp32_tiling). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a tile that does
// not fit).
extern "C" int msid_resblock_fp32_forward(const void* x, const void* w1,
                                          const void* w2, const void* aff,
                                          void* out, int B, int H, int W, int C,
                                          int TH, int TW, int NB, int G,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* af = static_cast<const float*>(aff);
  float* of = static_cast<float*>(out);
  switch (NB) {
    case 64:
      return (int)launch<8, 8>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, s);
    case 32:
      return (int)launch<4, 8>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, s);
    case 16:
      return (int)launch<4, 4>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
