// Fused eval-mode decoder ResidualBlock, v2 form, for Hopper (sm_90a), NHWC
// bf16: nine shifted tap GEMMs over one halo window loaded by TMA.
//
// Replaces the TPU kernel `fused_residual_block_v2` (`_resblock_kernel_v2`)
// of msid_tpu/ops/pallas_decoder.py. For x [B,H,W,C] bf16, HWIO weights
// w1, w2 [3,3,C,C] bf16 and the folded BN affine aff = (a1, b1, a2, b2)
// [4,C] fp32:
//
//   h = gelu_tanh(conv3x3(x, w1) * a1 + b1)   (fp32 accumulation)
//   h = 0 outside the image; h rounded to bf16
//   y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + float(x))  -> bf16
//
// What the TPU kernel had to work around, and what this one does instead:
//   * Pallas blocks may not overlap, so v2 pads x in device memory and
//     stitches each (rows, cols) tile's 2-pixel halo from four blocks of
//     the padded copy. Here one thread issues TMA loads of the overlapping
//     (TH+4) x (TW+4) x C window through a tensor map over the NHWC tensor
//     itself; the copy engine fills what lies outside the image with zeros
//     (conv1's zero padding), and an mbarrier armed with the window's byte
//     count reports completion. No padded copy, no per-thread loads.
//   * Each conv is nine tap GEMMs of depth C, one per (ky, kx), reading
//     nine shifted views of that one window and accumulating into the same
//     fp32 registers (bf16 mma.sync m16n8k16). There is no im2col buffer.
//   * The window arrives in channel chunks of CK = 64, 32 or 16 (128, 64
//     or 32 bytes a pixel) with the tensor map's matching swizzle, so the
//     A-fragment loads of eight neighbouring pixels fall on distinct banks
//     although the copy engine writes pixels densely. h is written by the
//     kernel itself, at a pitch of C + 8 elements, to shared memory only.
//   * The tile (TH, TW) is the CTA's output tile, a launch parameter: the
//     TPU's (16, 96) window does not fit a CTA's 227 KB. Ragged edges are
//     masked; the result does not depend on the tile.
// Weights are pre-transposed by the caller to [tap][Cout][Cin] and stream
// from L2, as in resblock.cu (first version).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): the
// block is 2 * 2 * 9 * C^2 * H * W * B operations against one read of x
// and one write of y, so it is bound by operations at every flagship
// shape. mma.sync with operands from L2 and shared memory stays far from
// that bound; wgmma and staged weights are later work.
#include <cuda.h>
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
constexpr int kMaxSmem = 232448;
constexpr uint32_t kMaxSpins = 1u << 22;   // a lost copy traps instead of hanging

typedef __nv_bfloat16 bf16;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Channel chunk of the window: the widest swizzle span that divides C.
template <int C>
struct Chunk {
  static constexpr int CK = (C % 64 == 0) ? 64 : (C % 32 == 0) ? 32 : 16;
  static_assert(C % CK == 0, "C must be a multiple of 16");
  // Within a chunk a pixel takes CK*2 = 128, 64 or 32 bytes. The copy
  // engine XORs the 16-byte unit index (address bits 4..) with address
  // bits 7.., i.e. with (pixel >> SH) & MASK.
  static constexpr int SH = (CK == 64) ? 0 : (CK == 32) ? 1 : 2;
  static constexpr int MASK = CK / 8 - 1;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > kMaxSpins) asm volatile("trap;\n");
  }
}

// Box (c0.., x0.., y0.., n) of the NHWC tensor map into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int x0, int y0,
                                            int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(x0), "r"(y0),
      "r"(n)
      : "memory");
}

// Element offset of (pixel p, channel co) in the swizzled window.
template <int C>
__device__ __forceinline__ int window_offset(int p, int co, int chunk_elems) {
  using K = Chunk<C>;
  const int q = co / K::CK;
  const int e = co - q * K::CK;
  return q * chunk_elems + p * K::CK +
         ((((e >> 3) ^ ((p >> K::SH) & K::MASK))) << 3) + (e & 7);
}

// One warp's share of one conv as nine tap GEMMs: output pixels
// [m0, m0 + 64) of a region `out_w` pixels wide holding `m_count` pixels,
// output channels [n0, n0 + 48). Tap (ky, kx) multiplies the view of `src`
// shifted by (ky, kx): region pixel (r, c) reads source pixel
// (r + ky, c + kx) of a tile `src_w` pixels wide. FROM_WINDOW: `src` is the
// swizzled, chunked x window; otherwise the h tile at pitch C + 8.
template <int C, bool FROM_WINDOW>
__device__ __forceinline__ void conv_nine_taps(const bf16* src, int chunk_elems,
                                               int src_w, int out_w, int m_count,
                                               int m0, int n0,
                                               const bf16* __restrict__ wt,
                                               float (&acc)[kMT][kNT][4]) {
  using K = Chunk<C>;
  constexpr int P = C + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  int pix[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = m0 + i * 16 + g + h * 8;
      if (p >= m_count) p = 0;  // padding row: computed, never stored
      const int r = p / out_w;
      pix[i][h] = r * src_w + (p - r * out_w);
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
    const int shift = ky * src_w + kx;
    const bf16* wtap = wt + (size_t)tap * C * C + (size_t)(n0 + g) * C + t * 2;
    int off[kMT][2];   // element offset of the shifted pixel (+ this thread's pair)
    int swz[kMT][2];   // its swizzle term (window only)
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pix[i][h] + shift;
        if (FROM_WINDOW) {
          off[i][h] = p * K::CK + t * 2;
          swz[i][h] = (p >> K::SH) & K::MASK;
        } else {
          off[i][h] = p * P + t * 2;
          swz[i][h] = 0;
        }
      }
    }
    if (FROM_WINDOW) {
      for (int q = 0; q < C / K::CK; ++q) {
        const bf16* chunk = src + q * chunk_elems;
#pragma unroll
        for (int u = 0; u < K::CK / 8; u += 2) {   // 16 channels: units u, u+1
          uint32_t a[kMT][4];
          uint32_t b[kNT][2];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const int u0 = (u ^ swz[i][0]) << 3;
            const int u1 = (u ^ swz[i][1]) << 3;
            a[i][0] = lds32(chunk + off[i][0] + u0);
            a[i][1] = lds32(chunk + off[i][1] + u1);
            a[i][2] = lds32(chunk + off[i][0] + (u0 ^ 8));
            a[i][3] = lds32(chunk + off[i][1] + (u1 ^ 8));
          }
          const int k = q * K::CK + u * 8;
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
    } else {
#pragma unroll 2
      for (int k = 0; k < C; k += 16) {
        uint32_t a[kMT][4];
        uint32_t b[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const bf16* s0 = src + off[i][0] + k;
          const bf16* s1 = src + off[i][1] + k;
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
}

// Bytes of one window chunk in shared memory: each starts on a 1024-byte
// boundary, the period of the widest swizzle.
__host__ __device__ inline int chunk_bytes(int th, int tw, int ck) {
  return ((th + 4) * (tw + 4) * ck * 2 + 1023) & ~1023;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_v2_kernel(const __grid_constant__ CUtensorMap xmap,
                       const bf16* __restrict__ w1t, const bf16* __restrict__ w2t,
                       const float* __restrict__ aff, bf16* __restrict__ out, int H,
                       int W, int TH, int TW) {
  static_assert(C % kUnitN == 0, "C must be a multiple of 48");
  using K = Chunk<C>;
  constexpr int P = C + 8;       // h pixel pitch in shared memory (elements)
  constexpr int NQ = C / K::CK;  // window chunks
  constexpr int NCH = C / kUnitN;
  const int XH = TH + 4, XW = TW + 4;   // x halo window
  const int HH = TH + 2, HW = TW + 2;   // h tile
  const int M1 = HH * HW;
  const int M2 = TH * TW;
  const int chunk_elems = chunk_bytes(TH, TW, K::CK) / 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + NQ * chunk_elems;
  const uint32_t bar = smem_u32(hs + M1 * P);

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (uint32_t)(XH * XW * C * 2));
    for (int q = 0; q < NQ; ++q)
      tma_load_4d(smem_u32(xs + q * chunk_elems), &xmap, bar, q * K::CK, x0 - 2,
                  y0 - 2, n);
  }
  mbar_wait(bar, 0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[kMT][kNT][4];

  // conv1 -> h (shared memory only).
  const int U1 = ((M1 + kUnitM - 1) / kUnitM) * NCH;
  for (int u = warp; u < U1; u += kWarps) {
    const int m0 = (u / NCH) * kUnitM;
    const int n0 = (u % NCH) * kUnitN;
    conv_nine_taps<C, true>(xs, chunk_elems, XW, HW, M1, m0, n0, w1t, acc);
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
  const int U2 = ((M2 + kUnitM - 1) / kUnitM) * NCH;
  for (int u = warp; u < U2; u += kWarps) {
    const int m0 = (u / NCH) * kUnitM;
    const int n0 = (u % NCH) * kUnitN;
    conv_nine_taps<C, false>(hs, 0, HW, TW, M2, m0, n0, w2t, acc);
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
        const int xp = (r + 2) * XW + c + 2;   // the same pixel in the window
        bf16* dst = on + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int co = n0 + j * 8 + t * 2;
          const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(
              xs + window_offset<C>(xp, co, chunk_elems));
          const float v0 = fmaf(acc[i][j][2 * h], __ldg(aff + 2 * C + co),
                                __ldg(aff + 3 * C + co)) +
                           __bfloat162float(res.x);
          const float v1 = fmaf(acc[i][j][2 * h + 1], __ldg(aff + 2 * C + co + 1),
                                __ldg(aff + 3 * C + co + 1)) +
                           __bfloat162float(res.y);
          *reinterpret_cast<__nv_bfloat162*>(dst + co) =
              __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
        }
      }
    }
  }
}

template <int C>
int launch(EncodeTiledFn encode, const void* x, const void* w1t, const void* w2t,
           const void* aff, void* out, int B, int H, int W, int TH, int TW,
           cudaStream_t stream) {
  using K = Chunk<C>;
  constexpr int NQ = C / K::CK;
  const size_t smem = (size_t)NQ * chunk_bytes(TH, TW, K::CK) +
                      (size_t)(TH + 2) * (TW + 2) * (C + 8) * sizeof(bf16) + 8 + 1024;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;

  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)K::CK, (cuuint32_t)(TW + 4),
                             (cuuint32_t)(TH + 4), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = K::CK == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : K::CK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 100000 + (int)res;

  auto kernel = resblock_v2_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      map, static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t),
      static_cast<const float*>(aff), static_cast<bf16*>(out), H, W, TH, TW);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B,H,W,C] bf16 contiguous, 16-byte aligned; w1t, w2t: [9][C][C]
// bf16 laid out as [tap][Cout][Cin]; aff: [4][C] fp32; (TH, TW) the CTA's
// output tile, each at most 252. Returns 0, the cudaError_t of the launch
// (cudaErrorInvalidValue for a width the kernel is not built for or a tile
// whose shared memory does not fit), -1 when libcuda exports no
// cuTensorMapEncodeTiled, or 100000 + the CUresult of the encoding.
extern "C" int msid_resblock_v2_forward(const void* x, const void* w1t,
                                        const void* w2t, const void* aff, void* out,
                                        int B, int H, int W, int C, int TH, int TW,
                                        void* stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  if (TH < 1 || TW < 1 || TH > 252 || TW > 252 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 48:
      return launch<48>(encode, x, w1t, w2t, aff, out, B, H, W, TH, TW, s);
    case 96:
      return launch<96>(encode, x, w1t, w2t, aff, out, B, H, W, TH, TW, s);
    case 192:
      return launch<192>(encode, x, w1t, w2t, aff, out, B, H, W, TH, TW, s);
    case 384:
      return launch<384>(encode, x, w1t, w2t, aff, out, B, H, W, TH, TW, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
