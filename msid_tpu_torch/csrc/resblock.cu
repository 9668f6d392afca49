// Fused eval-mode decoder ResidualBlock for Hopper (sm_90a), NHWC bf16, on
// wgmma with the weights staged by TMA: K1 and K3.
//
// K1 (`resblock_kernel`, entry `msid_resblock_forward`) replaces the TPU
// kernel `fused_residual_block_v3` (`_resblock_kernel_v3`), K3
// (`resblock_v2_kernel`, entry `msid_resblock_v2_forward`) the TPU kernel
// `fused_residual_block_v2` (`_resblock_kernel_v2`), both of
// msid_tpu/ops/pallas_decoder.py. Both compute, for x [B,H,W,C] bf16,
// 3x3 weights w1, w2 bf16 and the folded BN affine aff = (a1, b1, a2, b2)
// [4,C] fp32:
//
//   h = gelu_tanh(conv3x3(x, w1) * a1 + b1)   (fp32 accumulation)
//   h = 0 outside the image; h rounded to bf16
//   y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + float(x))  -> bf16
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): one block
// is 2 * 2 * 9 * C^2 * H * W operations, 3.06 GFLOP per 192x192 tile at
// every decoder stage (C=384@24^2 ... C=48@192^2), ~3.1 us a tile on the
// tensor cores, against one read of x and one write of y (~0.3 to ~2.1 us
// a tile). So it is bound by operations, and only wgmma reaches the
// card's rate for them.
//
// Design (the device code is in hopper_common.cuh):
//   * one cluster of G CTAs per (sample, TH x TW output tile); CTA r owns
//     N = CP / G output channels from r * N (CP the build's padded width). A CTA is two warpgroups (256
//     threads, one CTA a SM, up to 255 registers a thread). Tile and G
//     come from the caller (ops/cuda_decoder.py: bf16_tiling);
//   * the CTA's first thread loads the (TH+4) x (TW+4) x C window of x
//     by TMA straight from the NHWC tensor, in channel chunks under the
//     tensor map's swizzle with zero fill outside the image, and then
//     keeps a ring of weight tiles in flight: for every (tap, 64 input
//     channels) one TMA box [N output channels][64 input channels] of the
//     K-major weights (128-byte rows, 128-byte swizzle), with a full and an
//     empty mbarrier per stage. Every weight byte is read once per CTA and
//     pass;
//   * each conv is an implicit GEMM (pixels x N, K = 9C) of
//     wgmma.mma_async m64nNWk16 with fp32 accumulators: B is the staged
//     weight tile by descriptor; A comes from registers, each warp
//     loading its 16 rows' fragments from the swizzled window (conv1) or
//     from h (conv2), so the nine shifted tap views are a matter of
//     addresses. The two warpgroups take different 64-pixel tiles of the
//     region, or (NSPLIT) the two halves of N for the same tiles where a
//     region has few tiles; a warpgroup keeps up to MW tiles' accumulators
//     and a region with more takes several passes over the weights. One
//     wgmma group stays in flight: while a step's wgmmas run, the step
//     before is waited for, its stage released, and the next step's
//     fragments are loaded into the registers it read;
//   * conv1's epilogue applies the affine and GELU, zeroes h outside the
//     image, rounds to bf16 and writes this CTA's N channels of h to its
//     shared memory only. After a cluster barrier conv2 reads every
//     channel of h from the CTA that owns it (distributed shared memory),
//     adds the residual from the window in fp32 and writes bf16.
// The rounding points are the TPU kernel's; the order of the fp32 sums is
// the tensor core's.
//
// K3 is the TPU's other tiling of the same block, and on Hopper the two
// become one: the TPU kernel v2 pads x in device memory and stitches each
// (rows, cols) tile's 2-pixel halo from four blocks (Pallas blocks may not
// overlap), then runs nine tap GEMMs of depth C, tap-major. Here the TMA
// window load reads the overlapping halo straight from the NHWC tensor with
// zero fill, and the nine taps are the nine shifted views above. What stays
// K3's is its own kernel and that the output tile (row_block, col_block) is
// the caller's, a launch parameter (the TPU's (16, 96) does not fit a CTA's
// 227 KB; K1's tile comes from a cost model). Ragged edges and a ragged last
// m64 tile are masked, so the result does not depend on the tile.
//
// Widths. A library is built for one padded width CP (-DMSID_C=<CP>: 16,
// 32, 48, 64, 96, 128, 192, 256, 384, 512 or 768) and takes every true
// width C with 8 <= C <= CP at run time (ops/cuda_decoder.py: bf16_padded
// sends C to the least CP that holds it, so 11 builds cover 8..768). The
// window holds CP channels, zeros past C; a weight tile's rows past C and
// h's channels past C are zeros; the affine is read and y written below C
// only, one element at a time where C is odd. Where C is no multiple of 8
// the NHWC tensor has a pixel stride a tensor map cannot take (C = 12: 24
// bytes), and the CTA's 256 threads load the window with plain 2-byte
// loads instead (a few microseconds at the narrow widths where it happens;
// no copy of x is made). At C = 768 a cluster of 8 CTAs owns 96 channels
// each and the whole 768-channel window sits in every CTA's shared memory.
//
// The wide builds (256, 384, 512, 768) run K1 on another CTA body
// (resblock_stream_cta in hopper_common.cuh): a window that holds every
// channel leaves a C = 768 CTA room for a 6 x 8 tile and a 2-stage ring
// only, so there both convs stream their source through two 64-channel
// slots (the window's multicast across the cluster by TMA, h's copied from
// the CTAs that own it), A comes from the slot by descriptor, and a third
// warpgroup produces every copy. K3 keeps the resident window at every
// build.
//
// C = 48 has no 128-byte k-tile of its own (48 bf16 = 96 bytes). Two ways:
// 16-channel boxes under the 32-byte swizzle (3 k16 steps, no padding), or
// zero padding of the weights to 64 columns. Both kernels take the padding:
// the B tile keeps the 128-byte swizzle and the descriptor the card checks
// verified; only 3 k16 steps run, so no tensor-core work is wasted; the cost
// is 16 zero columns of every staged weight tile (6 KB a tap instead of 4.5,
// read from L2), which a 32-byte-swizzle descriptor would save.
//
// The host side (launch.cuh) costs a launch little, and every launch can
// be captured into a CUDA graph: the two weight maps are encoded once per
// prepared operand and cluster size and kept by the caller beside the
// operand (msid_resblock_weight_map), x's map comes from a bounded table
// keyed by every argument of its encoding, and the shared-memory limit of
// each kernel is set once.
#include "hopper_common.cuh"

#ifndef MSID_C
#error "build with -DMSID_C=<padded width>: 16, 32, 48, 64, 96, 128, 192, 256, 384, 512 or 768"
#endif

namespace {

// K1: the streamed body at the wide builds' variants (TAPS weight tiles a
// stage, 384 threads: a producer warpgroup beside the two of wgmma), the
// resident window at the others (TAPS 0).
template <int CP, int NW, int MW, bool NSPLIT, int TAPS>
__global__ void __launch_bounds__(TAPS > 0 ? kStreamThreads : kThreads, 1)
    resblock_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                    const float* __restrict__ aff, bf16* __restrict__ out, int H, int W,
                    int C, int TH, int TW, int stages) {
  if constexpr (TAPS > 0)
    resblock_stream_cta<CP, NW, MW, NSPLIT, TAPS>(&xmap, &w1map, &w2map, x, aff, out, H, W,
                                                  C, TH, TW, stages);
  else
    resblock_cta<CP, NW, MW, NSPLIT>(&xmap, &w1map, &w2map, x, aff, out, H, W, C, TH, TW,
                                     stages);
}

// K3: the resident window at every build.
template <int CP, int NW, int MW, bool NSPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_v2_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap w1map,
                       const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                       const float* __restrict__ aff, bf16* __restrict__ out, int H, int W,
                       int C, int TH, int TW, int stages) {
  resblock_cta<CP, NW, MW, NSPLIT>(&xmap, &w1map, &w2map, x, aff, out, H, W, C, TH, TW,
                                   stages);
}

// The instantiations of this build, by cluster size G: K1's (G, NW, MW,
// NSPLIT, TAPS) as ops/cuda_decoder.py's BF16_VARIANTS lists them (TAPS 0:
// the resident window; 1 or 3: the streamed body), K3's (G, NW, MW,
// NSPLIT) as its V2_VARIANTS does. Below 256 the two are one.
#if MSID_C == 16
#define MSID_VARIANTS(K1, K3) K1(1, 16, 4, false, 0) K3(1, 16, 4, false)
#elif MSID_C == 32
#define MSID_VARIANTS(K1, K3) K1(1, 32, 4, false, 0) K3(1, 32, 4, false)
#elif MSID_C == 48
#define MSID_VARIANTS(K1, K3) K1(1, 48, 4, false, 0) K3(1, 48, 4, false)
#elif MSID_C == 64
#define MSID_VARIANTS(K1, K3) K1(1, 64, 2, false, 0) K3(1, 64, 2, false)
#elif MSID_C == 96
#define MSID_VARIANTS(K1, K3) K1(1, 96, 2, false, 0) K3(1, 96, 2, false)
#elif MSID_C == 128
#define MSID_VARIANTS(K1, K3)                                           \
  K1(1, 64, 2, true, 0) K1(2, 64, 2, false, 0) K3(1, 64, 2, true) \
  K3(2, 64, 2, false)
#elif MSID_C == 192
#define MSID_VARIANTS(K1, K3)                                           \
  K1(1, 96, 2, true, 0) K1(2, 96, 2, false, 0) K3(1, 96, 2, true) \
  K3(2, 96, 2, false)
#elif MSID_C == 256
#define MSID_VARIANTS(K1, K3)                                         \
  K1(2, 64, 2, true, 3) K1(4, 64, 2, false, 3) K3(2, 64, 2, true) \
  K3(4, 64, 2, false)
#elif MSID_C == 384
#define MSID_VARIANTS(K1, K3)                                         \
  K1(2, 96, 2, true, 1) K1(4, 96, 2, false, 3) K3(2, 96, 2, true) \
  K3(4, 48, 4, true)
#elif MSID_C == 512
#define MSID_VARIANTS(K1, K3)                                         \
  K1(4, 64, 2, true, 3) K1(8, 64, 2, false, 3) K3(4, 64, 2, true) \
  K3(8, 32, 4, true)
#elif MSID_C == 768
#define MSID_VARIANTS(K1, K3) K1(8, 96, 2, false, 3) K3(8, 48, 2, true)
#else
#error "MSID_C must be 16, 32, 48, 64, 96, 128, 192, 256, 384, 512 or 768"
#endif

#define MSID_NONE(...)
#define MSID_K1(G, NW, MW, NSPLIT, TAPS)                                                  \
  case G:                                                                                \
    return launch_resblock<MSID_C, NW, MW, NSPLIT, TAPS>(                                \
        &resblock_kernel<MSID_C, NW, MW, NSPLIT, TAPS>, x, w1map, w2map, aff, out, B, H, W, \
        C, TH, TW, stages, s);
#define MSID_K3(G, NW, MW, NSPLIT)                                                          \
  case G:                                                                                  \
    return launch_resblock<MSID_C, NW, MW, NSPLIT>(&resblock_v2_kernel<MSID_C, NW, MW, NSPLIT>, \
                                                   x, w1map, w2map, aff, out, B, H, W, C, TH,  \
                                                   TW, stages, s);

// K1 (V2 false) or K3 (V2 true) at cluster size G.
template <bool V2>
int forward(const void* x, const void* w1map, const void* w2map, const void* aff, void* out,
            int B, int H, int W, int C, int TH, int TW, int G, int stages, void* stream) {
  if (TH < 1 || TW < 1 || TH > 252 || TW > 252 || B < 1 || B > 65535 || stages < 2 ||
      stages > kMaxStages || C < 8 || C > MSID_C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (V2) {
    switch (G) {
      MSID_VARIANTS(MSID_NONE, MSID_K3)
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (G) {
      MSID_VARIANTS(MSID_K1, MSID_NONE)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

#undef MSID_K1
#undef MSID_K3
#undef MSID_NONE
#undef MSID_VARIANTS

}  // namespace

// The tensor map K1 and K3 read the K-major weights wk ([9 * MSID_C][KP]
// bf16, row tap * MSID_C + output channel, column input channel, KP =
// MSID_C rounded up to a multiple of 64, zeros at every channel past the
// true width C; ops/cuda_decoder.py: prepare_bf16_weights) through, for
// clusters of G CTAs (boxes of MSID_C / G rows): written to `map`
// (CUtensorMap's 128 bytes, any alignment). The caller encodes it once per
// operand and cluster size and keeps it. Returns 0, cudaErrorInvalidValue,
// or 100000 + the CUresult of the encoding.
extern "C" int msid_resblock_weight_map(const void* wk, int C, int G, void* map) {
  if (C < 8 || C > MSID_C || G < 1 || G > 8 || MSID_C % G != 0 || MSID_C / G > 256 ||
      (MSID_C / G) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap encoded;
  const CUresult res =
      weight_map(&encoded, wk, MSID_C, (MSID_C + kBK - 1) / kBK * kBK, MSID_C / G);
  if (res != CUDA_SUCCESS) return 100000 + (int)res;
  memcpy(map, &encoded, sizeof(CUtensorMap));
  return 0;
}

// x, out: [B,H,W,C] bf16 contiguous, 16-byte aligned; w1map, w2map: the
// weight maps msid_resblock_weight_map wrote for this C and G; aff: [4][C]
// fp32. 8 <= C <= MSID_C. (TH, TW) is the output tile of one cluster of G
// CTAs (each at most 252), `stages` (2..4) the depth of the weight ring; the
// caller chooses them (K1: bf16_tiling; K3: v2_tile, around the caller's
// tile; the streamed body's geometry holds its own layout, stream_smem_bytes).
// Supported (MSID_C, G): (16, 1), (32, 1), (48, 1), (64, 1), (96, 1),
// (128, 1|2), (192, 1|2), (256, 2|4), (384, 2|4), (512, 4|8), (768, 8); a
// library holds one padded width's kernels (the builds compile side by
// side). Returns 0, the cudaError_t of the launch (cudaErrorInvalidValue
// for a geometry the kernel is not built for or that does not fit shared
// memory), or 100000 + the CUresult of x's encoding (CUDA_ERROR_NOT_FOUND
// when libcuda exports no cuTensorMapEncodeTiled).
extern "C" int msid_resblock_forward(const void* x, const void* w1map, const void* w2map,
                                     const void* aff, void* out, int B, int H, int W,
                                     int C, int TH, int TW, int G, int stages,
                                     void* stream) {
  return forward<false>(x, w1map, w2map, aff, out, B, H, W, C, TH, TW, G, stages, stream);
}

// K3: the same arguments and geometries.
extern "C" int msid_resblock_v2_forward(const void* x, const void* w1map, const void* w2map,
                                        const void* aff, void* out, int B, int H, int W,
                                        int C, int TH, int TW, int G, int stages,
                                        void* stream) {
  return forward<true>(x, w1map, w2map, aff, out, B, H, W, C, TH, TW, G, stages, stream);
}
