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
//     N = C / G output channels from r * N. A CTA is two warpgroups (256
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
// C = 48 has no 128-byte k-tile of its own (48 bf16 = 96 bytes). Two ways:
// 16-channel boxes under the 32-byte swizzle (3 k16 steps, no padding), or
// zero padding of the weights to 64 columns. Both kernels take the padding:
// the B tile keeps the 128-byte swizzle and the descriptor the card checks
// verified; only 3 k16 steps run, so no tensor-core work is wasted; the cost
// is 16 zero columns of every staged weight tile (6 KB a tap instead of 4.5,
// read from L2), which a 32-byte-swizzle descriptor would save.
#include "hopper_common.cuh"

namespace {

template <int C, int NW, int MW, bool NSPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap w2map,
                    const float* __restrict__ aff, bf16* __restrict__ out, int H, int W,
                    int TH, int TW, int stages) {
  resblock_cta<C, NW, MW, NSPLIT>(&xmap, &w1map, &w2map, aff, out, H, W, TH, TW, stages);
}

template <int C, int NW, int MW, bool NSPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_v2_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap w1map,
                       const __grid_constant__ CUtensorMap w2map,
                       const float* __restrict__ aff, bf16* __restrict__ out, int H, int W,
                       int TH, int TW, int stages) {
  resblock_cta<C, NW, MW, NSPLIT>(&xmap, &w1map, &w2map, aff, out, H, W, TH, TW, stages);
}

// K1 (V2 false) or K3 (V2 true) of one instantiation.
template <bool V2, int C, int NW, int MW, bool NSPLIT>
int launch(EncodeTiledFn encode, const void* x, const void* w1k, const void* w2k,
           const void* aff, void* out, int B, int H, int W, int TH, int TW, int stages,
           cudaStream_t stream) {
  return launch_resblock<C, NW, MW, NSPLIT>(
      V2 ? &resblock_v2_kernel<C, NW, MW, NSPLIT> : &resblock_kernel<C, NW, MW, NSPLIT>,
      encode, x, w1k, w2k, aff, out, B, H, W, TH, TW, stages, stream);
}

template <bool V2>
int forward(const void* x, const void* w1k, const void* w2k, const void* aff, void* out,
            int B, int H, int W, int C, int TH, int TW, int G, int stages, void* stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  if (TH < 1 || TW < 1 || TH > 252 || TW > 252 || B < 1 || B > 65535 || stages < 2 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C * 10 + G) {
#if !defined(MSID_C) || MSID_C == 48
    case 481:
      return launch<V2, 48, 48, 4, false>(encode, x, w1k, w2k, aff, out, B, H, W, TH, TW,
                                          stages, s);
#endif
#if !defined(MSID_C) || MSID_C == 96
    case 961:
      return launch<V2, 96, 96, 2, false>(encode, x, w1k, w2k, aff, out, B, H, W, TH, TW,
                                          stages, s);
#endif
#if !defined(MSID_C) || MSID_C == 192
    case 1921:
      return launch<V2, 192, 96, 2, true>(encode, x, w1k, w2k, aff, out, B, H, W, TH, TW,
                                          stages, s);
    case 1922:
      return launch<V2, 192, 96, 2, false>(encode, x, w1k, w2k, aff, out, B, H, W, TH, TW,
                                           stages, s);
#endif
#if !defined(MSID_C) || MSID_C == 384
    case 3842:
      return launch<V2, 384, 96, 2, true>(encode, x, w1k, w2k, aff, out, B, H, W, TH, TW,
                                          stages, s);
    case 3844:
      return launch<V2, 384, 48, 4, true>(encode, x, w1k, w2k, aff, out, B, H, W, TH, TW,
                                          stages, s);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [B,H,W,C] bf16 contiguous, 16-byte aligned; w1k, w2k: K-major
// weights [9 * C][CP] bf16, row tap * C + output channel, column input
// channel, CP = C rounded up to a multiple of 64 with zeros past C (the
// caller prepares them once: ops/cuda_decoder.py: prepare_bf16_weights);
// aff: [4][C] fp32. (TH, TW) is the output tile of one cluster of G CTAs
// (each at most 252), `stages` (2..4) the depth of the weight ring; the
// caller chooses them (K1: bf16_tiling; K3: v2_tile, around the caller's
// tile). Supported (C, G): (48, 1), (96, 1), (192, 1), (192, 2), (384, 2),
// (384, 4); a build with -DMSID_C=<width> holds that width's kernels only
// (one library per width compiles in a quarter of the time, and the four
// compile side by side). Returns 0, the cudaError_t of the launch
// (cudaErrorInvalidValue for a geometry the kernel is not built for or that
// does not fit shared memory), -1 when libcuda exports no
// cuTensorMapEncodeTiled, or 100000 + the CUresult of an encoding.
extern "C" int msid_resblock_forward(const void* x, const void* w1k, const void* w2k,
                                     const void* aff, void* out, int B, int H, int W,
                                     int C, int TH, int TW, int G, int stages,
                                     void* stream) {
  return forward<false>(x, w1k, w2k, aff, out, B, H, W, C, TH, TW, G, stages, stream);
}

// K3: the same arguments and geometries.
extern "C" int msid_resblock_v2_forward(const void* x, const void* w1k, const void* w2k,
                                        const void* aff, void* out, int B, int H, int W,
                                        int C, int TH, int TW, int G, int stages,
                                        void* stream) {
  return forward<true>(x, w1k, w2k, aff, out, B, H, W, C, TH, TW, G, stages, stream);
}
