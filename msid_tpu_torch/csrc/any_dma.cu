// Asynchronous-copy probe for Hopper (sm_90a): out = x * 2 through a TMA
// load into shared memory completed on an mbarrier.
//
// Replaces the TPU probe kernel of benchmarks/pallas_probe.py (the inner
// `kernel` of the `any_dma` variant): an ANY-space [rows, W, C] fp32 ref is
// copied into scratch by `pltpu.make_async_copy` under a DMA semaphore,
// then `out = scratch * 2`. There the whole array fits the scratch memory.
// Here [8, 192, 48] fp32 is 295 KB, more than a CTA's shared memory, so x
// is viewed as [rows, n = W*C] and the grid runs over boxes of at most
// 32 rows x 256 columns (32 KB; 256 elements is the widest box a tensor
// map takes). Each CTA:
//   * one thread arms an mbarrier with the box's byte count
//     (mbarrier.arrive.expect_tx) and issues one cp.async.bulk.tensor.2d
//     load through a tensor map over x; whatever part of the box lies past
//     the array's edge is filled with zeros by the copy engine;
//   * all threads wait on the barrier's phase, then scale from shared
//     memory and store 16 bytes a thread, masked at the ragged edge.
// It is the toolchain gate for the halo window load of resblock.cu (K3),
// as the TPU probe was for the halo-window-by-DMA design: tensor map
// from cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint,
// nothing links libcuda), __grid_constant__ descriptor, mbarrier wait.
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes, one read and one write of
// the array: 2 * rows * n * 4 bytes. Several 32 KB CTAs share an SM, so
// one CTA's load overlaps another's stores; there is no pipeline inside a
// CTA (first version).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBoxCols = 256;   // a tensor map's box extent is at most 256
constexpr int kBoxRows = 32;
constexpr uint32_t kMaxSpins = 1u << 22;   // a lost copy traps instead of hanging

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
    any_dma_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out,
                   int rows, int n, int box_rows, int box_cols) {
  extern __shared__ unsigned char smem_raw[];
  // A TMA destination is 128-byte aligned.
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  float* tile = reinterpret_cast<float*>(smem);
  const uint32_t box_bytes = (uint32_t)box_rows * box_cols * sizeof(float);
  const uint32_t bar = smem_u32(smem + box_bytes);

  const int col0 = blockIdx.x * box_cols;
  const int row0 = blockIdx.y * box_rows;
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, box_bytes);
    tma_load_2d(smem_u32(tile), &map, bar, col0, row0);
  }
  mbar_wait(bar, 0);

  const int vecs = box_cols / 4;
  for (int idx = threadIdx.x; idx < box_rows * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int v = idx - r * vecs;
    const int gr = row0 + r;
    const int gc = col0 + v * 4;
    if (gr >= rows || gc >= n) continue;   // n is a multiple of 4
    float4 a = reinterpret_cast<const float4*>(tile)[idx];
    a.x *= 2.0f;
    a.y *= 2.0f;
    a.z *= 2.0f;
    a.w *= 2.0f;
    *reinterpret_cast<float4*>(out + (size_t)gr * n + gc) = a;
  }
}

}  // namespace

// x, out: [rows, n] fp32 contiguous, 16-byte aligned, n a multiple of 4.
// Returns 0, the cudaError_t of the launch, -1 when libcuda exports no
// cuTensorMapEncodeTiled, or 100000 + the CUresult of the encoding.
extern "C" int msid_any_dma_scale(const void* x, void* out, int rows, int n,
                                  void* stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  const int box_cols = n < kBoxCols ? n : kBoxCols;
  const int box_rows = rows < kBoxRows ? rows : kBoxRows;
  const long long grid_y = ((long long)rows + box_rows - 1) / box_rows;
  if (rows < 1 || n < 4 || n % 4 != 0 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;

  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 100000 + (int)res;

  const size_t smem = (size_t)box_rows * box_cols * sizeof(float) + 8 + 128;
  const dim3 grid((n + box_cols - 1) / box_cols, (unsigned)grid_y);
  any_dma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(out), rows, n, box_rows, box_cols);
  return (int)cudaGetLastError();
}
