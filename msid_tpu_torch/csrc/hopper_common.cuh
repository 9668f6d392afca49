// Device code of the two bf16 fused ResidualBlock kernels for Hopper
// (sm_90a), both in resblock.cu: K1 (the port of `fused_residual_block_v3`)
// and K3 (the port of `fused_residual_block_v2`). Both compute,
// for x [B,H,W,C] bf16, K-major weights w1k, w2k and the folded BN affine
// aff = (a1, b1, a2, b2) [4,C] fp32:
//
//   h = gelu_tanh(conv3x3(x, w1) * a1 + b1)   (fp32 accumulation)
//   h = 0 outside the image; h rounded to bf16
//   y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + float(x))  -> bf16
//
// with one design, described in resblock.cu: per (sample, output tile) a
// cluster of G CTAs over the output channels; the (TH+4) x (TW+4) x C
// window by TMA in swizzled channel chunks; the weights through a TMA ring
// of [N][64] K-major tiles (full and empty mbarriers, the CTA's first
// thread the producer); each conv nine tap GEMMs of depth C on
// wgmma.mma_async m64nNk16, A from registers (the window or h, so a tap
// shift is address arithmetic), B by descriptor; h in shared memory, read
// across the cluster through distributed shared memory. Each source
// includes this file and defines its own __global__ function around
// resblock_cta and its own C entry point; what is here builds into each
// library, inside an anonymous namespace.
#pragma once
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;               // two warpgroups
constexpr int kBK = 64;                     // input channels of a weight tile
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;
constexpr uint32_t kMaxSpins = 1u << 24;    // a lost copy traps instead of hanging

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

// tanh.approx (one MUFU op, ~2^-11 relative): the result is rounded to
// bf16's 8 bits.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(k0 * (v + k1 * v * v * v)));
  return 0.5f * v * (1.0f + th);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
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

// Box (col.., row..) of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An empty statement that reads and writes every register of an
// accumulator tile: the compiler may move nothing that touches them across
// it. wgmma.mma_async writes its accumulators after the statement that
// issued it has returned, so without this the epilogue's reads (or the
// next pass's zeroing) may be scheduled before wgmma.wait_group.
template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// Descriptor of a K-major operand tile whose rows are 128 bytes (64 bf16)
// under the 128-byte swizzle, 8-row groups 1024 bytes apart: start address,
// leading byte offset 16 (unused by this layout), stride byte offset 1024,
// layout type B128. A k16 step inside the row advances the start by 32
// bytes.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d += a (registers, 64 x 16) * b (shared memory by descriptor, 16 x N).
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Element offset of (pixel p, channel co) in the swizzled window.
template <int C>
__device__ __forceinline__ int window_offset(int p, int co, int chunk_elems) {
  using K = Chunk<C>;
  const int q = co / K::CK;
  const int e = co - q * K::CK;
  return q * chunk_elems + p * K::CK +
         ((((e >> 3) ^ ((p >> K::SH) & K::MASK))) << 3) + (e & 7);
}

// Bytes of one window chunk in shared memory: each starts on a 1024-byte
// boundary, the period of the widest swizzle.
__host__ __device__ inline int chunk_bytes(int th, int tw, int ck) {
  return ((th + 4) * (tw + 4) * ck * 2 + 1023) & ~1023;
}

// Bytes of h in shared memory: (TH+2)(TW+2) pixels at a pitch of N + 8.
__host__ __device__ inline int h_bytes(int th, int tw, int n) {
  return ((th + 2) * (tw + 2) * (n + 8) * 2 + 15) & ~15;
}

// How a region's m64 tiles are dealt: each warpgroup takes `share` tiles
// from `first` (both take all of them under NSPLIT) in `passes` passes of
// at most MW tiles.
struct Deal {
  int tiles, share, passes;
  __device__ Deal(int m, int mw, bool nsplit) {
    tiles = (m + 63) / 64;
    share = nsplit ? tiles : (tiles + 1) / 2;
    passes = (share + mw - 1) / mw;
  }
};

// One pass of one conv for one warpgroup: acc[i] += the 3x3 conv for its MT
// m64 tiles from tile `first` (region `out_w` wide, `m` pixels) over all
// nine taps and C input channels, walking the weight ring from step `it`
// on. Source pixel (r + ky, c + kx) of a tile `src_w` pixels wide is tap
// (ky, kx) of region pixel (r, c). FROM_WINDOW: the source is the swizzled,
// chunked x window `xs`; otherwise h, whose channel k lies in the CTA k / N
// of the cluster at pitch N + 8.
//
// MT and the k16 steps of every weight tile are compile-time (where the
// tiles of a tap differ in them, the tap's tiles are unrolled): a wgmma
// under a run-time condition makes the compiler serialize every wgmma of
// the kernel.
template <int C, int N, int NW, int MW, int MT, bool FROM_WINDOW, typename Produce>
__device__ __forceinline__ void conv_tiles(Produce& produce, const bf16* xs,
                                           int chunk_elems, bf16* hs,
                                           cg::cluster_group& cluster, int src_w,
                                           int out_w, int m, int first, uint32_t ring,
                                           uint32_t full, uint32_t empty, int stages,
                                           int& it, int nb, float (&acc)[MW][NW / 2]) {
  using K = Chunk<C>;
  constexpr int HP = N + 8;
  constexpr int KQ = (C + kBK - 1) / kBK;
  constexpr int KS = kBK / 16;
  // Every weight tile has the same k16 steps unless C is no multiple of 64
  // and spans several tiles (C = 96: 4 steps, then 2).
  constexpr bool UNIFORM = C % kBK == 0 || KQ == 1;
  constexpr int KSU = (C < kBK ? C : kBK) / 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = (threadIdx.x >> 5) & 3;     // warp within its warpgroup

  int pix[MT > 0 ? MT : 1][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = (first + i) * 64 + wq * 16 + g + h * 8;
      if (p >= m) p = 0;   // padding row: computed, never stored
      const int r = p / out_w;
      pix[i][h] = r * src_w + (p - r * out_w);
    }
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[i][e] = 0.0f;
    fence_accumulators(acc[i]);
  }

  // A fragments of weight tile kq of tap `tap`: this warp's 16 rows of each
  // m64 tile, for the tile's k16 steps.
  auto load_a = [&](uint32_t (&a)[MW][KS][4], int tap, int kq) {
    const int ky = tap / 3;
    const int shift = ky * src_w + tap - 3 * ky;
    const int ks = UNIFORM ? KSU : min(kBK, C - kq * kBK) / 16;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int p0 = pix[i][0] + shift;
      const int p1 = pix[i][1] + shift;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < ks) {
          const int kch = kq * kBK + kk * 16;
          if (FROM_WINDOW) {
            const int q = kch / K::CK;
            const int u = (kch - q * K::CK) >> 3;
            const bf16* chunk = xs + q * chunk_elems + 2 * t;
            const int s0 = (p0 >> K::SH) & K::MASK;
            const int s1 = (p1 >> K::SH) & K::MASK;
            a[i][kk][0] = ld32(chunk + p0 * K::CK + ((u ^ s0) << 3));
            a[i][kk][1] = ld32(chunk + p1 * K::CK + ((u ^ s1) << 3));
            a[i][kk][2] = ld32(chunk + p0 * K::CK + (((u + 1) ^ s0) << 3));
            a[i][kk][3] = ld32(chunk + p1 * K::CK + (((u + 1) ^ s1) << 3));
          } else {
            const int owner = kch / N;
            const bf16* hp = (N == C ? hs : cluster.map_shared_rank(hs, owner)) +
                             (kch - owner * N) + 2 * t;
            a[i][kk][0] = ld32(hp + p0 * HP);
            a[i][kk][1] = ld32(hp + p1 * HP);
            a[i][kk][2] = ld32(hp + p0 * HP + 8);
            a[i][kk][3] = ld32(hp + p1 * HP + 8);
          }
        }
      }
    }
  };
  // Release the stage of step it - 1 (its wgmmas are done) and have the
  // producer refill it with the tile `stages` steps on.
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % stages));
    if (threadIdx.x == 0) produce(it - 1 + stages);
    __syncwarp();
  };
  // One step: the wgmmas of `cur` on the staged weight tile (tap, kq). While
  // they run, the previous step's group is waited for, its stage released,
  // and the next step's fragments loaded into `nxt` (the buffer the
  // previous step read).
  bool fresh = true;     // no wgmma of this pass is in flight yet
  auto step = [&](uint32_t (&cur)[MW][KS][4], uint32_t (&nxt)[MW][KS][4], int tap,
                  int kq) {
    const int ks = UNIFORM ? KSU : min(kBK, C - kq * kBK) / 16;
    const int s = it % stages;
    mbar_wait(full + 8 * s, (it / stages) & 1);
    const uint32_t tile = ring + s * (N * 128) + nb * 128;
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        if (kk < ks) Wgmma<NW>::mma(acc[i], cur[i][kk], b_descriptor(tile + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
    if (!fresh) release();
    fresh = false;
    ++it;
    if (kq + 1 < KQ) {
      load_a(nxt, tap, kq + 1);
    } else if (tap < 8) {
      load_a(nxt, tap + 1, 0);
    }
  };

  uint32_t a0[MW][KS][4], a1[MW][KS][4];
  load_a(a0, 0, 0);
  if constexpr (UNIFORM) {
    // Two steps a turn, so that the fragment buffers alternate at compile time.
    int tap = 0, kq = 0;
    auto advance = [&]() {
      if (++kq == KQ) {
        kq = 0;
        ++tap;
      }
    };
#pragma unroll 1
    for (int st = 0; st + 1 < 9 * KQ; st += 2) {
      step(a0, a1, tap, kq);
      advance();
      step(a1, a0, tap, kq);
      advance();
    }
    if ((9 * KQ) & 1) step(a0, a1, tap, kq);
  } else {
    // The KQ tiles of a tap unrolled (their k16 steps differ), two taps a
    // turn so that the fragment buffers alternate at compile time.
#pragma unroll 1
    for (int tap = 0; tap < 8; tap += 2) {
#pragma unroll
      for (int u = 0; u < 2 * KQ; ++u) {
        if (u & 1) {
          step(a1, a0, tap + u / KQ, u % KQ);
        } else {
          step(a0, a1, tap + u / KQ, u % KQ);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KQ; ++u) {
      if (u & 1) {
        step(a1, a0, 8, u);
      } else {
        step(a0, a1, 8, u);
      }
    }
  }
  // Drain: the last step's wgmmas, then its stage.
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_accumulators(acc[i]);
  release();
}

// The same for a warpgroup that holds `mt` (0..MW) tiles in this pass.
template <int C, int N, int NW, int MW, bool FROM_WINDOW, typename Produce>
__device__ __forceinline__ void conv_pass(Produce& produce, const bf16* xs,
                                          int chunk_elems, bf16* hs,
                                          cg::cluster_group& cluster, int src_w,
                                          int out_w, int m, int first, int mt,
                                          uint32_t ring, uint32_t full, uint32_t empty,
                                          int stages, int& it, int nb,
                                          float (&acc)[MW][NW / 2]) {
#define MSID_CONV_TILES(MT)                                                              \
  conv_tiles<C, N, NW, MW, MT, FROM_WINDOW>(produce, xs, chunk_elems, hs, cluster, src_w, \
                                            out_w, m, first, ring, full, empty, stages,  \
                                            it, nb, acc)
  // A switch: nvcc 12.8 compiled an if-else chain over these same calls to
  // the wrong instantiation (caught on the card at C=96, two passes).
  switch (mt) {
    case 4: MSID_CONV_TILES((MW >= 4 ? 4 : MW)); break;
    case 3: MSID_CONV_TILES((MW >= 3 ? 3 : MW)); break;
    case 2: MSID_CONV_TILES((MW >= 2 ? 2 : MW)); break;
    case 1: MSID_CONV_TILES(1); break;
    default: MSID_CONV_TILES(0); break;
  }
#undef MSID_CONV_TILES
}

// The block for one CTA of a cluster: the body of both kernels' __global__
// functions, which pass their __grid_constant__ tensor maps by address.
template <int C, int NW, int MW, bool NSPLIT>
__device__ __forceinline__ void resblock_cta(const CUtensorMap* xmap, const CUtensorMap* w1map,
                                             const CUtensorMap* w2map,
                                             const float* __restrict__ aff,
                                             bf16* __restrict__ out, int H, int W, int TH,
                                             int TW, int stages) {
  using K = Chunk<C>;
  constexpr int N = NSPLIT ? 2 * NW : NW;   // this CTA's output channels
  constexpr int G = C / N;
  static_assert(C % N == 0 && N % 16 == 0, "N must divide C in k16 steps");
  constexpr int HP = N + 8;
  constexpr int NQ = C / K::CK;
  constexpr int KQ = (C + kBK - 1) / kBK;
  const int XH = TH + 4, XW = TW + 4;   // x halo window
  const int HW = TW + 2;                // h tile width
  const int M1 = (TH + 2) * HW;
  const int M2 = TH * TW;
  const int chunk_elems = chunk_bytes(TH, TW, K::CK) / 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring_ptr = smem + NQ * chunk_elems * 2;
  bf16* hs = reinterpret_cast<bf16*>(ring_ptr + stages * (N * 128));
  const uint32_t ring = smem_u32(ring_ptr);
  const uint32_t bars = smem_u32(reinterpret_cast<unsigned char*>(hs) + h_bytes(TH, TW, N));
  const uint32_t xbar = bars;
  const uint32_t full = bars + 8;
  const uint32_t empty = bars + 8 + 8 * kMaxStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cbase = rank * N;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = (blockIdx.x / G) * TW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const Deal d1(M1, MW, NSPLIT), d2(M2, MW, NSPLIT);

  // The producer is the CTA's first thread: it loads the window, and weight
  // tile j (in the order the consumers use them: conv1's passes, then
  // conv2's, each nine taps by KQ chunks) into stage j % stages once all
  // eight warps have released that stage's previous tile. The ring starts
  // full; after that a tile is asked for when its stage is released.
  const int tiles1 = d1.passes * 9 * KQ;
  const int tiles = tiles1 + d2.passes * 9 * KQ;
  auto produce = [&](int j) {
    if (j >= tiles) return;
    const int step = (j < tiles1 ? j : j - tiles1) % (9 * KQ);
    const int s = j % stages;
    mbar_wait(empty + 8 * s, ((j / stages) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, N * 128);
    tma_load_2d(ring + s * (N * 128), j < tiles1 ? w1map : w2map, full + 8 * s,
                (step % KQ) * kBK, (step / KQ) * C + cbase);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(xbar, (uint32_t)(XH * XW * C * 2));
    for (int q = 0; q < NQ; ++q)
      tma_load_4d(smem_u32(xs + q * chunk_elems), xmap, xbar, q * K::CK, x0 - 2, y0 - 2,
                  n);
    for (int j = 0; j < stages; ++j) produce(j);
  }
  __syncwarp();

  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nb = NSPLIT ? wg * NW : 0;      // this warpgroup's first column in the CTA
  float acc[MW][NW / 2];
  int it = 0;

  mbar_wait(xbar, 0);

  // conv1 -> this CTA's channels of h (shared memory only).
  for (int pass = 0; pass < d1.passes; ++pass) {
    const int first = (NSPLIT ? 0 : wg * d1.share) + pass * MW;
    const int end = NSPLIT ? d1.tiles : min(d1.tiles, (wg + 1) * d1.share);
    const int mt = max(0, min(MW, end - first));
    conv_pass<C, N, NW, MW, true>(produce, xs, chunk_elems, hs, cluster, XW, HW, M1, first, mt,
                                  ring, full, empty, stages, it, nb, acc);
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (first + i) * 64 + wq * 16 + g + h * 8;
        if (p >= M1) continue;
        const int r = p / HW;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + (p - r * HW);
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int col = nb + j * 8 + t * 2;
          const int co = cbase + col;
          float v0 = 0.0f, v1 = 0.0f;
          if (inside) {
            v0 = gelu_tanh(fmaf(acc[i][4 * j + 2 * h], __ldg(aff + co), __ldg(aff + C + co)));
            v1 = gelu_tanh(fmaf(acc[i][4 * j + 2 * h + 1], __ldg(aff + co + 1),
                                __ldg(aff + C + co + 1)));
          }
          *reinterpret_cast<__nv_bfloat162*>(hs + p * HP + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // Every CTA of the cluster has written its channels of h.
  cluster.sync();

  // conv2 + residual -> out.
  bf16* on = out + (size_t)n * H * W * C;
  for (int pass = 0; pass < d2.passes; ++pass) {
    const int first = (NSPLIT ? 0 : wg * d2.share) + pass * MW;
    const int end = NSPLIT ? d2.tiles : min(d2.tiles, (wg + 1) * d2.share);
    const int mt = max(0, min(MW, end - first));
    conv_pass<C, N, NW, MW, false>(produce, xs, chunk_elems, hs, cluster, HW, TW, M2, first, mt,
                                   ring, full, empty, stages, it, nb, acc);
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (first + i) * 64 + wq * 16 + g + h * 8;
        if (p >= M2) continue;
        const int r = p / TW;
        const int c = p - r * TW;
        const int gy = y0 + r;
        const int gx = x0 + c;
        if (gy >= H || gx >= W) continue;
        const int xp = (r + 2) * XW + c + 2;   // the same pixel in the window
        bf16* dst = on + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int co = cbase + nb + j * 8 + t * 2;
          const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(
              xs + window_offset<C>(xp, co, chunk_elems));
          const float v0 = fmaf(acc[i][4 * j + 2 * h], __ldg(aff + 2 * C + co),
                                __ldg(aff + 3 * C + co)) +
                           __bfloat162float(res.x);
          const float v1 = fmaf(acc[i][4 * j + 2 * h + 1], __ldg(aff + 2 * C + co + 1),
                                __ldg(aff + 3 * C + co + 1)) +
                           __bfloat162float(res.y);
          *reinterpret_cast<__nv_bfloat162*>(dst + co) =
              __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
        }
      }
    }
  }

  // Keep this CTA's h alive until every CTA of the cluster has read it.
  cluster.sync();
}
// The tensor map of K-major weights [9 * C rows (tap, output channel)]
// [CP columns (input channel, padded to a multiple of 64)], in boxes of
// [N rows][64 columns] under the 128-byte swizzle.
CUresult weight_map(EncodeTiledFn encode, CUtensorMap* map, const void* w, int C, int CP,
                    int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)CP, (cuuint64_t)9 * C};
  const cuuint64_t strides[1] = {(cuuint64_t)CP * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)N};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The __global__ function of one instantiation, as each kernel library
// defines it around resblock_cta.
typedef void (*ResblockKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                               const float*, bf16*, int, int, int, int, int);

// Encode the three tensor maps and launch `kernel` (an instantiation
// <C, NW, MW, NSPLIT> of resblock_cta) on clusters of G = C / N CTAs.
template <int C, int NW, int MW, bool NSPLIT>
int launch_resblock(ResblockKernel kernel, EncodeTiledFn encode, const void* x,
                    const void* w1k, const void* w2k, const void* aff, void* out, int B,
                    int H, int W, int TH, int TW, int stages, cudaStream_t stream) {
  using K = Chunk<C>;
  constexpr int N = NSPLIT ? 2 * NW : NW;
  constexpr int G = C / N;
  constexpr int NQ = C / K::CK;
  constexpr int CP = (C + kBK - 1) / kBK * kBK;
  const size_t smem = (size_t)NQ * chunk_bytes(TH, TW, K::CK) + (size_t)stages * N * 128 +
                      h_bytes(TH, TW, N) + 8 * (1 + 2 * kMaxStages) + 1024;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;

  CUtensorMap xmap, w1map, w2map;
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
  CUresult res = encode(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res == CUDA_SUCCESS) res = weight_map(encode, &w1map, w1k, C, CP, N);
  if (res == CUDA_SUCCESS) res = weight_map(encode, &w2map, w2k, C, CP, N);
  if (res != CUDA_SUCCESS) return 100000 + (int)res;

  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, w1map, w2map,
                           static_cast<const float*>(aff), static_cast<bf16*>(out), H, W,
                           TH, TW, stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
