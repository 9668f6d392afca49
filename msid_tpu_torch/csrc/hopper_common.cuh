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
// across the cluster through distributed shared memory (resblock_cta).
// K1's wide builds run a second body, resblock_stream_cta (described at
// its section below): the window and h streamed through two slots by
// 64-channel chunk, A by descriptor, a producer warpgroup. Each source
// includes this file and defines its own __global__ functions around the
// bodies and its own C entry point; what is here builds into each library,
// inside an anonymous namespace.
//
// Widths: the code is instantiated for a padded width CP (a template
// argument: the window's channels, the K loop, the CTA's N = CP / G) and
// takes the true width C (8 <= C <= CP) at run time. Channels past C are
// zeros: in the window (the tensor map's out-of-bounds fill, or zero stores),
// in the weights (the operand is [9 * CP][KP], zero rows and columns past
// C: ops/cuda_decoder.py, prepare_bf16_weights), and in h (the epilogue
// writes 0); the
// affine is read and the output written for channels below C only. So
// padding costs work, never a value.
#pragma once
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;               // two warpgroups
constexpr int kBK = 64;                     // input channels of a weight tile
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;
constexpr uint32_t kMaxSpins = 1u << 24;    // a lost copy traps instead of hanging

typedef __nv_bfloat16 bf16;

// Channel chunk of the window: the widest swizzle span that divides the
// padded width CP.
template <int CP>
struct Chunk {
  static constexpr int CK = (CP % 64 == 0) ? 64 : (CP % 32 == 0) ? 32 : 16;
  static_assert(CP % CK == 0, "CP must be a multiple of 16");
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

// Whether the barrier's phase differs from `parity`, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
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

// The same box, written at `dst` in the shared memory of every CTA of the
// cluster in `mask`, each copy completing bytes on the barrier at `bar` in
// its own CTA.
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int x0, int y0,
                                                      int n, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(x0), "r"(y0),
      "r"(n)
      : "memory");
}

// Arrive on the barrier at `bar` in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
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
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

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
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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
template <int CP>
__device__ __forceinline__ int window_offset(int p, int co, int chunk_elems) {
  using K = Chunk<CP>;
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
// nine taps and CP input channels, walking the weight ring from step `it`
// on. Source pixel (r + ky, c + kx) of a tile `src_w` pixels wide is tap
// (ky, kx) of region pixel (r, c). FROM_WINDOW: the source is the swizzled,
// chunked x window `xs`; otherwise h, whose channel k lies in the CTA k / N
// of the cluster at pitch N + 8.
//
// MT and the k16 steps of every weight tile are compile-time (where the
// tiles of a tap differ in them, the tap's tiles are unrolled): a wgmma
// under a run-time condition makes the compiler serialize every wgmma of
// the kernel.
template <int CP, int N, int NW, int MW, int MT, bool FROM_WINDOW, typename Produce>
__device__ __forceinline__ void conv_tiles(Produce& produce, const bf16* xs,
                                           int chunk_elems, bf16* hs,
                                           cg::cluster_group& cluster, int src_w,
                                           int out_w, int m, int first, uint32_t ring,
                                           uint32_t full, uint32_t empty, int stages,
                                           int& it, int nb, float (&acc)[MW][NW / 2]) {
  using K = Chunk<CP>;
  constexpr int HP = N + 8;
  constexpr int KQ = (CP + kBK - 1) / kBK;
  constexpr int KS = kBK / 16;
  // Every weight tile has the same k16 steps unless CP is no multiple of 64
  // and spans several tiles (CP = 96: 4 steps, then 2).
  constexpr bool UNIFORM = CP % kBK == 0 || KQ == 1;
  constexpr int KSU = (CP < kBK ? CP : kBK) / 16;
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
    const int ks = UNIFORM ? KSU : min(kBK, CP - kq * kBK) / 16;
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
            const bf16* hp = (N == CP ? hs : cluster.map_shared_rank(hs, owner)) +
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
    const int ks = UNIFORM ? KSU : min(kBK, CP - kq * kBK) / 16;
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
template <int CP, int N, int NW, int MW, bool FROM_WINDOW, typename Produce>
__device__ __forceinline__ void conv_pass(Produce& produce, const bf16* xs,
                                          int chunk_elems, bf16* hs,
                                          cg::cluster_group& cluster, int src_w,
                                          int out_w, int m, int first, int mt,
                                          uint32_t ring, uint32_t full, uint32_t empty,
                                          int stages, int& it, int nb,
                                          float (&acc)[MW][NW / 2]) {
#define MSID_CONV_TILES(MT)                                                              \
  conv_tiles<CP, N, NW, MW, MT, FROM_WINDOW>(produce, xs, chunk_elems, hs, cluster, src_w, \
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

// conv1's epilogue for one warpgroup's `mt` tiles of a pass (from tile
// `first` of the (TH+2) x (TW+2) region, `M1` pixels `HW` wide; STREAMED:
// laid out `ext_w` wide, the columns past HW discarded): the affine and GELU,
// zero outside the image, bf16 into this CTA's N channels of h. PADDED: the
// true width C is below the build's CP, and h is zero past it (the affine
// is read below C only); otherwise C is CP.
template <int CP, int N, int NW, int MW, bool PADDED, bool STREAMED = false>
__device__ __forceinline__ void store_h(const float (&acc)[MW][NW / 2], bf16* hs,
                                        const float* __restrict__ aff, int true_c, int first,
                                        int mt, int M1, int HW, int y0, int x0, int H, int W,
                                        int cbase, int nb, int ext_w = 0) {
  constexpr int HP = N + 8;
  const int C = PADDED ? true_c : CP;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    if (i >= mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (first + i) * 64 + wq * 16 + g + h * 8;
      if (p >= M1) continue;
      const int r = p / (STREAMED ? ext_w : HW);
      const int c = p - r * (STREAMED ? ext_w : HW);
      if (STREAMED && c >= HW) continue;
      const int hp = STREAMED ? r * HW + c : p;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + c;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = nb + j * 8 + t * 2;
        const int co = cbase + col;
        float v0 = 0.0f, v1 = 0.0f;
        if (inside && (!PADDED || co < C)) {
          v0 = gelu_tanh(fmaf(acc[i][4 * j + 2 * h], __ldg(aff + co), __ldg(aff + C + co)));
          if (!PADDED || co + 1 < C)
            v1 = gelu_tanh(fmaf(acc[i][4 * j + 2 * h + 1], __ldg(aff + co + 1),
                                __ldg(aff + C + co + 1)));
        }
        *reinterpret_cast<__nv_bfloat162*>(hs + hp * HP + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// conv2's epilogue for one warpgroup's `mt` tiles of a pass (from tile
// `first` of the TH x TW tile, `M2` pixels `TW` wide): the affine, the
// residual from the window, GELU, bf16 into sample n of `out` inside the
// image. STREAMED (resblock_stream_cta): the tile laid out `ext_w` wide,
// the columns past TW discarded, and the residual from x in device memory
// (out's layout). PADDED: only channels below the true width C are read and
// written, one element at a time where C is odd; otherwise C is CP.
template <int CP, int NW, int MW, bool PADDED, bool STREAMED = false>
__device__ __forceinline__ void store_y(const float (&acc)[MW][NW / 2], const bf16* xs,
                                        int chunk_elems, const float* __restrict__ aff,
                                        bf16* __restrict__ out, int true_c, int n, int first,
                                        int mt, int M2, int TW, int XW, int y0, int x0, int H,
                                        int W, int cbase, int nb,
                                        const bf16* __restrict__ x = nullptr, int ext_w = 0) {
  const int C = PADDED ? true_c : CP;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = (threadIdx.x >> 5) & 3;
  bf16* on = out + (size_t)n * H * W * C;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    if (i >= mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (first + i) * 64 + wq * 16 + g + h * 8;
      if (p >= M2) continue;
      const int r = p / (STREAMED ? ext_w : TW);
      const int c = p - r * (STREAMED ? ext_w : TW);
      if (STREAMED && c >= TW) continue;
      const int gy = y0 + r;
      const int gx = x0 + c;
      if (gy >= H || gx >= W) continue;
      const int xp = (r + 2) * XW + c + 2;   // the same pixel in the window
      bf16* dst = on + ((size_t)gy * W + gx) * C;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int co = cbase + nb + j * 8 + t * 2;
        if (PADDED && co >= C) continue;
        __nv_bfloat162 res;
        if constexpr (STREAMED) {
          const bf16* src = x + (dst - out) + co;
          if (!PADDED || (C & 1) == 0) {
            res = __ldg(reinterpret_cast<const __nv_bfloat162*>(src));
          } else {
            res.x = src[0];
            res.y = co + 1 < C ? src[1] : __float2bfloat16(0.0f);
          }
        } else {
          res = *reinterpret_cast<const __nv_bfloat162*>(
              xs + window_offset<CP>(xp, co, chunk_elems));
        }
        const float v0 = gelu_tanh(fmaf(acc[i][4 * j + 2 * h], __ldg(aff + 2 * C + co),
                                        __ldg(aff + 3 * C + co)) +
                                   __bfloat162float(res.x));
        if (!PADDED || co + 1 < C) {
          const float v1 = gelu_tanh(fmaf(acc[i][4 * j + 2 * h + 1],
                                          __ldg(aff + 2 * C + co + 1),
                                          __ldg(aff + 3 * C + co + 1)) +
                                     __bfloat162float(res.y));
          if (!PADDED || (C & 1) == 0) {     // bf16x2 stores stay 4-byte aligned
            *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[co] = __float2bfloat16_rn(v0);
            dst[co + 1] = __float2bfloat16_rn(v1);
          }
        } else {
          dst[co] = __float2bfloat16_rn(v0);
        }
      }
    }
  }
}

// Whether x's window comes by TMA: a tensor map needs every global stride
// but the innermost to be a multiple of 16 bytes, so NHWC bf16 takes one
// only when C is a multiple of 8. Otherwise the CTA's threads load the
// window with plain loads.
__host__ __device__ inline bool window_by_tma(int C) { return C % 8 == 0; }

// The block for one CTA of a cluster: the body of both kernels' __global__
// functions, which pass their __grid_constant__ tensor maps by address.
// CP is the padded width the code is built for, C (<= CP) the true one.
template <int CP, int NW, int MW, bool NSPLIT>
__device__ __forceinline__ void resblock_cta(const CUtensorMap* xmap, const CUtensorMap* w1map,
                                             const CUtensorMap* w2map,
                                             const bf16* __restrict__ x,
                                             const float* __restrict__ aff,
                                             bf16* __restrict__ out, int H, int W, int C,
                                             int TH, int TW, int stages) {
  using K = Chunk<CP>;
  constexpr int N = NSPLIT ? 2 * NW : NW;   // this CTA's output channels
  constexpr int G = CP / N;
  static_assert(CP % N == 0 && N % 16 == 0, "N must divide CP in k16 steps");
  // MW = 3 (an n64 variant) gave wrong outputs on the card wherever a
  // region took more than one pass, with no spill; the cause is not known,
  // and every variant holds 2 or 4 tiles a pass.
  static_assert(MW == 2 || MW == 4, "a warpgroup holds 2 or 4 m64 tiles a pass");
  constexpr int NQ = CP / K::CK;
  constexpr int KQ = (CP + kBK - 1) / kBK;
  const int XH = TH + 4, XW = TW + 4;   // x halo window
  const int HW = TW + 2;                // h tile width
  const int M1 = (TH + 2) * HW;
  const int M2 = TH * TW;
  const int chunk_elems = chunk_bytes(TH, TW, K::CK) / 2;
  const bool by_tma = window_by_tma(C);
  // Window chunks that hold a channel below C; the rest are zeros.
  const int nq = by_tma ? (C + K::CK - 1) / K::CK : 0;

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
                (step % KQ) * kBK, (step / KQ) * CP + cbase);
  };
  if (threadIdx.x == 0) {
    if (by_tma) {
      mbar_expect_tx(xbar, (uint32_t)(XH * XW * K::CK * 2 * nq));
      for (int q = 0; q < nq; ++q)
        tma_load_4d(smem_u32(xs + q * chunk_elems), xmap, xbar, q * K::CK, x0 - 2, y0 - 2,
                    n);
    }
    for (int j = 0; j < stages; ++j) produce(j);
  }
  __syncwarp();

  if (by_tma) {
    // The chunks past C: zeros, 16 bytes a store.
    uint4* zero = reinterpret_cast<uint4*>(xs + nq * chunk_elems);
    const int words = (NQ - nq) * chunk_elems / 8;
    for (int e = threadIdx.x; e < words; e += kThreads) zero[e] = make_uint4(0, 0, 0, 0);
  } else {
    // Plain loads, every channel of the padded window: x inside the image
    // and below C, zero elsewhere.
    const bf16* xn = x + (size_t)n * H * W * C;
    const bf16 zero = __float2bfloat16(0.0f);
    for (int e = threadIdx.x; e < XH * XW * CP; e += kThreads) {
      const int p = e / CP;
      const int co = e - p * CP;
      const int r = p / XW;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 2 + (p - r * XW);
      bf16 v = zero;
      if (co < C && gy >= 0 && gy < H && gx >= 0 && gx < W) v = xn[((size_t)gy * W + gx) * C + co];
      xs[window_offset<CP>(p, co, chunk_elems)] = v;
    }
  }
  __syncthreads();

  const int wg = warp >> 2;
  const int nb = NSPLIT ? wg * NW : 0;      // this warpgroup's first column in the CTA
  float acc[MW][NW / 2];
  int it = 0;

  if (by_tma) mbar_wait(xbar, 0);

  // conv1 -> this CTA's channels of h (shared memory only). The epilogues
  // come in two forms: the exact width's (C == CP: no check of C, offsets
  // from a constant, the code of a build for one width) and the padded one.
  const bool exact = C == CP;
  for (int pass = 0; pass < d1.passes; ++pass) {
    const int first = (NSPLIT ? 0 : wg * d1.share) + pass * MW;
    const int end = NSPLIT ? d1.tiles : min(d1.tiles, (wg + 1) * d1.share);
    const int mt = max(0, min(MW, end - first));
    conv_pass<CP, N, NW, MW, true>(produce, xs, chunk_elems, hs, cluster, XW, HW, M1, first, mt,
                                   ring, full, empty, stages, it, nb, acc);
    if (exact)
      store_h<CP, N, NW, MW, false>(acc, hs, aff, C, first, mt, M1, HW, y0, x0, H, W, cbase, nb);
    else
      store_h<CP, N, NW, MW, true>(acc, hs, aff, C, first, mt, M1, HW, y0, x0, H, W, cbase, nb);
  }

  // Every CTA of the cluster has written its channels of h.
  cluster.sync();

  // conv2 + residual -> out, channels below C.
  for (int pass = 0; pass < d2.passes; ++pass) {
    const int first = (NSPLIT ? 0 : wg * d2.share) + pass * MW;
    const int end = NSPLIT ? d2.tiles : min(d2.tiles, (wg + 1) * d2.share);
    const int mt = max(0, min(MW, end - first));
    conv_pass<CP, N, NW, MW, false>(produce, xs, chunk_elems, hs, cluster, HW, TW, M2, first,
                                    mt, ring, full, empty, stages, it, nb, acc);
    if (exact)
      store_y<CP, NW, MW, false>(acc, xs, chunk_elems, aff, out, C, n, first, mt, M2, TW, XW,
                                 y0, x0, H, W, cbase, nb);
    else
      store_y<CP, NW, MW, true>(acc, xs, chunk_elems, aff, out, C, n, first, mt, M2, TW, XW,
                                y0, x0, H, W, cbase, nb);
  }

  // Keep this CTA's h alive until every CTA of the cluster has read it.
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The streamed body: K1's wide builds (CP a multiple of 64).
//
// resblock_cta keeps the whole (TH+4) x (TW+4) x CP window in every CTA of
// the cluster, loaded once per CTA: at CP = 768 that is 184 KB of the 227,
// which leaves a 6 x 8 tile and a 2-stage weight ring; and each warp loads
// its A fragments of every tap into registers, conv2's from the other
// CTAs' h over distributed shared memory. Here both convs walk their K loop
// by 64-channel chunk, outermost, through a ring of kWindowSlots slots,
// and the nine taps' weight tiles of a chunk then come through the weight
// ring TAPS at a time: a kernel row to a stage, so that a step's barrier
// waits cover three taps' wgmmas (the step's fixed cost, not its wgmmas,
// bounded the one-tap steps on the card), or one tap where three would
// leave no room for the tile (N = 192). A slot holds a chunk as 8 groups of 8
// channels, each pixel's group 16 contiguous bytes: that is wgmma's
// K-major layout without swizzle, whose 8-row core matrices may start at
// any pixel, so A is read from the slot by descriptor at every tap's shift
// (each region is computed at its source's pitch, the extra columns
// discarded) and no thread loads a fragment.
//   * conv1: the window chunk, (TH+4) rows at a pitch of stream_pitch(TW)
//     pixels. The CTAs of the cluster each load 1/G of its rows by TMA
//     (one box per 8-channel group) and multicast them to all, so the
//     cluster reads each chunk from L2 once. A slot is refilled once every
//     warp of every CTA has released it (its empty barrier counts 8 * G
//     arrivals, made remotely) after the wgmmas that read it completed.
//     Where C % 8 != 0 the producer warpgroup's copying warps load each
//     chunk with plain loads instead, zeros past C and outside the image.
//   * conv2: the producer warpgroup's last three warps copy each chunk of
//     the (TH+2) x (TW+2) h tile from the CTAs that own its channels
//     (16-byte loads of distributed shared memory, once a chunk) into the
//     same slots while the consumers work on the chunk before; the
//     epilogue reads the residual from x in device memory.
// Chunks that hold no channel below C are skipped with their weight steps
// (their weights and h are zeros there). The CTA has a third warpgroup
// whose first thread is the producer of every TMA copy (weights and window
// slices), so that no warp of wgmma waits on a stage being released or
// issues a copy: with the consumers' first thread as the producer
// (resblock_cta) the two consumer warpgroups wait on each other at every
// weight step. Its other three warps copy h (and plain-loaded window
// chunks), each chunk published on the slot's full barrier.
// ---------------------------------------------------------------------------

constexpr int kWindowSlots = 2;
constexpr int kStreamThreads = kThreads + 128;   // two consumer warpgroups and the producer's
constexpr int kCopyThreads = 96;                  // the producer warpgroup's last three warps

// Pixels of one row of a window slot: TW + 4 rounded up to 8, so that a
// slice of rows starts on a 128-byte boundary in every group.
__host__ __device__ inline int stream_pitch(int tw) { return (tw + 4 + 7) & ~7; }

// Bytes of one window slot: (TH+4) rows of stream_pitch(TW) pixels of 64
// channels (a multiple of 1024).
__host__ __device__ inline int stream_slot_bytes(int th, int tw) {
  return (th + 4) * stream_pitch(tw) * kBK * 2;
}

// Rows of a slot each CTA of a cluster of g loads and multicasts (the last
// slices overlap where g does not divide TH + 4).
__host__ __device__ inline int stream_rows(int th, int g) { return (th + 4 + g - 1) / g; }

// Shared memory of one CTA of the streamed body, N = CP / G channels: the
// window slots, the weight ring of `taps` tiles a stage, h, the barriers
// (window full and empty, weights full and empty) and the slack to align
// the base.
__host__ __device__ inline size_t stream_smem_bytes(int th, int tw, int n, int stages, int taps) {
  return (size_t)kWindowSlots * stream_slot_bytes(th, tw) + (size_t)stages * taps * n * 128 +
         h_bytes(th, tw, n) + 8 * (2 * kWindowSlots + 2 * kMaxStages) + 1024;
}

// Descriptor of a K-major operand tile without swizzle: 8-row core
// matrices of 128 contiguous bytes (8 rows of 8 bf16), 128 bytes from one
// to the next along M (stride byte offset), `lbo` bytes from one 8-channel
// group to the next along K (leading byte offset), layout type 0.
__device__ __forceinline__ uint64_t a_descriptor(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         (8ull << 32);
}

// d += a (shared memory by descriptor, 64 x 16) * b (by descriptor, 16 x N).
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47"
        "}, "
        "%48, %49, p, 1, 1, 0, 0;\n"
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
        : "l"(a), "l"(b), "r"(1));
  }
};

// One pass of a conv for one warpgroup in the streamed body: acc[i] += the
// 3x3 conv for its MT m64 tiles from tile `first` of a region laid out at
// its source's pitch `src_w` (tap (ky, kx) of region pixel p is source
// pixel p + ky * src_w + kx), over the nq chunks w0, w0 + 1, ... of the
// source's chunk sequence, K-chunk outermost. Chunk w lies in slot
// w % kWindowSlots from `slots`, its 8-channel groups `group` bytes apart.
// need(w) returns once chunk w is in its slot; done(w) releases it, once
// the wgmmas that read it are complete.
template <int N, int NW, int MW, int MT, int TAPS, typename Need, typename Done>
__device__ __forceinline__ void stream_conv_tiles(Need& need, Done& done,
                                                  uint32_t slots, uint32_t slot_bytes,
                                                  uint32_t group, int src_w, int first, int nq,
                                                  int w0, uint32_t ring, uint32_t full,
                                                  uint32_t empty, int stages, int& it, int nb,
                                                  float (&acc)[MW][NW / 2]) {
  constexpr int KS = kBK / 16;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[i][e] = 0.0f;
    fence_accumulators(acc[i]);
  }
  // Release the stage of step it - 1: its wgmmas are done.
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % stages));
    __syncwarp();
  };
  bool fresh = true;     // no wgmma of this pass is in flight yet
#pragma unroll 1
  for (int kq = 0; kq < nq; ++kq) {
    const int w = w0 + kq;
    need(w);
    const uint32_t chunk = slots + (w % kWindowSlots) * slot_bytes + first * 64 * 16;
    // A step takes TAPS taps, whose weight tiles share a stage.
#pragma unroll 1
    for (int t = 0; t < 9 / TAPS; ++t) {
      const int s = it % stages;
      mbar_wait(full + 8 * s, (it / stages) & 1);
      const uint32_t taps = ring + s * (TAPS * N * 128) + nb * 128;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < TAPS; ++u) {
        const int ky = (t * TAPS + u) / 3;
        const int kx = t * TAPS + u - 3 * ky;
        const uint32_t src = chunk + (uint32_t)(ky * src_w + kx) * 16;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            WgmmaSS<NW>::mma(acc[i], a_descriptor(src + i * 64 * 16 + 2 * kk * group, group),
                             b_descriptor(taps + u * (N * 128) + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (!fresh) release();
      // The group before this one, chunk w - 1's last, is complete.
      if (t == 0 && kq > 0) done(w - 1);
      fresh = false;
      ++it;
    }
  }
  // Drain: the last step's wgmmas, then its stage and its chunk.
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_accumulators(acc[i]);
  release();
  done(w0 + nq - 1);
}

// The same for a warpgroup that holds `mt` (0..MW) tiles in this pass.
template <int N, int NW, int MW, int TAPS, typename Need, typename Done>
__device__ __forceinline__ void stream_conv_pass(Need& need, Done& done,
                                                 uint32_t slots, uint32_t slot_bytes,
                                                 uint32_t group, int src_w, int first, int mt,
                                                 int nq, int w0, uint32_t ring, uint32_t full,
                                                 uint32_t empty, int stages, int& it, int nb,
                                                 float (&acc)[MW][NW / 2]) {
#define MSID_STREAM_TILES(MT)                                                              \
  stream_conv_tiles<N, NW, MW, MT, TAPS>(need, done, slots, slot_bytes, group, src_w,            \
                                   first, nq, w0, ring, full, empty, stages, it, nb, acc)
  switch (mt) {
    case 4: MSID_STREAM_TILES((MW >= 4 ? 4 : MW)); break;
    case 3: MSID_STREAM_TILES((MW >= 3 ? 3 : MW)); break;
    case 2: MSID_STREAM_TILES((MW >= 2 ? 2 : MW)); break;
    case 1: MSID_STREAM_TILES(1); break;
    default: MSID_STREAM_TILES(0); break;
  }
#undef MSID_STREAM_TILES
}

// Window chunk c0.. of sample xn (x inside the image and below C, zero
// elsewhere) into `slot` by plain loads of V channels (V divides C), the
// copying warps' share from `tid`, BATCH loads in flight a thread.
template <int V> struct PlainWord;
template <> struct PlainWord<1> { typedef uint16_t T; };
template <> struct PlainWord<2> { typedef uint32_t T; };
template <> struct PlainWord<4> { typedef uint2 T; };

template <int V>
__device__ __forceinline__ void plain_chunk(unsigned char* slot, const bf16* xn, int c0, int C,
                                            int H, int W, int y0, int x0, int XH, int XW,
                                            int pitch, uint32_t xgroup, int tid) {
  typedef typename PlainWord<V>::T Word;
  constexpr int PER = kBK / V;   // words of a pixel's chunk
  constexpr int BATCH = 4;
  const int total = XH * XW * PER;
  for (int e0 = tid; e0 < total; e0 += BATCH * kCopyThreads) {
    Word v[BATCH];
    int at[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * kCopyThreads;
      const int p = e / PER;
      const int co = (e - p * PER) * V;
      const int r = p / XW;
      const int c = p - r * XW;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 2 + c;
      at[k] = e < total ? (co >> 3) * (int)(xgroup / 2) + (r * pitch + c) * 8 + (co & 7) : -1;
      v[k] = Word();
      if (at[k] >= 0 && c0 + co < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v[k] = *reinterpret_cast<const Word*>(xn + ((size_t)gy * W + gx) * C + c0 + co);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (at[k] >= 0) *reinterpret_cast<Word*>(reinterpret_cast<bf16*>(slot) + at[k]) = v[k];
  }
}

// The block for one CTA of a cluster, streamed body, TAPS (1 or 3) weight
// tiles a stage of the ring. The arguments are resblock_cta's; xmap's box
// is 8 channels x stream_pitch(TW) x stream_rows(TH, G) rows, without
// swizzle.
template <int CP, int NW, int MW, bool NSPLIT, int TAPS>
__device__ __forceinline__ void resblock_stream_cta(const CUtensorMap* xmap,
                                                    const CUtensorMap* w1map,
                                                    const CUtensorMap* w2map,
                                                    const bf16* __restrict__ x,
                                                    const float* __restrict__ aff,
                                                    bf16* __restrict__ out, int H, int W, int C,
                                                    int TH, int TW, int stages) {
  constexpr int N = NSPLIT ? 2 * NW : NW;
  constexpr int G = CP / N;
  static_assert(CP % N == 0 && N % 16 == 0, "N must divide CP in k16 steps");
  static_assert(CP % kBK == 0, "the streamed body takes whole 64-channel chunks");
  static_assert(MW == 2 || MW == 4, "a warpgroup holds 2 or 4 m64 tiles a pass");
  static_assert(TAPS == 1 || TAPS == 3, "a stage holds one tap or one kernel row");
  constexpr int STEPS = 9 / TAPS;        // steps of a chunk
  const int XH = TH + 4, XW = TW + 4;
  const int pitch = stream_pitch(TW);
  const int HW = TW + 2;
  const int MH = (TH + 2) * HW;          // h's pixels
  const int M1 = (TH + 2) * pitch;       // conv1's region at the window's pitch
  const int M2 = TH * HW;                // conv2's at h's
  const uint32_t slot_bytes = stream_slot_bytes(TH, TW);
  const uint32_t xgroup = XH * pitch * 16;   // bytes of one 8-channel group of a window chunk
  const uint32_t hgroup = MH * 16;           // of an h chunk
  const bool by_tma = window_by_tma(C);
  const int nq = (C + kBK - 1) / kBK;    // chunks that hold a channel below C

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring_ptr = smem + kWindowSlots * slot_bytes;
  bf16* hs = reinterpret_cast<bf16*>(ring_ptr + stages * (TAPS * N * 128));
  const uint32_t slot0 = smem_u32(smem);
  const uint32_t ring = smem_u32(ring_ptr);
  const uint32_t bars = smem_u32(reinterpret_cast<unsigned char*>(hs) + h_bytes(TH, TW, N));
  const uint32_t wfull = bars;
  const uint32_t wempty = bars + 8 * kWindowSlots;
  const uint32_t full = bars + 16 * kWindowSlots;
  const uint32_t empty = full + 8 * kMaxStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cbase = rank * N;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = (blockIdx.x / G) * TW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWindowSlots; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, (kThreads / 32) * G);
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // Every CTA's barriers are set before any copy or arrival reaches them.
  cluster.sync();

  const Deal d1(M1, MW, NSPLIT), d2(M2, MW, NSPLIT);
  // The slots' chunk sequence: conv1's passes each walk the nq window
  // chunks below C, then conv2's the chunks of h.
  const int chunks = d1.passes * nq;

  // The producer: the first thread of the third warpgroup. Step j's TAPS
  // weight tiles (conv1's passes, then conv2's, each in (chunk, tap) order
  // over the nq chunks below C) go into stage j % stages once the
  // consumers' eight warps have released the step before it there. Window
  // chunk w + 1 goes into its slot while chunk w's weights are produced, as
  // soon as every consumer warp of the cluster has released chunk w - 1.
  if (warp >= kThreads / 32) {
    const int steps1 = d1.passes * STEPS * nq;
    const int steps = steps1 + d2.passes * STEPS * nq;
    auto produce = [&](int j) {
      const int step = (j < steps1 ? j : j - steps1) % (STEPS * nq);
      const int kq = step / STEPS;
      const int t = step - STEPS * kq;
      const int s = j % stages;
      mbar_wait(empty + 8 * s, ((j / stages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, TAPS * N * 128);
      for (int u = 0; u < TAPS; ++u)
        tma_load_2d(ring + s * (TAPS * N * 128) + u * (N * 128), j < steps1 ? w1map : w2map,
                    full + 8 * s, kq * kBK, (t * TAPS + u) * CP + cbase);
    };
    // This CTA's slice of chunk w's rows, one box per 8-channel group, to
    // every CTA of the cluster; its own barrier expects every slice.
    const int rows = stream_rows(TH, G);
    const int row0 = min(rank * rows, XH - rows);
    auto issue = [&](int w) {
      const uint32_t bar = wfull + 8 * (w % kWindowSlots);
      const uint32_t dst = slot0 + (w % kWindowSlots) * slot_bytes + row0 * pitch * 16;
      mbar_expect_tx(bar, (uint32_t)(G * 8 * rows * pitch * 16));
      for (int u = 0; u < 8; ++u)
        tma_load_4d_multicast(dst + u * xgroup, xmap, bar, (w % nq) * kBK + u * 8, x0 - 2,
                              y0 - 2 + row0, n, (uint16_t)((1u << G) - 1));
    };
    // Window chunks up to wj + 1 into their slots: a slot whose chunk the
    // cluster has not released yet holds up chunk wj + 1's copy, and the
    // producer itself only for a chunk up to wj.
    int next_w = 0;
    auto issue_window = [&](int wj) {
      while (next_w < chunks && next_w <= wj + 1) {
        if (next_w >= kWindowSlots) {
          const uint32_t bar = wempty + 8 * (next_w % kWindowSlots);
          const uint32_t parity = (next_w / kWindowSlots - 1) & 1;
          if (next_w > wj) {
            if (!mbar_test(bar, parity)) break;
          } else {
            mbar_wait(bar, parity);
          }
        }
        issue(next_w++);
      }
    };
    // Slot w's chunk is stored by the copying warps (the other three of
    // the warpgroup), once the consumers released the slot's previous
    // chunk, and published on its full barrier.
    const int tid = threadIdx.x - (kThreads + 32);
    auto copy_chunk = [&](int w, auto&& load) {
      mbar_wait(wempty + 8 * (w % kWindowSlots), (w / kWindowSlots - 1) & 1);
      load(smem + (w % kWindowSlots) * slot_bytes);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the wgmmas
      asm volatile("bar.sync 2, %0;\n" ::"n"(kCopyThreads) : "memory");
      if (tid == 0) mbar_arrive(wfull + 8 * (w % kWindowSlots));
    };
    // conv1's steps and the first of conv2's, then (once every CTA's h is
    // written) the rest.
    const int split = min(steps, steps1 + stages);
    if (threadIdx.x == kThreads) {
      for (int j = 0; j < split; ++j) {
        if (by_tma && j < steps1) issue_window(j / STEPS);
        produce(j);
      }
    } else if (warp > kThreads / 32 && !by_tma) {
      // Where C % 8 != 0 (no tensor map takes that pixel stride) the
      // window chunks come by plain loads, as wide as C allows.
      const bf16* xn = x + (size_t)n * H * W * C;
      for (int w = 0; w < chunks; ++w) {
        const int c0 = (w % nq) * kBK;
        copy_chunk(w, [&](unsigned char* slot) {
          if (C % 4 == 0)
            plain_chunk<4>(slot, xn, c0, C, H, W, y0, x0, XH, XW, pitch, xgroup, tid);
          else if (C % 2 == 0)
            plain_chunk<2>(slot, xn, c0, C, H, W, y0, x0, XH, XW, pitch, xgroup, tid);
          else
            plain_chunk<1>(slot, xn, c0, C, H, W, y0, x0, XH, XW, pitch, xgroup, tid);
        });
      }
    }
    __syncwarp();
    cluster.sync();
    if (threadIdx.x == kThreads) {
      for (int j = split; j < steps; ++j) produce(j);
    } else if (warp > kThreads / 32) {
      // The copying warps copy h for conv2: chunk v of its sequence is
      // chunk chunks + v of the slots', from the CTAs that own its channels
      // (16-byte loads of distributed shared memory; every one of conv1's
      // chunks was released before the cluster barrier).
      for (int v = 0; v < d2.passes * nq; ++v) {
        const int k0 = (v % nq) * kBK;
        copy_chunk(chunks + v, [&](unsigned char* slot) {
          for (int e = tid; e < MH * 8; e += kCopyThreads) {
            const int u = e / MH;
            const int p = e - u * MH;
            const int k = k0 + u * 8;
            const int owner = k / N;
            *reinterpret_cast<uint4*>(slot + u * hgroup + p * 16) =
                *reinterpret_cast<const uint4*>(cluster.map_shared_rank(hs, owner) +
                                                p * (N + 8) + (k - owner * N));
          }
        });
      }
    }
    __syncwarp();
    cluster.sync();
    return;
  }

  // Chunk w of a slot: its full barrier; its release: G arrivals of every
  // consumer warp, on each CTA of the cluster for a window chunk by TMA
  // (every CTA's copy wrote to this one), else on this CTA's.
  auto need = [&](int w) {
    mbar_wait(wfull + 8 * (w % kWindowSlots), (w / kWindowSlots) & 1);
    __syncwarp();
  };
  auto done = [&](int w) {
    __syncwarp();
    if (lane < G) {
      if (by_tma && w < chunks)
        mbar_arrive_cluster(wempty + 8 * (w % kWindowSlots), lane);
      else
        mbar_arrive(wempty + 8 * (w % kWindowSlots));
    }
    __syncwarp();
  };

  const int wg = warp >> 2;
  const int nb = NSPLIT ? wg * NW : 0;
  float acc[MW][NW / 2];
  int it = 0;

  const bool exact = C == CP;
  for (int pass = 0; pass < d1.passes; ++pass) {
    const int first = (NSPLIT ? 0 : wg * d1.share) + pass * MW;
    const int end = NSPLIT ? d1.tiles : min(d1.tiles, (wg + 1) * d1.share);
    const int mt = max(0, min(MW, end - first));
    stream_conv_pass<N, NW, MW, TAPS>(need, done, slot0, slot_bytes, xgroup, pitch, first, mt, nq,
                                pass * nq, ring, full, empty, stages, it, nb, acc);
    if (exact)
      store_h<CP, N, NW, MW, false, true>(acc, hs, aff, C, first, mt, M1, HW, y0, x0, H, W,
                                          cbase, nb, pitch);
    else
      store_h<CP, N, NW, MW, true, true>(acc, hs, aff, C, first, mt, M1, HW, y0, x0, H, W,
                                         cbase, nb, pitch);
  }

  // Every CTA of the cluster has written its channels of h.
  cluster.sync();

  // conv2's chunks of h come through the slots after conv1's window
  // chunks.
  for (int pass = 0; pass < d2.passes; ++pass) {
    const int first = (NSPLIT ? 0 : wg * d2.share) + pass * MW;
    const int end = NSPLIT ? d2.tiles : min(d2.tiles, (wg + 1) * d2.share);
    const int mt = max(0, min(MW, end - first));
    stream_conv_pass<N, NW, MW, TAPS>(need, done, slot0, slot_bytes, hgroup, HW, first, mt,
                                      nq, chunks + pass * nq, ring, full, empty, stages, it,
                                      nb, acc);
    if (exact)
      store_y<CP, NW, MW, false, true>(acc, nullptr, 0, aff, out, C, n, first, mt, M2, TW, XW,
                                       y0, x0, H, W, cbase, nb, x, HW);
    else
      store_y<CP, NW, MW, true, true>(acc, nullptr, 0, aff, out, C, n, first, mt, M2, TW, XW,
                                      y0, x0, H, W, cbase, nb, x, HW);
  }

  // Keep this CTA's h alive until every CTA of the cluster has read it.
  cluster.sync();
}

// The tensor map of K-major weights [9 * CP rows (tap, output channel)]
// [KP columns (input channel)], CP the padded width, KP = CP rounded up to
// a multiple of 64, zeros past the true width on both sides, in boxes of
// [N rows][64 columns] under the 128-byte swizzle. Encoded once per
// prepared operand and cluster size by the caller, who keeps it
// (msid_resblock_weight_map).
CUresult weight_map(CUtensorMap* map, const void* w, int CP, int KP, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)KP, (cuuint64_t)9 * CP};
  const cuuint64_t strides[1] = {(cuuint64_t)KP * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)N};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// The __global__ function of one instantiation, as each kernel library
// defines it around resblock_cta or resblock_stream_cta.
typedef void (*ResblockKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                               const bf16*, const float*, bf16*, int, int, int, int, int,
                               int);

// Launch `kernel` (an instantiation <CP, NW, MW, NSPLIT> of resblock_cta, or
// <CP, NW, MW, NSPLIT, TAPS> of resblock_stream_cta where TAPS > 0) on
// clusters of G = CP / N CTAs for a true width C <= CP. w1map and w2map are the weight maps the caller keeps
// (host memory, any alignment); x's map comes from the bounded table
// (cached_map) where the window comes by TMA, the shared-memory limit is
// set once.
template <int CP, int NW, int MW, bool NSPLIT, int TAPS = 0>
int launch_resblock(ResblockKernel kernel, const void* x, const void* w1map,
                    const void* w2map, const void* aff, void* out, int B, int H, int W,
                    int C, int TH, int TW, int stages, cudaStream_t stream) {
  using K = Chunk<CP>;
  constexpr int N = NSPLIT ? 2 * NW : NW;
  constexpr int G = CP / N;
  constexpr int NQ = CP / K::CK;
  constexpr bool STREAM = TAPS > 0;
  static_assert(!STREAM || K::CK == kBK, "the streamed body takes whole 64-channel chunks");
  if (C < 1 || C > CP) return (int)cudaErrorInvalidValue;
  const size_t smem =
      STREAM ? stream_smem_bytes(TH, TW, N, stages, TAPS)
             : (size_t)NQ * chunk_bytes(TH, TW, K::CK) + (size_t)stages * N * 128 +
                   h_bytes(TH, TW, N) + 8 * (1 + 2 * kMaxStages) + 1024;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;

  CUtensorMap xmap, w1, w2;
  memset(&xmap, 0, sizeof(xmap));
  if (window_by_tma(C)) {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                   (cuuint64_t)H * W * C * 2};
    // The whole window in swizzled chunks, or one CTA's slice of a streamed
    // chunk's rows, 8 channels a box, unswizzled.
    const cuuint32_t box[4] = {
        (cuuint32_t)(STREAM ? 8 : K::CK), (cuuint32_t)(STREAM ? stream_pitch(TW) : TW + 4),
        (cuuint32_t)(STREAM ? stream_rows(TH, G) : TH + 4), 1};
    const CUtensorMapSwizzle swizzle = STREAM         ? CU_TENSOR_MAP_SWIZZLE_NONE
                                       : K::CK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : K::CK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult res = cached_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims,
                                    strides, box, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
    if (res != CUDA_SUCCESS) return 100000 + (int)res;
  }
  memcpy(&w1, w1map, sizeof(CUtensorMap));
  memcpy(&w2, w2map, sizeof(CUtensorMap));

  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + TW - 1) / TW * G, (H + TH - 1) / TH, B);
  cfg.blockDim = dim3(STREAM ? kStreamThreads : kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, w1, w2, static_cast<const bf16*>(x),
                           static_cast<const float*>(aff), static_cast<bf16*>(out), H, W, C,
                           TH, TW, stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
