// Fused eval-mode decoder ResidualBlock for Hopper (sm_90a), NHWC fp32, on
// the tensor cores as an error-compensated 3xTF32 product.
//
// Replaces the TPU kernel `fused_residual_block` (v1, `_resblock_kernel`)
// of msid_tpu/ops/pallas_decoder.py. It computes, for x [B,H,W,C] fp32,
// HWIO weights w1, w2 [3,3,C,C] fp32 and the folded BN affine
// aff = (a1, b1, a2, b2) [4,C] fp32:
//
//   h = gelu_tanh(conv3x3(x, w1) * a1 + b1)   h = 0 outside the image
//   y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + x)
//
// The TPU kernel casts to fp32 and its matrix unit emulates each fp32
// product with several bf16 passes. The counterpart here: every fp32
// operand v is split into big = tf32(v) (round to nearest, ties away, the
// result of cvt.rna.tf32.f32) and small = tf32(v - big), and each product
// is accumulated as small_a*big_b + big_a*small_b + big_a*big_b (small
// terms first) into fp32 accumulators by mma.sync m16n8k8 tf32. The term
// left out and the rounding of `small` are each ~2^-22 relative, fp32's own
// order; a single TF32 pass (2^-11) is not used anywhere. The tensor core
// adds into its accumulator with truncation, so the three terms of a k8
// step go into a fresh accumulator that is added to the running sum on the
// FMA units (see `accumulate_tiles`).
//
// Bound on an H100 SXM (3.35 TB/s HBM): one block is 2 * 2 * 9 * C^2 * H * W
// operations, 3.06 GFLOP per 192x192 tile at every flagship decoder stage,
// against 2 * H * W * C * 4 bytes of activation traffic, so it is bound by
// operations at every width. On the FMA units (66.9 TFLOP/s) that is ~46 us
// a tile; three TF32 passes at 495 TFLOP/s are 165 TFLOP/s of fp32
// work, ~18.5 us a tile, which is the bound of the route taken here.
//
// Design:
//   * one cluster of G CTAs (256 threads, 8 warps) per (sample, TH x TW
//     output tile). CTA r owns NC = NU * 8 * NT output channels from
//     r * NC: it computes those channels of h over the (TH+2) x (TW+2)
//     region (conv1) and of the output over the tile (conv2), so a tile's
//     work is spread over G SMs and h (fp32, shared memory only) over G
//     shared memories. Tile, G, NU and KC come from the caller
//     (ops/cuda_decoder.py: fp32_tiling); channels past C are zeros in
//     shared memory, never in device memory, so any C works;
//   * each conv is an implicit GEMM (pixels x NC, K = 9C). The 8 warps are
//     8/NU along the pixels by NU along the channels; a warp holds up to
//     4 m16 tiles x NT n8 tiles of fp32 accumulators, and the region's m16
//     tiles are dealt evenly over warps and passes, so a ragged region
//     costs whole m16 tiles, not whole 64-pixel units;
//   * the K loop runs over chunks of KC input channels through a ring of
//     two stages: the x window chunk [(TH+4)(TW+4)][KC] and the weight
//     slice [9][KC][NC] of the next chunk arrive by cp.async (16 bytes a
//     thread, zero fill outside the image and past C) while the tensor
//     cores work on the current one. conv2 stages its chunk of h from the
//     owning CTA's shared memory (distributed shared memory) the same way;
//   * raw fp32 sits in shared memory; a fragment is split into big/small
//     in registers after its load, so the split of an A fragment is used
//     by NT n8 tiles and that of a B fragment by up to 4 m16 tiles;
//   * pitches: a staged pixel takes KC + 4 floats and a staged weight row
//     NC rounded up to 8 mod 16 floats, which makes the m16n8k8 fragment
//     loads (rows g, g+8; columns t, t+4) free of bank conflicts;
//   * the residual is read from x in device memory in the epilogue.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 4;          // m16 tiles a warp holds at most
constexpr int kStages = 2;      // ring of staged chunks
constexpr int kMaxSmem = 232448;
constexpr int kMaxCluster = 8;  // portable cluster size

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

// tf32(v), round to nearest with ties away from zero, as a bit pattern
// with the low 13 mantissa bits clear: what cvt.rna.tf32.f32 returns, on
// the integer pipe.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small + O(2^-22 |v|), both tf32 bit patterns.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));   // the difference is exact in fp32
}

// d = a * b + c on the tensor cores (m16n8k8, tf32 operands, fp32 sums).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pitch of a staged weight row: NC rounded up to 8 mod 16 floats.
__host__ __device__ inline int weight_pitch(int nc) { return ((nc + 7) / 16) * 16 + 8; }

// What one CTA lays out in shared memory, in floats: its h
// [(TH+2)(TW+2)][NC+4], then kStages x { chunk [(TH+4)(TW+4)][KC+4],
// weights [9][KC][weight_pitch(NC)] }.
struct Geometry {
  int TH, TW, XW, XH, HW, HH, M1, M2;
  int NC, KC, SP, WP, HP;
  int chunk_floats, stage_floats;
  __host__ __device__ Geometry(int th, int tw, int nc, int kc)
      : TH(th), TW(tw), XW(tw + 4), XH(th + 4), HW(tw + 2), HH(th + 2),
        M1((th + 2) * (tw + 2)), M2(th * tw), NC(nc), KC(kc), SP(kc + 4),
        WP(weight_pitch(nc)), HP(nc + 4) {
    chunk_floats = XH * XW * SP;
    stage_floats = chunk_floats + 9 * KC * WP;
  }
  __host__ __device__ size_t smem_floats() const {
    return (size_t)M1 * HP + (size_t)kStages * stage_floats;
  }
};

// Stage w[tap][kc + k][cbase + n] into ws[(tap * KC + k) * WP + n], zeros
// past C.
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w,
                                              const Geometry& q, int C, int kc,
                                              int cbase) {
  const int rows = 9 * q.KC;
  if ((C & 3) == 0) {
    const int nv = q.NC / 4;
    for (int idx = threadIdx.x; idx < rows * nv; idx += kThreads) {
      const int row = idx / nv;
      const int n = (idx - row * nv) * 4;
      const int tap = row / q.KC;
      const int ci = kc + row - tap * q.KC;
      const int co = cbase + n;
      const bool valid = ci < C && co < C;
      cp_async16(ws + row * q.WP + n,
                 valid ? w + ((size_t)tap * C + ci) * C + co : w, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * q.NC; idx += kThreads) {
      const int row = idx / q.NC;
      const int n = idx - row * q.NC;
      const int tap = row / q.KC;
      const int ci = kc + row - tap * q.KC;
      const int co = cbase + n;
      const bool valid = ci < C && co < C;
      cp_async4(ws + row * q.WP + n,
                valid ? w + ((size_t)tap * C + ci) * C + co : w, valid);
    }
  }
}

// Stage channels [kc, kc + KC) of the (TH+4) x (TW+4) window of x at
// (y0 - 2, x0 - 2) into st[pixel * SP + k], zeros outside the image and
// past C.
__device__ __forceinline__ void stage_window(float* st, const float* __restrict__ xn,
                                             const Geometry& q, int H, int W, int C,
                                             int kc, int y0, int x0) {
  const int pixels = q.XH * q.XW;
  if ((C & 3) == 0) {
    const int nv = q.KC / 4;
    for (int idx = threadIdx.x; idx < pixels * nv; idx += kThreads) {
      const int pix = idx / nv;
      const int k = (idx - pix * nv) * 4;
      const int r = pix / q.XW;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 2 + (pix - r * q.XW);
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W && kc + k < C;
      cp_async16(st + pix * q.SP + k,
                 valid ? xn + ((size_t)gy * W + gx) * C + kc + k : xn, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < pixels * q.KC; idx += kThreads) {
      const int pix = idx / q.KC;
      const int k = idx - pix * q.KC;
      const int r = pix / q.XW;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 2 + (pix - r * q.XW);
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W && kc + k < C;
      cp_async4(st + pix * q.SP + k,
                valid ? xn + ((size_t)gy * W + gx) * C + kc + k : xn, valid);
    }
  }
}

// Stage KC channels of h from the CTA that owns them (`peer`, already
// offset to the chunk's first channel; possibly another CTA's shared
// memory) into st[pixel * SP + k].
__device__ __forceinline__ void stage_h(float* st, const float* peer,
                                        const Geometry& q) {
  const int nv = q.KC / 4;
  for (int idx = threadIdx.x; idx < q.M1 * nv; idx += kThreads) {
    const int pix = idx / nv;
    const int k = (idx - pix * nv) * 4;
    *reinterpret_cast<float4*>(st + pix * q.SP + k) =
        *reinterpret_cast<const float4*>(peer + pix * q.HP + k);
  }
}

// acc += the 3x3 conv of one staged chunk of KC input channels for this
// warp's `mt` m16 tiles and NT n8 tiles. `st` is the staged tile, `src_w`
// pixels wide at SP floats a pixel; pix[i][h] is SP times the source pixel
// of row g + 8h of m16 tile i, plus this lane's column t; `wcol` is the
// staged weight slice offset to row t and this lane's first column.
//
// The tensor core adds into its accumulator with truncation, a bias that
// grows with the length of the chain (measured: relative RMS 2.6e-5 at
// K = 9 * 384 with the sums kept in the mma's accumulator). So the three
// terms of one k8 step go into a fresh accumulator and that is added to
// the running sum on the FMA units, round to nearest. The terms of JB n8
// tiles x mt m16 tiles are issued in turns, so that an mma never waits
// for the one just before it.
template <int NT, int MT>
__device__ __forceinline__ void accumulate_tiles(const float* __restrict__ st, int SP,
                                                 int src_w, const int (&pix)[kMT][2],
                                                 const float* __restrict__ wcol, int WP,
                                                 int KC, float (&acc)[kMT][NT][4]) {
  constexpr int JB = (NT % 2 == 0) ? 2 : 1;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3;
    const float* stap = st + (ky * src_w + tap - 3 * ky) * SP;
    const float* wtap = wcol + tap * KC * WP;
#pragma unroll 1
    for (int k8 = 0; k8 < KC; k8 += 8) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* s0 = stap + pix[i][0] + k8;
        const float* s1 = stap + pix[i][1] + k8;
        split_tf32(s0[0], ab[i][0], as[i][0]);
        split_tf32(s1[0], ab[i][1], as[i][1]);
        split_tf32(s0[4], ab[i][2], as[i][2]);
        split_tf32(s1[4], ab[i][3], as[i][3]);
      }
      const float* wk = wtap + k8 * WP;
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += JB) {
        uint32_t bb[JB][2], bs[JB][2];
        float part[JB][MT][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          split_tf32(wk[(j0 + jj) * 8], bb[jj][0], bs[jj][0]);
          split_tf32(wk[4 * WP + (j0 + jj) * 8], bb[jj][1], bs[jj][1]);
        }
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(part[jj][i], as[i], bb[jj], zero);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(part[jj][i], ab[i], bs[jj], part[jj][i]);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(part[jj][i], ab[i], bb[jj], part[jj][i]);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j0 + jj][e] += part[jj][i][e];
      }
    }
  }
}

// The same for a warp that holds `mt` (0..4) m16 tiles in this pass.
template <int NT>
__device__ __forceinline__ void accumulate(const float* __restrict__ st, int SP,
                                           int src_w, const int (&pix)[kMT][2], int mt,
                                           const float* __restrict__ wcol, int WP,
                                           int KC, float (&acc)[kMT][NT][4]) {
  switch (mt) {
    case 4: accumulate_tiles<NT, 4>(st, SP, src_w, pix, wcol, WP, KC, acc); break;
    case 3: accumulate_tiles<NT, 3>(st, SP, src_w, pix, wcol, WP, KC, acc); break;
    case 2: accumulate_tiles<NT, 2>(st, SP, src_w, pix, wcol, WP, KC, acc); break;
    case 1: accumulate_tiles<NT, 1>(st, SP, src_w, pix, wcol, WP, KC, acc); break;
    default: break;
  }
}

// How a region's m16 tiles are dealt over passes and the WM warps along
// the pixels: `passes` passes in which a warp takes `per` (<= 4) tiles.
struct Deal {
  int tiles, passes, per;
  __device__ Deal(int m, int wm) {
    tiles = (m + 15) / 16;
    passes = (tiles + kMT * wm - 1) / (kMT * wm);
    per = (tiles + passes * wm - 1) / (passes * wm);
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                         const float* __restrict__ w2, const float* __restrict__ aff,
                         float* __restrict__ out, int H, int W, int C, int TH, int TW,
                         int G, int NU, int KC) {
  constexpr int UN = 8 * NT;
  const Geometry q(TH, TW, NU * UN, KC);
  const int WM = kWarps / NU;

  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* stages = hs + (size_t)q.M1 * q.HP;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cbase = rank * q.NC;           // this CTA's first output channel
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = warp % NU;                // this warp's channel unit
  const int wm = warp / NU;                // and its place along the pixels
  const int ncol = wn * UN;                // first column of the unit in the CTA
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = (blockIdx.x / G) * TW;
  const float* xn = x + (size_t)n * H * W * C;
  float* on = out + (size_t)n * H * W * C;
  const int chunks = (C + KC - 1) / KC;

  int pix[kMT][2];
  float acc[kMT][NT][4];

  // ---- conv1 over the (TH+2) x (TW+2) region -> this CTA's channels of h.
  const Deal d1(q.M1, WM);
  for (int pass = 0; pass < d1.passes; ++pass) {
    const int tile0 = (pass * WM + wm) * d1.per;
    const int mt = max(0, min(d1.per, d1.tiles - tile0));
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p = (tile0 + i) * 16 + g + h * 8;
        if (p >= q.M1) p = 0;              // padding row: computed, never stored
        const int r = p / q.HW;
        pix[i][h] = (r * q.XW + (p - r * q.HW)) * q.SP + t;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
    {
      float* st = stages;
      stage_window(st, xn, q, H, W, C, 0, y0, x0);
      stage_weights(st + q.chunk_floats, w1, q, C, 0, cbase);
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      float* st = stages + (size_t)(c % kStages) * q.stage_floats;
      if (c + 1 < chunks) {
        float* nx = stages + (size_t)((c + 1) % kStages) * q.stage_floats;
        stage_window(nx, xn, q, H, W, C, (c + 1) * KC, y0, x0);
        stage_weights(nx + q.chunk_floats, w1, q, C, (c + 1) * KC, cbase);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                     // chunk c has landed for every thread
      accumulate<NT>(st, q.SP, q.XW, pix, mt, st + q.chunk_floats + t * q.WP + ncol + g,
                     q.WP, KC, acc);
      __syncthreads();                     // before its stage is filled again
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (tile0 + i) * 16 + g + h * 8;
        if (p >= q.M1) continue;
        const int r = p / q.HW;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + (p - r * q.HW);
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = ncol + j * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = cbase + col + e;
            v[e] = (inside && co < C)
                       ? gelu_tanh(fmaf(acc[i][j][2 * h + e], __ldg(aff + co),
                                        __ldg(aff + C + co)))
                       : 0.0f;
          }
          *reinterpret_cast<float2*>(hs + p * q.HP + col) = make_float2(v[0], v[1]);
        }
      }
    }
  }

  // Every CTA of the cluster has written its channels of h.
  cluster.sync();

  // ---- conv2 over the TH x TW tile, + residual -> out.
  const Deal d2(q.M2, WM);
  for (int pass = 0; pass < d2.passes; ++pass) {
    const int tile0 = (pass * WM + wm) * d2.per;
    const int mt = max(0, min(d2.per, d2.tiles - tile0));
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p = (tile0 + i) * 16 + g + h * 8;
        if (p >= q.M2) p = 0;
        const int r = p / TW;
        pix[i][h] = (r * q.HW + (p - r * TW)) * q.SP + t;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
    // Chunk c of h lies in the CTA that owns channel c * KC (KC divides NC).
    auto stage = [&](int c, float* st) {
      const int kc = c * KC;
      const int owner = kc / q.NC;
      stage_weights(st + q.chunk_floats, w2, q, C, kc, cbase);
      cp_async_commit();
      stage_h(st, cluster.map_shared_rank(hs, owner) + (kc - owner * q.NC), q);
    };
    stage(0, stages);
    for (int c = 0; c < chunks; ++c) {
      float* st = stages + (size_t)(c % kStages) * q.stage_floats;
      if (c + 1 < chunks) {
        stage(c + 1, stages + (size_t)((c + 1) % kStages) * q.stage_floats);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      accumulate<NT>(st, q.SP, q.HW, pix, mt, st + q.chunk_floats + t * q.WP + ncol + g,
                     q.WP, KC, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (tile0 + i) * 16 + g + h * 8;
        if (p >= q.M2) continue;
        const int r = p / TW;
        const int gy = y0 + r;
        const int gx = x0 + (p - r * TW);
        if (gy >= H || gx >= W) continue;
        const size_t base = ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int co = cbase + ncol + j * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (co + e >= C) continue;
            const float v = fmaf(acc[i][j][2 * h + e], __ldg(aff + 2 * C + co + e),
                                 __ldg(aff + 3 * C + co + e)) +
                            __ldg(xn + base + co + e);
            on[base + co + e] = gelu_tanh(v);
          }
        }
      }
    }
  }

  // Keep this CTA's h alive until every CTA of the cluster has read it.
  cluster.sync();
}

template <int NT>
cudaError_t launch(const float* x, const float* w1, const float* w2,
                   const float* aff, float* out, int B, int H, int W, int C,
                   int TH, int TW, int G, int NU, int KC, cudaStream_t stream) {
  const int NC = NU * 8 * NT;
  if (NC % KC != 0 || (long)G * NC < C) return cudaErrorInvalidValue;
  const size_t smem = Geometry(TH, TW, NC, KC).smem_floats() * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = resblock_fp32_kernel<NT>;
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kernel), smem);
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
  err = cudaLaunchKernelEx(&cfg, kernel, x, w1, w2, aff, out, H, W, C, TH, TW, G, NU, KC);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NT>
int active_clusters(int G, int smem) {
  auto kernel = resblock_fp32_kernel<NT>;
  if (smem_limit_once(reinterpret_cast<const void*>(kernel), smem) != cudaSuccess) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * 64, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) return 0;
  return clusters;
}

}  // namespace

// x, out: [B,H,W,C] fp32 contiguous; w1, w2: [3,3,C,C] fp32 HWIO
// contiguous; aff: [4][C] fp32; all 16-byte aligned. TH x TW is the output
// tile of one cluster of G (1..8) CTAs; each CTA owns NU (1, 2, 4 or 8)
// units of 8 * NT (NT = 1, 2, 3, 4 or 6) output channels, G * NU * 8 * NT
// >= C; KC (8 or 16, dividing NU * 8 * NT) input channels are staged at a
// time. The caller chooses all of them (ops/cuda_decoder.py: fp32_tiling).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// geometry the kernel does not take or that does not fit shared memory).
extern "C" int msid_resblock_fp32_forward(const void* x, const void* w1,
                                          const void* w2, const void* aff,
                                          void* out, int B, int H, int W, int C,
                                          int TH, int TW, int NT, int NU, int G,
                                          int KC, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || TH < 1 || TW < 1 || G < 1 ||
      G > kMaxCluster || (NU != 1 && NU != 2 && NU != 4 && NU != 8) ||
      (KC != 8 && KC != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* af = static_cast<const float*>(aff);
  float* of = static_cast<float*>(out);
  switch (NT) {
    case 1:
      return (int)launch<1>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, NU, KC, s);
    case 2:
      return (int)launch<2>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, NU, KC, s);
    case 3:
      return (int)launch<3>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, NU, KC, s);
    case 4:
      return (int)launch<4>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, NU, KC, s);
    case 6:
      return (int)launch<6>(xf, w1f, w2f, af, of, B, H, W, C, TH, TW, G, NU, KC, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Clusters of G CTAs of the NT = 6 kernel with `smem_bytes` of shared memory
// that the current card holds at once (cudaOccupancyMaxActiveClusters; 0 on
// error): what ops/cuda_decoder.py's FP32_ACTIVE_CLUSTERS records.
extern "C" int msid_resblock_fp32_active_clusters(int G, int smem_bytes) {
  if (G < 1 || G > kMaxCluster || smem_bytes > kMaxSmem) return 0;
  return active_clusters<6>(G, smem_bytes);
}
