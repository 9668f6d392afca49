"""Fused decoder ResidualBlock (inference): the ports of K1, K3 and K4.

Counterpart of ``msid_tpu/ops/pallas_decoder.py``. One eval-mode
``ResidualBlock`` with its two BatchNorms folded into a ``[4, C]`` affine
``(a1, b1, a2, b2)``:

    h = gelu_tanh(conv3x3(x, w1) * a1 + b1)      h = 0 outside the image
    y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + x)

``fused_residual_block`` runs a hand-written Hopper kernel on a CUDA
tensor: bf16 x takes K1 (``csrc/resblock.cu``, the port of
``fused_residual_block_v3``), fp32 x takes K4 (``csrc/resblock_fp32.cu``,
the port of ``fused_residual_block``, v1). A CPU tensor takes the plain
PyTorch version ``fused_residual_block_reference``. There is no other
route: a CUDA tensor neither kernel takes raises.

``fused_residual_block_v2`` is K3 (``csrc/resblock.cu`` beside K1, the port
of ``fused_residual_block_v2``): the same bf16 block as nine shifted tap
GEMMs over one halo window that TMA loads with zero fill, on K1's wgmma and
TMA weight ring (the device code both share is ``csrc/hopper_common.cuh``),
over an output tile the caller may name. As in the JAX package it is not
wired into the model; the kernel probe (``benchmarks/kernel_probe.py``)
runs it. Its plain version is ``fused_residual_block_v2_reference``.

Layouts follow the JAX package: x is NHWC, weights are HWIO.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

# Channel widths K1 is instantiated for (the flagship decoder's). K4 takes
# any width.
SUPPORTED_WIDTHS = (48, 96, 192, 384)

# Kernel launches so far in this process, K1 (bf16), K4 (fp32) and K3 (v2)
# apart; chip_smoke.py zeroes them before driving a path and reads them after.
launches = 0
launches_fp32 = 0
launches_v2 = 0

# K3's output tile (rows, cols) for a side the caller leaves out, and the
# tile a refusal names: K1's cost model's choice at B=16 of the flagship's
# stage of that width (and its cluster).
V2_DEFAULT_TILES = {48: (24, 32), 96: (16, 24), 192: (12, 16), 384: (6, 12)}
V2_MAX_TILE = 252       # a tensor map's box extent is at most 256 = tile + 4
# The K-major weights K3's functional entry has made, per HWIO weight
# tensor, for as long as that tensor lives: (data_ptr, _version, prepared).
_v2_weights = WeakIdKeyDictionary()

# K4's launch geometry, as csrc/resblock_fp32.cu lays it out: clusters of
# at most FP32_MAX_CLUSTER CTAs of FP32_WARPS warps; a warp holds at most
# FP32_MT m16 tiles of pixels by ``nt`` n8 tiles of channels; input channels
# are staged FP32_KCS at a time through FP32_STAGES buffers; at most
# MAX_SMEM bytes of shared memory per CTA.
FP32_WARPS = 8
FP32_MT = 4
FP32_STAGES = 2
FP32_KCS = (16, 8)
FP32_UNITS = (1, 2, 4, 8)
FP32_MAX_CLUSTER = 8
# Cost model of fp32_candidates, in m16 tiles of one warp over all of K.
FP32_MIN_STEP = 1.5
FP32_PASS_COST = 0.5
FP32_PIXEL_COST = 0.004
FP32_WEIGHT_COST = 0.001      # per staged weight row of a CTA's channels
# Clusters of g CTAs (256 threads, most of an SM's shared memory) that fit
# an H100's 132 SMs at once (cudaOccupancyMaxActiveClusters, printed by
# scripts/sweep_k4_tiles.py): a cluster lies within one GPC.
FP32_ACTIVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
MAX_SMEM = 232448
H100_SMS = 132

# K1's and K3's launch geometry, as csrc/resblock.cu is built: per (C,
# cluster size g) the width ``nw`` of a warpgroup's wgmma, the m64 tiles
# ``mw`` a warpgroup holds in one pass, and whether the two warpgroups split
# the CTA's N = C / g channels (True) or the region's tiles (False).
BF16_VARIANTS = {(48, 1): (48, 4, False), (96, 1): (96, 2, False),
                 (192, 1): (96, 2, True), (192, 2): (96, 2, False),
                 (384, 2): (96, 2, True), (384, 4): (48, 4, True)}
BF16_BK = 64            # input channels of one staged weight tile (128 bytes)
BF16_MAX_STAGES = 4
BF16_MIN_STAGES = 2
BF16_MAX_TILE = 252     # a tensor map's box extent is at most 256 = tile + 4
# Cost model of bf16_candidates, in m64 x 96-channel wgmma steps over all of K.
BF16_PASS_COST = 0.3
BF16_WINDOW_COST = 0.5 / 100e3      # per byte of window a CTA waits for


def fold_batchnorm(scale, bias, mean, var, eps: float = 1e-5):
    """BN eval:  y = (x - mean)/sqrt(var+eps)*scale + bias  ->  x*a + b."""
    a = scale / np.sqrt(np.asarray(var) + eps)
    return np.asarray(a, np.float32), np.asarray(bias - mean * a, np.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def fused_residual_block_reference(x: torch.Tensor, w1: torch.Tensor,
                                   w2: torch.Tensor,
                                   affines: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the block, in x's dtype.

    bf16 x follows the TPU kernel v3: fp32 convs over the bf16 operands,
    h rounded to bf16, residual added in fp32, bf16 out. fp32 x stays fp32
    end to end (the TPU kernel v1's numerics). Zero padding of conv2 is the
    kernel's "h = 0 outside the image".
    """
    xf = x.float().permute(0, 3, 1, 2)
    k1 = w1.float().permute(3, 2, 0, 1)
    k2 = w2.float().permute(3, 2, 0, 1)
    aff = affines.float()[:, :, None, None]
    h = _gelu(F.conv2d(xf, k1, padding=1) * aff[0] + aff[1])
    h = h.to(x.dtype).float()
    y = F.conv2d(h, k2, padding=1) * aff[2] + aff[3]
    return _gelu(y + xf).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's operand split, in plain PyTorch: ``big = tf32(v)`` (10 mantissa
    bits, round to nearest with ties away from zero, by integer arithmetic
    on the fp32 bits as the kernel does it) and ``small = tf32(v - big)``,
    both fp32 tensors whose low 13 bits are clear. ``v - big`` is exact in
    fp32, so ``v = big + small`` up to ~2^-22 |v|."""
    def tf32(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    big = tf32(v.float())
    return big, tf32(v.float() - big)


def conv3x3_split_tf32(x: torch.Tensor, w: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """The 3x3 'same' conv of NHWC x with HWIO w as K4's tensor cores see
    it: the sum of ``small_x * big_w + big_x * small_w + big_x * big_w``
    (``terms=3``), of ``big_x * big_w`` alone (``terms=1``, a single TF32
    pass, which K4 does not use) or with ``small_x * small_w`` too
    (``terms=4``). Products and sums are taken in float64, so the result
    shows the error of the split alone. Returns NHWC float64."""
    if terms not in (1, 3, 4):
        raise ValueError(f"terms must be 1, 3 or 4, got {terms}")
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)

    def conv(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return F.conv2d(u.double().permute(0, 3, 1, 2), k.double().permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    pairs = {1: [(xb, wb)], 3: [(xs, wb), (xb, ws), (xb, wb)],
             4: [(xs, ws), (xs, wb), (xb, ws), (xb, wb)]}[terms]
    out = conv(*pairs[0])
    for u, k in pairs[1:]:
        out = out + conv(u, k)
    return out


def fp32_channel_block(c: int) -> int:
    """K4's ``nt``: a warp's channel unit is ``8 * nt`` wide. 48 where it
    divides C (every flagship width), else 32, else the least that holds a
    narrow C."""
    if c % 48 == 0:
        return 6
    if c % 32 == 0:
        return 4
    return min(4, math.ceil(c / 8))


def fp32_cluster(c: int, nt: int) -> list[tuple[int, int]]:
    """K4's ways to split C output channels: ``(g, nu)`` pairs, a cluster
    of ``g`` CTAs (at most 8) that each own ``nu`` (1, 2, 4 or 8) units of
    ``8 * nt`` channels, with no CTA left without a channel."""
    units = math.ceil(c / (8 * nt))
    pairs = []
    for nu in FP32_UNITS:
        g = math.ceil(units / nu)
        if g <= FP32_MAX_CLUSTER and (g, nu) not in pairs and nu < 2 * units:
            pairs.append((g, nu))
    return pairs


def fp32_smem_bytes(th: int, tw: int, nt: int, nu: int, kc: int) -> int:
    """Shared memory of one K4 CTA for a ``th`` x ``tw`` output tile: its
    ``nc = nu * 8 * nt`` channels of h over the tile plus its halo (pitch
    nc + 4), and FP32_STAGES x (the staged chunk [(th+4)(tw+4)][kc+4] and the
    weights [9][kc][nc rounded up to 8 mod 16]), in fp32."""
    nc = nu * 8 * nt
    wp = (nc + 7) // 16 * 16 + 8
    stage = (th + 4) * (tw + 4) * (kc + 4) + 9 * kc * wp
    return 4 * ((th + 2) * (tw + 2) * (nc + 4) + FP32_STAGES * stage)


def fp32_steps(m: int, nu: int) -> tuple[int, int]:
    """``(passes, per)``: how K4 deals the m16 tiles of an ``m``-pixel
    region over passes and the ``8 / nu`` warps along the pixels; a warp
    takes ``per`` (at most FP32_MT) tiles in each pass."""
    wm = FP32_WARPS // nu
    tiles = math.ceil(m / 16)
    passes = math.ceil(tiles / (FP32_MT * wm))
    return passes, math.ceil(tiles / (passes * wm))


def fp32_candidates(c: int, h: int, w: int, b: int,
                    sms: int = H100_SMS) -> list[tuple[float, tuple[int, ...]]]:
    """Every K4 geometry ``(th, tw, nt, nu, g, kc)`` with an even tile that
    fits shared memory, with its estimated cost, cheapest first. The
    estimate: waves of clusters (FP32_ACTIVE_CLUSTERS of size g fit the
    card at once) times, for conv1's halo region and conv2's tile, the m16
    tiles a warp works through (at least FP32_MIN_STEP) plus
    FP32_PIXEL_COST for every source pixel a pass stages (each CTA of a
    cluster stages the whole window and all of h, whatever its share of the
    channels), FP32_WEIGHT_COST for every weight row of its own channels and
    FP32_PASS_COST a pass for pipeline fill and epilogue. The
    constants are fitted to ``scripts/sweep_k4_tiles.py`` on an H100. Ties
    go to the larger tile, then the deeper staging."""
    nt = fp32_channel_block(c)
    found = []
    for g, nu in fp32_cluster(c, nt):
        kcs = [kc for kc in FP32_KCS if (nu * 8 * nt) % kc == 0]
        for th in range(2, min(h + 1, 32) + 1, 2):
            for tw in range(2, min(w + 1, 48) + 1, 2):
                kc = next((k for k in kcs if fp32_smem_bytes(th, tw, nt, nu, k) <= MAX_SMEM),
                          None)
                if kc is None:
                    break                     # wider tiles need more still
                m1 = (th + 2) * (tw + 2)
                p1, per1 = fp32_steps(m1, nu)
                p2, per2 = fp32_steps(th * tw, nu)
                clusters = math.ceil(h / th) * math.ceil(w / tw) * b
                waves = math.ceil(clusters / max(1, FP32_ACTIVE_CLUSTERS[g] * sms // H100_SMS))
                weights = FP32_WEIGHT_COST * 9 * nu * 8 * nt
                steps = (p1 * (max(per1, FP32_MIN_STEP) + FP32_PASS_COST + weights
                               + FP32_PIXEL_COST * (th + 4) * (tw + 4))
                         + p2 * (max(per2, FP32_MIN_STEP) + FP32_PASS_COST + weights
                                 + FP32_PIXEL_COST * m1))
                found.append(((waves * steps, -th * tw, -kc), (th, tw, nt, nu, g, kc)))
    found.sort()
    return [(key[0], geometry) for key, geometry in found]


@functools.lru_cache(maxsize=None)
def fp32_tiling(c: int, h: int, w: int, b: int,
                sms: int = H100_SMS) -> tuple[int, int, int, int, int, int]:
    """``(th, tw, nt, nu, g, kc)`` for K4: the cheapest of
    ``fp32_candidates``: output tile, channel split and staging depth."""
    found = fp32_candidates(c, h, w, b, sms)
    if not found:
        raise ValueError(f"channel width {c} does not fit K4's shared memory")
    return found[0][1]


def fp32_check_tile(c: int, th: int, tw: int, nt: int, nu: int, g: int, kc: int) -> None:
    """Raise ``ValueError`` for a K4 geometry the kernel does not take."""
    nc = nu * 8 * nt
    if (nt not in (1, 2, 3, 4, 6) or nu not in FP32_UNITS or kc not in FP32_KCS
            or nc % kc or not 1 <= g <= FP32_MAX_CLUSTER or g * nc < c
            or th < 1 or tw < 1):
        raise ValueError(f"K4 takes no geometry tile ({th}, {tw}), nt={nt}, nu={nu}, "
                         f"g={g}, kc={kc} at C={c}")
    need = fp32_smem_bytes(th, tw, nt, nu, kc)
    if need > MAX_SMEM:
        raise ValueError(f"tile ({th}, {tw}) at C={c} (nt={nt}, nu={nu}, kc={kc}) needs "
                         f"{need} bytes of shared memory, a CTA has {MAX_SMEM}")


def prepare_bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> K1's K-major operand ``[9 * Cout, CP]``
    (row ``tap * C + cout``, column ``cin``, ``CP`` = C rounded up to a
    multiple of 64 with zeros past C): one TMA box of it is a wgmma B tile.
    Made once per weight (``ResidualBlock`` keeps it), not per launch."""
    c = w.shape[-1]
    k = w.permute(0, 1, 3, 2).reshape(9 * c, c)
    cp = -(-c // BF16_BK) * BF16_BK
    if cp == c:
        return k.contiguous()
    out = torch.zeros(9 * c, cp, dtype=w.dtype, device=w.device)
    out[:, :c] = k
    return out


def bf16_defines(c: int) -> tuple[str, ...]:
    """The ``-D`` defines of K1's build for channel width ``c``: each width
    has its own library (``csrc/resblock.cu`` holds many instantiations;
    four builds side by side take a quarter of the time of one)."""
    return (f"MSID_C={c}",)


def bf16_smem_bytes(c: int, th: int, tw: int, g: int, stages: int) -> int:
    """Shared memory of one K1 CTA for a ``th`` x ``tw`` output tile in a
    cluster of ``g``: the bf16 x window with its 2-pixel halo in channel
    chunks that each start on a 1024-byte boundary, ``stages`` weight tiles
    of [C / g][64], its C / g channels of h over the tile plus 1 pixel at a
    pitch of C / g + 8, the barriers, and the slack to align the base."""
    ck = v2_chunk(c)
    n = c // g
    chunk = -(-((th + 4) * (tw + 4) * ck * 2) // 1024) * 1024
    hbytes = -(-((th + 2) * (tw + 2) * (n + 8) * 2) // 16) * 16
    return (c // ck * chunk + stages * n * 128 + hbytes
            + 8 * (1 + 2 * BF16_MAX_STAGES) + 1024)


def bf16_steps(m: int, mw: int, nsplit: bool) -> tuple[int, int]:
    """``(passes, share)``: the m64 tiles of an ``m``-pixel region one K1
    warpgroup works through (all of them when the warpgroups split N, half
    otherwise) and the passes of at most ``mw`` tiles that takes."""
    tiles = math.ceil(m / 64)
    share = tiles if nsplit else math.ceil(tiles / 2)
    return math.ceil(share / mw), share


def bf16_candidates(c: int, h: int, w: int, b: int,
                    sms: int = H100_SMS) -> list[tuple[float, tuple[int, ...]]]:
    """Every K1 geometry ``(th, tw, g, stages)`` with an even tile that fits
    shared memory (the deepest weight ring that fits, at least 2), with its
    estimated cost, cheapest first: waves of clusters times the wgmma steps
    of a warpgroup over both convs (scaled by its width), plus a cost per
    pass and for the window a CTA waits for before conv1. Ties go to the
    larger tile."""
    found = []
    for (width, g), (nw, mw, nsplit) in BF16_VARIANTS.items():
        if width != c:
            continue
        for th in range(2, min(h + 1, 32) + 1, 2):
            for tw in range(2, min(w + 1, 64) + 1, 2):
                stages = next((s for s in range(BF16_MAX_STAGES, BF16_MIN_STAGES - 1, -1)
                               if bf16_smem_bytes(c, th, tw, g, s) <= MAX_SMEM), None)
                if stages is None:
                    break                     # wider tiles need more still
                p1, s1 = bf16_steps((th + 2) * (tw + 2), mw, nsplit)
                p2, s2 = bf16_steps(th * tw, mw, nsplit)
                clusters = math.ceil(h / th) * math.ceil(w / tw) * b
                waves = math.ceil(clusters / max(1, FP32_ACTIVE_CLUSTERS[g] * sms // H100_SMS))
                steps = ((s1 + s2) * nw / 96 + BF16_PASS_COST * (p1 + p2)
                         + BF16_WINDOW_COST * (th + 4) * (tw + 4) * c * 2)
                found.append(((waves * steps, -th * tw), (th, tw, g, stages)))
    found.sort()
    return [(key[0], geometry) for key, geometry in found]


@functools.lru_cache(maxsize=None)
def bf16_tiling(c: int, h: int, w: int, b: int,
                sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """``(th, tw, g, stages)`` for K1: the cheapest of ``bf16_candidates``."""
    if c not in SUPPORTED_WIDTHS:
        raise ValueError(f"channel width {c} not supported; the kernel is "
                         f"built for {SUPPORTED_WIDTHS}")
    return bf16_candidates(c, h, w, b, sms)[0][1]


def bf16_check_tile(c: int, th: int, tw: int, g: int, stages: int) -> None:
    """Raise ``ValueError`` for a K1 geometry the kernel does not take."""
    if ((c, g) not in BF16_VARIANTS or not 1 <= th <= BF16_MAX_TILE
            or not 1 <= tw <= BF16_MAX_TILE
            or not BF16_MIN_STAGES <= stages <= BF16_MAX_STAGES):
        raise ValueError(f"K1 takes no geometry tile ({th}, {tw}), g={g}, "
                         f"stages={stages} at C={c}")
    need = bf16_smem_bytes(c, th, tw, g, stages)
    if need > MAX_SMEM:
        raise ValueError(f"tile ({th}, {tw}) at C={c} (g={g}, stages={stages}) needs "
                         f"{need} bytes of shared memory, a CTA has {MAX_SMEM}")


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_weights(w1: torch.Tensor, w2: torch.Tensor, c: int, dtype, device) -> None:
    for name, wt in (("w1", w1), ("w2", w2)):
        if tuple(wt.shape) != (3, 3, c, c) or wt.dtype != dtype or wt.device != device:
            raise ValueError(f"{name}: expected (3, 3, {c}, {c}) {dtype} on "
                             f"{device}, got {tuple(wt.shape)} {wt.dtype} "
                             f"on {wt.device}")


def fused_residual_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                         affines: torch.Tensor) -> torch.Tensor:
    """Eval-mode ResidualBlock, fused. x [B,H,W,C]; w1, w2 [3,3,C,C] HWIO;
    affines [4,C] fp32. Returns [B,H,W,C] in x.dtype.

    CPU tensors take the plain version. CUDA tensors launch K1 (bf16) or
    K4 (fp32), or raise. For bf16 x on a card, w1 and w2 may also be the
    2-D K-major operands ``prepare_bf16_weights`` makes of them, which
    saves that copy on every call (``ResidualBlock`` keeps them).
    """
    if x.device.type == "cpu":
        return fused_residual_block_reference(x, w1, w2, affines)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the fused ResidualBlock kernels take bf16 (K1) or fp32 (K4), "
            f"got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"the fused ResidualBlock kernel needs a CUDA tensor, "
                         f"got one on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape {tuple(x.shape)}")
    if x.dtype == torch.float32:
        return _fused_residual_block_fp32(x, w1, w2, affines)
    if w1.dim() == 2 and w2.dim() == 2:
        return _fused_residual_block_bf16(x, w1, w2, affines)
    c = x.shape[-1]
    _check_width(c)
    _check_weights(w1, w2, c, torch.bfloat16, x.device)
    return _fused_residual_block_bf16(x, prepare_bf16_weights(w1),
                                      prepare_bf16_weights(w2), affines)


def _check_width(c: int) -> None:
    if c not in SUPPORTED_WIDTHS:
        raise ValueError(f"channel width {c} not supported; the kernel is "
                         f"built for {SUPPORTED_WIDTHS}")


def _fused_residual_block_bf16(x: torch.Tensor, w1k: torch.Tensor, w2k: torch.Tensor,
                               affines: torch.Tensor,
                               geometry: tuple[int, ...] | None = None) -> torch.Tensor:
    """K1 on a CUDA bf16 x with weights already in the kernel's K-major
    layout (``prepare_bf16_weights``). ``geometry`` overrides
    ``bf16_tiling``'s ``(th, tw, g, stages)`` (the tile sweep uses it)."""
    global launches
    b, h, w, c = x.shape
    _check_width(c)
    if geometry is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        geometry = bf16_tiling(c, h, w, b, sms)
    out = _launch_bf16("msid_resblock_forward", x, w1k, w2k, affines, geometry)
    launches += 1
    return out


def _launch_bf16(entry: str, x: torch.Tensor, w1k: torch.Tensor, w2k: torch.Tensor,
                 affines: torch.Tensor, geometry: tuple[int, ...]) -> torch.Tensor:
    """Launch K1 (``entry`` ``msid_resblock_forward``) or K3
    (``msid_resblock_v2_forward``) of ``csrc/resblock.cu`` on a CUDA bf16 x
    with K-major weights, at ``(th, tw, g, stages)``."""
    b, h, w, c = x.shape
    cp = -(-c // BF16_BK) * BF16_BK
    _check("x", x, (b, h, w, c), torch.bfloat16, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check("w1", w1k, (9 * c, cp), torch.bfloat16, x.device)
    _check("w2", w2k, (9 * c, cp), torch.bfloat16, x.device)
    th, tw, g, stages = geometry
    bf16_check_tile(c, th, tw, g, stages)
    for name, t in (("x", x), ("w1", w1k), ("w2", w2k)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    from msid_tpu_torch.ops._build import load_library

    fn = getattr(load_library("resblock", bf16_defines(c)), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1k.data_ptr(), w2k.data_ptr(), affines.data_ptr(),
                 out.data_ptr(), b, h, w, c, th, tw, g, stages, stream)
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed ({entry}): error {err}")
    return out


def _fused_residual_block_fp32(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                               affines: torch.Tensor,
                               geometry: tuple[int, ...] | None = None) -> torch.Tensor:
    """K4 on a CUDA fp32 x: any channel width, HWIO weights as they are
    (copied only if they are not contiguous). ``geometry`` overrides
    ``fp32_tiling``'s ``(th, tw, nt, nu, g, kc)`` (the tile sweep uses it)."""
    global launches_fp32
    b, h, w, c = x.shape
    _check("x", x, (b, h, w, c), torch.float32, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check_weights(w1, w2, c, torch.float32, x.device)
    from msid_tpu_torch.ops._build import load_library

    fn = load_library("resblock_fp32").msid_resblock_fp32_forward
    w1c, w2c = w1.contiguous(), w2.contiguous()
    out = torch.empty_like(x)
    if geometry is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        geometry = fp32_tiling(c, h, w, b, sms)
    th, tw, nt, nu, g, kc = geometry
    fp32_check_tile(c, th, tw, nt, nu, g, kc)
    for name, t in (("x", x), ("w1", w1c), ("w2", w2c), ("affines", affines)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), affines.data_ptr(),
                 out.data_ptr(), b, h, w, c, th, tw, nt, nu, g, kc, stream)
    if err != 0:
        raise RuntimeError(f"resblock_fp32 kernel launch failed: cudaError {err}")
    launches_fp32 += 1
    return out


def v2_chunk(c: int) -> int:
    """Channels per chunk of K3's window: the widest swizzle span (64, 32
    or 16 bf16 values) that divides C; C itself where none does."""
    return next((k for k in (64, 32, 16) if c % k == 0), c)


def v2_tile(c: int, h: int, w: int, b: int, row_block: int | None = None,
            col_block: int | None = None,
            sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """K3's launch geometry ``(th, tw, g, stages)`` for a ``[b, h, w, c]``
    block. With no tile named, K1's (``bf16_tiling``). Otherwise the
    caller's tile (a side left out from ``V2_DEFAULT_TILES``) with the
    smallest cluster at this width whose CTA holds it with a weight ring of
    at least BF16_MIN_STAGES stages, and the deepest ring that fits (at a
    width the kernels are not built for, where only the plain version runs,
    one CTA). The layout is K1's (``bf16_smem_bytes``). Raises
    ``ValueError`` for a tile that does not fit, naming one that does."""
    if row_block is None and col_block is None and c in SUPPORTED_WIDTHS:
        return bf16_tiling(c, h, w, b, sms)
    default = V2_DEFAULT_TILES.get(c, (8, 8))
    rb = default[0] if row_block is None else int(row_block)
    cb = default[1] if col_block is None else int(col_block)
    if not (1 <= rb <= V2_MAX_TILE and 1 <= cb <= V2_MAX_TILE):
        raise ValueError(f"tile ({rb}, {cb}) must lie in 1..{V2_MAX_TILE}")
    clusters = sorted(g for width, g in BF16_VARIANTS if width == c) or [1]
    for g in clusters:
        for stages in range(BF16_MAX_STAGES, BF16_MIN_STAGES - 1, -1):
            if bf16_smem_bytes(c, rb, cb, g, stages) <= MAX_SMEM:
                return rb, cb, g, stages
    raise ValueError(
        f"tile ({rb}, {cb}) at C={c} needs {bf16_smem_bytes(c, rb, cb, clusters[-1], 2)} "
        f"bytes of shared memory (cluster of {clusters[-1]}), a CTA has {MAX_SMEM}; "
        f"({default[0]}, {default[1]}) fits")


def v2_prepared_weights(w: torch.Tensor) -> torch.Tensor:
    """K3's K-major operand of HWIO ``w`` (``prepare_bf16_weights``), made
    once per weight tensor and kept while that tensor lives; made again
    after an in-place write (``_version``) or a change of storage."""
    kept = _v2_weights.get(w)
    if kept is not None and kept[:2] == (w.data_ptr(), w._version):
        return kept[2]
    prepared = prepare_bf16_weights(w.detach())
    _v2_weights[w] = (w.data_ptr(), w._version, prepared)
    return prepared


def fused_residual_block_v2_reference(x: torch.Tensor, w1: torch.Tensor,
                                      w2: torch.Tensor,
                                      affines: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3, in the TPU kernel v2's own form: each
    conv is nine shifted ``[pixels, C] @ [C, C]`` products over a
    zero-padded window, summed in fp32; h is zero outside the image (the
    padding of the second window) and rounded to x's dtype; the residual is
    added in fp32."""
    b, h, w, c = x.shape
    xf = x.float()
    aff = affines.float()

    def conv9(src: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        win = F.pad(src, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros(b, h, w, c, dtype=torch.float32, device=x.device)
        for ky in range(3):
            for kx in range(3):
                acc = acc + win[:, ky:ky + h, kx:kx + w, :] @ k[ky, kx]
        return acc

    y1 = _gelu(conv9(xf, w1.float()) * aff[0] + aff[1]).to(x.dtype).float()
    y2 = conv9(y1, w2.float()) * aff[2] + aff[3]
    return _gelu(y2 + xf).to(x.dtype)


def fused_residual_block_v2(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                            affines: torch.Tensor, row_block: int | None = None,
                            col_block: int | None = None) -> torch.Tensor:
    """Eval-mode ResidualBlock, fused, K3. x [B,H,W,C]; w1, w2 [3,3,C,C]
    HWIO; affines [4,C] fp32. Returns [B,H,W,C] in x.dtype.

    ``(row_block, col_block)`` is the output tile of one cluster (None: see
    ``v2_tile``). It need not divide H and W, and the result does not
    depend on it; a tile whose window, weight ring and h do not fit a CTA's
    shared memory raises ``ValueError``. A CPU tensor takes the plain
    version; a CUDA tensor (bf16, C in ``SUPPORTED_WIDTHS``) launches K3 or
    raises. On a card, w1 and w2 may also be the K-major operands
    ``prepare_bf16_weights`` makes of them (the kernel probe's case); HWIO
    weights are prepared once per tensor (``v2_prepared_weights``).
    """
    global launches_v2
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else H100_SMS)
    geometry = v2_tile(c, h, w, b, row_block, col_block, sms)
    if x.device.type == "cpu":
        return fused_residual_block_v2_reference(x, w1, w2, affines)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the fused ResidualBlock kernel v2 takes bf16, got {x.dtype}")
    _check_width(c)
    _check("x", x, (b, h, w, c), torch.bfloat16, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    prepared = w1.dim() == 2 and w2.dim() == 2
    if not prepared:
        _check_weights(w1, w2, c, torch.bfloat16, x.device)
    if x.device.type != "cuda":
        raise ValueError(f"the fused ResidualBlock kernel needs a CUDA tensor, "
                         f"got one on {x.device}")
    if not prepared:
        w1, w2 = v2_prepared_weights(w1), v2_prepared_weights(w2)
    out = _launch_bf16("msid_resblock_v2_forward", x, w1, w2, affines, geometry)
    launches_v2 += 1
    return out
