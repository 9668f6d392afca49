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

``fused_residual_block_op`` is the same function registered as the custom
operator ``msid::fused_residual_block``, with a shape-only fake version,
so that ``torch.export`` keeps the block as one opaque node of the graph
(``deployment/export.py``) and the node dispatches by device when the
exported program runs: a program traced on the card launches K1 or K4,
one traced on the CPU runs the plain version. Traced through the Python
function instead, the CPU trace would record the plain composition and a
trace on the card would reach the launch with tensors that have no
memory.

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

from msid_tpu_torch.ops import _build

# Channel widths K1 (and K3) take: every width from 8 to 768, the widest a
# repo config uses. Each is run by the library of the least padded width of
# BF16_BUILDS that holds it (``bf16_padded``), with the true width passed at
# run time; channels past it are zeros. K4 takes every width up to
# 8 clusters x 8 units x 32 channels.
BF16_MIN_WIDTH, BF16_MAX_WIDTH = 8, 768
SUPPORTED_WIDTHS = range(BF16_MIN_WIDTH, BF16_MAX_WIDTH + 1)
BF16_BUILDS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768)

# K3's output tile (rows, cols) for a side the caller leaves out, and the
# tile a refusal names: K1's cost model's choice at B=16 of the flagship's
# stage of that width (and its cluster).
V2_DEFAULT_TILES = {48: (24, 32), 96: (16, 24), 192: (12, 16), 384: (6, 12)}
V2_MAX_TILE = 252       # a tensor map's box extent is at most 256 = tile + 4

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
# an H100's 132 SMs at once, for every cluster size K4 and K1 launch
# (cudaOccupancyMaxActiveClusters, printed by scripts/sweep_k4_tiles.py): a
# cluster lies within one GPC.
FP32_ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
MAX_SMEM = 232448
H100_SMS = 132

# K1's and K3's launch geometry, as csrc/resblock.cu is built: per (padded
# width CP, cluster size g) the width ``nw`` of a warpgroup's wgmma, the m64
# tiles ``mw`` a warpgroup holds in one pass, and whether the two
# warpgroups split the CTA's N = CP / g channels (True) or the region's
# tiles (False). K3 (V2_VARIANTS) keeps the whole x window in every CTA
# (``"window"``: csrc/hopper_common.cuh, resblock_cta) at every build. K1
# (BF16_VARIANTS, which also names the body and, for the streamed one, the
# weight tiles a stage of its ring holds) does so below 256; its wide builds
# stream the window through a ring of 64-channel chunks multicast across
# the cluster (``"stream"``: resblock_stream_cta), which frees the shared
# memory for larger tiles and a deeper weight ring.
_NARROW_VARIANTS = {(16, 1): (16, 4, False), (32, 1): (32, 4, False),
                    (48, 1): (48, 4, False), (64, 1): (64, 2, False),
                    (96, 1): (96, 2, False),
                    (128, 1): (64, 2, True), (128, 2): (64, 2, False),
                    (192, 1): (96, 2, True), (192, 2): (96, 2, False)}
V2_VARIANTS = {**_NARROW_VARIANTS,
               (256, 2): (64, 2, True), (256, 4): (64, 2, False),
               (384, 2): (96, 2, True), (384, 4): (48, 4, True),
               (512, 4): (64, 2, True), (512, 8): (32, 4, True),
               (768, 8): (48, 2, True)}
BF16_VARIANTS = {**{key: (*v, "window", 0) for key, v in _NARROW_VARIANTS.items()},
                 (256, 2): (64, 2, True, "stream", 3), (256, 4): (64, 2, False, "stream", 3),
                 (384, 2): (96, 2, True, "stream", 1), (384, 4): (96, 2, False, "stream", 3),
                 (512, 4): (64, 2, True, "stream", 3), (512, 8): (64, 2, False, "stream", 3),
                 (768, 8): (96, 2, False, "stream", 3)}
_V2_BODIES = {key: (*v, "window", 0) for key, v in V2_VARIANTS.items()}
STREAM_SLOTS = 2        # window slots of the streamed body's ring (kWindowSlots)
BF16_BK = 64            # input channels of one staged weight tile (128 bytes)
TENSOR_MAP_BYTES = 128  # sizeof(CUtensorMap)
BF16_MAX_STAGES = 4
BF16_MIN_STAGES = 2
BF16_MAX_TILE = 252     # a tensor map's box extent is at most 256 = tile + 4
# The C entry points' argument types, bound once per library (_build.bind).
_BF16_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_WEIGHT_MAP_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FP32_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# Cost model of bf16_candidates, in m64 x 96-channel wgmma steps over all of K.
BF16_PASS_COST = 0.3
BF16_WINDOW_COST = 0.5 / 100e3      # per byte of window a CTA waits for
BF16_STREAM_STEP_COST = 0.04        # per barrier step of the streamed body's passes


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


@functools.lru_cache(maxsize=None)
def bf16_padded(c: int) -> int:
    """The padded width of the K1 build that runs width ``c``: the least of
    ``BF16_BUILDS`` that holds it. ``ValueError`` outside 8..768."""
    _check_width(c)
    return next(p for p in BF16_BUILDS if p >= c)


def prepare_bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C, C]`` -> K1's K-major operand ``[9 * CP, KP]`` (row
    ``tap * CP + cout``, column ``cin``; ``CP = bf16_padded(C)``, ``KP`` = CP
    rounded up to a multiple of 64; zeros in every row and column past C):
    one TMA box of it is a wgmma B tile, and a cluster's CTAs past C load
    zeros. Made once per weight (``ResidualBlock`` keeps it), not per
    launch."""
    c = w.shape[-1]
    cp = bf16_padded(c)
    kp = -(-cp // BF16_BK) * BF16_BK
    k = w.permute(0, 1, 3, 2).reshape(9, c, c)
    return F.pad(k, (0, kp - c, 0, cp - c)).reshape(9 * cp, kp)


@functools.lru_cache(maxsize=None)
def bf16_defines(c: int) -> tuple[str, ...]:
    """The ``-D`` defines of the K1 build that runs channel width ``c``: one
    library per padded width (``csrc/resblock.cu`` holds many
    instantiations; the builds compile side by side)."""
    return (f"MSID_C={bf16_padded(c)}",)


def variants(kernel: str = "k1") -> dict:
    """``(CP, g)`` -> ``(nw, mw, nsplit, body, taps)`` of K1 (``"k1"``) or
    K3 (``"k3"``, the resident window at every build; ``taps`` 0)."""
    if kernel == "k1":
        return BF16_VARIANTS
    if kernel == "k3":
        return _V2_BODIES
    raise ValueError(f"kernel must be 'k1' or 'k3', got {kernel!r}")


def stream_pitch(tw: int) -> int:
    """Pixels of a row of the streamed body's window slot: ``tw + 4``
    rounded up to 8 (csrc/hopper_common.cuh, stream_pitch)."""
    return -(-(tw + 4) // 8) * 8


def bf16_smem_bytes(c: int, th: int, tw: int, g: int, stages: int,
                    body: str = "window", taps: int = 0) -> int:
    """Shared memory of one K1 or K3 CTA for a ``th`` x ``tw`` output tile
    in a cluster of ``g``, at the padded width CP of ``c``'s build (``c``
    itself outside K1's widths): ``stages`` weight tiles of [CP / g][64],
    its CP / g channels of h over the tile plus 1 pixel at a pitch of
    CP / g + 8, the barriers, the slack to align the base, and the x window
    with its 2-pixel halo. ``"window"`` (resblock_cta): every channel, in
    chunks that each start on a 1024-byte boundary. ``"stream"``
    (resblock_stream_cta): STREAM_SLOTS slots of one 64-channel chunk,
    ``th + 4`` rows at a pitch of ``tw + 4`` rounded up to 8 pixels, and
    ``taps`` (1 or 3) weight tiles a ring stage."""
    cp = bf16_padded(c) if c in SUPPORTED_WIDTHS else c
    n = cp // g
    hbytes = -(-((th + 2) * (tw + 2) * (n + 8) * 2) // 16) * 16
    if body == "stream":
        if taps not in (1, 3):
            raise ValueError(f"the streamed body takes 1 or 3 taps a stage, got {taps}")
        return (STREAM_SLOTS * (th + 4) * stream_pitch(tw) * BF16_BK * 2 + stages * taps * n * 128
                + hbytes + 8 * (2 * STREAM_SLOTS + 2 * BF16_MAX_STAGES) + 1024)
    if body != "window":
        raise ValueError(f"body must be 'window' or 'stream', got {body!r}")
    ck = v2_chunk(cp)
    chunk = -(-((th + 4) * (tw + 4) * ck * 2) // 1024) * 1024
    return (cp // ck * chunk + stages * n * 128 + hbytes
            + 8 * (1 + 2 * BF16_MAX_STAGES) + 1024)


def bf16_regions(th: int, tw: int, body: str = "window") -> tuple[int, int]:
    """The pixels of conv1's and conv2's regions (h over the tile plus 1
    pixel, and the tile) as a body lays them out in m64 tiles: the resident
    window's at their own widths; the streamed body's at their sources'
    pitches (the window's ``stream_pitch(tw)``, h's ``tw + 2``), the extra
    columns computed and discarded."""
    if body == "stream":
        return (th + 2) * stream_pitch(tw), th * (tw + 2)
    return (th + 2) * (tw + 2), th * tw


def bf16_steps(m: int, mw: int, nsplit: bool) -> tuple[int, int]:
    """``(passes, share)``: the m64 tiles of an ``m``-pixel region one K1
    warpgroup works through (all of them when the warpgroups split N, half
    otherwise) and the passes of at most ``mw`` tiles that takes."""
    tiles = math.ceil(m / 64)
    share = tiles if nsplit else math.ceil(tiles / 2)
    return math.ceil(share / mw), share


def bf16_candidates(c: int, h: int, w: int, b: int, sms: int = H100_SMS,
                    kernel: str = "k1") -> list[tuple[float, tuple[int, ...]]]:
    """Every geometry ``(th, tw, g, stages)`` of K1 (or K3, ``kernel="k3"``)
    with an even tile that fits shared memory (the deepest weight ring that
    fits, at least 2), with its estimated cost, cheapest first: waves of
    clusters times the wgmma steps of a warpgroup over both convs (scaled by
    its width), plus a cost per pass, per barrier step of the streamed
    body (one for every chunk and ``taps`` taps) and for the window a CTA
    waits for before conv1 (all of it, or the streamed body's first chunk),
    all at the padded width of ``c``'s build (a CTA whose channels all lie
    past C computes zeros and costs the same). Ties go to the larger
    tile."""
    cp = bf16_padded(c)
    found = []
    for (width, g), (nw, mw, nsplit, body, taps) in variants(kernel).items():
        if width != cp:
            continue
        for th in range(2, min(h + 1, 32) + 1, 2):
            for tw in range(2, min(w + 1, 64) + 1, 2):
                stages = next((s for s in range(BF16_MAX_STAGES, BF16_MIN_STAGES - 1, -1)
                               if bf16_smem_bytes(c, th, tw, g, s, body, taps) <= MAX_SMEM),
                              None)
                if stages is None:
                    break                     # wider tiles need more still
                m1, m2 = bf16_regions(th, tw, body)
                p1, s1 = bf16_steps(m1, mw, nsplit)
                p2, s2 = bf16_steps(m2, mw, nsplit)
                clusters = math.ceil(h / th) * math.ceil(w / tw) * b
                waves = math.ceil(clusters / max(1, FP32_ACTIVE_CLUSTERS[g] * sms // H100_SMS))
                if body == "stream":
                    steps = ((s1 + s2) * nw / 96 + BF16_PASS_COST * (p1 + p2)
                             + BF16_STREAM_STEP_COST * (p1 + p2) * cp // BF16_BK * 9 // taps
                             + BF16_WINDOW_COST * (th + 4) * stream_pitch(tw) * BF16_BK * 2)
                else:
                    steps = ((s1 + s2) * nw / 96 + BF16_PASS_COST * (p1 + p2)
                             + BF16_WINDOW_COST * (th + 4) * (tw + 4) * cp * 2)
                found.append(((waves * steps, -th * tw), (th, tw, g, stages)))
    found.sort()
    return [(key[0], geometry) for key, geometry in found]


@functools.lru_cache(maxsize=None)
def bf16_tiling(c: int, h: int, w: int, b: int, sms: int = H100_SMS,
                kernel: str = "k1") -> tuple[int, int, int, int]:
    """``(th, tw, g, stages)`` for K1 (or K3): the cheapest of
    ``bf16_candidates``."""
    _check_width(c)
    return bf16_candidates(c, h, w, b, sms, kernel)[0][1]


@functools.lru_cache(maxsize=4096)
def bf16_check_tile(c: int, th: int, tw: int, g: int, stages: int,
                    kernel: str = "k1") -> None:
    """Raise ``ValueError`` for a K1 (or K3) geometry the kernel does not
    take (a geometry it takes is remembered: every launch checks its
    own)."""
    found = variants(kernel).get((bf16_padded(c), g)) if c in SUPPORTED_WIDTHS else None
    if (found is None
            or not 1 <= th <= BF16_MAX_TILE
            or not 1 <= tw <= BF16_MAX_TILE
            or not BF16_MIN_STAGES <= stages <= BF16_MAX_STAGES):
        raise ValueError(f"{kernel.upper()} takes no geometry tile ({th}, {tw}), g={g}, "
                         f"stages={stages} at C={c}")
    need = bf16_smem_bytes(c, th, tw, g, stages, *found[3:])
    if need > MAX_SMEM:
        raise ValueError(f"tile ({th}, {tw}) at C={c} (g={g}, stages={stages}, "
                         f"{found[3]} body) needs {need} bytes of shared memory, a CTA has "
                         f"{MAX_SMEM}")


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


@torch.library.custom_op("msid::fused_residual_block", mutates_args=(),
                         schema="(Tensor x, Tensor w1, Tensor w2, Tensor affines) -> Tensor")
def fused_residual_block_op(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                            affines: torch.Tensor) -> torch.Tensor:
    """``fused_residual_block`` as the operator ``msid::fused_residual_block``:
    what ``ResidualBlock`` calls while it is being exported."""
    return fused_residual_block(x, w1, w2, affines)


@fused_residual_block_op.register_fake
def _fused_residual_block_fake(x, w1, w2, affines):
    return torch.empty_like(x)


def _check_width(c: int) -> None:
    if c not in SUPPORTED_WIDTHS:
        raise ValueError(f"channel width {c} not supported; the kernel takes "
                         f"widths {BF16_MIN_WIDTH} to {BF16_MAX_WIDTH}")


def _fused_residual_block_bf16(x: torch.Tensor, w1k: torch.Tensor, w2k: torch.Tensor,
                               affines: torch.Tensor,
                               geometry: tuple[int, ...] | None = None) -> torch.Tensor:
    """K1 on a CUDA bf16 x with weights already in the kernel's K-major
    layout (``prepare_bf16_weights``). ``geometry`` overrides
    ``bf16_tiling``'s ``(th, tw, g, stages)`` (the tile sweep uses it)."""
    b, h, w, c = x.shape
    _check_width(c)
    if geometry is None:
        geometry = bf16_tiling(c, h, w, b, _build.multiprocessors(x.device))
    return _launch_bf16("msid_resblock_forward", x, w1k, w2k, affines, geometry)


def weight_map(wk: torch.Tensor, g: int) -> ctypes.Array:
    """The tensor map K1 and K3 read the K-major operand ``wk`` through in
    clusters of ``g`` CTAs (``msid_resblock_weight_map`` of the build of
    the operand's padded width): encoded on first use and kept on the
    operand itself, per (address, g), so the operand
    ``ResidualBlock.prepared_operands`` keeps carries its maps for as long
    as it lives, and a launch encodes only x's map (found again in the
    kernel library's bounded table). The map does not depend on the true
    width: the operand is zero past it."""
    c = wk.shape[0] // 9
    maps = wk.__dict__.setdefault("_tensor_maps", {})
    key = (wk.data_ptr(), g)
    found = maps.get(key)
    if found is None:
        found = ctypes.create_string_buffer(TENSOR_MAP_BYTES)
        fn = _build.bind("resblock", "msid_resblock_weight_map", _WEIGHT_MAP_ARGTYPES,
                         defines=bf16_defines(c))
        err = fn(wk.data_ptr(), c, g, found)
        if err != 0:
            raise RuntimeError(f"resblock weight map failed: error {err}")
        maps[key] = found
    return found


def _launch_bf16(entry: str, x: torch.Tensor, w1k: torch.Tensor, w2k: torch.Tensor,
                 affines: torch.Tensor, geometry: tuple[int, ...]) -> torch.Tensor:
    """Launch K1 (``entry`` ``msid_resblock_forward``) or K3
    (``msid_resblock_v2_forward``) of ``csrc/resblock.cu`` on a CUDA bf16 x
    with K-major weights, at ``(th, tw, g, stages)``."""
    b, h, w, c = x.shape
    cp = bf16_padded(c)
    kp = -(-cp // BF16_BK) * BF16_BK
    _check("x", x, (b, h, w, c), torch.bfloat16, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check("w1", w1k, (9 * cp, kp), torch.bfloat16, x.device)
    _check("w2", w2k, (9 * cp, kp), torch.bfloat16, x.device)
    th, tw, g, stages = geometry
    bf16_check_tile(c, th, tw, g, stages, "k3" if entry == "msid_resblock_v2_forward" else "k1")
    for name, t in (("x", x), ("w1", w1k), ("w2", w2k)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    _build.launch("resblock", entry, _BF16_ARGTYPES, x.device, x.data_ptr(),
                  weight_map(w1k, g), weight_map(w2k, g), affines.data_ptr(), out.data_ptr(),
                  b, h, w, c, th, tw, g, stages, defines=bf16_defines(c))
    return out


def _fused_residual_block_fp32(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                               affines: torch.Tensor,
                               geometry: tuple[int, ...] | None = None) -> torch.Tensor:
    """K4 on a CUDA fp32 x: any channel width, HWIO weights as they are
    (copied only if they are not contiguous). ``geometry`` overrides
    ``fp32_tiling``'s ``(th, tw, nt, nu, g, kc)`` (the tile sweep uses it)."""
    b, h, w, c = x.shape
    _check("x", x, (b, h, w, c), torch.float32, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check_weights(w1, w2, c, torch.float32, x.device)
    w1c, w2c = w1.contiguous(), w2.contiguous()
    out = torch.empty_like(x)
    if geometry is None:
        geometry = fp32_tiling(c, h, w, b, _build.multiprocessors(x.device))
    th, tw, nt, nu, g, kc = geometry
    fp32_check_tile(c, th, tw, nt, nu, g, kc)
    for name, t in (("x", x), ("w1", w1c), ("w2", w2c), ("affines", affines)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.launch("resblock_fp32", "msid_resblock_fp32_forward", _FP32_ARGTYPES, x.device,
                  x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), affines.data_ptr(),
                  out.data_ptr(), b, h, w, c, th, tw, nt, nu, g, kc)
    return out


def v2_chunk(c: int) -> int:
    """Channels per chunk of K3's window: the widest swizzle span (64, 32
    or 16 bf16 values) that divides C; C itself where none does."""
    return next((k for k in (64, 32, 16) if c % k == 0), c)


def v2_tile(c: int, h: int, w: int, b: int, row_block: int | None = None,
            col_block: int | None = None,
            sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """K3's launch geometry ``(th, tw, g, stages)`` for a ``[b, h, w, c]``
    block. With no tile named, K1's cost model over K3's own variants
    (``bf16_tiling(..., kernel="k3")``). Otherwise the
    caller's tile (a side left out from ``V2_DEFAULT_TILES``) with the
    smallest cluster at this width whose CTA holds it with a weight ring of
    at least BF16_MIN_STAGES stages, and the deepest ring that fits (at a
    width the kernels are not built for, where only the plain version runs,
    one CTA). The layout is the resident window's (``bf16_smem_bytes``).
    Raises ``ValueError`` for a tile that does not fit, naming one that
    does."""
    if row_block is None and col_block is None and c in SUPPORTED_WIDTHS:
        return bf16_tiling(c, h, w, b, sms, "k3")
    default = V2_DEFAULT_TILES.get(c, (8, 8))
    rb = default[0] if row_block is None else int(row_block)
    cb = default[1] if col_block is None else int(col_block)
    if not (1 <= rb <= V2_MAX_TILE and 1 <= cb <= V2_MAX_TILE):
        raise ValueError(f"tile ({rb}, {cb}) must lie in 1..{V2_MAX_TILE}")
    cp = bf16_padded(c) if c in SUPPORTED_WIDTHS else c
    clusters = sorted(g for width, g in V2_VARIANTS if width == cp) or [1]
    for g in clusters:
        for stages in range(BF16_MAX_STAGES, BF16_MIN_STAGES - 1, -1):
            if bf16_smem_bytes(c, rb, cb, g, stages) <= MAX_SMEM:
                return rb, cb, g, stages
    raise ValueError(
        f"tile ({rb}, {cb}) at C={c} needs {bf16_smem_bytes(c, rb, cb, clusters[-1], 2)} "
        f"bytes of shared memory (cluster of {clusters[-1]}), a CTA has {MAX_SMEM}; "
        f"({default[0]}, {default[1]}) fits")


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
    version; a CUDA tensor (bf16, C in ``SUPPORTED_WIDTHS``, on K1's
    builds) launches K3 or raises. On a card, w1 and w2 may also be the 2-D
    K-major operands ``prepare_bf16_weights`` makes of them, which saves that
    copy on every call (the kernel probe's case).
    """
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    sms = _build.multiprocessors(x.device) if x.device.type == "cuda" else H100_SMS
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
        w1, w2 = prepare_bf16_weights(w1), prepare_bf16_weights(w2)
    return _launch_bf16("msid_resblock_v2_forward", x, w1, w2, affines, geometry)
