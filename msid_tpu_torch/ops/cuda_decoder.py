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

``fused_residual_block_v2`` is K3 (``csrc/resblock_v2.cu``, the port of
``fused_residual_block_v2``): the same bf16 block as nine shifted tap GEMMs
over one halo window that TMA loads with zero fill. As in the JAX package
it is not wired into the model; the kernel probe
(``benchmarks/kernel_probe.py``) runs it. Its plain version is
``fused_residual_block_v2_reference``.

Layouts follow the JAX package: x is NHWC, weights are HWIO.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

# Channel widths K1 is instantiated for (the flagship decoder's). K4 takes
# any width.
SUPPORTED_WIDTHS = (48, 96, 192, 384)

# Kernel launches so far in this process, K1 (bf16), K4 (fp32) and K3 (v2)
# apart; chip_smoke.py zeroes them before driving a path and reads them after.
launches = 0
launches_fp32 = 0
launches_v2 = 0

# K3's output tile (rows, cols) per channel width when the caller names
# none: the largest of K1's tiles, which also fit K3's window and h tile.
V2_DEFAULT_TILES = {48: (16, 32), 96: (16, 16), 192: (8, 16), 384: (8, 8)}
V2_MAX_TILE = 252       # a tensor map's box extent is at most 256 = tile + 4

# K4's launch geometry, as csrc/resblock_fp32.cu lays it out: clusters of
# at most FP32_MAX_CLUSTER CTAs of 256 threads, each thread holding
# FP32_SLOTS x FP32_TM pixels of the region, input channels staged FP32_KC
# at a time, at most MAX_SMEM bytes of shared memory per CTA.
FP32_THREADS = 256
FP32_TM = 2
FP32_SLOTS = 4
FP32_KC = 8
FP32_MAX_CLUSTER = 8
MAX_SMEM = 232448
H100_SMS = 132


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


def fp32_channel_block(c: int) -> tuple[int, int]:
    """K4's ``(TN, CG)``: TN output channels per thread, CG threads across
    a block of ``NB = TN * CG`` channels (64, 32 or 16, dividing C where
    it can)."""
    return (8, 8) if c % 64 == 0 else (4, 8) if c % 32 == 0 else (4, 4)


def fp32_cluster(c: int, nb: int) -> int:
    """K4's cluster size G: the fewest CTAs per tile that still give each
    the fewest output-channel blocks of ``nb`` (at most 8)."""
    blocks = math.ceil(c / nb)
    return math.ceil(blocks / math.ceil(blocks / FP32_MAX_CLUSTER))


def fp32_smem_bytes(c: int, tile: int, nb: int, g: int) -> int:
    """Shared memory of one K4 CTA for a ``tile`` x ``tile`` output tile:
    staged weights [9][KC][NB], its blocks of h over the tile plus its halo
    (pitch: its channels plus one) and the staged chunk [(tile+4)^2][KC+1],
    in fp32."""
    pitch = math.ceil(math.ceil(c / nb) / g) * nb + 1
    return 4 * (9 * FP32_KC * nb + (tile + 2) ** 2 * pitch
                + (tile + 4) ** 2 * (FP32_KC + 1))


def fp32_tiling(c: int, h: int, w: int, b: int,
                sms: int = H100_SMS) -> tuple[int, int, int]:
    """``(tile, nb, g)`` for K4: clusters of ``g`` CTAs share each square
    output tile, and the tile is the one whose grid finishes in the fewest
    slot passes on ``sms`` SMs (waves of CTAs times the channel blocks a
    CTA owns times the slots of conv1's halo region and of conv2's tile),
    among the tiles whose shared memory and region fit; ties go to the
    larger tile."""
    tn, cg = fp32_channel_block(c)
    nb = tn * cg
    g = fp32_cluster(c, nb)
    owned = math.ceil(math.ceil(c / nb) / g)
    slot = FP32_THREADS // cg * FP32_TM
    # CTAs an SM holds by registers: the 64-channel variant takes ~160 per
    # thread (one CTA of 256 threads), the others ~128 (two).
    ctas_by_registers = 1 if nb == 64 else 2
    best = None
    tile = 1
    while (tile + 2) ** 2 <= FP32_SLOTS * slot and fp32_smem_bytes(c, tile, nb, g) <= MAX_SMEM:
        per_sm = max(1, min(ctas_by_registers,
                            MAX_SMEM // (fp32_smem_bytes(c, tile, nb, g) + 1024)))
        ctas = math.ceil(h / tile) * math.ceil(w / tile) * b * g
        passes = math.ceil((tile + 2) ** 2 / slot) + math.ceil(tile * tile / slot)
        cost = math.ceil(ctas / (sms * per_sm)) * per_sm * owned * passes
        if best is None or cost <= best[0]:
            best = (cost, tile)
        tile += 1
    if best is None:
        raise ValueError(f"channel width {c} does not fit K4's shared memory")
    return best[1], nb, g


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
    K4 (fp32), or raise.
    """
    global launches
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
    b, h, w, c = x.shape
    if c not in SUPPORTED_WIDTHS:
        raise ValueError(f"channel width {c} not supported; the kernel is "
                         f"built for {SUPPORTED_WIDTHS}")
    _check("x", x, (b, h, w, c), torch.bfloat16, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check_weights(w1, w2, c, torch.bfloat16, x.device)
    # [ky, kx, Cin, Cout] -> [tap, Cout, Cin]: a B fragment is one load.
    w1t = w1.transpose(2, 3).contiguous()
    w2t = w2.transpose(2, 3).contiguous()
    out = torch.empty_like(x)

    from msid_tpu_torch.ops._build import load_library

    fn = load_library("resblock").msid_resblock_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
                 affines.data_ptr(), out.data_ptr(), b, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _fused_residual_block_fp32(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                               affines: torch.Tensor) -> torch.Tensor:
    """K4 on a CUDA fp32 x: any channel width, HWIO weights as they are."""
    global launches_fp32
    b, h, w, c = x.shape
    _check("x", x, (b, h, w, c), torch.float32, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check_weights(w1, w2, c, torch.float32, x.device)
    from msid_tpu_torch.ops._build import load_library

    fn = load_library("resblock_fp32").msid_resblock_fp32_forward
    w1c, w2c = w1.contiguous(), w2.contiguous()
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, nb, g = fp32_tiling(c, h, w, b, sms)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), affines.data_ptr(),
                 out.data_ptr(), b, h, w, c, tile, tile, nb, g, stream)
    if err != 0:
        raise RuntimeError(f"resblock_fp32 kernel launch failed: cudaError {err}")
    launches_fp32 += 1
    return out


def v2_chunk(c: int) -> int:
    """Channels per chunk of K3's window: the widest swizzle span (64, 32
    or 16 bf16 values) that divides C; C itself where none does."""
    return next((k for k in (64, 32, 16) if c % k == 0), c)


def v2_smem_bytes(c: int, row_block: int, col_block: int) -> int:
    """Shared memory of one K3 CTA for a ``row_block`` x ``col_block``
    output tile, as csrc/resblock_v2.cu lays it out: the bf16 x window with
    its 2-pixel halo in channel chunks that each start on a 1024-byte
    boundary, h over the tile plus 1 pixel at a pitch of C + 8, the
    barrier, and the slack to align the base."""
    ck = v2_chunk(c)
    chunk = -(-((row_block + 4) * (col_block + 4) * ck * 2) // 1024) * 1024
    return (c // ck * chunk + (row_block + 2) * (col_block + 2) * (c + 8) * 2
            + 8 + 1024)


def v2_tile(c: int, row_block: int | None, col_block: int | None) -> tuple[int, int]:
    """K3's output tile: the caller's, checked against the CTA's shared
    memory, or the default for the width. Raises ``ValueError`` for a tile
    that does not fit, naming one that does."""
    default = V2_DEFAULT_TILES.get(c, (8, 8))
    rb = default[0] if row_block is None else int(row_block)
    cb = default[1] if col_block is None else int(col_block)
    if not (1 <= rb <= V2_MAX_TILE and 1 <= cb <= V2_MAX_TILE):
        raise ValueError(f"tile ({rb}, {cb}) must lie in 1..{V2_MAX_TILE}")
    need = v2_smem_bytes(c, rb, cb)
    if need > MAX_SMEM:
        raise ValueError(
            f"tile ({rb}, {cb}) at C={c} needs {need} bytes of shared memory, a CTA "
            f"has {MAX_SMEM}; ({default[0]}, {default[1]}) fits "
            f"({v2_smem_bytes(c, *default)} bytes)")
    return rb, cb


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

    ``(row_block, col_block)`` is the CTA's output tile (None: the default
    for the width). It need not divide H and W, and the result does not
    depend on it; a tile whose window and h do not fit a CTA's shared
    memory raises ``ValueError``. A CPU tensor takes the plain version; a
    CUDA tensor (bf16, C in ``SUPPORTED_WIDTHS``) launches K3 or raises.
    """
    global launches_v2
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    rb, cb = v2_tile(c, row_block, col_block)
    if x.device.type == "cpu":
        return fused_residual_block_v2_reference(x, w1, w2, affines)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the fused ResidualBlock kernel v2 takes bf16, got {x.dtype}")
    if c not in SUPPORTED_WIDTHS:
        raise ValueError(f"channel width {c} not supported; the kernel is "
                         f"built for {SUPPORTED_WIDTHS}")
    _check("x", x, (b, h, w, c), torch.bfloat16, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    _check_weights(w1, w2, c, torch.bfloat16, x.device)
    if x.device.type != "cuda":
        raise ValueError(f"the fused ResidualBlock kernel needs a CUDA tensor, "
                         f"got one on {x.device}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("x must be 16-byte aligned")
    # [ky, kx, Cin, Cout] -> [tap, Cout, Cin]: a B fragment is one load.
    w1t = w1.transpose(2, 3).contiguous()
    w2t = w2.transpose(2, 3).contiguous()
    out = torch.empty_like(x)

    from msid_tpu_torch.ops._build import load_library

    fn = load_library("resblock_v2").msid_resblock_v2_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), affines.data_ptr(),
                 out.data_ptr(), b, h, w, c, rb, cb, stream)
    if err != 0:
        raise RuntimeError(f"resblock_v2 kernel launch failed: error {err}")
    launches_v2 += 1
    return out
