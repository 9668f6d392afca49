"""Fused decoder ResidualBlock (inference): the port of K1.

Counterpart of ``msid_tpu/ops/pallas_decoder.py``. One eval-mode
``ResidualBlock`` with its two BatchNorms folded into a ``[4, C]`` affine
``(a1, b1, a2, b2)``:

    h = gelu_tanh(conv3x3(x, w1) * a1 + b1)      h = 0 outside the image
    y = gelu_tanh(conv3x3(h, w2) * a2 + b2 + x)

``fused_residual_block`` runs the hand-written Hopper kernel
(``csrc/resblock.cu``) on a CUDA tensor and the plain PyTorch version
``fused_residual_block_reference`` on a CPU tensor. There is no other
route: a CUDA tensor the kernel does not take raises.

Layouts follow the JAX package: x is NHWC, weights are HWIO.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

# Channel widths the kernel is instantiated for (the flagship decoder's).
SUPPORTED_WIDTHS = (48, 96, 192, 384)

# Kernel launches so far in this process; chip_smoke.py zeroes it before
# driving the serving path and reads it after.
launches = 0


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


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_residual_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                         affines: torch.Tensor) -> torch.Tensor:
    """Eval-mode ResidualBlock, fused. x [B,H,W,C]; w1, w2 [3,3,C,C] HWIO;
    affines [4,C] fp32. Returns [B,H,W,C] in x.dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bf16 only) or raise.
    """
    global launches
    if x.device.type == "cpu":
        return fused_residual_block_reference(x, w1, w2, affines)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the fused ResidualBlock kernel takes bf16, got {x.dtype}: the "
            "fp32 block is K4 (fused_residual_block, "
            "msid_tpu/ops/pallas_decoder.py:470), not yet ported")
    if x.device.type != "cuda":
        raise ValueError(f"the fused ResidualBlock kernel needs a CUDA tensor, "
                         f"got one on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c not in SUPPORTED_WIDTHS:
        raise ValueError(f"channel width {c} not supported; the kernel is "
                         f"built for {SUPPORTED_WIDTHS}")
    _check("x", x, (b, h, w, c), torch.bfloat16, x.device)
    _check("affines", affines, (4, c), torch.float32, x.device)
    for name, wt in (("w1", w1), ("w2", w2)):
        if tuple(wt.shape) != (3, 3, c, c) or wt.dtype != torch.bfloat16 \
                or wt.device != x.device:
            raise ValueError(f"{name}: expected (3, 3, {c}, {c}) bf16 on "
                             f"{x.device}, got {tuple(wt.shape)} {wt.dtype} "
                             f"on {wt.device}")
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
