"""Convolutional building blocks of the decoder (PyTorch, NCHW channels-last).

Counterparts of ``msid_tpu/models/blocks.py``: ``Norm``, ``ResidualBlock``
and ``UpsampleBlock``. Tensors are NCHW in shape and channels-last in
memory, so that ``x.permute(0, 2, 3, 1)`` is the contiguous NHWC view the
fused ResidualBlock kernel takes. GELU is the tanh approximation throughout
(flax ``nn.gelu``'s default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from msid_tpu_torch.ops.cuda_decoder import fused_residual_block

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch convention: flax momentum 0.9 keeps 0.9 of the old value
GN_EPS = 1e-6       # flax GroupNorm default


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class Norm(nn.Module):
    """Selectable normalization: ``batch`` or ``group``.

    Parameters and running statistics stay fp32 whatever the model's
    compute dtype. In train mode ``batch`` normalizes with the biased batch
    variance and updates the running stats with it, as flax does.
    """

    def __init__(self, features: int, kind: str = "batch"):
        super().__init__()
        if kind not in ("batch", "group"):
            raise ValueError(f"Unknown norm kind: {kind}")
        self.kind = kind
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if kind == "batch":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))
        else:
            groups = min(32, features)
            while features % groups != 0:
                groups -= 1
            self.num_groups = groups

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode BN as ``x * a + b`` (fp32)."""
        a = self.weight.float() * torch.rsqrt(self.running_var.float() + BN_EPS)
        return a, self.bias.float() - self.running_mean.float() * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "group":
            y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                             self.bias.float(), GN_EPS)
            return y.to(x.dtype)
        if not self.training:
            a, b = self.folded()
            return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var, BN_MOMENTUM)
        scale = self.weight.float() * torch.rsqrt(var + BN_EPS)
        shift = self.bias.float() - mean * scale
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class ResidualBlock(nn.Module):
    """Conv3x3-Norm-GELU-Conv3x3-Norm, residual add, GELU.

    In eval mode with BatchNorm the block is the fused kernel's function:
    both BNs fold into a ``[4, C]`` affine and ``fused_residual_block``
    computes it (the Hopper kernel on a CUDA tensor). Under autocast, x
    and both conv weights go to the autocast dtype first, as autocast
    would cast a conv's operands. In train mode, or with GroupNorm, it is
    plain convs and norms.
    """

    def __init__(self, features: int, norm: str = "batch"):
        super().__init__()
        self.conv0 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm0 = Norm(features, norm)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm1 = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or self.norm0.kind != "batch":
            y = gelu(self.norm0(self.conv0(x)))
            y = self.norm1(self.conv1(y))
            return gelu(x + y)
        affines = torch.stack([*self.norm0.folded(), *self.norm1.folded()])
        w1, w2 = self.conv0.weight, self.conv1.weight
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
            x, w1, w2 = x.to(dtype), w1.to(dtype), w2.to(dtype)
        out = fused_residual_block(
            channels_last(x).permute(0, 2, 3, 1),
            w1.permute(2, 3, 1, 0),
            w2.permute(2, 3, 1, 0),
            affines,
        )
        return out.permute(0, 3, 1, 2)


class UpsampleBlock(nn.Module):
    """2x upsample: ConvTranspose(k=2, s=2) or conv + pixel shuffle, then
    Norm-GELU."""

    def __init__(self, in_features: int, features: int,
                 use_pixel_shuffle: bool = False, norm: str = "batch"):
        super().__init__()
        self.use_pixel_shuffle = use_pixel_shuffle
        if use_pixel_shuffle:
            self.conv = nn.Conv2d(in_features, features * 4, 3, padding=1)
        else:
            self.conv = nn.ConvTranspose2d(in_features, features, 2, stride=2)
        self.norm = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.use_pixel_shuffle:
            # Depth-to-space with channel index (i*2 + j)*C + c, as the JAX
            # block reshapes NHWC (not F.pixel_shuffle's c*4 + i*2 + j).
            b, c4, h, w = y.shape
            c = c4 // 4
            y = y.view(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            y = channels_last(y.reshape(b, c, h * 2, w * 2))
        return gelu(self.norm(y))
