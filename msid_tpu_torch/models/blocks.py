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

from msid_tpu_torch.ops.cuda_decoder import (
    SUPPORTED_WIDTHS,
    fused_residual_block,
    fused_residual_block_op,
    prepare_bf16_weights,
)

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
    would cast a conv's operands. The folded affine and the weights in the
    kernel's dtype and layout are prepared once and kept on the module
    (``prepared_operands``); they are made again when a source tensor was
    written (its ``_version``), replaced, or the dtype or device changed.
    While the block is being exported (``torch.export``) they are graph ops
    of its parameters instead, made on every call of the exported program
    and never kept, and the block is one ``msid::fused_residual_block``
    node. In train mode, or with GroupNorm, it is plain convs and norms.
    """

    def __init__(self, features: int, norm: str = "batch"):
        super().__init__()
        self.conv0 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm0 = Norm(features, norm)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm1 = Norm(features, norm)
        self._prepared: tuple | None = None     # (key, (w1, w2, affines))

    def train(self, mode: bool = True):
        if mode:
            self._prepared = None               # training rewrites every source
        return super().train(mode)

    def __getstate__(self) -> dict:
        # A copy (copy.deepcopy, pickling) prepares its own operands.
        return {**super().__getstate__(), "_prepared": None}

    @property
    def kept_operands(self) -> tuple | None:
        """The ``(w1, w2, affines)`` that ``prepared_operands`` last made and
        keeps, or None."""
        return None if self._prepared is None else self._prepared[1]

    def prepared_operands(self, dtype: torch.dtype, device: torch.device) -> tuple:
        """``(w1, w2, affines)`` as ``fused_residual_block`` takes them for an
        x of ``dtype`` on ``device``: the fp32 ``[4, C]`` affine of the two
        folded BNs, and the conv weights in ``dtype``: K1's K-major
        operands for bf16 on a card, contiguous HWIO for fp32 on a card,
        HWIO views on the CPU."""
        sources = [self.conv0.weight, self.conv1.weight]
        for norm in (self.norm0, self.norm1):
            sources += [norm.weight, norm.bias, norm.running_mean, norm.running_var]
        try:
            key = (dtype, device, tuple((t._version, t.data_ptr(), t.dtype) for t in sources))
        except RuntimeError:                    # inference tensors carry no version
            key = None
        if key is not None and self._prepared is not None and self._prepared[0] == key:
            return self._prepared[1]
        with torch.no_grad():
            operands = self._operands(dtype, device)
        self._prepared = (key, operands) if key is not None else None
        return operands

    def _operands(self, dtype: torch.dtype, device: torch.device) -> tuple:
        affines = torch.stack([*self.norm0.folded(), *self.norm1.folded()])
        weights = [w.to(dtype).permute(2, 3, 1, 0)
                   for w in (self.conv0.weight, self.conv1.weight)]
        if device.type == "cuda" and dtype == torch.bfloat16 \
                and weights[0].shape[-1] in SUPPORTED_WIDTHS:
            weights = [prepare_bf16_weights(w) for w in weights]
        elif device.type == "cuda":
            weights = [w.contiguous() for w in weights]
        return weights[0], weights[1], affines

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or self.norm0.kind != "batch":
            y = gelu(self.norm0(self.conv0(x)))
            y = self.norm1(self.conv1(y))
            return gelu(x + y)
        dtype = x.dtype
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
        if torch.compiler.is_exporting():
            w1, w2, affines = self._operands(dtype, x.device)
            block = fused_residual_block_op
        else:
            w1, w2, affines = self.prepared_operands(dtype, x.device)
            block = fused_residual_block
        out = block(channels_last(x.to(dtype)).permute(0, 2, 3, 1), w1, w2, affines)
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
