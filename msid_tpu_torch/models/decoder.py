"""Progressive-upsampling CNN decoders (PyTorch, NCHW channels-last).

Counterparts of ``msid_tpu/models/decoder.py``: ``LightweightDecoder``
(``unet_light``), ``InputPyramid`` (the skip stem) and ``SkipDecoder``
(``unet_skip``). Module attribute names follow the flax names so that the
weight converter (``models/from_jax.py``) maps one to one.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from msid_tpu_torch.models.blocks import Norm, ResidualBlock, UpsampleBlock, gelu


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA 'SAME' padding: the odd pixel goes after (an even size padded
    for a stride-2 3x3 conv gets (0, 1), not torch's (1, 1))."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Head(nn.Module):
    """conv3 -> Norm -> GELU -> conv1 to the spectral bands."""

    def __init__(self, channels: int, out_channels: int, norm: str,
                 zero_init_head: bool):
        super().__init__()
        self.head_conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.head_norm = Norm(channels, norm)
        self.head_out = nn.Conv2d(channels, out_channels, 1)
        if zero_init_head:
            # Under a global residual head the model starts as the identity.
            nn.init.zeros_(self.head_out.weight)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.head_out(gelu(self.head_norm(self.head_conv(x))))


class LightweightDecoder(_Head):
    """Progressive 2x upsampling with residual refinement (``unet_light``)."""

    def __init__(self, in_channels: int = 768,
                 channels: Sequence[int] = (384, 192, 96, 48),
                 out_channels: int = 13, num_residual_blocks: int = 2,
                 use_pixel_shuffle: bool = False, norm: str = "batch",
                 zero_init_head: bool = False):
        super().__init__(channels[-1], out_channels, norm, zero_init_head)
        self.up = nn.ModuleList()
        self.res = nn.ModuleList()
        prev = in_channels
        for ch in channels:
            self.up.append(UpsampleBlock(prev, ch, use_pixel_shuffle, norm))
            self.res.append(nn.ModuleList(
                ResidualBlock(ch, norm) for _ in range(num_residual_blocks)))
            prev = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for up, blocks in zip(self.up, self.res):
            x = up(x)
            for block in blocks:
                x = block(x)
        return self.head(x)


class InputPyramid(nn.Module):
    """Multi-scale conv features of the raw input, ordered coarse -> fine."""

    def __init__(self, in_channels: int = 13, num_levels: int = 4,
                 width: int = 32, norm: str = "batch"):
        super().__init__()
        self.stem = nn.Conv2d(in_channels, width, 3, padding=1, bias=False)
        self.stem_norm = Norm(width, norm)
        self.down = nn.ModuleList(
            nn.Conv2d(width, width, 3, stride=2, bias=False)
            for _ in range(num_levels - 1))
        self.down_norm = nn.ModuleList(Norm(width, norm) for _ in range(num_levels - 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        f = gelu(self.stem_norm(self.stem(x)))
        feats = [f]
        for conv, norm in zip(self.down, self.down_norm):
            f = gelu(norm(conv(same_pad(f, 3, 2))))
            feats.append(f)
        return feats[::-1]


class SkipDecoder(_Head):
    """LightweightDecoder with per-stage fusion of InputPyramid features
    (``unet_skip``): upsample -> concat skip -> 1x1 fuse -> Norm -> GELU ->
    residual blocks."""

    def __init__(self, in_channels: int = 768,
                 channels: Sequence[int] = (384, 192, 96, 48),
                 out_channels: int = 13, num_residual_blocks: int = 2,
                 skip_width: int = 32, norm: str = "batch",
                 zero_init_head: bool = False):
        super().__init__(channels[-1], out_channels, norm, zero_init_head)
        self.up = nn.ModuleList()
        self.fuse = nn.ModuleList()
        self.fuse_norm = nn.ModuleList()
        self.res = nn.ModuleList()
        prev = in_channels
        for ch in channels:
            self.up.append(UpsampleBlock(prev, ch, False, norm))
            self.fuse.append(nn.Conv2d(ch + skip_width, ch, 1, bias=False))
            self.fuse_norm.append(Norm(ch, norm))
            self.res.append(nn.ModuleList(
                ResidualBlock(ch, norm) for _ in range(num_residual_blocks)))
            prev = ch

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(skips) != len(self.up):
            raise ValueError(f"need {len(self.up)} skip features, got {len(skips)}")
        for i, (up, fuse, norm, blocks) in enumerate(
                zip(self.up, self.fuse, self.fuse_norm, self.res)):
            x = up(x)
            s = skips[i]
            if s.shape[2:] != x.shape[2:]:
                raise ValueError(f"stage {i}: skip {tuple(s.shape)} vs decoder "
                                 f"{tuple(x.shape)}")
            x = gelu(norm(fuse(torch.cat([x, s.to(x.dtype)], dim=1))))
            for block in blocks:
                x = block(x)
        return self.head(x)


DECODER_REGISTRY = {
    "unet_light": LightweightDecoder,
    "unet_skip": SkipDecoder,
}
