"""Restormer (PyTorch): a full-resolution restoration transformer, a port-only
restorer beside ``SatMAERestoration``.

Zamir et al., "Restormer: Efficient Transformer for High-Resolution Image
Restoration", CVPR 2022 (arXiv:2111.09881); the code release's
``basicsr/models/archs/restormer_arch.py``, class ``Restormer``, with the
denoising options (``LayerNorm_type: BiasFree``, ``bias: False``). NHWC
model-range tiles in, NHWC out, at the tile's own resolution (a side must
be a multiple of 8: three 2x downsamples):

* ``patch_embed``: a 3x3 conv from the bands to ``dim``;
* four levels at ``dim``, ``2 dim``, ``4 dim``, ``8 dim`` with ``heads``
  heads; each ``Downsample`` a 3x3 conv to half the channels and a 2x pixel
  unshuffle, each ``Upsample`` a 3x3 conv to twice the channels and a 2x
  pixel shuffle; the decoder concatenates the encoder's skip at each level,
  levels 3 and 2 reduce it by a 1x1 conv, level 1 does not, so
  ``decoder_level1`` and ``refinement`` run at ``2 dim`` with ``heads[0]``;
* ``output``: a 3x3 conv back to the bands, plus the input (global
  residual).

A block is ``x + MDTA(LN(x))`` then ``x + GDFN(LN(x))``. ``LN`` is the
bias-free LayerNorm over the channels of each pixel, ``x / sqrt(var(x) +
1e-5) * w``: the variance is about the mean, but the mean is not taken from
``x``. MDTA (transposed attention) is ``qkv = dwconv3x3(conv1x1(x))``, q,
k, v split per head to ``[B, h, C/h, H*W]``, q and k L2-normalised along
``H*W``, ``A = softmax(q k^T * t_h)`` over ``C/h x C/h`` with a learned
temperature per head (the reduction runs over every pixel), ``A v``, a 1x1
``project_out``. GDFN is ``u = dwconv3x3(conv1x1(x, C -> 2 Hd))``,
``Hd = int(2.66 C)``, and ``conv1x1(gelu(u1) * u2, Hd -> C)`` (exact GELU).
No conv has a bias.

Plain torch operations on channels-last memory: the 1x1 and 3x3 convs,
the depthwise convs and the pixel shuffles are cuDNN's and PyTorch's; on a
card the LayerNorm is the port's kernel N2 (``bias_free_norm``). The
LayerNorm's variance and the L2 norms accumulate in float32; everything
else computes in the model's dtype (``set_compute_dtype``). Spans:
``msid.restormer.mdta`` and ``msid.restormer.gdfn`` around each block's
halves, ``msid.restormer.level`` around each level's blocks (eager
forwards: a scene step replays a captured graph, which the spans do not
see).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from msid_tpu_torch.models.restoration import exact_fp32, resolve_device
from msid_tpu_torch.ops import cuda_layernorm
from msid_tpu_torch.utils.profiling import annotate

LN_EPS = 1e-5
L2_EPS = 1e-12        # F.normalize's: a norm below it divides by it instead
SIDE_MULTIPLE = 8


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def bias_free_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x / sqrt(var_c(x) + eps) * w`` over the channels of each pixel of a
    channels-last ``[B, C, H, W]``, the variance in float32.

    On a card it is the kernel N2 (``ops/cuda_layernorm.py``), one pass
    over x, as the operator ``msid::bias_free_norm``: it raises on a tensor
    it cannot read, stays one node in an exported program, and has a
    closed-form backward. On the CPU it is ``bias_free_norm_plain``."""
    if x.device.type == "cuda":
        return cuda_layernorm.bias_free_norm_op(x, weight, LN_EPS)
    return bias_free_norm_plain(x, weight)


def bias_free_norm_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The LayerNorm as PyTorch passes: an fp32 variance, its rsqrt in x's
    dtype, two multiplies in x's dtype (N2's plain version)."""
    y = x.permute(0, 2, 3, 1)                                 # [B, H, W, C] view
    var = y.float().var(dim=-1, keepdim=True, correction=0)
    return (y * torch.rsqrt(var + LN_EPS).to(x.dtype) * weight).permute(0, 3, 1, 2)


def l2_normalize(t: torch.Tensor) -> torch.Tensor:
    """``t`` over its L2 norm along the last dim (at least ``L2_EPS``), the
    norm accumulated in float32."""
    norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True, dtype=torch.float32)
    return t / norm.clamp_min(L2_EPS).to(t.dtype)


class BiasFreeLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bias_free_norm(x, self.weight)


class Attention(nn.Module):
    """MDTA: attention across channels, per head, over every pixel."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, dim, h, w = x.shape
        heads = self.num_heads
        qkv = self.qkv_dwconv(self.qkv(x))
        t = qkv.permute(0, 2, 3, 1).reshape(b, h * w, 3, heads, dim // heads)
        q, k, v = (t[:, :, i].permute(0, 2, 3, 1) for i in range(3))     # [B, h, C/h, HW]
        attn = (l2_normalize(q) @ l2_normalize(k).transpose(-2, -1)) * self.temperature
        attn = attn.softmax(dim=-1)
        out = v.transpose(-2, -1) @ attn.transpose(-2, -1)       # (A v)^T: [B, h, HW, C/h]
        out = out.permute(0, 2, 1, 3).reshape(b, h, w, dim).permute(0, 3, 1, 2)
        return self.project_out(out)


class FeedForward(nn.Module):
    """GDFN: a depthwise-convolved gate, exact GELU."""

    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1, groups=hidden * 2,
                                bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u1, u2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(u1) * u2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float):
        super().__init__()
        self.norm1 = BiasFreeLayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = BiasFreeLayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("msid.restormer.mdta"):
            x = x + self.attn(self.norm1(x))
        with annotate("msid.restormer.gdfn"):
            return x + self.ffn(self.norm2(x))


def level(dim: int, heads: int, blocks: int, ffn_expansion_factor: float) -> nn.Sequential:
    return nn.Sequential(*(TransformerBlock(dim, heads, ffn_expansion_factor)
                           for _ in range(blocks)))


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(dim, dim // 2, 3, padding=1, bias=False),
                                  nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channels_last(self.body(x))


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(dim, dim * 2, 3, padding=1, bias=False),
                                  nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channels_last(self.body(x))


class RestormerRestoration(nn.Module):
    """Restormer as a restorer of the port: NHWC model-range tiles in and
    out, ``in_channels`` bands each way, any side that is a multiple of 8.
    The defaults are the release's preset (``Restormer()``) at 13 bands."""

    def __init__(self, in_channels: int = 13, out_channels: int = 13, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66):
        super().__init__()
        if out_channels != in_channels:
            raise ValueError("Restormer's global residual needs out_channels == in_channels, "
                             f"got {out_channels} != {in_channels}")
        if len(num_blocks) != 4 or len(heads) != 4:
            raise ValueError(f"Restormer has four levels, got num_blocks {num_blocks} and "
                             f"heads {heads}")
        self.in_channels = in_channels
        self.dtype = torch.float32
        ffn = ffn_expansion_factor
        widths = [dim * 2 ** i for i in range(4)]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_channels, dim, 3, padding=1, bias=False)
        self.encoder_level1 = level(widths[0], heads[0], num_blocks[0], ffn)
        self.down1_2 = Downsample(widths[0])
        self.encoder_level2 = level(widths[1], heads[1], num_blocks[1], ffn)
        self.down2_3 = Downsample(widths[1])
        self.encoder_level3 = level(widths[2], heads[2], num_blocks[2], ffn)
        self.down3_4 = Downsample(widths[2])
        self.latent = level(widths[3], heads[3], num_blocks[3], ffn)
        self.up4_3 = Upsample(widths[3])
        self.reduce_chan_level3 = nn.Conv2d(widths[3], widths[2], 1, bias=False)
        self.decoder_level3 = level(widths[2], heads[2], num_blocks[2], ffn)
        self.up3_2 = Upsample(widths[2])
        self.reduce_chan_level2 = nn.Conv2d(widths[2], widths[1], 1, bias=False)
        self.decoder_level2 = level(widths[1], heads[1], num_blocks[1], ffn)
        self.up2_1 = Upsample(widths[1])
        self.decoder_level1 = level(widths[1], heads[0], num_blocks[0], ffn)
        self.refinement = level(widths[1], heads[0], num_refinement_blocks, ffn)
        self.output = nn.Conv2d(widths[1], out_channels, 3, padding=1, bias=False)

    def set_compute_dtype(self, dtype: torch.dtype) -> "RestormerRestoration":
        """Cast every parameter (convs, norm scales, temperatures) to ``dtype``."""
        self.to(dtype)
        self.dtype = dtype
        return self

    def compute_dtype(self, device_type: str) -> torch.dtype:
        """The dtype the forward computes in: the autocast dtype when
        autocast is on for ``device_type``, else the weights' dtype."""
        if torch.is_autocast_enabled(device_type):
            return torch.get_autocast_dtype(device_type)
        return self.dtype

    def norm_shapes(self, side: int) -> list[tuple[int, int, int]]:
        """``(C, side, norms)`` of each level's LayerNorms in a forward over
        ``side`` x ``side`` tiles, in the forward's order: two norms a block."""
        levels = ((self.encoder_level1, 1), (self.encoder_level2, 2), (self.encoder_level3, 4),
                  (self.latent, 8), (self.decoder_level3, 4), (self.decoder_level2, 2),
                  (self.decoder_level1, 1), (self.refinement, 1))
        return [(blocks[0].norm1.weight.shape[0], side // scale, 2 * len(blocks))
                for blocks, scale in levels]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % SIDE_MULTIPLE or w % SIDE_MULTIPLE:
            raise ValueError(f"Restormer takes sides that are multiples of {SIDE_MULTIPLE}, "
                             f"got {h}x{w}")
        if c != self.in_channels:
            raise ValueError(f"expected {self.in_channels} bands, got {c}")
        with exact_fp32(self.compute_dtype(x.device.type)):
            return self._forward(channels_last(x.permute(0, 3, 1, 2)))

    @staticmethod
    def _level(blocks: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        with annotate("msid.restormer.level"):
            return blocks(x)

    def _forward(self, inp: torch.Tensor) -> torch.Tensor:
        enc1 = self._level(self.encoder_level1, self.patch_embed.proj(inp))
        enc2 = self._level(self.encoder_level2, self.down1_2(enc1))
        enc3 = self._level(self.encoder_level3, self.down2_3(enc2))
        latent = self._level(self.latent, self.down3_4(enc3))
        dec3 = self.reduce_chan_level3(torch.cat([self.up4_3(latent), enc3], dim=1))
        dec3 = self._level(self.decoder_level3, dec3)
        dec2 = self.reduce_chan_level2(torch.cat([self.up3_2(dec3), enc2], dim=1))
        dec2 = self._level(self.decoder_level2, dec2)
        dec1 = self._level(self.decoder_level1, torch.cat([self.up2_1(dec2), enc1], dim=1))
        out = self.output(self._level(self.refinement, dec1)) + inp
        return out.permute(0, 2, 3, 1)                          # NHWC

    @classmethod
    def from_config(cls, config: dict, dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda") -> "RestormerRestoration":
        """Build from the YAML schema's ``model:`` section (``encoder``:
        ``input_channels``, ``dim``, ``num_blocks``, ``heads``,
        ``ffn_expansion_factor``; ``decoder``: ``output_channels``,
        ``num_refinement_blocks``; the constructor's defaults where a key is
        missing) on ``device``, computing in ``dtype``. The release's bias
        and WithBias options are not the port's: a configuration that asks
        for them raises."""
        device = resolve_device(device)
        enc, dec = config["model"]["encoder"], config["model"]["decoder"]
        if enc.get("bias", False) or enc.get("layer_norm_type", "BiasFree") != "BiasFree":
            raise ValueError("the port's Restormer is the release's denoising form: no "
                             "biases and the BiasFree LayerNorm")
        sizes = {k: enc[k] for k in ("dim", "num_blocks", "heads", "ffn_expansion_factor")
                 if k in enc}
        if "num_refinement_blocks" in dec:
            sizes["num_refinement_blocks"] = dec["num_refinement_blocks"]
        model = cls(in_channels=int(enc.get("input_channels", 13)),
                    out_channels=int(dec.get("output_channels", 13)), **sizes)
        return model.set_compute_dtype(dtype).to(device)
