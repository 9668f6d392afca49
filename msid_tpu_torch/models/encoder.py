"""SatMAE ViT encoder (PyTorch): counterpart of ``msid_tpu/models/encoder.py``.

``SatMAEEncoder``: 13-band patch embed (16x16/16 conv + LayerNorm),
learnable position embedding without a CLS token, pre-LN transformer blocks
(qkv bias, LN eps 1e-6, tanh GELU), final LayerNorm.

``SatMAEGroupEncoder``: SatMAE's group-channel ViT (Cong et al., NeurIPS
2022, arXiv:2207.08051 §3.3; ``models_vit_group_channels.py`` of the code
release). Each group of bands has its own patch embed (a conv, no norm);
the tokens are laid out group-major, ``[B, G*L, D]``, each given a 2-D
sin-cos position embedding of ``D - C_e`` features concatenated with a 1-D
sin-cos embedding of its group (``C_e`` features), both trainable; the
blocks (exact GELU) attend over all ``G*L`` tokens, across space and
across groups. The restorer has no head that reads a CLS token, so there
is none.

Attention in both: q/k/v projections, ``softmax(q k^T / sqrt(hd)) v``
(``attend``), output projection. On the card it is
``F.scaled_dot_product_attention``, on the H100 cuDNN's fused flash kernel
(softmax statistics in fp32, no score matrix in memory): a layer of 64
tiles takes 0.048 ms at 144 tokens and 12 heads and 0.20 ms at 432 tokens
and 16 heads, where the unfused fp32 scores, softmax and casts took 0.28
and 2.23 ms (``PERF.md``). On the CPU it stays unfused, as flax computes it.

With ``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` in train mode (the JAX encoder's ``nn.remat``):
only the block boundaries are kept for the backward. The blocks hold no
BatchNorm, so recomputing them updates no running statistics twice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from msid_tpu_torch.utils.profiling import annotate

LN_EPS = 1e-6

# SatMAE's published band groups (``--dropped_bands 0 9 10``) as indices
# into the 13 bands B1, B2, B3, B4, B5, B6, B7, B8, B8A, B9, B10, B11, B12:
# (B2, B3, B4, B8), (B5, B6, B7, B8A), (B11, B12).
SATMAE_CHANNEL_GROUPS = ((1, 2, 3, 7), (4, 5, 6, 8), (11, 12))


class PatchEmbed(nn.Module):
    """Conv(patch, stride=patch) -> flatten -> LayerNorm."""

    def __init__(self, in_channels: int = 13, embed_dim: int = 768,
                 patch_size: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)                       # [B, D, H/p, W/p]
        y = y.flatten(2).transpose(1, 2)       # [B, N, D], row-major grid
        return self.norm(y)


class MlpBlock(nn.Module):
    """fc1 -> GELU -> fc2; ``gelu`` is ``F.gelu``'s ``approximate``: "tanh"
    (flax's default, the SatMAE ViT-Base port's) or "none" (exact)."""

    def __init__(self, features: int, hidden: int, gelu: str = "tanh"):
        super().__init__()
        self.gelu = gelu
        self.fc1 = nn.Linear(features, hidden)
        self.fc2 = nn.Linear(hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.gelu))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(hd)) v`` over ``[B, H, N, hd]`` heads. On the
    card, the fused kernel of ``F.scaled_dot_product_attention``; elsewhere
    as flax writes it (scaled q, the scores' softmax in fp32, cast, product),
    the arithmetic the CPU tests hold against the JAX package and against
    one another to fp32 rounding."""
    if q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    scores = (q / math.sqrt(q.shape[-1])) @ k.transpose(-2, -1)
    return torch.softmax(scores.float(), dim=-1).to(v.dtype) @ v


class MultiHeadAttention(nn.Module):
    """Self-attention in flax ``MultiHeadDotProductAttention``'s form."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.view(b, n, self.num_heads, hd).transpose(1, 2)  # [B,H,N,hd]

        y = attend(heads(self.query(x)), heads(self.key(x)), heads(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(b, n, d))


class ViTBlock(nn.Module):
    """Pre-LN transformer block: x + MHSA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim: int = 768, num_heads: int = 12, mlp_ratio: float = 4.0,
                 gelu: str = "tanh"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class SatMAEEncoder(nn.Module):
    """ViT encoder over 13-band tiles -> [B, N, D] patch features."""

    def __init__(self, image_size: int = 192, patch_size: int = 16,
                 in_channels: int = 13, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 gradient_checkpointing: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.gradient_checkpointing = gradient_checkpointing
        self.num_patches = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size)
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, self.num_patches, embed_dim), std=0.02))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: NCHW tile. ``cond`` ([B, embed_dim], optional) is added to every
        token after the position embedding (the dead-band mask condition)."""
        y = self.patch_embed(x)
        y = y + self.pos_embed.to(y.dtype)
        if cond is not None:
            y = y + cond[:, None, :].to(y.dtype)
        return _blocks_and_norm(self, y)


def _blocks_and_norm(encoder: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """The encoder's blocks (each under ``checkpoint`` when it is set and
    the encoder trains) and its final LayerNorm."""
    remat = encoder.gradient_checkpointing and encoder.training and torch.is_grad_enabled()
    for block in encoder.blocks:
        y = checkpoint(block, y, use_reentrant=False) if remat else block(y)
    return encoder.norm(y)


def sincos_1d(dim: int, positions) -> np.ndarray:
    """MAE's ``get_1d_sincos_pos_embed_from_grid``: ``[M, dim]``, the sines
    of ``pos * 10000^(-2i/dim)`` for ``i < dim/2``, then their cosines."""
    if dim % 2:
        raise ValueError(f"a sin-cos embedding needs an even width, got {dim}")
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.outer(np.asarray(positions, np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, grid: int) -> np.ndarray:
    """MAE's ``get_2d_sincos_pos_embed`` (no CLS row): ``[grid*grid, dim]``
    over the row-major grid, the first half embedding each token's column
    and the second its row (MAE's ``meshgrid(w, h)`` order)."""
    if dim % 4:
        raise ValueError(f"a 2-D sin-cos embedding needs a width divisible by 4, got {dim}")
    rows, cols = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    return np.concatenate([sincos_1d(dim // 2, cols), sincos_1d(dim // 2, rows)], axis=1)


class _GroupPatchEmbed(nn.Module):
    """One group's patch embed: Conv(patch, stride=patch), no norm."""

    def __init__(self, bands: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(bands, embed_dim, patch_size, stride=patch_size)


class SatMAEGroupEncoder(nn.Module):
    """SatMAE's group-channel ViT over 13-band tiles -> ``[B, G*L, D]``
    tokens, group-major. ``channel_groups`` lists each group's band indices
    into the input's bands; bands in no group reach no token."""

    def __init__(self, image_size: int = 96, patch_size: int = 8,
                 channel_groups: Sequence[Sequence[int]] = SATMAE_CHANNEL_GROUPS,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, channel_embed: int = 256,
                 gradient_checkpointing: bool = False):
        super().__init__()
        if not 0 < channel_embed < embed_dim:
            raise ValueError(f"channel_embed must lie in (0, {embed_dim}), got {channel_embed}")
        self.channel_groups = tuple(tuple(int(b) for b in g) for g in channel_groups)
        self.embed_dim = embed_dim
        self.gradient_checkpointing = gradient_checkpointing
        grid = image_size // patch_size
        self.num_patches = grid * grid
        # Every group's bands in group order, gathered by one index_select.
        self.register_buffer("band_order", torch.tensor(
            [b for g in self.channel_groups for b in g], dtype=torch.long), persistent=False)
        self.patch_embed = nn.ModuleList(
            _GroupPatchEmbed(len(g), embed_dim, patch_size) for g in self.channel_groups)
        self.pos_embed = nn.Parameter(torch.from_numpy(
            sincos_2d(embed_dim - channel_embed, grid)).float()[None])
        self.channel_embed = nn.Parameter(torch.from_numpy(
            sincos_1d(channel_embed, np.arange(len(self.channel_groups)))).float()[None])
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, gelu="none") for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def embed(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[B, G*L, D]`` tokens before the blocks: each group's patch
        embed, the position and group embedding, ``cond`` on every token."""
        b = x.shape[0]
        groups, length = len(self.channel_groups), self.num_patches
        bands = x.index_select(1, self.band_order)
        tokens, at = [], 0
        for embed, g in zip(self.patch_embed, self.channel_groups):
            tokens.append(embed.proj(bands[:, at:at + len(g)]).flatten(2).transpose(1, 2))
            at += len(g)
        y = torch.stack(tokens, dim=1)                              # [B, G, L, D]
        pos = torch.cat([self.pos_embed[:, None].expand(-1, groups, -1, -1),
                         self.channel_embed[:, :, None].expand(-1, -1, length, -1)], dim=-1)
        y = (y + pos.to(y.dtype)).reshape(b, groups * length, self.embed_dim)
        if cond is not None:
            y = y + cond[:, None, :].to(y.dtype)
        return y

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: NCHW tile; ``cond`` ([B, embed_dim], optional) as in
        ``SatMAEEncoder``."""
        with annotate("msid.encoder.group_embed"):
            y = self.embed(x, cond)
        return _blocks_and_norm(self, y)
