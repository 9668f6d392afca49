"""SatMAE ViT encoder (PyTorch): counterpart of ``msid_tpu/models/encoder.py``.

13-band patch embed (16x16/16 conv + LayerNorm), learnable position
embedding without a CLS token, pre-LN transformer blocks (qkv bias, LN eps
1e-6, tanh GELU), final LayerNorm. Attention is written out as flax
computes it: q/k/v projections, ``softmax(q k^T / sqrt(d)) v``, output
projection. At 144 tokens a fused attention kernel has nothing to gain.

With ``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` in train mode (the JAX encoder's ``nn.remat``):
only the block boundaries are kept for the backward. The blocks hold no
BatchNorm, so recomputing them updates no running statistics twice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6


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
    def __init__(self, features: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(features, hidden)
        self.fc2 = nn.Linear(hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


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

        q = heads(self.query(x)) / math.sqrt(hd)
        k = heads(self.key(x))
        v = heads(self.value(x))
        weights = torch.softmax((q @ k.transpose(-2, -1)).float(), dim=-1)
        y = weights.to(v.dtype) @ v                                  # [B,H,N,hd]
        return self.out(y.transpose(1, 2).reshape(b, n, d))


class ViTBlock(nn.Module):
    """Pre-LN transformer block: x + MHSA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim: int = 768, num_heads: int = 12, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio))

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
        remat = self.gradient_checkpointing and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            y = checkpoint(block, y, use_reentrant=False) if remat else block(y)
        return self.norm(y)
