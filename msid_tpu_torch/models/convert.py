"""Pretrained SatMAE (torch) -> the port's encoder: counterpart of
``msid_tpu/models/convert.py``.

The reference's pretrained-weight adaptation, as a conversion of the
checkpoint's state dict into the port's ``SatMAEEncoder`` state dict:

  * patch-embed channel inflation 3 -> 13: RGB kept in bands 0-2, bands
    3-12 copy channel 0;
  * position embedding: the CLS token stripped when the checkpoint has
    exactly one extra token, else the grid resampled by bicubic
    interpolation (:func:`adapt_pos_embed`);
  * a non-strict load: a tensor whose shape still mismatches is skipped and
    logged, and keeps its initialization (as does the patch embed's
    LayerNorm, which the torch SatMAE lacks).

Layouts: the checkpoint's fused ``attn.qkv`` ``[3D, D]`` splits by rows
into the query, key and value weights, and ``attn.proj`` is the output
projection; every other tensor keeps its name and layout (the port's
modules are torch's). The JAX package reshapes into flax's head axes
instead; the weights the two make are the same.

The bicubic resampling is ``jax.image.resize(method="bicubic",
antialias=False)``'s, not ``F.interpolate``'s: the Keys kernel with a =
-0.5 (torch uses -0.75), half-pixel centres, and at the edges the taps
that fall outside the grid dropped and the rest renormalized (torch
clamps to the edge). It is written out here as separable weight matrices.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def load_torch_checkpoint(path: str | Path) -> Dict[str, np.ndarray]:
    """A SatMAE checkpoint as a flat ``{name: numpy array}`` dict: a ``.pth``
    holding a raw state dict or one nested under ``model`` / ``state_dict``
    (the reference's formats), or an ``.npz`` of the same names."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach().cpu().float().numpy() for k, v in ckpt.items()
            if isinstance(v, torch.Tensor)}


def inflate_patch_embed(weight: np.ndarray, target_channels: int) -> np.ndarray:
    """3 -> ``target_channels`` channel inflation of an ``[O, I, kH, kW]``
    patch-embed weight: the first (up to) 3 channels kept, every further
    one a copy of channel 0."""
    o, i, kh, kw = weight.shape
    if i == target_channels:
        return weight
    new = np.zeros((o, target_channels, kh, kw), weight.dtype)
    keep = min(i, 3)
    new[:, :keep] = weight[:, :keep]
    for c in range(keep, target_channels):
        new[:, c] = weight[:, 0]
    return new


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic convolution kernel with a = -0.5, in x's dtype."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near)).astype(x.dtype)


def bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """``[dst, src]`` weights of ``jax.image.resize(method="bicubic",
    antialias=False)`` along one axis, in its float32 arithmetic:
    half-pixel sample positions, the kernel unscaled, each row's taps
    renormalized to sum to 1."""
    f32 = np.float32
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * (f32(1.0) / f32(dst / src)) - f32(0.5)
    w = _keys_cubic(sample[:, None] - np.arange(src, dtype=f32)[None, :])
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[:, None], w, f32(0.0))


def adapt_pos_embed(pos: np.ndarray, target_tokens: int) -> np.ndarray:
    """``[1, N(+1), D]`` -> ``[1, target_tokens, D]``: as it is, the CLS token
    stripped, or the (CLS-less) square grid resampled bicubically."""
    n = pos.shape[1]
    if n == target_tokens:
        return pos
    if n == target_tokens + 1:
        return pos[:, 1:, :]
    has_cls = int(np.sqrt(n)) ** 2 != n
    grid_pos = pos[:, 1:, :] if has_cls else pos
    src = int(np.sqrt(grid_pos.shape[1]))
    dst = int(np.sqrt(target_tokens))
    m = bicubic_matrix(src, dst)
    grid = grid_pos.reshape(src, src, -1).astype(np.float64)
    out = np.einsum("ij,jkd,lk->ild", m, grid, m)
    return out.reshape(1, dst * dst, -1).astype(pos.dtype)


def convert_satmae_encoder(state_dict: Dict[str, np.ndarray],
                           target: Dict[str, torch.Tensor],
                           target_channels: int = 13) -> dict:
    """A new encoder state dict (``SatMAEEncoder.state_dict()`` names) from a
    torch SatMAE state dict. ``target`` is the encoder's own state dict: it
    gives the shapes, and everything the checkpoint lacks or has in another
    shape keeps its value from it (shape mismatches are logged)."""
    out = {k: v.detach().clone() for k, v in target.items()}
    loaded, skipped = [], []

    def put(name: str, value: np.ndarray, source: str) -> None:
        want = tuple(out[name].shape)
        if tuple(value.shape) != want:
            skipped.append((source, tuple(value.shape), want))
            return
        out[name] = torch.from_numpy(np.ascontiguousarray(value, np.float32)).to(
            out[name].device, out[name].dtype)
        loaded.append(source)

    if "patch_embed.proj.weight" in state_dict:
        put("patch_embed.proj.weight",
            inflate_patch_embed(state_dict["patch_embed.proj.weight"], target_channels),
            "patch_embed.proj.weight")
    if "patch_embed.proj.bias" in state_dict:
        put("patch_embed.proj.bias", state_dict["patch_embed.proj.bias"],
            "patch_embed.proj.bias")
    if "pos_embed" in state_dict:
        put("pos_embed", adapt_pos_embed(state_dict["pos_embed"], out["pos_embed"].shape[1]),
            "pos_embed")

    depth = len({k.split(".")[1] for k in out if k.startswith("blocks.")})
    for i in range(depth):
        pre = f"blocks.{i}."
        if pre + "norm1.weight" not in state_dict:
            continue
        for name in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                     "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"):
            put(pre + name, state_dict[pre + name], pre + name)
        qkv_w = state_dict[pre + "attn.qkv.weight"]            # [3D, D]
        qkv_b = state_dict.get(pre + "attn.qkv.bias")
        d = qkv_w.shape[1]
        for j, proj in enumerate(("query", "key", "value")):
            put(f"{pre}attn.{proj}.weight", qkv_w[j * d:(j + 1) * d],
                f"{pre}attn.qkv.weight[{proj}]")
            if qkv_b is not None:
                put(f"{pre}attn.{proj}.bias", qkv_b[j * d:(j + 1) * d],
                    f"{pre}attn.qkv.bias[{proj}]")
        put(pre + "attn.out.weight", state_dict[pre + "attn.proj.weight"],
            pre + "attn.proj.weight")
        if pre + "attn.proj.bias" in state_dict:
            put(pre + "attn.out.bias", state_dict[pre + "attn.proj.bias"],
                pre + "attn.proj.bias")

    if "norm.weight" in state_dict:
        put("norm.weight", state_dict["norm.weight"], "norm.weight")
        put("norm.bias", state_dict["norm.bias"], "norm.bias")

    logger.info("Converted %d tensors (%d skipped on shape mismatch)", len(loaded),
                len(skipped))
    for name, got, want in skipped:
        logger.warning("skipped %s: %s vs %s", name, got, want)
    return out


def load_pretrained_encoder(path: str | Path, model: nn.Module,
                            target_channels: int = 13) -> nn.Module:
    """Load a SatMAE checkpoint (``.pth`` or ``.npz``) into ``model.encoder``
    in place, through :func:`convert_satmae_encoder`; returns the model."""
    converted = convert_satmae_encoder(load_torch_checkpoint(path),
                                       model.encoder.state_dict(), target_channels)
    model.encoder.load_state_dict(converted)
    return model
