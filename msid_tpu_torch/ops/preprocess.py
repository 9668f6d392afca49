"""Device preprocessing (PyTorch): raw 64x64x13 tiles -> model-range 192x192x13.

Counterpart of ``msid_tpu/ops/preprocess.py``. The host ships raw NHWC
tiles; range scaling, the half-pixel bilinear upsample (no antialias, as
``jax.image.resize(..., antialias=False)`` upsamples) and the affine to
about [-2, 2] run on the device. NHWC in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normalize_raw(x: torch.Tensor) -> torch.Tensor:
    """Per-image range heuristic: max > 10 -> /10000 (Sentinel-2 DN),
    max > 1.5 -> /255, else unchanged. The max is taken per image over the
    last three axes (H, W, C), so a mixed-scale batch keeps each tile's
    own scale."""
    x = x.float()
    if x.dim() < 3:
        raise ValueError(f"normalize_raw expects [..., H, W, C] (got shape {tuple(x.shape)})")
    m = torch.amax(x, dim=(-3, -2, -1), keepdim=True)
    scale = torch.where(m > 10.0, 1.0 / 10000.0, torch.where(m > 1.5, 1.0 / 255.0, 1.0))
    return x * scale


def resize_bilinear(x: torch.Tensor, target_size: int) -> torch.Tensor:
    """Half-pixel bilinear resize of an NHWC batch, no antialias."""
    b, h, w, c = x.shape
    if h == target_size and w == target_size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(target_size, target_size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """clamp [0, 1] then (x - 0.5) * 4 -> about [-2, 2]."""
    return (torch.clamp(x, 0.0, 1.0) - 0.5) * 4.0


def preprocess_tiles(x: torch.Tensor, target_size: int = 192) -> torch.Tensor:
    """Raw NHWC tiles (any real dtype) -> fp32 ``[B, target, target, C]``
    in model range: scale, resize, affine."""
    return to_model_range(resize_bilinear(normalize_raw(x), target_size))


def from_model_range(x: torch.Tensor) -> torch.Tensor:
    """Inverse affine back to [0, 1] reflectance."""
    return torch.clamp(x.float() * 0.25 + 0.5, 0.0, 1.0)


def random_band_permutation(x: torch.Tensor, prob: float,
                            generator: torch.Generator, sample_offset: int = 0,
                            global_batch: int | None = None) -> torch.Tensor:
    """Permute the band axis of each sample with probability ``prob``
    (spectral augmentation). The gates and permutations are drawn from
    ``generator`` on its own device and moved to x's. ``x`` is rows
    ``[sample_offset, sample_offset + B)`` of a batch of ``global_batch``
    (default: the whole batch): the draws are the whole batch's, and x
    takes its rows of them."""
    b, _, _, c = x.shape
    n = b if global_batch is None else int(global_batch)
    if not 0 <= sample_offset <= n - b:
        raise ValueError(f"rows [{sample_offset}, {sample_offset + b}) are not in a "
                         f"batch of {n}")
    device = generator.device
    gate = torch.rand(n, generator=generator, device=device) < prob
    perms = torch.stack([torch.randperm(c, generator=generator, device=device)
                         for _ in range(n)])
    identity = torch.arange(c, device=device)
    rows = slice(sample_offset, sample_offset + b)
    idx = torch.where(gate[rows, None], perms[rows], identity[None, :]).to(x.device)
    return torch.take_along_dim(x, idx[:, None, None, :].expand_as(x), dim=3)


def normalize_spectral(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-band standardization; mean and std are [C]."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device).reshape(1, 1, 1, -1)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device).reshape(1, 1, 1, -1)
    return (x.float() - mean) / torch.clamp(std, min=1e-8)


def denormalize_spectral(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Inverse of ``normalize_spectral``."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device).reshape(1, 1, 1, -1)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device).reshape(1, 1, 1, -1)
    return x.float() * std + mean
