"""Plain reference of sliding-window scene restoration.

Windows of ``window`` pixels at a stride of ``window - overlap`` (the last
one flush with the edge) are cut from the raw scene, preprocessed as the
training tiles are (each window's own range scale, half-pixel bilinear
upsample to the model's size, clamp and affine to model range), restored,
resized back, and blended with a separable raised-cosine weight, then
divided by the summed weight. Everything is float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normalize_raw(x: torch.Tensor) -> torch.Tensor:
    """Per-tile range: max > 10 is Sentinel-2 DN (/10000), max > 1.5 is
    8-bit (/255), else reflectance already."""
    x = x.float()
    m = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    return x * torch.where(m > 10.0, 1e-4, torch.where(m > 1.5, 1.0 / 255.0, 1.0))


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Half-pixel bilinear resize of an NHWC batch, no antialias."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def preprocess(raw: torch.Tensor, size: int) -> torch.Tensor:
    return (torch.clamp(resize(normalize_raw(raw), size), 0.0, 1.0) - 0.5) * 4.0


def blend_weights(window: int, overlap: int) -> np.ndarray:
    w = np.ones(window, np.float64)
    n = max(1, overlap)
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(n) + 0.5) / n)
    w[:n] = ramp
    w[-n:] = ramp[::-1]
    return np.outer(w, w).astype(np.float32)


def origins(size: int, window: int, stride: int) -> list:
    if size <= window:
        return [0]
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return starts


def windows_of(shape, window: int, overlap: int) -> list:
    h, w = shape[:2]
    stride = window - overlap
    return [(y, x) for y in origins(h, window, stride) for x in origins(w, window, stride)]


@torch.no_grad()
def restore(forward, scene: np.ndarray, window: int, overlap: int, model_size: int,
            batch: int, device: torch.device) -> np.ndarray:
    """The restored ``[H, W, C]`` float32 scene (model range); ``forward``
    maps model-range ``[B, S, S, C]`` float32 tiles to the restored ones."""
    h, w, c = scene.shape
    if h < window or w < window:
        raise ValueError("the reference takes scenes of at least one window")
    src = torch.from_numpy(scene.astype(np.float32)).to(device)
    weight = torch.from_numpy(blend_weights(window, overlap)).to(device)[:, :, None]
    out = torch.zeros((h, w, c), dtype=torch.float32, device=device)
    total = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
    at = windows_of(scene.shape, window, overlap)
    for i in range(0, len(at), batch):
        chunk = at[i:i + batch]
        raw = torch.stack([src[y:y + window, x:x + window] for y, x in chunk])
        tiles = resize(forward(preprocess(raw, model_size)).float(), window)
        for tile, (y, x) in zip(tiles, chunk):
            out[y:y + window, x:x + window] += tile * weight
            total[y:y + window, x:x + window] += weight
    return (out / total).cpu().numpy()
