"""Windowed SSIM as a depthwise convolution (PyTorch, NHWC in).

Counterpart of ``msid_tpu/ops/ssim.py``: 11x11 Gaussian window, sigma 1.5,
zero 'SAME' padding (not crop-to-valid), C1/C2 from data_range 6.0. All
statistics are fp32 whatever the input dtype, with autocast off: the
variance terms E[x^2] - E[x]^2 cancel catastrophically in bf16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_DATA_RANGE = 6.0
DEFAULT_WINDOW_SIZE = 11
DEFAULT_SIGMA = 1.5


@functools.lru_cache(maxsize=8)
def _gaussian_window_1d(window_size: int, sigma: float) -> tuple:
    """1-D Gaussian taps normalized to sum 1, rounded to fp32."""
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


def gaussian_window(window_size: int = DEFAULT_WINDOW_SIZE,
                    sigma: float = DEFAULT_SIGMA,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """``[window, window]`` outer product of the 1-D taps (fp32)."""
    g1 = torch.tensor(_gaussian_window_1d(window_size, sigma), dtype=torch.float32,
                      device=device)
    return torch.outer(g1, g1)


@functools.lru_cache(maxsize=8)
def _window(window_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``gaussian_window`` made once a device and kept: read, never written,
    so a train step captured as a CUDA graph makes no host-to-device copy."""
    return gaussian_window(window_size, sigma, device)


def depthwise_filter(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise zero-padded 'SAME' filter of an NCHW fp32 tensor."""
    c = x.shape[1]
    k = window.shape[0]
    kernel = window[None, None].expand(c, 1, k, k)
    with torch.autocast(x.device.type, enabled=False):
        return F.conv2d(x.float(), kernel, padding=k // 2, groups=c)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             data_range: float = DEFAULT_DATA_RANGE,
             window_size: int = DEFAULT_WINDOW_SIZE,
             sigma: float = DEFAULT_SIGMA) -> torch.Tensor:
    """Per-pixel, per-band SSIM of two NHWC batches: fp32 ``[B, H, W, C]``."""
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    window = _window(window_size, sigma, x.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu1 = depthwise_filter(x, window)
    mu2 = depthwise_filter(y, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = depthwise_filter(x * x, window) - mu1_sq
    sigma2_sq = depthwise_filter(y * y, window) - mu2_sq
    sigma12 = depthwise_filter(x * y, window) - mu1_mu2
    numerator = (2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)
    denominator = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return (numerator / denominator).permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = DEFAULT_DATA_RANGE,
         window_size: int = DEFAULT_WINDOW_SIZE,
         sigma: float = DEFAULT_SIGMA) -> torch.Tensor:
    """Scalar mean SSIM over the whole batch."""
    return torch.mean(ssim_map(img1, img2, data_range, window_size, sigma))


def ssim_per_sample(img1: torch.Tensor, img2: torch.Tensor,
                    data_range: float = DEFAULT_DATA_RANGE,
                    window_size: int = DEFAULT_WINDOW_SIZE,
                    sigma: float = DEFAULT_SIGMA) -> torch.Tensor:
    """Per-sample mean SSIM, fp32 ``[B]``."""
    return torch.mean(ssim_map(img1, img2, data_range, window_size, sigma), dim=(1, 2, 3))
