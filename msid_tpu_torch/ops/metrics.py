"""Restoration metrics (PyTorch): counterpart of ``msid_tpu/ops/metrics.py``.

PSNR / SSIM / SAM / RMSE / MAE at data_range 6.0, each with a
``*_per_sample`` form returning fp32 ``[B]``. ``batch_metric_sums`` sums
the per-sample metrics of a batch on the device (optionally weighted by a
``mask`` that zeroes padded samples), and ``MetricsTracker`` accumulates
those sums with one host transfer at ``compute()``. fp32 throughout, with
autocast off. NHWC in.
"""

from __future__ import annotations

import math

import torch

from msid_tpu_torch.ops.ssim import DEFAULT_DATA_RANGE, ssim, ssim_per_sample

_LN10 = 2.302585092994046


def _diff(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return pred.float() - target.float()


def mse_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = _diff(pred, target).reshape(pred.shape[0], -1)
    return torch.mean(d * d, dim=-1)


def psnr_per_sample(pred: torch.Tensor, target: torch.Tensor,
                    data_range: float = DEFAULT_DATA_RANGE) -> torch.Tensor:
    """Per-sample PSNR in dB: 10 log10(range^2 / MSE)."""
    mse = mse_per_sample(pred, target)
    return 10.0 * (torch.log(data_range ** 2 / torch.clamp(mse, min=1e-20)) / _LN10)


def calculate_psnr(pred: torch.Tensor, target: torch.Tensor,
                   data_range: float = DEFAULT_DATA_RANGE) -> torch.Tensor:
    """PSNR of one MSE over every element of the batch."""
    d = _diff(pred, target)
    mse = torch.mean(d * d)
    return 10.0 * (torch.log(data_range ** 2 / torch.clamp(mse, min=1e-20)) / _LN10)


def calculate_ssim(pred: torch.Tensor, target: torch.Tensor,
                   data_range: float = DEFAULT_DATA_RANGE) -> torch.Tensor:
    return ssim(pred, target, data_range)


def _cos_angle(pred: torch.Tensor, target: torch.Tensor, epsilon: float) -> torch.Tensor:
    p, t = pred.float(), target.float()
    dot = torch.sum(p * t, dim=-1)
    p_norm = torch.sqrt(torch.sum(p * p, dim=-1)) + epsilon
    t_norm = torch.sqrt(torch.sum(t * t, dim=-1)) + epsilon
    return torch.clamp(dot / (p_norm * t_norm), -1.0, 1.0)


def sam_per_sample(pred: torch.Tensor, target: torch.Tensor,
                   epsilon: float = 1e-8) -> torch.Tensor:
    """Per-sample mean spectral angle in degrees (arccos form), fp32 [B]."""
    angle = torch.arccos(_cos_angle(pred, target, epsilon)) * (180.0 / math.pi)
    return torch.mean(angle, dim=(1, 2))


def calculate_sam(pred: torch.Tensor, target: torch.Tensor,
                  epsilon: float = 1e-8) -> torch.Tensor:
    """Mean spectral angle in degrees over every pixel of the batch."""
    return torch.mean(torch.arccos(_cos_angle(pred, target, epsilon)) * (180.0 / math.pi))


def rmse_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mse_per_sample(pred, target))


def calculate_rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = _diff(pred, target)
    return torch.sqrt(torch.mean(d * d))


def mae_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_diff(pred, target)).reshape(pred.shape[0], -1), dim=-1)


def calculate_mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_diff(pred, target)))


def batch_metric_sums(pred: torch.Tensor, target: torch.Tensor,
                      data_range: float = DEFAULT_DATA_RANGE,
                      mask: torch.Tensor | None = None) -> dict:
    """Per-sample PSNR/SSIM/SAM/RMSE summed over the batch, as fp32 device
    scalars, plus ``count``. ``mask`` (fp32 [B]) weights each sample: 0 for
    the padding of a padded trailing batch; ``count`` is then its sum."""
    with torch.autocast(pred.device.type, enabled=False):
        if mask is None:
            def weigh(v):
                return torch.sum(v)
            count = torch.tensor(float(pred.shape[0]), device=pred.device)
        else:
            mask = mask.float()

            def weigh(v):
                return torch.sum(v * mask)
            count = torch.sum(mask)
        return {
            "psnr": weigh(psnr_per_sample(pred, target, data_range)),
            "ssim": weigh(ssim_per_sample(pred, target, data_range)),
            "sam": weigh(sam_per_sample(pred, target)),
            "rmse": weigh(rmse_per_sample(pred, target)),
            "count": count,
        }


class MetricsTracker:
    """Accumulates metric sums on the device; one host transfer at
    ``compute()``."""

    def __init__(self, data_range: float = DEFAULT_DATA_RANGE):
        self.data_range = data_range
        self.reset()

    def reset(self) -> None:
        self._sums = None

    def update(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        sums = batch_metric_sums(pred, target, self.data_range)
        if self._sums is None:
            self._sums = sums
        else:
            self._sums = {k: self._sums[k] + v for k, v in sums.items()}

    def compute(self) -> dict:
        if self._sums is None:
            return {"psnr": 0.0, "ssim": 0.0, "sam": 0.0, "rmse": 0.0}
        host = {k: float(v) for k, v in self._sums.items()}
        count = max(host["count"], 1.0)
        return {k: host[k] / count for k in ("psnr", "ssim", "sam", "rmse")}

    def __repr__(self) -> str:
        m = self.compute()
        return (f"PSNR: {m['psnr']:.2f} dB, SSIM: {m['ssim']:.4f}, "
                f"SAM: {m['sam']:.2f}°, RMSE: {m['rmse']:.4f}")
