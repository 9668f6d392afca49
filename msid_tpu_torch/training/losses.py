"""Restoration losses (PyTorch): counterpart of ``msid_tpu/training/losses.py``.

``combined_loss`` = mse_weight * MSE + ssim_weight * (1 - SSIM)
[+ sam_weight * SAM] [+ perceptual_weight * Sobel-edge MSE], with its exact
per-sample decomposition ``combined_loss_per_sample`` for the masked eval
step. Every term is computed in fp32 with autocast off, whatever the dtype
of ``pred``. The VGG16 perceptual loss (``training/perceptual.py`` of the
JAX package) is not ported yet: it needs weights from a user file.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import torch
import torch.nn.functional as F

from msid_tpu_torch.ops.ssim import DEFAULT_DATA_RANGE, ssim, ssim_per_sample

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    mse_weight: float = 1.0
    ssim_weight: float = 0.1
    perceptual_weight: float = 0.0
    sam_weight: float = 0.0
    data_range: float = DEFAULT_DATA_RANGE

    @classmethod
    def from_config(cls, config: dict) -> "LossConfig":
        loss = config.get("training", {}).get("loss", {})
        return cls(
            mse_weight=float(loss.get("mse_weight", 1.0)),
            ssim_weight=float(loss.get("ssim_weight", 0.1)),
            perceptual_weight=float(loss.get("perceptual_weight", 0.0)),
            sam_weight=float(loss.get("sam_weight", 0.0)),
        )


def resolve_perceptual(loss_config: dict) -> str:
    """The perceptual loss a ``training.loss`` section asks for, as the
    reference's ``resolve_perceptual`` decides it: ``"edge"`` (the Sobel
    stand-in) unless ``perceptual_impl: vgg``; ``vgg`` without a weights file
    warns and falls back to ``"edge"``; an unknown name raises
    ``ValueError``. VGG with a weights file raises ``NotImplementedError``:
    the VGG16 loss (training/perceptual.py) is not ported yet."""
    impl = str(loss_config.get("perceptual_impl", "edge")).lower()
    if impl not in ("vgg", "edge"):
        raise ValueError(f"unknown perceptual_impl {impl!r}")
    if impl == "edge":
        return "edge"
    path = loss_config.get("perceptual_weights_path")
    if path and Path(path).exists():
        raise NotImplementedError(
            f"perceptual_impl: vgg with weights {path}: the VGG16 perceptual loss "
            "(training/perceptual.py) is not ported yet")
    logger.warning("perceptual_impl=vgg but no weights at %r — falling back to the "
                   "Sobel edge stand-in", path)
    return "edge"


def refuse_vgg(vgg_params) -> None:
    """Raise if VGG weights are given: the VGG16 loss is not ported yet."""
    if vgg_params is not None:
        raise NotImplementedError(
            "the VGG16 perceptual loss (training/perceptual.py) is not ported "
            "yet; leave vgg_params unset to use the Sobel edge stand-in")


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.float() - target.float()
    return torch.mean(d * d)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor,
              data_range: float = DEFAULT_DATA_RANGE) -> torch.Tensor:
    """1 - mean SSIM."""
    return 1.0 - ssim(pred, target, data_range)


def sam_loss_per_sample(pred: torch.Tensor, target: torch.Tensor,
                        epsilon: float = 1e-8) -> torch.Tensor:
    """Per-sample mean spectral angle in radians, fp32 [B], as
    ``atan2(sin, cos)``: arccos's derivative blows up as cos -> 1, where a
    converging model lives; atan2's stays bounded."""
    p, t = pred.float(), target.float()
    dot = torch.sum(p * t, dim=-1)
    p_sq = torch.sum(p * p, dim=-1)
    t_sq = torch.sum(t * t, dim=-1)
    norm_prod = (torch.sqrt(p_sq) + epsilon) * (torch.sqrt(t_sq) + epsilon)
    cos = dot / norm_prod
    sin_sq = torch.clamp(p_sq * t_sq - dot * dot, min=0.0)
    sin = torch.sqrt(sin_sq + epsilon * epsilon) / norm_prod
    return torch.mean(torch.atan2(sin, cos), dim=(1, 2))


def sam_loss(pred: torch.Tensor, target: torch.Tensor,
             epsilon: float = 1e-8) -> torch.Tensor:
    return torch.mean(sam_loss_per_sample(pred, target, epsilon))


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _edges(x: torch.Tensor) -> torch.Tensor:
    """Depthwise Sobel magnitude of an NHWC fp32 tensor (zero padding)."""
    c = x.shape[-1]
    kx = torch.tensor(_SOBEL_X, dtype=torch.float32, device=x.device) / 8.0
    kernel = torch.stack([kx, kx.T])[:, None].repeat(c, 1, 1, 1)     # [2C,1,3,3]
    g = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=1, groups=c)
    gx, gy = g[:, 0::2], g[:, 1::2]
    return torch.sqrt(gx * gx + gy * gy + 1e-12).permute(0, 2, 3, 1)


def _halve(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def edge_perceptual_loss(pred: torch.Tensor, target: torch.Tensor,
                         scales: int = 3) -> torch.Tensor:
    """Multi-scale Sobel edge-response MSE on the first 3 bands."""
    return torch.mean(_edge_perceptual_per_sample(pred, target, scales))


def _edge_perceptual_per_sample(pred: torch.Tensor, target: torch.Tensor,
                                scales: int = 3) -> torch.Tensor:
    p = pred[..., :3].float()
    t = target[..., :3].float()
    total = torch.zeros(p.shape[0], device=p.device)
    for s in range(scales):
        e = (_edges(p) - _edges(t)).reshape(p.shape[0], -1)
        total = total + torch.mean(e * e, dim=-1)
        if s + 1 < scales:
            p, t = _halve(p), _halve(t)
    return total / scales


def combined_loss_per_sample(pred: torch.Tensor, target: torch.Tensor,
                             cfg: LossConfig = LossConfig(),
                             vgg_params=None) -> torch.Tensor:
    """Per-sample combined loss, fp32 [B]; its mean is ``combined_loss``."""
    refuse_vgg(vgg_params)
    with torch.autocast(pred.device.type, enabled=False):
        p, t = pred.float(), target.float()
        d = (p - t).reshape(p.shape[0], -1)
        total = cfg.mse_weight * torch.mean(d * d, dim=-1)
        if cfg.ssim_weight > 0:
            total = total + cfg.ssim_weight * (1.0 - ssim_per_sample(p, t, cfg.data_range))
        if cfg.sam_weight > 0:
            total = total + cfg.sam_weight * sam_loss_per_sample(p, t)
        if cfg.perceptual_weight > 0:
            total = total + cfg.perceptual_weight * _edge_perceptual_per_sample(p, t)
        return total


def combined_loss(pred: torch.Tensor, target: torch.Tensor,
                  cfg: LossConfig = LossConfig(),
                  vgg_params=None) -> tuple[torch.Tensor, dict]:
    """Weighted MSE + (1 - SSIM) [+ SAM] [+ edge perceptual]; returns
    ``(total, components)`` as fp32 device scalars."""
    refuse_vgg(vgg_params)
    with torch.autocast(pred.device.type, enabled=False):
        p, t = pred.float(), target.float()
        mse = mse_loss(p, t)
        total = cfg.mse_weight * mse
        aux = {"mse": mse}
        if cfg.ssim_weight > 0:
            s = ssim_loss(p, t, cfg.data_range)
            aux["ssim_loss"] = s
            total = total + cfg.ssim_weight * s
        if cfg.sam_weight > 0:
            sa = sam_loss(p, t)
            aux["sam_loss"] = sa
            total = total + cfg.sam_weight * sa
        if cfg.perceptual_weight > 0:
            pe = edge_perceptual_loss(p, t)
            aux["perceptual"] = pe
            total = total + cfg.perceptual_weight * pe
        aux["total"] = total
        return total, aux
