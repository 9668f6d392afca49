"""Dead-band detection and cross-band linear fill (PyTorch).

Counterpart of ``msid_tpu/ops/fill.py``. A killed band holds only
thermal noise (per-sample spatial RMS well below 0.05 in model space); it
is replaced by the best linear prediction from the surviving bands under a
shared ``[C+1, C+1]`` second-moment (Gram) matrix. All arithmetic is fp32;
the per-sample solves are one batched ``torch.linalg.solve_ex`` (no host
sync on a CUDA tensor). ``fit_gram`` fits the Gram matrix over a train
loader before training.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_RMS_THRESH = 0.05
RIDGE = 1e-6


def detect_alive(x: torch.Tensor, rms_thresh: float = DEFAULT_RMS_THRESH) -> torch.Tensor:
    """fp32 ``[B, 1, 1, C]`` mask of surviving bands of an NHWC batch."""
    x32 = x.float()
    rms = torch.sqrt(torch.mean(x32 * x32, dim=(1, 2), keepdim=True))
    return (rms >= rms_thresh).float()


def fill_weights(gram: torch.Tensor, alive: torch.Tensor,
                 ridge: float = RIDGE) -> torch.Tensor:
    """``[B, C+1, C]`` weights W with ``[x*alive, 1] @ W`` predicting every
    band from the surviving ones; rows of dead bands are exactly zero.

    gram: ``[C+1, C+1]`` (bias column last); alive: ``[B, C]`` float mask.
    The dead rows and columns of the system are masked out and given an
    identity diagonal, which decouples them to zero weights.
    """
    c = gram.shape[0] - 1
    gram = gram.float()
    a = alive.float()
    m = torch.cat([a, torch.ones_like(a[:, :1])], dim=1)            # [B, C+1]
    system = (gram * (m[:, :, None] * m[:, None, :])
              + torch.diag_embed(1.0 - m) + ridge * torch.diag_embed(m))
    rhs = m[:, :, None] * gram[:, :c]
    weights, _ = torch.linalg.solve_ex(system, rhs)
    return weights


def linear_fill(x: torch.Tensor, alive: torch.Tensor, gram: torch.Tensor,
                ridge: float = RIDGE) -> torch.Tensor:
    """fp32 NHWC batch with surviving bands untouched and dead bands
    replaced by their linear prediction. alive: ``[B,1,1,C]`` or ``[B,C]``."""
    b, h, w, c = x.shape
    x32 = x.float()
    a = alive.reshape(b, c).float()
    weights = fill_weights(gram, a, ridge)                           # [B, C+1, C]
    a4 = a[:, None, None, :]
    masked = x32 * a4
    pred = masked.reshape(b, h * w, c) @ weights[:, :c] + weights[:, c:]
    return masked + (1.0 - a4) * pred.view(b, h, w, c)


def detect_and_fill(x: torch.Tensor, gram: torch.Tensor,
                    rms_thresh: float = DEFAULT_RMS_THRESH,
                    ridge: float = RIDGE) -> tuple[torch.Tensor, torch.Tensor]:
    """Detection + fill: ``(filled fp32 NHWC, alive [B,1,1,C])``."""
    alive = detect_alive(x, rms_thresh)
    return linear_fill(x, alive, gram, ridge), alive


def fit_gram(loader, image_size: int = 192,
             device: str | torch.device = "cpu") -> np.ndarray:
    """Fit the clean-pixel Gram matrix ``E[z z^T]``, ``z = [bands..., 1]``,
    over a loader of raw host tiles (or ``(batch, count)`` pairs from a
    padding loader). Each batch is preprocessed to model space on
    ``device`` as the model sees it; its fp32 ``z^T z`` is summed in fp64
    on the host. Returns the ``[C+1, C+1]`` fp32 matrix."""
    from msid_tpu_torch.ops.preprocess import preprocess_tiles
    from msid_tpu_torch.training.eval import split_batch_item

    total, n = None, 0
    with torch.no_grad():
        for item in loader:
            batch, count = split_batch_item(item)
            raw = torch.as_tensor(np.asarray(batch)[:count]).to(device)
            clean = preprocess_tiles(raw, image_size)
            z = clean.reshape(-1, clean.shape[-1])
            z = torch.cat([z, torch.ones_like(z[:, :1])], dim=1)
            g = (z.T @ z).double().cpu().numpy()
            total = g if total is None else total + g
            n += z.shape[0]
    if total is None:
        raise ValueError("empty loader — cannot fit the cross-band Gram")
    return (total / n).astype(np.float32)


def fit_gram_from_config(config: dict, device: str | torch.device = "cpu") -> np.ndarray:
    """Fit the Gram over the config's whole train split, in order, with no
    sample dropped."""
    from msid_tpu_torch.data.dataset import build_dataset
    from msid_tpu_torch.data.pipeline import BatchLoader

    training = config.get("training", {})
    micro = int(training.get("micro_batch_size", 8))
    accum = int(training.get("gradient_accumulation_steps", 1))
    loader = BatchLoader(build_dataset(config, "train"), batch_size=micro * accum,
                         shuffle=False, drop_last=False, pad_last=True)
    return fit_gram(loader, int(config.get("data", {}).get("image_size", 192)), device)
