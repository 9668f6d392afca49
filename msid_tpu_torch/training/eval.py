"""Evaluation (PyTorch): counterpart of ``split_batch_item``,
``run_eval_loop`` and ``evaluate_model`` of ``msid_tpu/training/eval.py``."""

from __future__ import annotations

import logging
from typing import Optional

import torch

from msid_tpu_torch.ops.noise import NoiseConfig, fold_in
from msid_tpu_torch.training.losses import LossConfig

logger = logging.getLogger(__name__)


def split_batch_item(item):
    """``(batch, true_count)`` from a loader item: padding loaders yield
    ``(batch, count)`` pairs, plain loaders bare batches."""
    if isinstance(item, (tuple, list)) and len(item) == 2:
        return item[0], int(item[1])
    return item, int(item.shape[0])


def run_eval_loop(eval_step, loader, base_seed: int) -> dict:
    """Accumulate eval-step sums over a loader, batch ``i`` corrupted with
    the fixed seed ``fold_in(base_seed, i)``; one host transfer at the end.
    Returns the per-sample means of loss, PSNR, SSIM, SAM and RMSE, and
    ``num_samples``."""
    sums = None
    for i, item in enumerate(loader):
        batch, count = split_batch_item(item)
        s = eval_step(batch, fold_in(base_seed, i), count)
        sums = s if sums is None else {k: sums[k] + v for k, v in s.items()}
    if sums is None:
        return {"loss": 0.0, "psnr": 0.0, "ssim": 0.0, "sam": 0.0, "rmse": 0.0,
                "num_samples": 0}
    keys = sorted(sums)
    host = dict(zip(keys, torch.stack([sums[k].float() for k in keys]).tolist()))
    count = max(host["count"], 1.0)
    results = {k: host[k] / count for k in ("loss", "psnr", "ssim", "sam", "rmse")}
    results["num_samples"] = int(count)
    return results


def evaluate_model(model, variables, loader, loss_cfg: Optional[LossConfig] = None,
                   noise_cfg: Optional[NoiseConfig] = None,
                   image_size: Optional[int] = None, eval_seed: int = 1234,
                   verbose: bool = True, tta: int = 1, forward_impl: str = "auto",
                   compute_dtype: torch.dtype = torch.float32,
                   noise_impl: str = "auto") -> dict:
    """Evaluate over a loader with one host transfer; returns the metric
    dict of :func:`run_eval_loop`.

    ``variables`` None scores the module's own weights, a dict of
    parameters and buffers scores those, and a tuple or list of such dicts
    scores the mean restoration of the ensemble. ``tta`` > 1 averages over
    that many dihedral views of each noisy input. ``noise_impl`` must be
    the one the trainer's validation used (``noise.impl``) for the numbers
    to reproduce its validation line.
    """
    from msid_tpu_torch.training.train_state import ensemble_members, make_eval_step

    variables, ensemble_size = ensemble_members(variables)
    eval_step = make_eval_step(
        model, loss_cfg or LossConfig(), noise_cfg or NoiseConfig(),
        image_size=image_size or model.image_size, noise_impl=noise_impl, tta=tta,
        forward_impl=forward_impl, ensemble_size=ensemble_size,
        compute_dtype=compute_dtype)
    results = run_eval_loop(
        lambda batch, seed, count: eval_step(batch, seed, count, variables),
        loader, eval_seed)
    if verbose:
        logger.info("=" * 50)
        logger.info("Evaluation results (%d samples):", results["num_samples"])
        logger.info("  PSNR: %.2f dB", results["psnr"])
        logger.info("  SSIM: %.4f", results["ssim"])
        logger.info("  SAM:  %.2f°", results["sam"])
        logger.info("  RMSE: %.4f", results["rmse"])
        logger.info("=" * 50)
    return results
