"""Evaluation loop (PyTorch): counterpart of ``split_batch_item`` and
``run_eval_loop`` of ``msid_tpu/training/eval.py``."""

from __future__ import annotations

import torch

from msid_tpu_torch.ops.noise import fold_in


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
