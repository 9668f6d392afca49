"""Training loop (PyTorch): counterpart of ``msid_tpu/training/trainer.py``.

Epochs of ``make_train_step`` calls, per-epoch validation through
``make_eval_step``, history, best tracking, early stopping on val PSNR,
the per-epoch abort after ``MAX_NAN_SKIPS_PER_EPOCH`` skipped steps, a
checkpoint after each epoch (``utils/checkpointing.py``) and resume.
Train losses stay on the device during an epoch and reach the host in one
transfer at its end. Corruption seeds are ``fold_in(fold_in(seed, epoch),
batch)`` for training and ``fold_in(eval_seed, batch)`` for validation,
so validation sees the same corruption every epoch.

One card; the multi-device mesh is a later slice of the port.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import torch

from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.ops.noise import IMPLS, NoiseConfig, fold_in
from msid_tpu_torch.training.eval import run_eval_loop
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.training.perceptual import resolve_perceptual
from msid_tpu_torch.training.train_state import TrainState, make_eval_step, make_train_step

logger = logging.getLogger(__name__)

MAX_NAN_SKIPS_PER_EPOCH = 10


def compute_dtype_from_config(config: dict) -> torch.dtype:
    """bf16 under ``training.mixed_precision`` (the default), else fp32."""
    mixed = config.get("training", {}).get("mixed_precision", True)
    return torch.bfloat16 if mixed else torch.float32


class Trainer:
    """Drives training of a restoration model on one device."""

    def __init__(self, model, state: TrainState, config: Optional[dict] = None,
                 loss_cfg: Optional[LossConfig] = None,
                 noise_cfg: Optional[NoiseConfig] = None,
                 checkpoint_manager=None, lr_schedule: Optional[Callable] = None,
                 train_step: Optional[Callable] = None,
                 eval_step: Optional[Callable] = None, seed: int = 42,
                 eval_seed: int = 1234, log_every: int = 50,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        config = config or {}
        training = config.get("training", {})
        self.model = model.to(self.device)
        self.state = state
        self.config = config
        self.ckpt = checkpoint_manager
        self.loss_cfg = loss_cfg or LossConfig.from_config(config)
        self.noise_cfg = noise_cfg or NoiseConfig.from_config(config)
        self.lr_schedule = lr_schedule
        self.seed = seed
        self.eval_seed = eval_seed
        self.log_every = log_every
        self.compute_dtype = compute_dtype_from_config(config)

        image_size = int(config.get("data", {}).get("image_size", model.image_size))
        accum = int(training.get("gradient_accumulation_steps", 1))
        # The reference accumulates only to fit a small GPU; one big batch is
        # the same math. Collapse unless the config pins it.
        if accum > 1 and bool(training.get("auto_accum", True)):
            num_params = sum(p.numel() for p in model.parameters())
            if self._memory_fits(config, accum, num_params, device=self.device):
                logger.info("collapsing gradient accumulation %dx -> 1 (fits in "
                            "device memory; set training.auto_accum: false to "
                            "keep)", accum)
                accum = 1
        self.accum_steps = accum

        noise_impl = str(config.get("noise", {}).get("impl", "auto"))
        if noise_impl not in IMPLS:
            raise ValueError(f"noise.impl must be one of {IMPLS}, got {noise_impl!r}")

        self.ema_decay = float(training.get("ema_decay", 0.0))
        if self.ema_decay > 0.0 and self.state.ema is None:
            self.state.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
            logger.info("EMA of params enabled (decay %.5g); validation uses the "
                        "shadow weights", self.ema_decay)

        # The perceptual term: the reference's VGG16 feature MSE when usable
        # weights are configured, else the Sobel edge stand-in.
        vgg_params = None
        if self.loss_cfg.perceptual_weight > 0:
            _, vgg_params = resolve_perceptual(training.get("loss", {}), self.device)

        augment = training.get("augment", {})
        self.train_step = train_step or make_train_step(
            model, self.loss_cfg, self.noise_cfg, accum_steps=accum,
            image_size=image_size, noise_impl=noise_impl,
            band_permutation_prob=float(augment.get("band_permutation_prob", 0.0)),
            vgg_params=vgg_params, ema_decay=self.ema_decay,
            compute_dtype=self.compute_dtype,
        )
        self.eval_step = eval_step or make_eval_step(
            model, self.loss_cfg, self.noise_cfg, image_size=image_size,
            noise_impl=noise_impl, vgg_params=vgg_params,
            forward_impl=str(training.get("eval_forward", "auto")),
            compute_dtype=self.compute_dtype,
        )

        es = config.get("early_stopping", {})
        self.early_stopping_enabled = bool(es.get("enabled", False))
        self.patience = int(es.get("patience", 10))
        self.min_delta = float(es.get("min_delta", 0.1))

        self.history: Dict[str, list] = {
            "train_loss": [], "val_loss": [], "val_psnr": [], "val_ssim": [],
            "val_sam": [], "val_rmse": [], "lr": [], "epoch_time": [],
        }
        self.best_val_loss = float("inf")
        self.best_val_metric = float("-inf")
        self.epochs_without_improvement = 0

    @staticmethod
    def _memory_fits(config: dict, accum: int, num_params: int,
                     safety: float = 0.7, limit_gb: Optional[float] = None,
                     device: str | torch.device = "cpu") -> bool:
        """Would the un-accumulated batch fit? The analytic estimate of
        ``estimate_memory`` at ``accum`` times the micro batch, against the
        card's total memory (8 GB assumed off the card)."""
        from msid_tpu_torch.utils.setup_helpers import estimate_memory

        training = dict(config.get("training", {}))
        micro = int(training.get("micro_batch_size", 8)) * accum
        cfg = dict(config, training=dict(training, micro_batch_size=micro))
        est = estimate_memory(cfg, num_params)["total_gb"]
        if limit_gb is None:
            device = torch.device(device)
            limit_gb = (torch.cuda.get_device_properties(device).total_memory / 1e9
                        if device.type == "cuda" else 8.0)
        return est < safety * limit_gb

    def train_epoch(self, loader, epoch: int) -> Dict[str, float]:
        """One epoch; returns ``{'loss', 'skipped', 'steps'}``."""
        base_seed = fold_in(self.seed, epoch)
        skips_at_start = self.state.nan_skips
        losses = []
        t0 = time.time()
        for i, batch in enumerate(loader):
            self.state, metrics = self.train_step(self.state, batch, fold_in(base_seed, i))
            losses.append(metrics["loss"])
            skipped = self.state.nan_skips - skips_at_start
            if skipped > MAX_NAN_SKIPS_PER_EPOCH:
                raise RuntimeError(
                    f"Aborting epoch {epoch}: {skipped} non-finite batches "
                    f"(> {MAX_NAN_SKIPS_PER_EPOCH}). Check LR / data health.")
            if self.log_every and (i + 1) % self.log_every == 0:
                logger.info("epoch %d batch %d/%d loss=%.5f (%.2f batch/s)",
                            epoch, i + 1, len(loader), float(metrics["loss"]),
                            (i + 1) / (time.time() - t0))
        host = torch.stack(losses).tolist() if losses else []
        return {
            "loss": float(sum(host) / len(host)) if host else 0.0,
            "skipped": self.state.nan_skips - skips_at_start,
            "steps": len(host),
        }

    def validate(self, loader) -> Dict[str, float]:
        """Deterministically corrupted validation over every sample; the
        padded trailing batch counts only its real samples."""
        with self.state.eval_weights(self.model):
            results = run_eval_loop(self.eval_step, loader, self.eval_seed)
        results.pop("num_samples", None)
        return results

    def fit(self, train_loader, val_loader, epochs: int,
            start_epoch: int = 0) -> Dict[str, list]:
        """Train and validate for ``epochs``; returns the history, also
        after a KeyboardInterrupt."""
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                train_m = self.train_epoch(train_loader, epoch)
                val_m = self.validate(val_loader)
                dt = time.time() - t0
                lr = (float(self.lr_schedule(self.state.step))
                      if self.lr_schedule is not None else float("nan"))
                self.history["train_loss"].append(train_m["loss"])
                self.history["val_loss"].append(val_m["loss"])
                self.history["val_psnr"].append(val_m["psnr"])
                self.history["val_ssim"].append(val_m["ssim"])
                self.history["val_sam"].append(val_m["sam"])
                self.history["val_rmse"].append(val_m["rmse"])
                self.history["lr"].append(lr)
                self.history["epoch_time"].append(dt)
                logger.info(
                    "epoch %d/%d: train_loss=%.5f val_loss=%.5f val_psnr=%.2fdB "
                    "val_ssim=%.4f val_sam=%.2f° lr=%.2e skipped=%d (%.1fs)",
                    epoch + 1, epochs, train_m["loss"], val_m["loss"], val_m["psnr"],
                    val_m["ssim"], val_m["sam"], lr, train_m["skipped"], dt)

                improved_metric = val_m["psnr"] > self.best_val_metric + (
                    self.min_delta if self.early_stopping_enabled else 0.0)
                self.best_val_loss = min(self.best_val_loss, val_m["loss"])
                self.best_val_metric = max(self.best_val_metric, val_m["psnr"])

                if self.ckpt is not None:
                    metrics = {"val_loss": val_m["loss"], "val_psnr": val_m["psnr"],
                               "val_ssim": val_m["ssim"], "val_sam": val_m["sam"]}
                    self.ckpt.save(
                        epoch + 1, self.state, metrics=metrics,
                        metadata={"epoch": epoch + 1, "history": self.history,
                                  "config": _jsonable(self.config)},
                        force=(epoch + 1 == epochs))
                if self.early_stopping_enabled:
                    if improved_metric:
                        self.epochs_without_improvement = 0
                    else:
                        self.epochs_without_improvement += 1
                        if self.epochs_without_improvement >= self.patience:
                            logger.info("Early stopping at epoch %d (no val_psnr "
                                        "improvement > %.3f for %d epochs)",
                                        epoch + 1, self.min_delta, self.patience)
                            break
        except KeyboardInterrupt:
            logger.warning("Training interrupted — returning partial history")
        finally:
            if self.ckpt is not None:
                self.ckpt.wait_until_finished()     # drain background saves
        return self.history

    def load_checkpoint(self, manager=None, step: Optional[int] = None,
                        best: bool = False) -> int:
        """Restore the state, history and best values from a checkpoint
        manager (this trainer's unless given). Returns the epoch to resume
        from, 0 if there is no checkpoint."""
        manager = manager or self.ckpt
        if manager is None:
            return 0
        if step is not None:
            out = manager.load_step(step, target=self.state)
        elif best:
            out = manager.load_best(target=self.state)
        else:
            out = manager.load_latest(target=self.state)
        if out is None:
            return 0
        state, metadata, ckpt_step = out
        if self.ema_decay <= 0.0 and state.ema is not None:
            # A shadow this run never updates would freeze validation at the
            # restored weights: drop it, so validation scores the live ones.
            logger.info("checkpoint carries an EMA shadow but training.ema_decay "
                        "is 0 — dropping the shadow; validation serves live params")
            state.ema = None
        self.state = state
        history = (metadata or {}).get("history")
        if history:
            self.history = history
            if history.get("val_loss"):
                self.best_val_loss = min(history["val_loss"])
            if history.get("val_psnr"):
                self.best_val_metric = max(history["val_psnr"])
        return int((metadata or {}).get("epoch", ckpt_step))


def _jsonable(obj):
    """A config dict with every value JSON can hold (others as strings)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
