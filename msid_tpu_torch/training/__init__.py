"""Training of the PyTorch port: losses, schedules, the optimizer, the
train and eval steps, the trainer and evaluation."""

from msid_tpu_torch.training.eval import evaluate_model
from msid_tpu_torch.training.losses import (
    LossConfig,
    combined_loss,
    edge_perceptual_loss,
    l1_loss,
    mse_loss,
    ssim_loss,
)
from msid_tpu_torch.training.optim import (
    build_optimizer,
    build_optimizer_from_config,
    label_params,
)
from msid_tpu_torch.training.schedules import build_schedule, cosine_warm_restarts
from msid_tpu_torch.training.train_state import TrainState, make_eval_step, make_train_step
from msid_tpu_torch.training.trainer import Trainer

__all__ = [
    "LossConfig",
    "TrainState",
    "Trainer",
    "build_optimizer",
    "build_optimizer_from_config",
    "build_schedule",
    "combined_loss",
    "cosine_warm_restarts",
    "edge_perceptual_loss",
    "evaluate_model",
    "l1_loss",
    "label_params",
    "make_eval_step",
    "make_train_step",
    "mse_loss",
    "ssim_loss",
]
