"""LR schedules (PyTorch): counterpart of ``msid_tpu/training/schedules.py``.

A schedule is a function of the number of optimizer updates already
applied (0 for the first update) that returns the learning rate as a
Python float. The SGDR curve is the closed form of the JAX package,
evaluated in fp32 as there.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def cosine_warm_restarts(base_lr: float, t_0: int, t_mult: int = 1,
                         eta_min: float = 0.0,
                         steps_per_cycle_unit: int = 1) -> Schedule:
    """SGDR: cosine from ``base_lr`` to ``eta_min`` over ``t_0`` units, then
    restart with cycles ``t_mult`` times longer each time. With ``t_mult``
    above 1 the cycle index is ``floor(log(t/t0*(m-1)+1)/log(m) + 1e-5)``:
    the epsilon absorbs fp32 rounding at exact restart steps."""
    t0 = float(max(1, int(t_0)) * max(1, int(steps_per_cycle_unit)))
    m = float(max(1, int(t_mult)))
    span = base_lr - eta_min
    f32 = torch.float32

    def schedule(step: int) -> float:
        t = torch.tensor(float(step), dtype=f32)
        if m == 1.0:
            frac = torch.remainder(t, t0) / t0
        else:
            n = torch.floor(torch.log(t / t0 * (m - 1.0) + 1.0) / math.log(m) + 1e-5)
            start = t0 * (torch.pow(torch.tensor(m, dtype=f32), n) - 1.0) / (m - 1.0)
            length = t0 * torch.pow(torch.tensor(m, dtype=f32), n)
            frac = torch.clamp((t - start) / length, 0.0, 1.0)
        return float(eta_min + span * 0.5 * (1.0 + torch.cos(math.pi * frac)))

    return schedule


def cosine_decay(base_lr: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``: cosine from ``base_lr`` to
    ``alpha * base_lr`` over ``decay_steps``, then flat."""
    def schedule(step: int) -> float:
        frac = min(float(step), float(decay_steps)) / float(decay_steps)
        return base_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def constant(base_lr: float) -> Schedule:
    def schedule(step: int) -> float:
        return base_lr

    return schedule


def build_schedule(config: dict, steps_per_epoch: int = 1) -> Schedule:
    """From the YAML schema's ``training.scheduler``: SGDR (T_0 in optimizer
    steps, or epochs with ``unit: epoch``), cosine, or constant."""
    training = config.get("training", {})
    opt = training.get("optimizer", {})
    sched = training.get("scheduler", {})
    base_lr = float(opt.get("lr", 1e-4))
    kind = str(sched.get("type", "CosineAnnealingWarmRestarts")).lower()
    if kind in ("cosineannealingwarmrestarts", "sgdr", "cosine_warm_restarts"):
        scale = steps_per_epoch if str(sched.get("unit", "step")) == "epoch" else 1
        return cosine_warm_restarts(
            base_lr=base_lr,
            t_0=int(sched.get("T_0", 10)),
            t_mult=int(sched.get("T_mult", 2)),
            eta_min=float(sched.get("eta_min", 1e-6)),
            steps_per_cycle_unit=scale,
        )
    if kind in ("cosine", "cosineannealinglr"):
        return cosine_decay(base_lr, int(sched.get("T_max", 100)) * steps_per_epoch,
                            float(sched.get("eta_min", 0.0)) / base_lr)
    if kind in ("constant", "none"):
        return constant(base_lr)
    raise ValueError(f"Unknown scheduler type: {kind}")
