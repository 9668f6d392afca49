"""Optimizer (PyTorch): counterpart of ``msid_tpu/training/optim.py``.

The JAX chain is ``clip_by_global_norm -> multi_transform(frozen: zero,
encoder: AdamW at encoder_lr_scale x LR, decoder: AdamW at 1x LR)``. Here:

  * every parameter keeps ``requires_grad``; frozen ones (the listed
    encoder blocks and ``fill_gram``) get gradients that count in the
    global norm and the clip, as ``set_to_zero`` acts after the clip in
    JAX, and are in no AdamW group, so they get neither an update nor
    weight decay;
  * the clip is optax's: ``g / norm * max_norm`` only when
    ``norm >= max_norm`` (``clip_grad_norm_`` divides by ``norm + 1e-6``
    and always scales);
  * under tensor parallelism (``parallel/tp.py`` sets ``model_group`` and
    ``sharded``) the global norm counts each sharded gradient's shards
    once, their squares summed over the model group, and each replicated
    one once;
  * ``torch.optim.AdamW`` updates the two groups (the JAX package computes
    AdamW in XLA, not in a kernel); each group's LR is set from
    ``schedule(count)`` before the update, ``count`` being the number of
    updates already applied;
  * on a card AdamW is ``capturable``: it counts its updates on the device
    and reads each group's LR from a device tensor that ``set_lr`` writes,
    so that an update can be captured in a CUDA graph and replayed
    (``training/train_state.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from msid_tpu_torch.training.schedules import Schedule, build_schedule

ENCODER_LR_SCALE_DEFAULT = 0.1


def label_params(model: nn.Module, freeze_layers: Sequence[int] = ()) -> dict:
    """``{name: 'frozen' | 'encoder' | 'decoder'}`` for every parameter.

    ``fill_gram`` is frozen (a measured statistic: weight decay would pull
    it toward zero-fill); ``encoder.blocks.{i}.*`` for ``i`` in
    ``freeze_layers`` is frozen; any other ``encoder.*`` is encoder;
    everything else is decoder.
    """
    frozen_blocks = {str(int(i)) for i in freeze_layers}
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if "fill_gram" in parts:
            labels[name] = "frozen"
        elif parts[0] == "encoder":
            frozen = len(parts) > 2 and parts[1] == "blocks" and parts[2] in frozen_blocks
            labels[name] = "frozen" if frozen else "encoder"
        else:
            labels[name] = "decoder"
    return labels


class GroupedAdamW:
    """Global-norm clip over every gradient, then AdamW per label group."""

    def __init__(self, model: nn.Module, schedule: Schedule,
                 weight_decay: float = 0.05, betas: Sequence[float] = (0.9, 0.999),
                 gradient_clip: float = 1.0,
                 encoder_lr_scale: float = ENCODER_LR_SCALE_DEFAULT,
                 freeze_layers: Sequence[int] = ()):
        self.schedule = schedule
        self.gradient_clip = float(gradient_clip or 0.0)
        self.labels = label_params(model, freeze_layers)
        named = dict(model.named_parameters())
        self.params = list(named.values())
        groups = []
        for label, scale in (("encoder", float(encoder_lr_scale)), ("decoder", 1.0)):
            names = [n for n, lab in self.labels.items() if lab == label]
            groups.append({"params": [named[n] for n in names], "names": names,
                           "lr_scale": scale, "label": label})
        groups = [g for g in groups if g["params"]]
        self.model_group = None     # tensor parallelism: see parallel/tp.py
        self.sharded: list[bool] | None = None
        capturable = all(p.is_cuda for p in self.params)
        if capturable:
            for group in groups:
                group["lr"] = torch.zeros((), device=group["params"][0].device)
        self.adamw = torch.optim.AdamW(
            groups, lr=schedule(0), betas=(float(betas[0]), float(betas[1])),
            eps=1e-8, weight_decay=float(weight_decay), capturable=capturable)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> list[torch.Tensor]:
        """Every parameter's gradient (zeros where none was computed)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def global_norm(self) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient, frozen ones too."""
        norms = torch.stack(torch._foreach_norm(self.grads()))
        if self.model_group is None:
            return torch.linalg.vector_norm(norms)
        from msid_tpu_torch.parallel.collectives import all_reduce_sum

        squares = norms * norms
        sharded = torch.tensor(self.sharded, device=squares.device)
        shards = all_reduce_sum(squares[sharded].sum(), self.model_group)
        return torch.sqrt(squares[~sharded].sum() + shards)

    def clip_(self, norm: torch.Tensor) -> None:
        """optax ``clip_by_global_norm`` in place, with no host sync:
        ``g / norm * max_norm`` where ``norm >= max_norm``, else ``g``."""
        if self.gradient_clip <= 0:
            return
        keep = norm < self.gradient_clip
        one = torch.ones_like(norm)
        grads = self.grads()
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.gradient_clip))

    def ready(self) -> bool:
        """Whether every parameter AdamW trains has its moments, so that an
        update creates no state (one that a CUDA graph captures must not)."""
        state = self.adamw.state
        return all(state.get(p) for group in self.adamw.param_groups for p in group["params"])

    def set_lr(self, count: int) -> None:
        """Set each group's LR to ``schedule(count)`` times its scale: on a
        card a write of the group's LR tensor, with no host sync."""
        lr = self.schedule(count)
        for group in self.adamw.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr * group["lr_scale"])
            else:
                group["lr"] = lr * group["lr_scale"]

    def step(self, count: int | None) -> None:
        """Apply one AdamW update with the LR of ``schedule(count)``; None
        keeps the LR ``set_lr`` set (a captured update, before whose every
        replay the host sets it)."""
        if count is not None:
            self.set_lr(count)
        self.adamw.step()

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Restore the moments by parameter name, so a state saved under
        another freeze set loads (stage B of the two-stage recipe resumes
        stage A's): a parameter that has moments in ``state`` and is
        trained here gets them; one trained here with none starts fresh, as
        AdamW starts every parameter; saved moments of a parameter frozen
        here are dropped. Each group takes the settings (learning rate,
        betas, ...) of the saved group with its label, where there is one,
        but keeps whether it is ``capturable`` and, where either side's LR
        is a tensor, its own LR (the schedule sets it before every update)."""
        saved = {name: state["state"][i]
                 for group in state["param_groups"]
                 for name, i in zip(group["names"], group["params"]) if i in state["state"]}
        settings = {group["label"]: group for group in state["param_groups"]}
        groups = []
        for group in self.adamw.state_dict()["param_groups"]:
            merged = dict(settings.get(group["label"], group), params=group["params"],
                          names=group["names"], capturable=group["capturable"])
            if isinstance(group["lr"], torch.Tensor) or isinstance(merged["lr"], torch.Tensor):
                merged["lr"] = group["lr"]
            groups.append(merged)
        self.adamw.load_state_dict({
            "state": {i: saved[name] for group in groups
                      for name, i in zip(group["names"], group["params"]) if name in saved},
            "param_groups": groups})


def build_optimizer(model: nn.Module, schedule: Schedule, weight_decay: float = 0.05,
                    betas: Sequence[float] = (0.9, 0.999), gradient_clip: float = 1.0,
                    encoder_lr_scale: float = ENCODER_LR_SCALE_DEFAULT,
                    freeze_layers: Sequence[int] = ()) -> GroupedAdamW:
    return GroupedAdamW(model, schedule, weight_decay, betas, gradient_clip,
                        encoder_lr_scale, freeze_layers)


def build_optimizer_from_config(config: dict, model: nn.Module,
                                steps_per_epoch: int = 1) -> tuple[GroupedAdamW, Schedule]:
    """``(optimizer, schedule)`` from the YAML schema."""
    training = config.get("training", {})
    opt = training.get("optimizer", {})
    schedule = build_schedule(config, steps_per_epoch)
    freeze = config.get("model", {}).get("encoder", {}).get("freeze_layers") or ()
    optimizer = build_optimizer(
        model, schedule,
        weight_decay=float(opt.get("weight_decay", 0.05)),
        betas=[float(b) for b in opt.get("betas", (0.9, 0.999))],
        gradient_clip=float(training.get("gradient_clip", 1.0)),
        encoder_lr_scale=float(opt.get("encoder_lr_scale", ENCODER_LR_SCALE_DEFAULT)),
        freeze_layers=tuple(int(i) for i in freeze),
    )
    return optimizer, schedule
