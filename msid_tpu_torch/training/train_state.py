"""Train state and train/eval steps (PyTorch): counterpart of
``msid_tpu/training/train_state.py``.

One ``train_step`` call does, in order: preprocess the raw tiles on the
device, permute bands (optional), corrupt (``ops/noise.corrupt``: kernel
K2 on the card), forward and backward per micro-batch with the gradients
summed and then averaged, the non-finite guard, the global-norm clip and
grouped AdamW (``training/optim.py``), and the EMA.

The parameters live in the module (fp32); the compute dtype is separate:
bf16 runs the forward under ``torch.autocast`` with no GradScaler (bf16
keeps fp32's exponent range), fp32 runs with TF32 off (``exact_fp32``)
around the whole step and the eval forward. BatchNorm running statistics update in place
during the forward and thread through the micro-batches in order, while
the parameters stay those of the step's start, as in the JAX step.

The non-finite guard costs one host sync per step: whether the loss and
the gradient norm are finite decides on the host whether to update. A
skipped step leaves the parameters, the AdamW moments, the update count
and the EMA as they were, restores the BatchNorm statistics the forward
updated, and counts one ``nan_skips``.

Under a ``mesh`` (``parallel/mesh.py``, one process per device) each
rank's step takes its rows of a global batch and gives the single-device
step's result on that batch, as the JAX mesh step does under GSPMD: the
corruption and the band permutation draw as for the global batch
(sample offsets); train-mode BatchNorm takes global moments (its norms'
``data_group``, set by ``parallel.set_data_group``); after the
accumulation loop one bucketed all-reduce averages every gradient over
the data group (the frozen blocks' and ``fill_gram``'s too: they count in
the clip norm); the loss and mse are averaged over it before the
non-finite test, so every rank skips or applies the same steps. Under
tensor parallelism (``parallel/tp.py``) the ViT's sharded blocks carry
their own collectives and the clip norm counts each shard once.

The eval step scores the live weights, one set of weights given as a
dict (``torch.func.functional_call``, the counterpart of
``model.apply(variables, ...)``), or the mean restoration of an ensemble
of them, optionally over dihedral test-time views (``ops/tta.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from msid_tpu_torch.models.restoration import exact_fp32
from msid_tpu_torch.ops.metrics import batch_metric_sums
from msid_tpu_torch.ops.noise import NoiseConfig, corrupt, fold_in
from msid_tpu_torch.ops.preprocess import preprocess_tiles, random_band_permutation
from msid_tpu_torch.ops.tta import dihedral_ensemble, orbit_prefix
from msid_tpu_torch.parallel.collectives import all_reduce_mean_
from msid_tpu_torch.training.losses import (
    LossConfig,
    combined_loss,
    combined_loss_per_sample,
)
from msid_tpu_torch.training.optim import GroupedAdamW
from msid_tpu_torch.utils.profiling import annotate

if TYPE_CHECKING:
    from msid_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class TrainState:
    """The model, the step count (updates applied), skipped steps, the
    optimizer and the optional EMA shadow (``{name: fp32 tensor}`` over
    every parameter)."""

    optimizer: GroupedAdamW
    step: int = 0
    nan_skips: int = 0
    ema: Optional[dict] = None
    model: Optional[nn.Module] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: GroupedAdamW,
               ema: bool = False) -> "TrainState":
        shadow = ({n: p.detach().clone() for n, p in model.named_parameters()}
                  if ema else None)
        return cls(optimizer=optimizer, ema=shadow, model=model)

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, by reference (not copied): the
        module's parameters and BN statistics, the AdamW moments and
        counts, ``step``, ``nan_skips`` and the EMA shadow."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "nan_skips": self.nan_skips, "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` in place, onto the module's device."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.nan_skips = int(state["nan_skips"])
        device = next(self.model.parameters()).device
        self.ema = (None if state["ema"] is None else
                    {k: v.to(device) for k, v in state["ema"].items()})

    @property
    def variables(self) -> dict:
        """The live weights, ``{name: tensor}`` by reference: the module's
        parameters and BatchNorm statistics (its state dict), never the EMA
        shadow (``eval_variables`` gives that)."""
        return dict(self.model.state_dict())

    def eval_variables(self, raw: bool = False) -> dict:
        """The weights to evaluate or serve, as a ``{name: tensor}`` copy
        of the module's parameters and buffers: the EMA shadow in place of
        the parameters when there is one (unless ``raw``)."""
        variables = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        if self.ema is not None and not raw:
            variables.update({k: v.detach().clone() for k, v in self.ema.items()})
        return variables

    @contextlib.contextmanager
    def eval_weights(self, model: nn.Module):
        """The weights to evaluate inside the block: the EMA shadow when
        there is one (the live parameters are restored after), else the
        live parameters. BatchNorm statistics are the live ones."""
        if self.ema is None:
            yield model
            return
        params = dict(model.named_parameters())
        live = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.ema[n])
        try:
            yield model
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(live[n])


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def _to_device(batch, device: torch.device) -> torch.Tensor:
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


def _clean_batch(batch: torch.Tensor, image_size: int,
                 preprocess_on_device: bool) -> torch.Tensor:
    if preprocess_on_device:
        return preprocess_tiles(batch, image_size)
    return batch.float()


def _rows(mesh: Optional["Mesh"], local_batch: int) -> tuple[int, int]:
    """``(offset, global_batch)`` of a rank's rows (the whole batch without
    a mesh)."""
    return (0, local_batch) if mesh is None else mesh.rows(local_batch)


def _reduced(mesh: Optional["Mesh"]) -> bool:
    return mesh is not None and mesh.distributed


def make_train_step(
    model: nn.Module,
    loss_cfg: LossConfig = LossConfig(),
    noise_cfg: NoiseConfig = NoiseConfig(),
    accum_steps: int = 1,
    image_size: int = 192,
    preprocess_on_device: bool = True,
    noise_impl: str = "auto",
    band_permutation_prob: float = 0.0,
    vgg_params=None,
    ema_decay: float = 0.0,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional["Mesh"] = None,
) -> Callable:
    """The train step ``(state, batch, seed) -> (state, metrics)``.

    ``batch`` is raw tiles ``[accum * micro, h0, w0, C]`` (numpy or a
    tensor; ``preprocess_on_device=True``) or clean model-range images;
    it goes to the model's device. ``seed`` (an int) seeds the corruption
    and the band permutation. ``metrics`` holds ``loss``, ``mse`` and
    ``grad_norm`` as device scalars and ``skipped`` as an int. ``vgg_params``
    (on the model's device) makes the perceptual term the VGG16 loss.

    With ``mesh`` the batch is this rank's rows of the global batch
    (``mesh.data`` times as many) and the metrics are the global batch's
    (see the module docstring). ``train_step.prepare(batch, seed)`` is the
    step's ``(clean, noisy)`` input, for checks.
    """
    device = next(model.parameters()).device
    buffers = [b for b in model.buffers() if b.is_floating_point()]

    def train_step(state: TrainState, batch, seed: int):
        with exact_fp32(compute_dtype):
            return _train_step(state, batch, seed)

    @torch.no_grad()
    def prepare(batch, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
        clean = _clean_batch(_to_device(batch, device), image_size, preprocess_on_device)
        offset, global_batch = _rows(mesh, clean.shape[0])
        noise_seed = seed
        if band_permutation_prob > 0.0:
            g = torch.Generator().manual_seed(fold_in(seed, 1) % 2 ** 63)
            clean = random_band_permutation(clean, band_permutation_prob, g,
                                            offset, global_batch)
            noise_seed = fold_in(seed, 0)
        noisy = corrupt(noise_seed, clean, noise_cfg, impl=noise_impl,
                        sample_offset=offset, global_batch=global_batch)
        return clean, noisy

    def _train_step(state: TrainState, batch, seed: int):
        optimizer = state.optimizer
        model.train()
        with annotate("msid.train.prepare"):
            clean, noisy = prepare(batch, seed)
        n = clean.shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} not divisible by accum_steps {accum_steps}")
        micro = n // accum_steps
        stats = [b.clone() for b in buffers]

        optimizer.zero_grad()
        loss_sum = mse_sum = None
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            with annotate("msid.train.forward"):
                with _autocast(device, compute_dtype):
                    out = model(noisy[rows].to(compute_dtype))
                loss, aux = combined_loss(out, clean[rows], loss_cfg, vgg_params)
            with annotate("msid.train.backward"):
                loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            mse_sum = aux["mse"].detach() if mse_sum is None else mse_sum + aux["mse"].detach()
        with annotate("msid.train.update"):
            return _update(state, optimizer, stats, loss_sum, mse_sum)

    def _update(state: TrainState, optimizer: GroupedAdamW, stats: list,
                loss_sum: torch.Tensor, mse_sum: torch.Tensor):
        grads = optimizer.grads()
        if accum_steps > 1:
            torch._foreach_mul_(grads, 1.0 / accum_steps)
            loss_sum = loss_sum * (1.0 / accum_steps)
            mse_sum = mse_sum * (1.0 / accum_steps)
        if _reduced(mesh):
            all_reduce_mean_(grads, mesh.data_group, mesh.data)
            means = torch.stack([loss_sum, mse_sum])
            all_reduce_mean_([means], mesh.data_group, mesh.data)
            loss_sum, mse_sum = means[0], means[1]
        grad_norm = optimizer.global_norm()

        finite = bool(torch.isfinite(grad_norm) & torch.isfinite(loss_sum))  # host sync
        if finite:
            optimizer.clip_(grad_norm)
            optimizer.step(state.step)
            state.step += 1
            if ema_decay > 0.0:
                if state.ema is None:
                    raise ValueError("ema_decay > 0 needs TrainState.create(..., ema=True)")
                names = [n for n, _ in model.named_parameters()]
                with torch.no_grad():
                    torch._foreach_lerp_([state.ema[k] for k in names],
                                         [p.detach() for p in model.parameters()],
                                         1.0 - ema_decay)
        else:
            with torch.no_grad():
                torch._foreach_copy_(buffers, stats)
            state.nan_skips += 1
        optimizer.zero_grad()
        return state, {"loss": loss_sum, "mse": mse_sum, "grad_norm": grad_norm,
                       "skipped": int(not finite)}

    train_step.prepare = prepare
    return train_step


def make_eval_step(
    model: nn.Module,
    loss_cfg: LossConfig = LossConfig(),
    noise_cfg: NoiseConfig = NoiseConfig(),
    image_size: int = 192,
    preprocess_on_device: bool = True,
    noise_impl: str = "auto",
    vgg_params=None,
    tta: int = 1,
    forward_impl: str = "auto",
    ensemble_size: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional["Mesh"] = None,
) -> Callable:
    """The eval step ``(batch, seed, count, variables=None) -> sums``:
    corrupt with the batch's fixed seed, run the eval-mode forward in the
    compute dtype, and return the metric sums of ``batch_metric_sums`` and
    ``loss`` (the sum of the per-sample combined loss) as device scalars,
    over the first ``count`` samples only (the rest is padding).

    ``variables`` None scores the module's own weights, a dict of
    parameters and buffers scores those. With ``ensemble_size`` > 1 it is a
    sequence of that many dicts, and the step scores their mean
    restoration, averaged in fp32. ``tta`` > 1 averages over that many
    dihedral views of the noisy input, each view going through the
    (ensemble-averaged) forward. Both are checked when the step is built.

    ``forward_impl`` selects the eval forward graph: ``apply`` (what
    ``auto`` resolves to) is the module's own forward; ``hybrid`` is the
    module's encoder and the folded-BN conv-transpose decoder, folded from
    the scored weights on every call (``fastpath.make_hybrid_forward``), so
    validation can score the graph that serving ships. It is opt-in, raises
    ``ValueError`` for models the folded graphs do not support, and does
    not combine with an ensemble. ``vgg_params`` is the train step's.

    With ``mesh`` the batch is this rank's rows of a global batch whose
    first ``count`` samples are real; the rank corrupts its rows as the
    global batch's, masks the ones past ``count`` and returns the sums over
    the whole global batch (all-reduced over the data group).
    """
    orbit_prefix(tta, image_size, image_size)
    if forward_impl not in ("auto", "apply", "hybrid"):
        raise ValueError(f"forward_impl must be auto|apply|hybrid, got {forward_impl!r}")
    if ensemble_size < 1:
        raise ValueError(f"ensemble_size must be >= 1, got {ensemble_size}")
    if ensemble_size > 1 and forward_impl == "hybrid":
        raise ValueError("checkpoint ensembling supports only the apply/auto "
                         "forward, not hybrid")
    hybrid_forward = None
    if forward_impl == "hybrid":
        from msid_tpu_torch.deployment.fastpath import make_hybrid_forward

        hybrid_forward = make_hybrid_forward(model)      # raises for unsupported models
    device = next(model.parameters()).device

    def apply(variables: Optional[dict], z: torch.Tensor) -> torch.Tensor:
        with _autocast(device, compute_dtype):
            if hybrid_forward is not None:
                return hybrid_forward(variables, z.to(compute_dtype))
            if variables is None:
                return model(z.to(compute_dtype))
            return functional_call(model, variables, (z.to(compute_dtype),))

    def eval_step(batch, seed: int, count: int, variables=None) -> dict:
        if ensemble_size > 1 and (isinstance(variables, dict)
                                  or len(variables or ()) != ensemble_size):
            raise ValueError(f"an ensemble of {ensemble_size} needs a sequence of "
                             f"{ensemble_size} variable dicts")

        def forward(z: torch.Tensor) -> torch.Tensor:
            if ensemble_size == 1:
                return apply(variables, z)
            outs = [apply(v, z).float() for v in variables]
            return sum(outs[1:], outs[0]) / float(ensemble_size)

        model.eval()
        with torch.no_grad(), exact_fp32(compute_dtype):
            clean = _clean_batch(_to_device(batch, device), image_size, preprocess_on_device)
            b = clean.shape[0]
            offset, global_batch = _rows(mesh, b)
            noisy = corrupt(seed, clean, noise_cfg, impl=noise_impl,
                            sample_offset=offset, global_batch=global_batch)
            out = dihedral_ensemble(forward, noisy, tta).float()
            local_count = min(max(int(count) - offset, 0), b)
            mask = (torch.arange(b, device=device) < local_count).float()
            loss_ps = combined_loss_per_sample(out, clean, loss_cfg, vgg_params)
            sums = batch_metric_sums(out, clean, mask=mask)
            sums["loss"] = torch.sum(loss_ps * mask)
            if _reduced(mesh):
                keys = sorted(sums)
                stacked = torch.stack([sums[k].float() for k in keys])
                dist.all_reduce(stacked, group=mesh.data_group)
                sums = dict(zip(keys, stacked.unbind()))
        return sums

    return eval_step


def ensemble_members(variables) -> tuple[Optional[dict | Sequence[dict]], int]:
    """``(variables, ensemble_size)`` from what a caller passes: None or a
    dict is one set of weights; a tuple or list of dicts is an ensemble
    (one element means one set)."""
    if isinstance(variables, (tuple, list)):
        members = tuple(variables)
        return (members[0], 1) if len(members) == 1 else (members, len(members))
    return variables, 1
