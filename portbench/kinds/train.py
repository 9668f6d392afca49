"""Training steps back to back, as the port's trainer runs them.

The program under test: the train step that ``Trainer`` builds from the
configuration (``make_train_step``: the device preprocessing, K2's
corruption, the bf16-autocast train-mode forward with every ViT block
checkpointed and blocks 0-5 frozen, MSE + SSIM, the backward, the clip and
grouped AdamW; gradient accumulation collapsed to one batch as
``auto_accum`` does), fed by the configuration's ``DeviceCachedLoader``
over the synthetic EuroSAT tiles (seeded by the run's seed), epoch after
epoch, the step seeds folded from the epoch and batch as the trainer
folds them. No evaluation and no checkpoint in the window.

Set-up builds the one train state and drives it through its first
``check_steps`` steps (and ``warmup_steps`` more) with the window's own
call and feed; those steps are what the reference follows.
``train_tiles_per_s`` is every step's batch over the window's time.

The check compares, with the plain float32 reference: each of the first
steps' loss (``loss_gap``, the worst step); the first gradient as AdamW
got it (its first moment after one step over ``1 - beta1``), by leaf
(``grad_gap_median``, the median leaf); each parameter's change after
those steps (``change_gap``, the worst leaf). A leaf's gap is the gap of
the two norms over the reference's norm or the median leaf's, whichever
is larger; leaves whose reference gradient is under a thousandth of the
median leaf's (moved by round-off alone) are left out. The gradient is
compared by its median leaf: its worst leaf is one of a few small ones
(attention query and key weights of the first trained blocks, norm
scales) and swings from seed to seed past what the control reads.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from portbench.kinds import program_model
from portbench.reference import train as ref_train
from portbench.reference.precision import exact_fp32, fp8_operands
from portbench.weights import reference_model, seeded_state

NEGLIGIBLE = 1e-3


def data_seed(seed: int) -> int:
    """The configuration's seed for the tiles, their split, their order and
    the step seeds (the split seeds numpy's legacy generator: 32 bits)."""
    return int(seed) % 2 ** 31


class Driver:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        from msid_tpu_torch.data.pipeline import get_dataloaders
        from msid_tpu_torch.training.optim import build_optimizer_from_config
        from msid_tpu_torch.training.train_state import TrainState
        from msid_tpu_torch.training.trainer import Trainer

        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell["traffic"]
        self.config = copy.deepcopy(cell["config"]["config"])
        self.config["seed"] = data_seed(seed)
        self.loader, _ = get_dataloaders(self.config, device)
        model = program_model({"config": self.config}, seeded_state(self.config, seed, device),
                              device, torch.float32)
        optimizer, schedule = build_optimizer_from_config(self.config, model,
                                                          max(1, len(self.loader)))
        trainer = Trainer(model, TrainState.create(model, optimizer), config=self.config,
                          lr_schedule=schedule, seed=self.config["seed"], device=device)
        training = self.config["training"]
        self.batch = (int(training["micro_batch_size"])
                      * int(training["gradient_accumulation_steps"]))
        self.state, self.step_fn, self.model = trainer.state, trainer.train_step, model
        self.epoch, self.index, self.batches = 0, 0, iter(self.loader)
        self.attempted = self.failed = 0
        self.wait_s = 0.0
        self.extra = {}
        self.losses = []
        beta1 = float(self.config["training"]["optimizer"]["betas"][0])
        names = {p: n for n, p in model.named_parameters()}
        for step in range(int(self.traffic["check_steps"])):
            self.losses.append(self.step()["loss"])
            if step == 0:
                adam = optimizer.adamw.state
                self.first = {names[p]: float(s["exp_avg"].norm()) / (1 - beta1)
                              for p, s in adam.items() if "exp_avg" in s}
        self.losses = [float(v) for v in self.losses]
        self.after = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        if device.type == "cuda":
            torch.cuda.synchronize()

    def step(self) -> dict:
        from msid_tpu_torch.ops.noise import fold_in

        t = time.perf_counter()
        batch = next(self.batches, None)
        if batch is None:
            self.epoch, self.index, self.batches = self.epoch + 1, 0, iter(self.loader)
            batch = next(self.batches)
        self.wait_s += time.perf_counter() - t
        seed = fold_in(fold_in(self.config["seed"], self.epoch), self.index)
        self.index += 1
        self.state, metrics = self.step_fn(self.state, batch, seed)
        self.attempted += 1
        self.failed += int(metrics["skipped"])
        return metrics

    def window(self, seconds: float) -> dict:
        start = time.perf_counter()
        steps = 0
        while time.perf_counter() - start < seconds:
            self.step()
            steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return {"train_tiles_per_s": steps * self.batch / (time.perf_counter() - start)}

    def traced(self) -> None:
        count = int(self.traffic["traced_steps"])
        self.wait_s = 0.0
        for _ in range(count):
            with torch.profiler.record_function("portbench.train_step"):
                self.step()
        self.extra.update(config=self.config, tiles=count * self.batch,
                          data_wait_ms=1e3 * self.wait_s / count)

    def notes(self) -> list[str]:
        return [f"train: {self.attempted} steps of {self.batch}, {self.failed} skipped, "
                f"losses of the first steps {self.losses}"]

    def release(self) -> None:
        self.state = self.step_fn = self.model = self.loader = self.batches = None

    def reference(self, operands=None):
        state = seeded_state(self.config, self.seed, self.device)
        ref = reference_model(self.config, state, self.device).train()
        if operands is not None:
            ref.operands.fn = operands
        with exact_fp32():
            return state, ref_train.follow(ref, self.config, len(self.losses), self.batch,
                                           self.config["seed"])

    def control(self) -> dict:
        """The control's numbers: the reference with fp8 operands in the
        program's place, against the float32 reference."""
        _, (ref_losses, ref_first, ref_change, raw) = self.reference()
        _, (losses, first, change, _) = self.reference(fp8_operands)
        first = {n: float(g.norm()) for n, g in first.items() if float(ref_change[n].norm()) > 0}
        return compare(losses, first, change, ref_losses, ref_first, ref_change, raw)

    def check(self) -> dict:
        start, (losses, first, change, raw) = self.reference()
        return compare(self.losses, self.first,
                       {n: self.after[n].to(self.device) - start[n] for n in self.after},
                       losses, first, change, raw)


def _gaps(got: dict, want: dict, keep: list) -> list[float]:
    floor = float(np.median([want[n] for n in keep]))
    return [abs(got.get(n, 0.0) - want[n]) / max(want[n], floor) for n in keep]


def compare(losses, first, change, ref_losses, ref_first, ref_change, ref_raw) -> dict:
    """The three numbers of a training check (see the module's docstring);
    ``first`` maps a trained leaf to its first gradient's norm, ``change``
    every leaf to its change."""
    trained = sorted(n for n in ref_change if float(ref_change[n].norm()) > 0
                     or n in first)
    raw = {n: float(ref_raw[n].norm()) for n in trained}
    floor = float(np.median(list(raw.values())))
    keep = [n for n in trained if raw[n] >= NEGLIGIBLE * floor]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    return {
        "loss_gap": loss_gap,
        "grad_gap_median": float(np.median(
            _gaps(first, {n: float(ref_first[n].norm()) for n in keep}, keep))),
        "change_gap": max(_gaps({n: float(change[n].norm()) for n in change},
                                {n: float(ref_change[n].norm()) for n in keep}, keep)),
    }
