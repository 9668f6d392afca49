"""Scenes restored back to back through the port's scene path, on SwinIR.

The ``scene_restormer`` driver (``kinds/scene_restormer.py``: the same
program under test, built by the port's factory of restorers from
``model.architecture``, the same window, the same check) with the seeded
weights and the plain reference taken from ``reference/swinir.py``. SwinIR
works at the window's own resolution (``model_size`` equal to ``window``:
no resize). Its traced run records ``model_size`` and the attention
windows of one tile (``attention_windows``), which the readers count the
model at.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import roofline_swinir
from portbench import traffic as gen
from portbench.kinds import DTYPES, scene_restormer
from portbench.reference import scene as ref_scene
from portbench.reference import swinir
from portbench.reference.precision import exact_fp32


class Driver(scene_restormer.Driver):
    def __init__(self, cell: dict, seed: int, device: torch.device):
        from msid_tpu_torch.deployment.sliding_window import make_device_scene_step

        self.cell, self.seed, self.device = cell, seed, device
        self.config = cell["config"]["config"]
        t = self.traffic = cell["traffic"]
        self.scenes = gen.scenes(t, seed, device)
        model = scene_restormer.program_model(cell["config"],
                                              swinir.seeded_state(self.config, seed, device),
                                              device, DTYPES[cell["config"]["dtype"]])
        self.step = make_device_scene_step(model, None, int(t["window"]), int(t["model_size"]),
                                           int(t["overlap"]), optimize=t["optimize"],
                                           device=device)
        del model
        self.attempted = self.failed = 0
        self.kept = None              # (scene index, restored scene)
        self._pick = np.random.default_rng([int(seed), 4])
        self.extra = {}
        self.restore(0)               # warm-up: captures the graph
        if device.type == "cuda":
            torch.cuda.synchronize()

    def traced(self) -> None:
        super().traced()
        self.extra.update(attention_windows=roofline_swinir.attention_windows(
            self.config, int(self.traffic["model_size"])))

    def reference(self, scene_raw: np.ndarray, operands=None) -> np.ndarray:
        t = self.traffic
        state = swinir.seeded_state(self.config, self.seed, self.device)
        ref = swinir.reference_model(self.config, state, self.device).eval()
        if operands is not None:
            ref.operands.fn = operands
        with exact_fp32():
            return ref_scene.restore(ref, scene_raw, int(t["window"]), int(t["overlap"]),
                                     int(t["model_size"]), int(t["batch"]), self.device)
