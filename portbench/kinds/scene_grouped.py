"""Scenes restored back to back through the port's scene path, on a
group-channel restorer.

The ``scene`` driver (``kinds/scene.py``: the same program under test, the
same window, the same check) with the seeded weights and the plain
reference taken from ``reference/grouped.py``, SatMAE's group-channel ViT
under the ``unet_skip`` restorer. Its traced run also records the
encoder's ``tokens`` a tile and its ``groups``, which the grouped readers
use.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as gen
from portbench.kinds import DTYPES, program_model, scene
from portbench.reference import grouped
from portbench.reference import scene as ref_scene
from portbench.reference.precision import exact_fp32


class Driver(scene.Driver):
    def __init__(self, cell: dict, seed: int, device: torch.device):
        from msid_tpu_torch.deployment.sliding_window import make_device_scene_step

        self.cell, self.seed, self.device = cell, seed, device
        self.config = cell["config"]["config"]
        t = self.traffic = cell["traffic"]
        self.scenes = gen.scenes(t, seed, device)
        model = program_model(cell["config"], grouped.seeded_state(self.config, seed, device),
                              device, DTYPES[cell["config"]["dtype"]])
        self.step = make_device_scene_step(model, None, int(t["window"]), int(t["model_size"]),
                                           int(t["overlap"]), optimize=t["optimize"],
                                           device=device)
        del model
        self.attempted = self.failed = 0
        self.kept = None              # (scene index, restored scene)
        self._pick = np.random.default_rng([int(seed), 4])
        self.extra = {}
        self.restore(0)               # warm-up: captures the graph, builds the kernels
        if device.type == "cuda":
            torch.cuda.synchronize()

    def traced(self) -> None:
        super().traced()
        enc, data = self.config["model"]["encoder"], self.config["data"]
        groups = len(enc["channel_groups"])
        self.extra.update(groups=groups,
                          tokens=groups * (int(data["image_size"]) // int(enc["patch_size"])) ** 2)

    def reference(self, scene_raw: np.ndarray, operands=None) -> np.ndarray:
        t = self.traffic
        state = grouped.seeded_state(self.config, self.seed, self.device)
        ref = grouped.reference_model(self.config, state, self.device).eval()
        if operands is not None:
            ref.operands.fn = operands
        with exact_fp32():
            return ref_scene.restore(ref, scene_raw, int(t["window"]), int(t["overlap"]),
                                     int(t["model_size"]), int(t["batch"]), self.device)
