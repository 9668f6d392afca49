"""Scenes restored back to back through the port's scene path, on Restormer.

The ``scene`` driver (``kinds/scene.py``: the same program under test, the
same window, the same check) with the restorer built by the port's factory
of restorers (``restorer_from_config``, which reads ``model.architecture``)
and the seeded weights and the plain reference taken from
``reference/restormer.py``. Restormer works at the window's own
resolution (``model_size`` equal to ``window``: no resize). Its traced run
also records ``model_size``, the side the readers count the model at.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as gen
from portbench.kinds import DTYPES, scene
from portbench.reference import restormer
from portbench.reference import scene as ref_scene
from portbench.reference.precision import exact_fp32


def program_model(config_file: dict, state: dict, device: torch.device, dtype: torch.dtype):
    """The port's restorer that the configuration names, built on ``device``
    by the port's factory, computing in ``dtype``, holding ``state``."""
    from msid_tpu_torch.models.restoration import restorer_from_config

    with torch.device(device):
        model = restorer_from_config(config_file["config"], dtype=dtype, device=device)
    model.load_state_dict(state)
    return model


class Driver(scene.Driver):
    def __init__(self, cell: dict, seed: int, device: torch.device):
        from msid_tpu_torch.deployment.sliding_window import make_device_scene_step

        self.cell, self.seed, self.device = cell, seed, device
        self.config = cell["config"]["config"]
        t = self.traffic = cell["traffic"]
        self.scenes = gen.scenes(t, seed, device)
        model = program_model(cell["config"], restormer.seeded_state(self.config, seed, device),
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
        self.extra.update(model_size=int(self.traffic["model_size"]))

    def reference(self, scene_raw: np.ndarray, operands=None) -> np.ndarray:
        t = self.traffic
        state = restormer.seeded_state(self.config, self.seed, self.device)
        ref = restormer.reference_model(self.config, state, self.device).eval()
        if operands is not None:
            ref.operands.fn = operands
        with exact_fp32():
            return ref_scene.restore(ref, scene_raw, int(t["window"]), int(t["overlap"]),
                                     int(t["model_size"]), int(t["batch"]), self.device)
