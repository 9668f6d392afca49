"""Scenes restored back to back through the port's scene path.

The program under test: ``restore_scene(..., device_assembly=True)`` with
one ``make_device_scene_step`` reused across scenes (the per-batch
function, captured as a CUDA graph), on the configuration's restorer in its
dtype, with the traffic file's ``optimize`` (``"auto"``: the folded hybrid
graph where the model supports it, as ``unet_light`` does, else the
module's forward with the decoder's fused blocks, K1 in bf16). The traffic file sets the
scene size, the window, overlap, model size and batch, and how many
distinct scenes the seed makes; the window cycles through them, closed
loop. ``restore_mpix_per_s`` is the pixels of the completed scenes over
the time from the window's start to the end of the last one.

The check: one completed scene, drawn from the seed among those of the
window (reservoir sampling), is restored again by the plain reference in
float32 from the same raw scene and the same seeded weights; the number
compared is the worst relative RMS gap over 64-pixel squares.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic as gen
from portbench.kinds import DTYPES, program_model, worst_block_rel_rms
from portbench.reference import scene as ref_scene
from portbench.reference.precision import exact_fp32, fp8_operands
from portbench.weights import reference_model, seeded_state

CHECK_BLOCK = 64


class Driver:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        from msid_tpu_torch.deployment.sliding_window import make_device_scene_step

        self.cell, self.seed, self.device = cell, seed, device
        self.config = cell["config"]["config"]
        t = self.traffic = cell["traffic"]
        self.scenes = gen.scenes(t, seed, device)
        model = program_model(cell["config"], seeded_state(self.config, seed, device), device,
                              DTYPES[cell["config"]["dtype"]])
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

    def restore(self, k: int) -> np.ndarray:
        from msid_tpu_torch.deployment.sliding_window import restore_scene

        t = self.traffic
        return restore_scene(None, None, self.scenes[k % len(self.scenes)], int(t["window"]),
                             int(t["overlap"]), int(t["model_size"]), int(t["batch"]),
                             step=self.step, device_assembly=True, device=self.device)

    def _keep(self, k: int, out: np.ndarray) -> None:
        self.attempted += 1
        if self._pick.random() * self.attempted < 1.0:
            self.kept = (k, out)

    def window(self, seconds: float) -> dict:
        start = time.perf_counter()
        end, pixels, k = start, 0, 0
        while end - start < seconds:
            out = self.restore(k)
            end = time.perf_counter()
            pixels += out.shape[0] * out.shape[1]
            self._keep(k, out)
            k += 1
        return {"restore_mpix_per_s": pixels / (end - start) / 1e6}

    def traced(self) -> None:
        count = int(self.traffic["traced_scenes"])
        windows = len(ref_scene.windows_of(self.scenes[0].shape, int(self.traffic["window"]),
                                           int(self.traffic["overlap"])))
        batch = int(self.traffic["batch"])
        for k in range(count):
            with torch.profiler.record_function("portbench.scene"):
                self._keep(k, self.restore(k))
        self.extra.update(config=self.config, tiles=count * -(-windows // batch) * batch,
                          batch=batch, scenes=count)

    def notes(self) -> list[str]:
        return [f"scenes: {self.attempted} completed, {len(self.scenes)} distinct, "
                f"checked scene {self.kept[0] % len(self.scenes) if self.kept else None}"]

    def release(self) -> None:
        self.step = None

    def reference(self, scene: np.ndarray, operands=None) -> np.ndarray:
        """The plain reference's restore of ``scene``; ``operands`` replaces
        its products' operand rounding (the control's)."""
        t = self.traffic
        state = seeded_state(self.config, self.seed, self.device)
        ref = reference_model(self.config, state, self.device).eval()
        if operands is not None:
            ref.operands.fn = operands
        with exact_fp32():
            return ref_scene.restore(ref, scene, int(t["window"]), int(t["overlap"]),
                                     int(t["model_size"]), int(t["batch"]), self.device)

    def control(self) -> dict:
        """The control's number: the reference with fp8 operands in the
        program's place, on the scene the check would compare."""
        k = self.kept[0] if self.kept else 0
        scene = self.scenes[k % len(self.scenes)]
        got = self.reference(scene, fp8_operands)
        return {"worst_block_rel_rms": worst_block_rel_rms(got, self.reference(scene),
                                                           CHECK_BLOCK)}

    def check(self) -> dict:
        if self.kept is None:
            return {"worst_block_rel_rms": float("inf")}
        k, out = self.kept
        want = self.reference(self.scenes[k % len(self.scenes)])
        return {"worst_block_rel_rms": worst_block_rel_rms(out, want, CHECK_BLOCK)}
