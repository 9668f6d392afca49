"""Inference session (PyTorch): counterpart of ``msid_tpu/deployment/inference.py``.

``predict`` takes a model-space noisy NHWC float32 numpy batch and returns
the restored NHWC float32 batch, computed in the model's dtype on the
session's device (the GPU unless ``device="cpu"``): a bf16 model's decoder
blocks run K1, an fp32 model's K4. ``tta`` > 1 averages each prediction
over that many dihedral views of the input (``ops/tta.py``), checked when
the session is built. ``benchmark`` times the forward with CUDA events
after warmup.
"""

from __future__ import annotations

import numpy as np
import torch

from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.ops.tta import wrap_forward


class InferenceSession:
    """Restoration inference at a fixed batch size."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 1,
                 image_size: int = 192, num_bands: int = 13,
                 device: str | torch.device = "cuda", tta: int = 1):
        self.tta = int(tta)
        self._infer = wrap_forward(self._model_forward, self.tta, image_size, image_size)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dtype = getattr(model, "dtype", torch.float32)
        self.batch_size = batch_size
        self.input_shape = (batch_size, image_size, image_size, num_bands)

    def _model_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.dtype))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._infer(x).float()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Restore a noisy NHWC float32 batch; checks rank, shape and batch."""
        x = np.asarray(x)
        if x.ndim != 4:
            raise ValueError(f"Expected 4D NHWC input, got ndim={x.ndim}")
        if x.shape[1:] != self.input_shape[1:]:
            raise ValueError(f"Expected shape [*,{self.input_shape[1:]}], got {x.shape}")
        if x.dtype != np.float32:
            x = x.astype(np.float32)
        if x.shape[0] != self.batch_size:
            raise ValueError(
                f"session built for batch {self.batch_size}, got {x.shape[0]}")
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._forward(xt).cpu().numpy()

    def benchmark(self, warmup_runs: int = 10, benchmark_iterations: int = 100,
                  seed: int = 0) -> dict:
        """Device time of one forward on a device-resident batch: CUDA events
        around each call after ``warmup_runs`` calls. A CPU session raises:
        it has no device time to report."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the GPU with CUDA events; "
                               f"this session runs on {self.device}")
        x = torch.from_numpy(np.random.default_rng(seed).uniform(
            -2.0, 2.0, self.input_shape).astype(np.float32)).to(self.device)
        for _ in range(warmup_runs):
            self._forward(x)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(benchmark_iterations)]
        for start, end in pairs:
            start.record()
            self._forward(x)
            end.record()
        torch.cuda.synchronize(self.device)
        times_ms = np.asarray([s.elapsed_time(e) for s, e in pairs])
        mean_ms = float(times_ms.mean())
        return {
            "mean_ms": mean_ms,
            "std_ms": float(times_ms.std()),
            "min_ms": float(times_ms.min()),
            "max_ms": float(times_ms.max()),
            "p50_ms": float(np.percentile(times_ms, 50)),
            "p99_ms": float(np.percentile(times_ms, 99)),
            "images_per_sec": self.batch_size * 1e3 / float(np.percentile(times_ms, 50)),
            "batch_size": self.batch_size,
            "iterations": benchmark_iterations,
            "device": torch.cuda.get_device_name(self.device),
        }
