"""Inference session (PyTorch): counterpart of ``msid_tpu/deployment/inference.py``.

``predict`` takes a model-space noisy NHWC float32 numpy batch and returns
the restored NHWC float32 batch, computed in the model's dtype on the
session's device (the GPU unless ``device="cpu"``). ``optimize`` picks the
inference graph (``deployment/fastpath.py``): the module's own forward
(``apply``: a bf16 model's decoder blocks run K1, an fp32 model's K4), the
hybrid graph (module encoder + folded-BN conv-transpose decoder) or the
full fastpath (fused QKV, patch embed and upsample as matmuls); the folded
graphs run library convs and launch no fused-block kernel. ``tta`` > 1
averages each prediction over that many dihedral views of the input
(``ops/tta.py``), around whichever graph was chosen, checked when the
session is built. ``benchmark`` times the forward with CUDA events after
warmup and returns the reference's result. An fp32 session computes in
fp32 on the card: each graph turns TF32 off around itself (``exact_fp32``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.ops.tta import wrap_forward

# The batch-size switch points of optimize="auto" are the JAX package's
# (msid_tpu/deployment/inference.py), kept as behaviour, not as a claim
# about this card: the H100 times of the three graphs at B=1, 16 and 128
# are in PERF.md.
# Largest batch at which "auto" picks the full fastpath (0: never).
FASTPATH_AUTO_MAX_BATCH = 0
# Smallest batch at which "auto" picks the hybrid graph; below it "auto"
# serves the module's own forward (self.optimized = False).
HYBRID_AUTO_MIN_BATCH = 8


class InferenceSession:
    """Restoration inference at a fixed batch size."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 1,
                 image_size: int = 192, num_bands: int = 13,
                 device: str | torch.device = "cuda", tta: int = 1,
                 optimize: bool | str = "auto"):
        """``optimize`` selects the inference graph. ``"auto"`` (default)
        picks by batch size and serves the module's own forward for models
        the folded graphs do not support: below ``HYBRID_AUTO_MIN_BATCH``
        the module's forward, from there up the hybrid graph (the full
        fastpath only up to ``FASTPATH_AUTO_MAX_BATCH``, i.e. never).
        ``True`` forces the full fastpath and raises ``ValueError`` for
        unsupported models; ``False`` always uses the module's forward.
        ``self.optimized`` records the choice: ``"fastpath"``, ``"hybrid"``
        or ``False``."""
        self.tta = int(tta)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dtype = getattr(model, "dtype", torch.float32)
        self.batch_size = batch_size
        self.input_shape = (batch_size, image_size, image_size, num_bands)
        self.optimized: bool | str = False
        infer = self._model_forward
        if optimize is True or optimize == "auto":
            from msid_tpu_torch.deployment.fastpath import (
                make_fast_inference_fn,
                make_hybrid_inference_fn,
                optimize_for_hybrid,
                optimize_for_inference,
            )

            small = batch_size <= FASTPATH_AUTO_MAX_BATCH
            try:
                if optimize == "auto" and not small and batch_size < HYBRID_AUTO_MIN_BATCH:
                    pass                       # below the hybrid switch point: the raw graph
                elif optimize is True or small:
                    # The JAX package's choice of upsample form: matmul +
                    # depth-to-space for unet_light, conv-transpose for
                    # unet_skip.
                    mm = self.model.decoder_arch != "unet_skip"
                    with torch.no_grad():
                        weights = optimize_for_inference(
                            self.model, dtype=self.dtype,
                            upsample="matmul" if mm else "ct")
                    infer = functools.partial(
                        make_fast_inference_fn(self.model, matmul_upsample=mm), weights)
                    self.optimized = "fastpath"
                else:
                    with torch.no_grad():
                        weights = optimize_for_hybrid(self.model, dtype=self.dtype)
                    infer = functools.partial(make_hybrid_inference_fn(self.model), weights)
                    self.optimized = "hybrid"
            except ValueError:
                if optimize is True:
                    raise
        elif optimize is not False:
            raise ValueError(f"optimize must be 'auto', True or False, got {optimize!r}")
        self._infer = wrap_forward(infer, self.tta, image_size, image_size)

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
                  seed: int = 0, pipelined: bool = False) -> dict:
        """Device time of one forward on a device-resident batch, after
        ``warmup_runs`` calls: CUDA events around each call, or with
        ``pipelined`` around all of them, one trailing sync, so the calls
        queue back to back. The reference's result: ``mean_ms``, ``fps``
        and ``images_per_sec`` from the mean; a pipelined run is one
        aggregate sample, so its ``std/min/max/p50/p99_ms`` are None. A CPU
        session raises: it has no device time to report."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the GPU with CUDA events; "
                               f"this session runs on {self.device}")
        x = torch.from_numpy(np.random.default_rng(seed).uniform(
            -2.0, 2.0, self.input_shape).astype(np.float32)).to(self.device)
        for _ in range(warmup_runs):
            self._forward(x)
        return benchmark_summary(self._timed_ms(x, benchmark_iterations, pipelined),
                                 self.batch_size, benchmark_iterations, pipelined,
                                 torch.cuda.get_device_name(self.device))

    def _timed_ms(self, x: torch.Tensor, iterations: int, pipelined: bool) -> np.ndarray:
        """ms per forward by CUDA events: one per call, or one aggregate."""
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(1 if pipelined else iterations)]
        if pipelined:
            pairs[0][0].record()
            for _ in range(iterations):
                self._forward(x)
            pairs[0][1].record()
        else:
            for start, end in pairs:
                start.record()
                self._forward(x)
                end.record()
        torch.cuda.synchronize(self.device)
        times_ms = np.asarray([start.elapsed_time(end) for start, end in pairs])
        return times_ms / iterations if pipelined else times_ms


def benchmark_summary(times_ms: np.ndarray, batch_size: int, iterations: int,
                      pipelined: bool, device: str) -> dict:
    """``InferenceSession.benchmark``'s result from its per-call times (one
    aggregate time when ``pipelined``), in the reference's keys."""
    mean_ms = float(np.mean(times_ms))
    result = {
        "mean_ms": mean_ms,
        "fps": 1e3 / mean_ms,
        "images_per_sec": batch_size * 1e3 / mean_ms,
        "batch_size": batch_size,
        "iterations": iterations,
        "device": device,
    }
    if pipelined:
        result.update(std_ms=None, min_ms=None, max_ms=None, p50_ms=None, p99_ms=None)
    else:
        result.update(std_ms=float(np.std(times_ms)), min_ms=float(np.min(times_ms)),
                      max_ms=float(np.max(times_ms)),
                      p50_ms=float(np.percentile(times_ms, 50)),
                      p99_ms=float(np.percentile(times_ms, 99)))
    return result
