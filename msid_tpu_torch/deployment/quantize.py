"""Weight quantization for deployment artifacts (PyTorch): counterpart of
``msid_tpu/deployment/quantize.py``.

Symmetric per-output-channel int8 weight-only quantization, the JAX
package's rule: ``scale = max|w| / 127`` over everything but the output
channel (1 for an all-zero channel), ``q = clip(rint(w / scale), -127,
127)``; compute stays bf16/fp32 (dequantized at load).

The quantized tensors and their channel grouping are flax's, so that a
dequantized port model is tensor for tensor the converted dequantized JAX
model: exactly the weights whose flax counterpart is a >=2-D ``kernel``
leaf, with the scale running over that kernel's last axis. In the port's
layouts that axis is

  * dim 0 of a ``Conv2d`` or ``Linear`` weight (OIHW, ``[out, in]``);
  * dim 1 of a ``ConvTranspose2d`` weight (``[in, out, kh, kw]``);
  * ``head_dim`` of the attention's query/key/value weights, shared across
    heads (flax kernel ``[D, H, hd]``): row ``h * hd + j`` takes the scale
    of ``j``;
  * the output feature of the attention's output weight (flax ``[H, hd,
    D]``), which is dim 0, as for any ``Linear``.

Position embedding, norms, biases and ``fill_gram`` stay fp32. The port's
weights do not say their layout by name, so the functions take the model.
Scales are stored broadcastable against the weight (``[C, 1, ...]``,
``[1, C, 1, 1]``; per row for query/key/value).

API (numpy in, numpy out; ``variables`` is a ``{name: array}`` state dict):
    qparams, scales = quantize_params(variables, model)
    variables_hat   = dequantize_params(qparams, scales)
    report          = quantization_report(variables, model)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from msid_tpu_torch.models.encoder import MultiHeadAttention

_UNQUANTIZED = np.zeros((0,), np.float32)  # sentinel: kept full precision


def kernel_layouts(model: nn.Module) -> dict[str, tuple[int, int]]:
    """``{state-dict name: (output axis, heads)}`` of every weight that is a
    flax kernel: ``heads`` > 1 for query/key/value (rows ``h * hd + j``
    grouped by ``j``), else 1."""
    layouts: dict[str, tuple[int, int]] = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention):
            for proj in ("query", "key", "value"):
                layouts[f"{prefix}{proj}.weight"] = (0, m.num_heads)
        elif isinstance(m, nn.ConvTranspose2d):
            layouts[f"{prefix}weight"] = (1, 1)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            layouts.setdefault(f"{prefix}weight", (0, 1))
    return layouts


def _quantize(w: np.ndarray, axis: int, heads: int) -> tuple[np.ndarray, np.ndarray]:
    w = np.asarray(w, np.float32)
    # Group the output channels as the flax kernel's last axis: a view with
    # that axis at 1 for query/key/value ([H, hd, in]), as it is otherwise.
    v = w.reshape(heads, w.shape[0] // heads, -1) if heads > 1 else w
    keep = 1 if heads > 1 else axis
    axes = tuple(i for i in range(v.ndim) if i != keep)
    amax = np.abs(v).max(axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8).reshape(w.shape)
    if heads > 1:
        scale = np.broadcast_to(scale, (heads, scale.shape[1], 1)).reshape(-1, 1)
    return q, np.ascontiguousarray(scale)


def quantize_params(variables: Mapping[str, np.ndarray],
                    model: nn.Module) -> tuple[dict, dict]:
    """``(qtree, scale_tree)`` over the keys of ``variables``: the model's
    kernels as int8 with their fp32 scales, every other entry as it is with
    an empty-array sentinel for its scale."""
    layouts = kernel_layouts(model)
    qtree, stree = {}, {}
    for name, value in variables.items():
        value = np.asarray(value)
        if name in layouts and value.ndim >= 2:
            qtree[name], stree[name] = _quantize(value, *layouts[name])
        else:
            qtree[name], stree[name] = value, _UNQUANTIZED
    return qtree, stree


def dequantize_params(qtree: Mapping[str, np.ndarray],
                      stree: Mapping[str, np.ndarray]) -> dict:
    """int8 + scales -> fp32 kernels; other entries as they are."""
    return {k: q if stree[k].size == 0 else np.asarray(q, np.float32) * stree[k]
            for k, q in qtree.items()}


def quantized_size_bytes(qtree: Mapping[str, np.ndarray]) -> int:
    return sum(np.asarray(v).nbytes for v in qtree.values())


def quantization_report(variables: Mapping[str, np.ndarray], model: nn.Module,
                        sample_input=None) -> dict:
    """Size reduction and, with a ``sample_input`` (an NHWC tensor on the
    model's device), the output error of the dequantized weights, in the
    JAX package's keys. Only the model's parameters count, as only the JAX
    params are quantized (not the BatchNorm statistics)."""
    names = {n for n, _ in model.named_parameters()}
    params = {k: np.asarray(v) for k, v in variables.items() if k in names}
    qtree, stree = quantize_params(params, model)
    orig = sum(v.nbytes for v in params.values())
    quant = quantized_size_bytes(qtree) + quantized_size_bytes(stree)
    report = {"original_mb": orig / 1e6, "quantized_mb": quant / 1e6,
              "compression": orig / max(quant, 1)}
    if sample_input is not None:
        hat = dequantize_params(qtree, stree)
        device = sample_input.device
        dtypes = {k: v.dtype for k, v in model.state_dict().items()}

        def run(weights: Mapping[str, np.ndarray]) -> torch.Tensor:
            tensors = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device, dtypes[k])
                       for k, v in {**variables, **weights}.items()}
            with torch.no_grad():
                return functional_call(model, tensors,
                                       (sample_input.to(model.dtype),)).float()

        training = model.training
        model.eval()
        try:
            d = (run(params) - run(hat)).abs()
        finally:
            model.train(training)
        report["max_abs_err"] = float(d.max())
        report["mean_abs_err"] = float(d.mean())
    return report
