"""Seeded weights for both sides, made on the device in a few large draws.

The names and shapes come from the plain reference (``reference/model.py``),
whose parameter names are the program's, so the same state dict loads into
the program under test and into the reference. Every value is random,
including the heads the program initialises to zero and the fill's Gram
matrix, so that every path carries signal:

* conv and dense weights N(0, 1/fan_in), their biases N(0, 0.1);
* norm scales N(1, 0.1), norm shifts and running means N(0, 0.1),
  running variances U(0.5, 2);
* the position embedding N(0, 0.02);
* the Gram matrix ``A A^T / n + 0.1 I`` (symmetric positive definite).
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.model import Norm, Restorer


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose2d):
        return weight.shape[0]
    return weight[0].numel()


def seeded_state(config: dict, seed: int, device: torch.device) -> dict:
    """``{name: fp32 tensor on device}`` for every parameter and buffer of
    the configuration's restorer, drawn from ``seed``."""
    with torch.device("meta"):
        ref = Restorer(config)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    normals = []        # (name, shape, std, mean)
    variances = []      # (name, shape)
    for prefix, module in ref.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{prefix}.{pname}" if prefix else pname
            if pname == "fill_gram":
                continue
            if pname == "pos_embed":
                normals.append((name, p.shape, 0.02, 0.0))
            elif isinstance(module, (Norm, nn.LayerNorm)):
                normals.append((name, p.shape, 0.1, 1.0 if pname == "weight" else 0.0))
            elif pname == "weight":
                normals.append((name, p.shape, _fan_in(module, p) ** -0.5, 0.0))
            else:
                normals.append((name, p.shape, 0.1, 0.0))
        if isinstance(module, Norm):
            normals.append((f"{prefix}.running_mean", module.running_mean.shape, 0.1, 0.0))
            variances.append((f"{prefix}.running_var", module.running_var.shape))
    total = sum(s.numel() for _, s, _, _ in normals)
    flat = torch.randn(total, generator=g, device=device)
    state, at = {}, 0
    for name, shape, std, mean in normals:
        n = shape.numel()
        state[name] = flat[at:at + n].view(shape) * std + mean
        at += n
    total = sum(s.numel() for _, s in variances)
    flat = torch.rand(total, generator=g, device=device) * 1.5 + 0.5
    at = 0
    for name, shape in variances:
        state[name] = flat[at:at + shape.numel()].view(shape)
        at += shape.numel()
    if ref.fill:
        n = ref.fill_gram.shape[0]
        a = torch.randn(n, n, generator=g, device=device)
        state["fill_gram"] = a @ a.T / n + 0.1 * torch.eye(n, device=device)
    return state


def reference_model(config: dict, state: dict, device: torch.device) -> Restorer:
    """The plain reference holding ``state``, in float32 on ``device``."""
    with torch.device(device):
        ref = Restorer(config)
    ref.load_state_dict(state)
    return ref
