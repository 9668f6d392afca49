"""VGG16 feature-space perceptual loss (PyTorch): counterpart of
``msid_tpu/training/perceptual.py``.

The reference's ``PerceptualLoss``: VGG16 ``.features`` activations after
relu1_2 / relu2_2 / relu3_3 / relu4_3 (torchvision sequential indices
3/8/15/22), the MSE between the prediction's and the target's features on
the first 3 bands, unit layer weights, no input normalization; fp32 with
autocast off, whatever the dtype of the images.

The weights are an input (nothing is downloaded): point
``training.loss.perceptual_weights_path`` at a torchvision ``vgg16``
state dict (``.pth``) or an ``.npz`` holding the same
``features.N.weight/bias`` arrays, and set ``perceptual_impl: vgg``.
Without weights the loss falls back to the Sobel edge stand-in
(``training/losses.py``). Parameters are ``{"features.N.weight": OIHW,
"features.N.bias": [O]}`` fp32 tensors (the JAX package holds HWIO).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

# torchvision vgg16().features conv indices and channel plan through relu4_3.
VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)
# maxpool immediately BEFORE these conv ids
_POOL_BEFORE = frozenset({5, 10, 17})
# relu outputs that feed the loss: conv id -> torchvision relu index
FEATURE_AFTER_CONV = {2: "3", 7: "8", 14: "15", 21: "22"}
DEFAULT_LAYER_WEIGHTS = {"3": 1.0, "8": 1.0, "15": 1.0, "22": 1.0}


def init_vgg16_params(seed: int = 0, device: str | torch.device = "cpu") -> dict:
    """He-initialized random VGG16-features weights: the JAX package's draws
    for the same seed, in OIHW (for tests, and a random-feature loss)."""
    rng = np.random.default_rng(seed)
    params = {}
    cin = 3
    for conv_id, cout in zip(VGG16_CONV_IDS, VGG16_CHANNELS):
        w = rng.normal(0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout)).astype(np.float32)
        params[f"features.{conv_id}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(device)
        params[f"features.{conv_id}.bias"] = torch.zeros(cout, device=device)
        cin = cout
    return params


def load_vgg16_weights(path: str | Path, device: str | torch.device = "cpu") -> dict:
    """torchvision vgg16 ``features.*`` weights from ``.pth`` or ``.npz``, as
    fp32 OIHW tensors on ``device``. A kernel whose first two axes are 3x3
    is HWIO (the JAX package's layout) and is transposed; classifier
    weights are ignored."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
        raw = {k: v.float().numpy() for k, v in state.items()}
    params = {}
    for conv_id in VGG16_CONV_IDS:
        wk, bk = f"features.{conv_id}.weight", f"features.{conv_id}.bias"
        if wk not in raw:
            raise KeyError(f"VGG16 weights at {path} miss {wk}")
        w = np.asarray(raw[wk], np.float32)
        if w.ndim != 4:
            raise ValueError(f"{wk}: expected 4-D conv kernel, got {w.shape}")
        if w.shape[0] == 3 and w.shape[1] == 3:  # HWIO
            w = w.transpose(3, 2, 0, 1)
        params[wk] = torch.from_numpy(np.ascontiguousarray(w)).to(device)
        params[bk] = torch.from_numpy(np.asarray(raw[bk], np.float32)).to(device)
    logger.info("Loaded VGG16 perceptual weights from %s", path)
    return params


def vgg16_features(params: dict, x: torch.Tensor) -> dict:
    """``{relu index: NHWC activation}`` of an NHWC input's first 3 bands
    (the caller slices), fp32 with autocast off."""
    with torch.autocast(x.device.type, enabled=False):
        y = x.float().permute(0, 3, 1, 2)
        feats = {}
        for conv_id in VGG16_CONV_IDS:
            if conv_id in _POOL_BEFORE:
                y = F.max_pool2d(y, 2)
            y = F.relu(F.conv2d(y, params[f"features.{conv_id}.weight"],
                                params[f"features.{conv_id}.bias"], padding=1))
            name = FEATURE_AFTER_CONV.get(conv_id)
            if name is not None:
                feats[name] = y.permute(0, 2, 3, 1)
        return feats


def vgg_perceptual_per_sample(params: dict, pred: torch.Tensor, target: torch.Tensor,
                              layer_weights: dict | None = None) -> torch.Tensor:
    """Per-sample feature MSE on the first 3 bands, summed over the layers
    with their weights, fp32 ``[B]``; its mean is
    :func:`vgg_perceptual_loss`."""
    lw = layer_weights or DEFAULT_LAYER_WEIGHTS
    fp = vgg16_features(params, pred[..., :3])
    ft = vgg16_features(params, target[..., :3])
    total = torch.zeros(pred.shape[0], device=pred.device)
    for layer, weight in lw.items():
        d = (fp[layer] - ft[layer]).reshape(pred.shape[0], -1)
        total = total + weight * torch.mean(d * d, dim=-1)
    return total


def vgg_perceptual_loss(params: dict, pred: torch.Tensor, target: torch.Tensor,
                        layer_weights: dict | None = None) -> torch.Tensor:
    """The reference's ``PerceptualLoss.forward``: the weighted sum over the
    layers of the feature MSE on the first 3 bands (a scalar)."""
    return torch.mean(vgg_perceptual_per_sample(params, pred, target, layer_weights))


def resolve_perceptual(loss_config: dict, device: str | torch.device = "cpu"):
    """``(impl, vgg_params)`` from a ``training.loss`` section: ``("vgg",
    weights on device)`` when ``perceptual_impl: vgg`` names a weights file
    that exists, else ``("edge", None)`` (with a warning when VGG was asked
    for, as the reference disables it when its weights cannot be had). An
    unknown name raises ``ValueError``."""
    impl = str(loss_config.get("perceptual_impl", "edge")).lower()
    if impl not in ("vgg", "edge"):
        raise ValueError(f"unknown perceptual_impl {impl!r}")
    if impl != "vgg":
        return "edge", None
    path = loss_config.get("perceptual_weights_path")
    if path and Path(path).exists():
        return "vgg", load_vgg16_weights(path, device)
    logger.warning("perceptual_impl=vgg but no weights at %r — falling back to the "
                   "Sobel edge stand-in", path)
    return "edge", None
