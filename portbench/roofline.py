"""Peaks of the card and the operations and bytes of the work, from shapes.

Peaks are NVIDIA's published H100 SXM figures (dense, no sparsity), which
assume the full 700 W; a run prints the card's power limit beside them.

``forward_ops(config)`` lists the products of one tile's forward as
``(flops, kind)``: ``kind`` says what the backward needs of it, which
``train_flops`` counts (no recomputation of checkpointed blocks):

* ``"input"``: a product on the model's input (patch embed, skip stem,
  mask condition): a weight gradient only;
* ``"weight"`` / ``"frozen"``: a product with trainable / frozen weights
  (the frozen ViT blocks): an input gradient, and a weight gradient only
  when trainable;
* ``"pair"``: a product of two activations (attention scores and
  values): a gradient for each.
Elementwise work, norms, the fill's solve and the loss are not counted.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12     # HBM3 bytes/s

SKIP_WIDTH = 32
RESIDUAL_BLOCKS = 2


def block_bound(c: int, s: int, b: int, itemsize: int = 2) -> tuple[float, float, float]:
    """Least seconds of one fused residual block (two 3x3 convs of ``c``
    channels on a ``b x s x s`` batch): ``(seconds, flops, bytes)``, the
    bytes being x read and the output written once, both weights and the
    folded ``[4, c]`` fp32 affine."""
    flops = 2 * 2 * 9 * c * c * s * s * b
    nbytes = (2 * b * s * s * c + 2 * 9 * c * c) * itemsize + 4 * c * 4
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES), flops, nbytes


def decoder_stages(config: dict) -> list[tuple[int, int]]:
    """``(channels, side)`` of each decoder stage, coarse to fine."""
    data, enc = config["data"], config["model"]["encoder"]
    side = int(data["image_size"]) // int(enc["patch_size"])
    stages = []
    for ch in config["model"]["decoder"]["channels"]:
        side *= 2
        stages.append((int(ch), side))
    return stages


def forward_ops(config: dict) -> list[tuple[float, str]]:
    data, model = config["data"], config["model"]
    enc, dec = model["encoder"], model["decoder"]
    size, patch = int(data["image_size"]), int(enc["patch_size"])
    bands, d = int(enc["input_channels"]), int(enc["embed_dim"])
    n = (size // patch) ** 2
    frozen = {int(i) for i in enc.get("freeze_layers") or ()}
    ops = [(2 * n * d * bands * patch * patch, "input")]
    if model.get("input_fill", {}).get("enabled", False):
        ops.append((2 * bands * d, "input"))
    for i in range(int(enc["depth"])):
        kind = "frozen" if i in frozen else "weight"
        ops += [(8 * n * d * d, kind), (16 * n * d * d, kind), (4 * n * n * d, "pair")]
    skip = dec["architecture"] == "unet_skip"
    prev = d
    for ch, side in decoder_stages(config):
        px = side * side
        ops.append((2 * px * prev * ch, "weight"))
        if skip:
            ops.append((2 * px * (ch + SKIP_WIDTH) * ch, "weight"))
        ops.append((RESIDUAL_BLOCKS * 2 * 2 * 9 * ch * ch * px, "weight"))
        prev = ch
    px = size * size
    ops += [(2 * 9 * prev * prev * px, "weight"),
            (2 * prev * int(dec["output_channels"]) * px, "weight")]
    if skip:
        ops.append((2 * 9 * bands * SKIP_WIDTH * px, "input"))
        for level in range(1, len(dec["channels"])):
            ops.append((2 * 9 * SKIP_WIDTH * SKIP_WIDTH * px / 4 ** level, "weight"))
    return ops


def forward_flops(config: dict) -> float:
    """One tile's forward."""
    return float(sum(f for f, _ in forward_ops(config)))


def train_flops(config: dict) -> float:
    """One tile's forward and backward."""
    backward = {"input": 1, "weight": 2, "frozen": 1, "pair": 2}
    return float(sum(f * (1 + backward[kind]) for f, kind in forward_ops(config)))
