"""Operations and bytes of the group-channel restorer, from shapes.

``roofline.forward_ops`` counts one token a patch and a decoder fed
``embed_dim`` channels; the group-channel encoder (``reference/grouped.py``)
has ``G`` tokens a patch and feeds ``G * embed_dim`` channels. Its encoder
is counted here; its decoder is ``roofline.forward_ops``'s own count, taken
from a configuration with no blocks and a ``G * embed_dim`` wide token (the
patch embed and mask condition that count puts first are dropped). The
peaks are ``roofline.py``'s.

``attention_bound(batch, heads, tokens, head_dim)`` is the least time of
one fused attention launch over ``[batch, heads, tokens, head_dim]`` bf16
``q``, ``k``, ``v``: the larger of its products (``q k^T`` and ``p v``,
``4 B H N^2 hd``) at the bf16 peak and of its bytes (``q``, ``k``, ``v``
read and ``o`` written once) at the HBM peak.
"""

from __future__ import annotations

import copy

from portbench.roofline import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, forward_ops

BF16_BYTES = 2


def _sizes(config: dict) -> tuple:
    enc = config["model"]["encoder"]
    groups = [list(g) for g in enc["channel_groups"]]
    length = (int(config["data"]["image_size"]) // int(enc["patch_size"])) ** 2
    return enc, groups, length, int(enc["embed_dim"])


def encoder_ops(config: dict) -> list[tuple[float, str]]:
    """``(flops, kind)`` of one tile's group-channel encoder, as
    ``roofline.forward_ops`` names kinds."""
    enc, groups, length, d = _sizes(config)
    patch, n = int(enc["patch_size"]), len(groups) * length
    frozen = {int(i) for i in enc.get("freeze_layers") or ()}
    ops = [(2 * length * d * len(g) * patch * patch, "input") for g in groups]
    if config["model"].get("input_fill", {}).get("enabled", False):
        ops.append((2 * int(enc["input_channels"]) * d, "input"))
    for i in range(int(enc["depth"])):
        kind = "frozen" if i in frozen else "weight"
        ops += [(8 * n * d * d, kind), (16 * n * d * d, kind), (4 * n * n * d, "pair")]
    return ops


def decoder_ops(config: dict) -> list[tuple[float, str]]:
    """``roofline.forward_ops``'s decoder and skip pyramid at the grouped
    decoder's input width."""
    enc, groups, _, d = _sizes(config)
    flat = copy.deepcopy(config)
    flat["model"]["encoder"].update(depth=0, embed_dim=len(groups) * d)
    lead = 2 if config["model"].get("input_fill", {}).get("enabled", False) else 1
    return forward_ops(flat)[lead:]


def forward_flops(config: dict) -> float:
    """One tile's forward through the group-channel restorer."""
    return float(sum(f for f, _ in encoder_ops(config) + decoder_ops(config)))


def attention_bound(batch: int, heads: int, tokens: int, head_dim: int) -> float:
    flops = 4 * batch * heads * tokens * tokens * head_dim
    nbytes = 4 * batch * heads * tokens * head_dim * BF16_BYTES
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
