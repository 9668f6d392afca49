"""Operations and bytes of the Restormer restorer, from shapes.

``forward_ops(config, side)`` lists the products of one ``side x side``
tile's forward (``reference/restormer.py``) as ``(flops, kind)``, two
FLOPs a multiply-add:

* ``"conv"``: the dense convs (the 3x3 stem, downsamples, upsamples and
  head, the 1x1 projections and channel reductions);
* ``"depthwise"``: the two depthwise 3x3 convs of each block (``qkv_dwconv``
  over ``3C`` channels, GDFN's ``dwconv`` over ``2 Hd``);
* ``"attention"``: the two channel-attention products of each block, ``q
  k^T`` and ``A v``, each ``2 C (C/h) P`` over the ``P`` pixels.

Norms, softmax, GELU, the gate and the adds are not counted.
``depthwise_convs(config, side)`` gives ``(channels, side)`` of each
depthwise conv of one forward, in order, and ``depthwise_bound(batch,
channels, side)`` the least time of one such launch: its bf16 input read
and output written once, and its bf16 weights, at the HBM peak (its products
at the bf16 peak would take 1/66 of that). The peaks are ``roofline.py``'s.
"""

from __future__ import annotations

from portbench.roofline import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

BF16_BYTES = 2
TAPS = 9


def _sizes(config: dict) -> tuple:
    enc, dec = config["model"]["encoder"], config["model"]["decoder"]
    dim = int(enc["dim"])
    widths = [dim * 2 ** i for i in range(4)]
    return (int(enc["input_channels"]), widths, [int(n) for n in enc["num_blocks"]],
            [int(n) for n in enc["heads"]], float(enc["ffn_expansion_factor"]),
            int(dec["num_refinement_blocks"]))


def _levels(config: dict, side: int) -> list[tuple[int, int, int, int]]:
    """``(channels, heads, blocks, side)`` of every level of blocks, in the
    order the forward runs them."""
    _, w, n, h, _, refine = _sizes(config)
    sides = [side // 2 ** i for i in range(4)]
    return [(w[0], h[0], n[0], sides[0]), (w[1], h[1], n[1], sides[1]),
            (w[2], h[2], n[2], sides[2]), (w[3], h[3], n[3], sides[3]),
            (w[2], h[2], n[2], sides[2]), (w[1], h[1], n[1], sides[1]),
            (w[1], h[0], n[0], sides[0]), (w[1], h[0], refine, sides[0])]


def block_ops(c: int, heads: int, pixels: int, expansion: float) -> list[tuple[float, str]]:
    hidden = int(c * expansion)
    return [(2 * pixels * c * 3 * c, "conv"), (2 * pixels * 3 * c * TAPS, "depthwise"),
            (2 * pixels * c * (c // heads), "attention"),
            (2 * pixels * c * (c // heads), "attention"), (2 * pixels * c * c, "conv"),
            (2 * pixels * c * 2 * hidden, "conv"), (2 * pixels * 2 * hidden * TAPS, "depthwise"),
            (2 * pixels * hidden * c, "conv")]


def forward_ops(config: dict, side: int) -> list[tuple[float, str]]:
    bands, w, _, _, expansion, _ = _sizes(config)
    px = [(side // 2 ** i) ** 2 for i in range(4)]
    ops = [(2 * px[0] * TAPS * bands * w[0], "conv")]
    for c, heads, blocks, s in _levels(config, side):
        ops += block_ops(c, heads, s * s, expansion) * blocks
    for i in range(3):                   # downsamples: 3x3, C -> C/2 at level i's side
        ops.append((2 * px[i] * TAPS * w[i] * (w[i] // 2), "conv"))
    for i in (3, 2, 1):                  # upsamples: 3x3, C -> 2C at level i's side
        ops.append((2 * px[i] * TAPS * w[i] * 2 * w[i], "conv"))
    ops.append((2 * px[2] * w[3] * w[2], "conv"))            # reduce_chan_level3
    ops.append((2 * px[1] * w[2] * w[1], "conv"))            # reduce_chan_level2
    ops.append((2 * px[0] * TAPS * w[1] * bands, "conv"))    # output
    return ops


def forward_flops(config: dict, side: int) -> float:
    """One ``side x side`` tile's forward through Restormer."""
    return float(sum(f for f, _ in forward_ops(config, side)))


def depthwise_convs(config: dict, side: int) -> list[tuple[int, int]]:
    _, _, _, _, expansion, _ = _sizes(config)
    convs = []
    for c, _, blocks, s in _levels(config, side):
        convs += [(3 * c, s), (2 * int(c * expansion), s)] * blocks
    return convs


def depthwise_bound(batch: int, channels: int, side: int) -> float:
    nbytes = (2 * batch * channels * side * side + TAPS * channels) * BF16_BYTES
    flops = 2 * batch * channels * side * side * TAPS
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
