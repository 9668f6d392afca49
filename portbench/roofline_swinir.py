"""Operations and bytes of the SwinIR restorer, from shapes.

``forward_ops(config, side)`` lists the products of one ``side x side``
tile's forward (``reference/swinir.py``; the side reflect-padded up to a
multiple of the window first) as ``(flops, kind)``, two FLOPs a
multiply-add:

* ``"conv"``: the 3x3 convs (``conv_first``, each RSTB's ``conv``,
  ``conv_after_body``, ``conv_last``);
* ``"linear"``: each Swin block's ``qkv``, ``proj``, ``mlp.fc1`` and
  ``mlp.fc2``;
* ``"attention"``: each block's two window-attention products, ``q k^T``
  and ``A v``, ``2 * window**2 * C`` a token each.

Norms, softmax, GELU, the bias, the mask, the rolls and the adds are not
counted. ``attention_bound(batch, windows, heads, tokens, head_dim)`` is the
least time of one block's attention launch over ``batch`` tiles of
``windows`` windows of ``tokens`` tokens: the larger of its products (``4 B
nW H N^2 d``) at the bf16 peak and of its bytes (bf16 ``q``, ``k``, ``v``
read once, the output written once, the ``[H, N, N]`` bias read once) at
the HBM peak. The peaks are ``roofline.py``'s.
"""

from __future__ import annotations

from portbench.roofline import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

BF16_BYTES = 2
TAPS = 9


def _sizes(config: dict) -> tuple:
    enc = config["model"]["encoder"]
    return (int(enc["input_channels"]), int(enc["embed_dim"]),
            [int(d) for d in enc["depths"]], [int(h) for h in enc["num_heads"]],
            int(enc["window_size"]), float(enc["mlp_ratio"]))


def padded_side(config: dict, side: int) -> int:
    window = _sizes(config)[4]
    return -(-side // window) * window


def attention_windows(config: dict, side: int) -> int:
    """Attention windows of one ``side x side`` tile."""
    return (padded_side(config, side) // _sizes(config)[4]) ** 2


def block_ops(c: int, pixels: int, window: int, mlp_ratio: float) -> list[tuple[float, str]]:
    hidden = int(c * mlp_ratio)
    n = window * window
    return [(2 * pixels * c * 3 * c, "linear"), (2 * pixels * n * c, "attention"),
            (2 * pixels * n * c, "attention"), (2 * pixels * c * c, "linear"),
            (2 * pixels * c * hidden, "linear"), (2 * pixels * hidden * c, "linear")]


def forward_ops(config: dict, side: int) -> list[tuple[float, str]]:
    bands, c, depths, _, window, mlp_ratio = _sizes(config)
    px = padded_side(config, side) ** 2
    ops = [(2 * px * TAPS * bands * c, "conv")]
    for depth in depths:
        ops += block_ops(c, px, window, mlp_ratio) * depth
        ops.append((2 * px * TAPS * c * c, "conv"))
    ops += [(2 * px * TAPS * c * c, "conv"), (2 * px * TAPS * c * bands, "conv")]
    return ops


def forward_flops(config: dict, side: int) -> float:
    """One ``side x side`` tile's forward through SwinIR."""
    return float(sum(f for f, _ in forward_ops(config, side)))


def attention_launches(config: dict) -> list[tuple[int, int]]:
    """``(heads, head_dim)`` of each block's attention launch in one forward."""
    _, c, depths, heads, _, _ = _sizes(config)
    return [(h, c // h) for depth, h in zip(depths, heads) for _ in range(depth)]


def attention_bound(batch: int, windows: int, heads: int, tokens: int, head_dim: int) -> float:
    flops = 4 * batch * windows * heads * tokens * tokens * head_dim
    nbytes = (4 * batch * windows * tokens * heads * head_dim + heads * tokens * tokens) \
        * BF16_BYTES
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
