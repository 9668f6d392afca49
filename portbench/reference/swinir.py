"""Plain PyTorch reference of the SwinIR restorer the benchmark runs.

SwinIR (Liang et al., ICCV Workshops 2021, arXiv:2108.10257; the code
release's ``models/network_swinir.py``, class ``SwinIR``, with the
denoising options ``upsampler=''``, ``img_range=1.``,
``resi_connection='1conv'``), written from the release's equations in
float32, NCHW around the convs and ``[B, L, C]`` tokens in between:

* ``check_image_size``: reflect-pad to a multiple of ``window_size``;
* ``x_first = conv_first(x)`` (3x3, bands to ``embed_dim``); ``res =
  conv_after_body(forward_features(x_first)) + x_first``; ``x +
  conv_last(res)`` (3x3 back to the bands), cropped to the input's side;
* ``forward_features``: flatten to tokens, ``patch_embed.norm``, the RSTBs,
  ``norm``, unflatten; an RSTB is ``x + conv(blocks(x))`` (3x3);
* a Swin block: ``x + attn(norm1(x))`` over the windows of the image rolled
  by ``-shift`` (``shift`` 0 on even blocks, ``window_size // 2`` on odd
  ones) and rolled back, then ``x + fc2(gelu(fc1(norm2(x))))`` (exact
  GELU); ``WindowAttention``: ``qkv`` split as ``(3, heads, C / heads)``,
  ``q * (C / heads)**-0.5 @ k^T``, plus the ``relative_position_bias_table``
  gathered by ``relative_position_index`` (``(dy + w - 1) (2w - 1) + dx + w
  - 1``), plus ``calculate_mask`` on shifted blocks (-100 between tokens of
  different regions of the rolled image), softmax, ``@ v``, ``proj``.

Departures from the release: ``in_chans`` is the configuration's bands (13
for Sentinel-2; the preset's is 3, and with other than 3 bands the release's
mean is zero), the input comes NHWC and the output goes NHWC, the index and
the mask are computed in each forward (the release registers them as
buffers, so they are not in this state dict), and the weights are drawn
from the seed (``seeded_state``): the output projections scaled by the
depth of their residual stream, the bias tables drawn wide enough to
matter.

Every product (the convs, the Linears and the two attention products)
passes its operands and its result through ``self.q``, and so do the
model's input and output, as in ``reference/model.py``: the identity for
the reference, the fp8 rounding for the control. Nothing of the program is
imported; the parameter names are the program's, so one state dict loads
into both. Run inside ``precision.exact_fp32()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import Operands, QConv, QLinear
from portbench.reference.restormer import module_state

# The bias tables' spread. ``module_state`` draws them N(0, 0.1) (its rule
# for parameters that are neither weights nor norms); they are scaled to
# this. On the benchmark's smooth scenes the tokens of a window are alike,
# so their scores are too and the softmax is close to a mean over the
# window: at 0.1 a program without the bias lands near a bf16 program's
# rounding. At 1 a bf16 forward stays as far from float32 as at 0.1 and
# one without the bias lands well above the fp8 control (CPU, 64-128 px
# windows; the card's readings are in the cell's check file).
BIAS_TABLE_STD = 8.0
SHIFT_MASK = -100.0


def relative_position_index(window: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / window / window))
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window).view(-1, window * window)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, SHIFT_MASK).masked_fill(attn_mask == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = QLinear(dim, 3 * dim)
        self.proj = QLinear(dim, dim)

    def forward(self, x, mask):
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = self.q(self.q(q) @ self.q(k).transpose(-2, -1))
        index = relative_position_index(self.window).to(x.device)
        bias = self.relative_position_bias_table[index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = attn.softmax(dim=-1)
        out = self.q(self.q(attn) @ self.q(v)).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift_size = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = QLinear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = QLinear(int(dim * mlp_ratio), dim)

    def forward(self, x, x_size):
        h, w = x_size
        b, _, c = x.shape
        s, ws = self.shift_size, self.window
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        if s:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        windows = window_partition(x, ws).view(-1, ws * ws, c)
        mask = calculate_mask(h, w, ws, s).to(x.device) if s else None
        x = window_reverse(self.attn(windows, mask).view(-1, ws, ws, c), ws, h, w)
        if s:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = shortcut + x.view(b, h * w, c)
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)), approximate="none"))


class RSTB(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth))
        self.conv = QConv(dim, dim, 3)

    def forward(self, x, x_size):
        b, _, c = x.shape
        y = x
        for block in self.residual_group.blocks:
            y = block(y, x_size)
        y = self.conv(y.transpose(1, 2).reshape(b, c, *x_size))
        return y.flatten(2).transpose(1, 2) + x


class SwinIRReference(nn.Module):
    """NHWC model-range tiles in, restored NHWC tiles out."""

    def __init__(self, config: dict):
        super().__init__()
        enc, dec = config["model"]["encoder"], config["model"]["decoder"]
        bands, dim = int(enc["input_channels"]), int(enc["embed_dim"])
        if int(dec["output_channels"]) != bands:
            raise ValueError("the reference's global residual needs as many bands out as in")
        self.window = int(enc["window_size"])
        mlp_ratio = float(enc["mlp_ratio"])
        self.conv_first = QConv(bands, dim, 3)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(dim)
        self.layers = nn.ModuleList(RSTB(dim, int(d), int(h), self.window, mlp_ratio)
                                    for d, h in zip(enc["depths"], enc["num_heads"]))
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = QConv(dim, dim, 3)
        self.conv_last = QConv(dim, bands, 3)
        self.operands = Operands()
        for m in self.modules():
            object.__setattr__(m, "q", self.operands)

    def forward_features(self, x):
        b, c, h, w = x.shape
        t = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for layer in self.layers:
            t = layer(t, (h, w))
        return self.norm(t).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x):
        x = self.operands(x).permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        ph, pw = (self.window - h % self.window) % self.window, \
            (self.window - w % self.window) % self.window
        x = F.pad(x, (0, pw, 0, ph), "reflect")
        x_first = self.conv_first(x)
        res = self.conv_after_body(self.forward_features(x_first)) + x_first
        out = (x + self.conv_last(res))[:, :, :h, :w]
        return self.operands(out.permute(0, 2, 3, 1))


def output_projections(config: dict) -> list[tuple[str, float]]:
    """``(parameter, scale)`` of each output projection's weight: each
    block's ``attn.proj`` and ``mlp.fc2`` by ``1/sqrt(2 n)``, ``n`` the
    blocks of its RSTB (its residual stream), and each RSTB's ``conv`` by
    ``1/sqrt(m)``, ``m`` the RSTBs (theirs)."""
    enc = config["model"]["encoder"]
    depths = [int(d) for d in enc["depths"]]
    out = []
    for i, depth in enumerate(depths):
        for j in range(depth):
            for name in ("attn.proj", "mlp.fc2"):
                out.append((f"layers.{i}.residual_group.blocks.{j}.{name}.weight",
                            (2 * depth) ** -0.5))
        out.append((f"layers.{i}.conv.weight", len(depths) ** -0.5))
    return out


def seeded_state(config: dict, seed: int, device: torch.device) -> dict:
    """``restormer.module_state`` of the configuration's SwinIR reference
    (weights N(0, 1/fan_in), biases N(0, 0.1), LayerNorm scales N(1, 0.1)
    and shifts N(0, 0.1)), then the output projections scaled by the depth
    of their residual stream (``output_projections``: every block or RSTB
    then adds about as much to its stream whatever the stream's depth, and
    the seeded network's gain, which scales the program's rounding and the
    control's alike, stays even from seed to seed) and the bias tables
    scaled from 0.1 to ``BIAS_TABLE_STD``."""
    with torch.device("meta"):
        ref = SwinIRReference(config)
    state = module_state(ref, seed, device)
    for name, scale in output_projections(config):
        state[name] *= scale
    for name in state:
        if name.endswith("relative_position_bias_table"):
            state[name] *= BIAS_TABLE_STD / 0.1
    return state


def reference_model(config: dict, state: dict, device: torch.device) -> SwinIRReference:
    """The plain SwinIR reference holding ``state``, in float32 on ``device``."""
    with torch.device(device):
        ref = SwinIRReference(config)
    ref.load_state_dict(state)
    return ref
