"""SwinIR (PyTorch): a shifted-window transformer restorer, a port-only
restorer beside ``SatMAERestoration`` and ``RestormerRestoration``.

Liang et al., "SwinIR: Image Restoration Using Swin Transformer", ICCV
Workshops 2021 (arXiv:2108.10257); the code release's
``models/network_swinir.py``, class ``SwinIR``, with the denoising options
(``upsampler=''``, ``img_range=1.``, ``resi_connection='1conv'``). NHWC
model-range tiles in, NHWC out, at the tile's own resolution:

* the tile is reflect-padded to a multiple of ``window_size`` (the
  release's ``check_image_size``) and the output cropped back;
* ``x_first = conv_first(x)``, a 3x3 conv from the bands to ``embed_dim``;
  ``res = conv_after_body(forward_features(x_first)) + x_first``; the output
  is ``x + conv_last(res)``, a 3x3 conv back to the bands (with bands other
  than 3 the release's mean is zero, and ``img_range`` is 1);
* ``forward_features``: the pixels as tokens, ``patch_embed.norm``
  (LayerNorm), the residual Swin transformer blocks (RSTBs), ``norm``;
* an RSTB is ``x + conv3x3(blocks(x))`` over ``depths[i]`` Swin blocks;
* a Swin block is ``x + attn(LN1(x))`` then ``x + fc2(gelu(fc1(LN2(x))))``
  (exact GELU, hidden width ``mlp_ratio * embed_dim``); every second block
  rolls the image by ``-window_size // 2`` on both axes before its window
  partition and back after the reverse;
* window attention: ``qkv`` (a Linear with bias) split into heads, scores
  ``(q * d**-0.5) k^T + B + M`` over the ``window_size**2`` tokens of each
  window, softmax, ``@ v``, ``proj``. ``B`` is the learned
  ``relative_position_bias_table`` gathered by the release's
  ``relative_position_index``; ``M`` is the release's ``calculate_mask``
  for the padded side on shifted blocks: -100 between tokens that the roll
  brought together from different regions of the image, 0 elsewhere.

The parameter names are the release's (``layers.{i}.residual_group.blocks
.{j}.attn.relative_position_bias_table`` and so on). The release keeps the
index and the mask as buffers; here they are derived tensors, built once
for each padded side, device and dtype (``SwinIRRestoration.derived``) and
counted in ``derived_builds``.

The window attention is one ``F.scaled_dot_product_attention`` call a block
with ``B + M`` as its additive mask, so that a fused back end can take it on
a card. Those back ends take head widths in multiples of ``HEAD_ALIGN``:
``qkv``'s and ``proj``'s weights are zero-padded to that width for each head
(30 -> 32 at the published preset), with the scale kept at the true width,
which is the same mathematics. Unshifted blocks order the tokens window by
window (SDPA's batch is the windows of every image, its heads the model's),
and their mask is ``B`` alone, broadcast over the windows; shifted blocks
order them position by position (SDPA's batch is the images, its heads the
windows' heads), so that their ``B + M``, one per window, is broadcast over
the images. Everything computes in the model's dtype; the LayerNorm
statistics and the softmax accumulate in float32 (PyTorch's kernels).
Spans: ``msid.swinir.attention`` (roll, partition, attention, reverse),
``msid.swinir.mlp`` and ``msid.swinir.rstb``, in eager forwards (a scene
step replays a captured graph, which the spans do not see).
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from msid_tpu_torch.models.restoration import exact_fp32, resolve_device
from msid_tpu_torch.utils.profiling import annotate

SHIFT_MASK = -100.0    # the release's score between tokens of different regions
HEAD_ALIGN = 8         # head widths the fused attention back ends take

# Builds of the derived tensors, by name ("index", "mask"), in this process.
derived_builds: collections.Counter = collections.Counter()


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """``[window**2, window**2]`` int64: for tokens i, j of a window, the row
    of the bias table for their offset, ``(dy + w - 1) * (2w - 1) + dx + w - 1``."""
    token = torch.arange(window * window, device=device)
    ys, xs = token // window, token % window
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def shift_mask(h: int, w: int, window: int, shift: int, device=None) -> torch.Tensor:
    """``[windows, window**2, window**2]`` float32, windows in raster order:
    ``SHIFT_MASK`` between tokens of one window of the rolled ``h x w``
    image that came from different regions of the image (the release's
    three bands a side: up to ``-window``, to ``-shift``, the rest), 0
    elsewhere. Built from arithmetic on the device alone, so that an
    exported program that builds it copies nothing from the host."""
    ys, xs = torch.arange(h, device=device), torch.arange(w, device=device)
    rows = (ys >= h - window).long() + (ys >= h - shift).long()
    cols = (xs >= w - window).long() + (xs >= w - shift).long()
    regions = 3 * rows[:, None] + cols[None, :]
    tokens = regions.view(h // window, window, w // window, window).permute(0, 2, 1, 3)
    tokens = tokens.reshape(-1, window * window)
    differ = tokens[:, None, :] != tokens[:, :, None]
    return torch.where(differ, SHIFT_MASK, 0.0)


def pad_heads(t: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """``t`` with its dimension ``dim`` (``heads`` heads of equal width)
    zero-padded per head to a multiple of ``HEAD_ALIGN``."""
    width = t.shape[dim] // heads
    extra = -width % HEAD_ALIGN
    if not extra:
        return t
    dim = dim % t.dim()
    split = t.unflatten(dim, (heads, width))
    pad = [0, 0] * (split.dim() - dim - 2) + [0, extra]
    return F.pad(split, pad).flatten(dim, dim + 1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self, index: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``B``: ``[heads, window**2, window**2]`` in ``dtype``."""
        n = self.window ** 2
        table = self.relative_position_bias_table.to(dtype)
        return table[index.view(-1)].view(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def _attend(self, q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=(self.dim // self.num_heads) ** -0.5)

    def forward(self, x: torch.Tensor, shift: int, index: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """Attention within the windows of ``x`` ``[B, H, W, C]`` (sides
        multiples of the window), rolled by ``-shift`` first and back after
        when ``shift``; ``mask`` is ``M`` for this side, used when shifted."""
        b, h, w, c = x.shape
        ws, heads, n = self.window, self.num_heads, self.window ** 2
        gh, gw = h // ws, w // ws
        wqkv = pad_heads(self.qkv.weight.unflatten(0, (3, c)), heads, 1)   # [3, heads*d, C]
        bqkv = pad_heads(self.qkv.bias.unflatten(0, (3, c)), heads, 1)
        wproj = pad_heads(self.proj.weight, heads, 1)                       # [C, heads*d]
        d = wqkv.shape[1] // heads
        grid = x.view(b, gh, ws, gw, ws, c)
        if not shift:
            # windows of every image as SDPA's batch: [B*nW, n, C], window-major
            win = grid.permute(0, 1, 3, 2, 4, 5).reshape(b * gh * gw, n, c)
            qkv = F.linear(win, wqkv.flatten(0, 1), bqkv.flatten()).view(-1, n, 3, heads, d)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            out = self._attend(q, k, v, self.bias(index, q.dtype)[None])
            out = F.linear(out.transpose(1, 2).reshape(-1, n, heads * d), wproj, self.proj.bias)
            return out.view(b, gh, gw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        # tokens of the rolled image position-major, [B, n, nW, C], so that
        # the windows' heads form SDPA's heads and B + M broadcasts over images
        grid = torch.roll(x, (-shift, -shift), (1, 2)).view(b, gh, ws, gw, ws, c)
        pos = grid.permute(0, 2, 4, 1, 3, 5).reshape(b, n, gh * gw, c)
        q, k, v = (F.linear(pos, wqkv[i], bqkv[i]).view(b, n, -1, d).transpose(1, 2)
                   for i in range(3))
        bias_mask = self.bias(index, q.dtype)[None] + mask.to(q.dtype)[:, None]
        out = self._attend(q, k, v, bias_mask.view(1, -1, n, n))
        out = F.linear(out.transpose(1, 2).reshape(b, n, gh * gw, heads * d), wproj,
                       self.proj.bias)
        out = out.view(b, ws, ws, gh, gw, c).permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)
        return torch.roll(out, (shift, shift), (1, 2))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.shift_size = shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with annotate("msid.swinir.attention"):
            x = x + self.attn(self.norm1(x), self.shift_size, index, mask)
        with annotate("msid.swinir.mlp"):
            return x + self.mlp(self.norm2(x))


class RSTB(nn.Module):
    """A residual Swin transformer block: ``x + conv3x3(blocks(x))``."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                                 mlp_ratio) for i in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor, index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with annotate("msid.swinir.rstb"):
            y = x
            for block in self.residual_group.blocks:
                y = block(y, index, mask)
            return x + self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SwinIRRestoration(nn.Module):
    """SwinIR as a restorer of the port: NHWC model-range tiles in and out,
    ``in_channels`` bands each way, any side. The defaults are the release's
    colour-denoising preset (``main_test_swinir.py`` task ``color_dn``) at
    13 bands."""

    def __init__(self, in_channels: int = 13, out_channels: int = 13, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6, num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 8, mlp_ratio: float = 2.0):
        super().__init__()
        if out_channels != in_channels:
            raise ValueError("SwinIR's global residual needs out_channels == in_channels, "
                             f"got {out_channels} != {in_channels}")
        if len(depths) != len(num_heads) or any(embed_dim % h for h in num_heads):
            raise ValueError(f"depths {depths} and num_heads {num_heads} must pair up, each "
                             f"head count dividing embed_dim {embed_dim}")
        self.in_channels = in_channels
        self.window_size = window_size
        self.dtype = torch.float32
        self._derived: dict = {}
        self.conv_first = nn.Conv2d(in_channels, embed_dim, 3, 1, 1)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList(RSTB(embed_dim, depth, heads, window_size, mlp_ratio)
                                    for depth, heads in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_last = nn.Conv2d(embed_dim, out_channels, 3, 1, 1)

    def set_compute_dtype(self, dtype: torch.dtype) -> "SwinIRRestoration":
        """Cast every parameter (convs, Linears, LayerNorms, bias tables) to ``dtype``."""
        self.to(dtype)
        self.dtype = dtype
        return self

    def compute_dtype(self, device_type: str) -> torch.dtype:
        """The dtype the forward computes in: the autocast dtype when
        autocast is on for ``device_type``, else the weights' dtype."""
        if torch.is_autocast_enabled(device_type):
            return torch.get_autocast_dtype(device_type)
        return self.dtype

    def derived(self, h: int, w: int, device: torch.device,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """``(relative_position_index, M)`` for a padded ``h x w`` side on
        ``device``, M in ``dtype``: built at the first forward of that side
        (counted in ``derived_builds``) and kept (not while ``torch.export``
        traces, whose tensors are not real)."""
        key = (h, w, torch.device(device), dtype)
        got = self._derived.get(key)
        if got is None:
            ws = self.window_size
            got = (relative_position_index(ws, device),
                   shift_mask(h, w, ws, ws // 2, device).to(dtype))
            derived_builds.update(("index", "mask"))
            if not torch.compiler.is_exporting():
                self._derived[key] = got
        return got

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} bands, got {x.shape[-1]}")
        with exact_fp32(self.compute_dtype(x.device.type)):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws = self.window_size
        inp = x.permute(0, 3, 1, 2)
        if h % ws or w % ws:
            inp = F.pad(inp, (0, -w % ws, 0, -h % ws), mode="reflect")
        inp = inp.contiguous(memory_format=torch.channels_last)
        x_first = self.conv_first(inp)
        res = self.conv_after_body(self.forward_features(x_first)) + x_first
        out = inp + self.conv_last(res)
        return out[:, :, :h, :w].permute(0, 2, 3, 1)                  # NHWC

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, C, H, W]`` channels-last features through the RSTBs, as
        tokens ``[B, H, W, C]`` in between."""
        _, _, h, w = x.shape
        t = x.permute(0, 2, 3, 1)
        index, mask = self.derived(h, w, x.device, t.dtype)
        t = self.patch_embed.norm(t)
        for layer in self.layers:
            t = layer(t, index, mask)
        return self.norm(t).permute(0, 3, 1, 2)

    @classmethod
    def from_config(cls, config: dict, dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda") -> "SwinIRRestoration":
        """Build from the YAML schema's ``model:`` section (``encoder``:
        ``input_channels``, ``embed_dim``, ``depths``, ``num_heads``,
        ``window_size``, ``mlp_ratio``; ``decoder``: ``output_channels``;
        the constructor's defaults where a key is missing) on ``device``,
        computing in ``dtype``. The port's SwinIR is the release's denoising
        form: another ``upsampler``, ``img_range`` or ``resi_connection``
        raises."""
        device = resolve_device(device)
        enc, dec = config["model"]["encoder"], config["model"]["decoder"]
        if (enc.get("upsampler", "") != "" or float(enc.get("img_range", 1.0)) != 1.0
                or enc.get("resi_connection", "1conv") != "1conv"):
            raise ValueError("the port's SwinIR is the release's denoising form: "
                             "upsampler '', img_range 1 and resi_connection '1conv'")
        sizes = {k: enc[k] for k in ("embed_dim", "depths", "num_heads", "window_size",
                                     "mlp_ratio") if k in enc}
        model = cls(in_channels=int(enc.get("input_channels", 13)),
                    out_channels=int(dec.get("output_channels", 13)), **sizes)
        return model.set_compute_dtype(dtype).to(device)
