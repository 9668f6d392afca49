"""Plain PyTorch reference of the restorer the benchmark runs.

SatMAE ViT encoder (Cong et al., NeurIPS 2022, arXiv:2207.08051: 13-band
patch embed, learned position embedding, pre-LN blocks) with the repo's
own decoders (``unet_light`` and ``unet_skip`` with its input pyramid),
the dead-band fill stage and the global residual head. It is written from
the model's equations, as a frozen copy beside the benchmark: it imports
nothing of the program, and its parameter names are the program's, so
one state dict made by the benchmark loads into both.

Every matrix product and convolution passes its operands and its result
through ``self.q``, and so do the model's input and output: the identity for the
reference itself, a fake quantizer for the lower-precision control
(``reference/precision.py``). Run the reference
inside ``precision.exact_fp32()`` so that float32 is float32 on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
BN_EPS = 1e-5
FILL_RMS_THRESH = 0.05
FILL_RIDGE = 1e-6
SKIP_WIDTH = 32
RESIDUAL_BLOCKS = 2


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Operands:
    """What every product applies to its operands: ``fn``, the identity
    unless a control sets another."""

    def __init__(self):
        self.fn = identity

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return self.fn(t)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class QLinear(nn.Linear):
    def forward(self, x):
        return self.q(F.linear(self.q(x), self.q(self.weight), self.bias))


class QConv(nn.Conv2d):
    """A conv padded as XLA's SAME: symmetric for an odd kernel at stride 1,
    else the odd pixel after."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pad = 0
        if s == 1 and k % 2 == 1:
            pad = k // 2
        elif k > 1 or s > 1:
            pads = []
            for size in (x.shape[3], x.shape[2]):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        return self.q(F.conv2d(self.q(x), self.q(self.weight), self.bias, s, pad))


class QConvT(nn.ConvTranspose2d):
    def forward(self, x):
        return self.q(F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias, stride=2))


class Norm(nn.Module):
    """BatchNorm over NCHW: running statistics in eval mode, the biased
    batch moments in train mode (running statistics are not tracked)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            var = var.clamp_min(0.0)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + BN_EPS)
        return x * a[:, None, None] + (self.bias - mean * a)[:, None, None]


class Block(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = nn.Module()
        for name in ("query", "key", "value", "out"):
            setattr(self.attn, name, QLinear(d, d))
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = QLinear(d, mlp)
        self.mlp.fc2 = QLinear(mlp, d)

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.heads
        h = self.norm1(x)

        def split(t):
            return t.view(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.attn.query(h)) / math.sqrt(hd)
        k = split(self.attn.key(h))
        v = split(self.attn.value(h))
        w = torch.softmax(self.q(self.q(q) @ self.q(k).transpose(-2, -1)), dim=-1)
        y = self.q(self.q(w) @ self.q(v)).transpose(1, 2).reshape(b, n, d)
        x = x + self.attn.out(y)
        return x + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x))))


class Encoder(nn.Module):
    def __init__(self, size: int, patch: int, bands: int, d: int, depth: int, heads: int):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = QConv(bands, d, patch, stride=patch)
        self.patch_embed.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.pos_embed = nn.Parameter(torch.zeros(1, (size // patch) ** 2, d))
        self.blocks = nn.ModuleList(Block(d, heads, 4 * d) for _ in range(depth))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, cond):
        y = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        y = self.patch_embed.norm(y) + self.pos_embed
        if cond is not None:
            y = y + cond[:, None, :]
        for block in self.blocks:
            y = block(y)
        return self.norm(y)


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv0 = QConv(c, c, 3, bias=False)
        self.norm0 = Norm(c)
        self.conv1 = QConv(c, c, 3, bias=False)
        self.norm1 = Norm(c)

    def forward(self, x):
        y = self.norm1(self.conv1(gelu(self.norm0(self.conv0(x)))))
        return gelu(x + y)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = QConvT(cin, cout, 2, stride=2)
        self.norm = Norm(cout)

    def forward(self, x):
        return gelu(self.norm(self.conv(x)))


class Decoder(nn.Module):
    """``unet_light`` (``skip`` False) or ``unet_skip``: per stage a 2x
    upsample, the skip fusion (``unet_skip``), two residual blocks; then
    the head."""

    def __init__(self, d: int, channels, bands: int, skip: bool):
        super().__init__()
        self.skip = skip
        self.up = nn.ModuleList()
        self.res = nn.ModuleList()
        if skip:
            self.fuse = nn.ModuleList()
            self.fuse_norm = nn.ModuleList()
        prev = d
        for ch in channels:
            self.up.append(Up(prev, ch))
            if skip:
                self.fuse.append(QConv(ch + SKIP_WIDTH, ch, 1, bias=False))
                self.fuse_norm.append(Norm(ch))
            self.res.append(nn.ModuleList(ResBlock(ch) for _ in range(RESIDUAL_BLOCKS)))
            prev = ch
        self.head_conv = QConv(prev, prev, 3)
        self.head_norm = Norm(prev)
        self.head_out = QConv(prev, bands, 1)

    def forward(self, x, skips=None):
        for i, up in enumerate(self.up):
            x = up(x)
            if self.skip:
                x = gelu(self.fuse_norm[i](self.fuse[i](torch.cat([x, skips[i]], dim=1))))
            for block in self.res[i]:
                x = block(x)
        return self.head_out(gelu(self.head_norm(self.head_conv(x))))


class Pyramid(nn.Module):
    def __init__(self, bands: int, levels: int):
        super().__init__()
        self.stem = QConv(bands, SKIP_WIDTH, 3, bias=False)
        self.stem_norm = Norm(SKIP_WIDTH)
        self.down = nn.ModuleList(QConv(SKIP_WIDTH, SKIP_WIDTH, 3, stride=2, bias=False)
                                  for _ in range(levels - 1))
        self.down_norm = nn.ModuleList(Norm(SKIP_WIDTH) for _ in range(levels - 1))

    def forward(self, x):
        f = gelu(self.stem_norm(self.stem(x)))
        feats = [f]
        for conv, norm in zip(self.down, self.down_norm):
            f = gelu(norm(conv(f)))
            feats.append(f)
        return feats[::-1]


def detect_and_fill(x, gram):
    """Bands whose spatial RMS is under the threshold are dead; each is
    replaced by its least-squares prediction from the live bands under the
    ``[C+1, C+1]`` second-moment matrix ``gram`` (bias last)."""
    b, h, w, c = x.shape
    alive = (torch.sqrt(torch.mean(x * x, dim=(1, 2))) >= FILL_RMS_THRESH).float()
    m = torch.cat([alive, torch.ones_like(alive[:, :1])], dim=1)
    system = (gram * (m[:, :, None] * m[:, None, :]) + torch.diag_embed(1.0 - m)
              + FILL_RIDGE * torch.diag_embed(m))
    weights = torch.linalg.solve(system, m[:, :, None] * gram[:, :c])
    a4 = alive[:, None, None, :]
    masked = x * a4
    pred = masked.reshape(b, h * w, c) @ weights[:, :c] + weights[:, c:]
    return masked + (1.0 - a4) * pred.view(b, h, w, c), alive


class Restorer(nn.Module):
    """NHWC model-range tiles in, restored NHWC tiles out."""

    def __init__(self, config: dict):
        super().__init__()
        enc = config["model"]["encoder"]
        dec = config["model"]["decoder"]
        self.size = int(config["data"]["image_size"])
        self.patch = int(enc["patch_size"])
        self.bands = int(enc["input_channels"])
        self.d = int(enc["embed_dim"])
        self.arch = dec["architecture"]
        if self.arch not in ("unet_light", "unet_skip") or dec.get("norm") != "batch":
            raise ValueError(f"the reference has unet_light and unet_skip with batch norms, "
                             f"not {self.arch} with {dec.get('norm')}")
        self.residual = bool(dec.get("residual", False))
        self.fill = bool(config["model"].get("input_fill", {}).get("enabled", False))
        channels = [int(c) for c in dec["channels"]]
        if self.fill:
            self.fill_gram = nn.Parameter(torch.eye(self.bands + 1))
            self.mask_cond = QLinear(self.bands, self.d)
        self.encoder = Encoder(self.size, self.patch, self.bands, self.d, int(enc["depth"]),
                               int(enc["num_heads"]))
        self.decoder = Decoder(self.d, channels, int(dec["output_channels"]),
                               self.arch == "unet_skip")
        if self.arch == "unet_skip":
            self.skip_stem = Pyramid(self.bands, len(channels))
        self.operands = Operands()
        for m in self.modules():
            object.__setattr__(m, "q", self.operands)

    def forward(self, x):
        b = x.shape[0]
        x = self.operands(x)            # the model's input in its compute precision
        cond = None
        if self.fill:
            x, alive = detect_and_fill(x, self.fill_gram)
            cond = self.mask_cond(alive)
        xc = x.permute(0, 3, 1, 2)
        tokens = self.encoder(xc, cond)
        g = self.size // self.patch
        spatial = tokens.reshape(b, g, g, self.d).permute(0, 3, 1, 2)
        skips = self.skip_stem(xc) if self.arch == "unet_skip" else None
        out = self.decoder(spatial, skips).permute(0, 2, 3, 1)
        return self.operands(out + x if self.residual else out)
