"""Plain PyTorch reference of the group-channel restorer the benchmark runs.

SatMAE's group-channel ViT (Cong et al., NeurIPS 2022, arXiv:2207.08051
§3.3 and §4.2; ``models_vit_group_channels.py`` of the code release,
``vit_large_patch16``) as the encoder of the repo's ``unet_skip`` restorer,
written from the paper's and the release's equations:

* each group ``g`` of bands has its own patch embed, a conv from ``|g|``
  bands to ``D`` (kernel and stride ``p``), with no norm: ``[B, L, D]``;
* the groups' tokens are stacked group-major, ``[B, G, L, D]``, and each is
  given its position's embedding (``D - C_e`` wide) concatenated with its
  group's (``C_e`` wide), then flattened to ``[B, G*L, D]``;
* the detected dead-band mask's condition is added to every token;
* pre-LN blocks (qkv bias, LayerNorm eps 1e-6, exact GELU), attention over
  all ``G*L`` tokens, then the final LayerNorm;
* the tokens fold back to a ``[B, G*D, L^0.5, L^0.5]`` grid, the groups'
  tokens at one position concatenated along features, for the decoder.

Departures from the release, as in the program: no CLS token (no head
reads one), the final LayerNorm over every token, and ``pos_embed`` and
``channel_embed`` drawn from the seed like the other weights (the release
starts them from sin-cos tables).

The decoder, skip pyramid, fill stage and operand rounding are
``reference/model.py``'s, imported as they are. Nothing of the program is
imported; the parameter names are the program's, so one state dict made by
``seeded_state`` loads into both. Run inside ``precision.exact_fp32()``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import (
    LN_EPS,
    Block,
    Decoder,
    Norm,
    Operands,
    Pyramid,
    QConv,
    QLinear,
    detect_and_fill,
)
from portbench.weights import _fan_in


class ExactBlock(Block):
    """``reference/model.py``'s block (its names and products) with the
    group-channel ViT's exact GELU in the MLP."""

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
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)), approximate="none"))


class GroupEncoder(nn.Module):
    def __init__(self, size: int, patch: int, groups, d: int, depth: int, heads: int,
                 channel_embed: int):
        super().__init__()
        self.groups = [list(g) for g in groups]
        self.length = (size // patch) ** 2
        self.patch_embed = nn.ModuleList()
        for g in self.groups:
            embed = nn.Module()
            embed.proj = QConv(len(g), d, patch, stride=patch)
            self.patch_embed.append(embed)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.length, d - channel_embed))
        self.channel_embed = nn.Parameter(torch.zeros(1, len(self.groups), channel_embed))
        self.blocks = nn.ModuleList(ExactBlock(d, heads, 4 * d) for _ in range(depth))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, cond):
        b, n_groups = x.shape[0], len(self.groups)
        y = torch.stack([embed.proj(x[:, g]).flatten(2).transpose(1, 2)
                         for embed, g in zip(self.patch_embed, self.groups)], dim=1)
        pos = self.pos_embed[:, None].expand(-1, n_groups, -1, -1)            # [1, G, L, pD]
        chan = self.channel_embed[:, :, None].expand(-1, -1, self.length, -1)  # [1, G, L, cD]
        y = (y + torch.cat([pos, chan], dim=-1)).reshape(b, n_groups * self.length, -1)
        if cond is not None:
            y = y + cond[:, None, :]
        for block in self.blocks:
            y = block(y)
        return self.norm(y)


class GroupRestorer(nn.Module):
    """NHWC model-range tiles in, restored NHWC tiles out."""

    def __init__(self, config: dict):
        super().__init__()
        enc = config["model"]["encoder"]
        dec = config["model"]["decoder"]
        self.size = int(config["data"]["image_size"])
        self.patch = int(enc["patch_size"])
        self.bands = int(enc["input_channels"])
        self.d = int(enc["embed_dim"])
        self.groups = [[int(b) for b in g] for g in enc["channel_groups"]]
        if dec["architecture"] != "unet_skip" or dec.get("norm") != "batch":
            raise ValueError("the grouped reference has the unet_skip decoder with batch "
                             f"norms, not {dec['architecture']} with {dec.get('norm')}")
        self.residual = bool(dec.get("residual", False))
        self.fill = bool(config["model"].get("input_fill", {}).get("enabled", False))
        channels = [int(c) for c in dec["channels"]]
        if self.fill:
            self.fill_gram = nn.Parameter(torch.eye(self.bands + 1))
            self.mask_cond = QLinear(self.bands, self.d)
        self.encoder = GroupEncoder(self.size, self.patch, self.groups, self.d,
                                    int(enc["depth"]), int(enc["num_heads"]),
                                    int(enc["channel_embed"]))
        self.decoder = Decoder(len(self.groups) * self.d, channels,
                               int(dec["output_channels"]), True)
        self.skip_stem = Pyramid(self.bands, len(channels))
        self.operands = Operands()
        for m in self.modules():
            object.__setattr__(m, "q", self.operands)

    def forward(self, x):
        b = x.shape[0]
        x = self.operands(x)
        cond = None
        if self.fill:
            x, alive = detect_and_fill(x, self.fill_gram)
            cond = self.mask_cond(alive)
        xc = x.permute(0, 3, 1, 2)
        tokens = self.encoder(xc, cond)                                   # [B, G*L, D]
        grid, n_groups = self.size // self.patch, len(self.groups)
        spatial = (tokens.reshape(b, n_groups, grid, grid, self.d).permute(0, 1, 4, 2, 3)
                   .reshape(b, n_groups * self.d, grid, grid))
        out = self.decoder(spatial, self.skip_stem(xc)).permute(0, 2, 3, 1)
        return self.operands(out + x if self.residual else out)


def seeded_state(config: dict, seed: int, device: torch.device) -> dict:
    """``{name: fp32 tensor on device}`` for every parameter and buffer of
    the grouped restorer, drawn from ``seed`` by ``weights.py``'s rules,
    ``channel_embed`` as ``pos_embed`` is (N(0, 0.02))."""
    with torch.device("meta"):
        ref = GroupRestorer(config)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    normals = []        # (name, shape, std, mean)
    variances = []      # (name, shape)
    for prefix, module in ref.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{prefix}.{pname}" if prefix else pname
            if pname == "fill_gram":
                continue
            if pname in ("pos_embed", "channel_embed"):
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
    flat = torch.randn(sum(s.numel() for _, s, _, _ in normals), generator=g, device=device)
    state, at = {}, 0
    for name, shape, std, mean in normals:
        state[name] = flat[at:at + shape.numel()].view(shape) * std + mean
        at += shape.numel()
    flat = torch.rand(sum(s.numel() for _, s in variances), generator=g, device=device)
    flat = flat * 1.5 + 0.5
    at = 0
    for name, shape in variances:
        state[name] = flat[at:at + shape.numel()].view(shape)
        at += shape.numel()
    if ref.fill:
        n = ref.fill_gram.shape[0]
        a = torch.randn(n, n, generator=g, device=device)
        state["fill_gram"] = a @ a.T / n + 0.1 * torch.eye(n, device=device)
    return state


def reference_model(config: dict, state: dict, device: torch.device) -> GroupRestorer:
    """The plain grouped reference holding ``state``, in float32 on ``device``."""
    with torch.device(device):
        ref = GroupRestorer(config)
    ref.load_state_dict(state)
    return ref
