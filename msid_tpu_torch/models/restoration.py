"""Composite restoration model (PyTorch): SatMAE ViT encoder + CNN decoder.

Counterpart of ``msid_tpu/models/restoration.py``. NHWC in, NHWC out:
encode the noisy tile to [B, N, D] patch tokens, fold the token grid back
to [B, D, H/p, W/p], decode to [B, 13, H, W]. With ``channel_groups`` the
encoder is SatMAE's group-channel ViT (``SatMAEGroupEncoder``, a port-only
model): its ``[B, G*N, D]`` tokens fold to ``[B, G*D, H/p, W/p]``, the G
groups' tokens at one position concatenated along features, and the
decoder takes ``G*D`` channels. Options as in the JAX model:
the ``unet_skip`` input pyramid, the global residual head
(``residual_output``) and the dead-band input stage (``input_fill``: fill
from the ``fill_gram`` Gram matrix, condition the encoder on the detected
mask through ``mask_cond``).

Two ways to compute in bf16. Serving casts the weights
(``set_compute_dtype``). Training keeps fp32 parameters and runs under
``torch.autocast``; the model then casts where the JAX model casts to its
compute dtype (the filled tile, the skip stem's input, the residual add)
to the autocast dtype, while the fill stage and ``mask_cond`` run in fp32
with autocast off, as ``mask_cond`` is an fp32 layer in the JAX model.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

from msid_tpu_torch.models.decoder import DECODER_REGISTRY, ZERO_INIT_HEAD, InputPyramid
from msid_tpu_torch.models.encoder import (
    SATMAE_CHANNEL_GROUPS,
    SatMAEEncoder,
    SatMAEGroupEncoder,
)
from msid_tpu_torch.ops.fill import DEFAULT_RMS_THRESH, detect_and_fill
from msid_tpu_torch.utils.profiling import annotate

ENCODER_PRESETS = {
    "satmae_vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "satmae_vit_base": dict(embed_dim=768, depth=12, num_heads=12),
    "satmae_vit_large": dict(embed_dim=1024, depth=24, num_heads=16),
    "satmae_group_vit_large": dict(embed_dim=1024, depth=24, num_heads=16, channel_embed=256,
                                   channel_groups=SATMAE_CHANNEL_GROUPS),
}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "device='cpu' is passed")
    return device


@contextlib.contextmanager
def exact_fp32(dtype: torch.dtype):
    """Inside the block an fp32 computation is fp32 on the card too: cuDNN
    convolutions and cuBLAS matrix products run without TF32 (torch's
    default leaves TF32 on for convolutions). The caller's flags are back
    afterwards. Any other compute dtype leaves the flags alone. The flags
    are process-wide, so this is not thread-safe: fp32 forwards that
    overlap on two threads may restore TF32 under each other."""
    if dtype != torch.float32:
        yield
        return
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class SatMAERestoration(nn.Module):
    """Flagship model: 13-band noisy NHWC tile in, restored NHWC tile out."""

    def __init__(self, image_size: int = 192, patch_size: int = 16,
                 in_channels: int = 13, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 decoder_arch: str = "unet_light",
                 decoder_channels: Sequence[int] = (384, 192, 96, 48),
                 out_channels: int = 13, norm: str = "batch",
                 residual_output: bool = False, input_fill: bool = False,
                 fill_rms_thresh: float = DEFAULT_RMS_THRESH,
                 gradient_checkpointing: bool = False,
                 channel_groups: Optional[Sequence[Sequence[int]]] = None,
                 channel_embed: int = 256):
        super().__init__()
        if decoder_arch not in DECODER_REGISTRY:
            raise ValueError(f"Unknown decoder {decoder_arch!r}; have "
                             f"{sorted(DECODER_REGISTRY)}")
        if (residual_output or input_fill) and out_channels != in_channels:
            raise ValueError(
                "residual output and input_fill require out_channels == "
                f"in_channels, got {out_channels} != {in_channels}")
        self.image_size = image_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.embed_dim = embed_dim
        self.decoder_arch = decoder_arch
        self.residual_output = residual_output
        self.input_fill = input_fill
        self.fill_rms_thresh = fill_rms_thresh
        self.dtype = torch.float32
        if input_fill:
            self.fill_gram = nn.Parameter(torch.eye(in_channels + 1))
            self.mask_cond = nn.Linear(in_channels, embed_dim)
            nn.init.zeros_(self.mask_cond.weight)
            nn.init.zeros_(self.mask_cond.bias)
        if channel_groups is None:
            self.encoder = SatMAEEncoder(image_size, patch_size, in_channels,
                                         embed_dim, depth, num_heads, mlp_ratio,
                                         gradient_checkpointing)
        else:
            self.encoder = SatMAEGroupEncoder(image_size, patch_size, channel_groups,
                                              embed_dim, depth, num_heads, mlp_ratio,
                                              channel_embed, gradient_checkpointing)
            if not all(0 <= b < in_channels for g in channel_groups for b in g):
                raise ValueError(f"channel_groups {channel_groups} index bands outside "
                                 f"the {in_channels} input bands")
        self.channel_groups = getattr(self.encoder, "channel_groups", None)
        groups = len(self.channel_groups or (None,))
        # Under a global residual head the JAX model zero-inits the head of
        # unet_light and unet_skip only.
        head = {"zero_init_head": residual_output} if decoder_arch in ZERO_INIT_HEAD else {}
        self.decoder = DECODER_REGISTRY[decoder_arch](
            in_channels=groups * embed_dim, channels=tuple(decoder_channels),
            out_channels=out_channels, norm=norm, **head)
        if decoder_arch == "unet_skip":
            self.skip_stem = InputPyramid(in_channels, len(decoder_channels),
                                          norm=norm)

    def set_compute_dtype(self, dtype: torch.dtype) -> "SatMAERestoration":
        """Cast the convs, dense layers, LayerNorms and position (and group)
        embeddings to ``dtype``. Norm parameters and statistics, ``fill_gram``
        and ``mask_cond`` stay fp32, as in the JAX model's fp32 params."""
        keep = set(self.mask_cond.modules()) if self.input_fill else set()
        for m in self.modules():
            if m not in keep and isinstance(
                    m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.LayerNorm)):
                m.to(dtype)
        self.encoder.pos_embed.data = self.encoder.pos_embed.data.to(dtype)
        if self.channel_groups is not None:
            self.encoder.channel_embed.data = self.encoder.channel_embed.data.to(dtype)
        self.dtype = dtype
        return self

    def compute_dtype(self, device_type: str) -> torch.dtype:
        """The dtype the forward computes in: the autocast dtype when
        autocast is on for ``device_type``, else the weights' dtype."""
        if torch.is_autocast_enabled(device_type):
            return torch.get_autocast_dtype(device_type)
        return self.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h != self.image_size or w != self.image_size:
            raise ValueError(f"expected {self.image_size}x{self.image_size}, "
                             f"got {h}x{w}")
        if c != self.in_channels:
            raise ValueError(f"expected {self.in_channels} bands, got {c}")
        dtype = self.compute_dtype(x.device.type)
        with exact_fp32(dtype):
            return self._forward(x, dtype)

    def _forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, _, _, c = x.shape
        cond = None
        if self.input_fill:
            with torch.autocast(x.device.type, enabled=False):
                filled, alive = detect_and_fill(x, self.fill_gram, self.fill_rms_thresh)
                cond = self.mask_cond(alive.reshape(b, c).to(self.mask_cond.weight.dtype))
            x = filled.to(dtype)
        xc = x.contiguous().permute(0, 3, 1, 2)      # NCHW, channels-last
        tokens = self.encoder(xc, cond)                # [B, G*N, D]
        spatial = self._fold(tokens)
        if self.decoder_arch == "unet_skip":
            out = self.decoder(spatial, self.skip_stem(xc.to(dtype)))
        else:
            out = self.decoder(spatial)
        out = out.permute(0, 2, 3, 1)                  # NHWC
        if self.residual_output:
            out = out + x.to(out.dtype)
        return out

    def _fold(self, tokens: torch.Tensor) -> torch.Tensor:
        """``[B, G*N, D]`` group-major tokens -> ``[B, G*D, H/p, W/p]`` (NCHW
        shape, channels-last memory), channel ``g*D + d`` holding feature
        ``d`` of group ``g``'s token."""
        b, grid, d = tokens.shape[0], self.image_size // self.patch_size, self.embed_dim
        if self.channel_groups is None:
            return tokens.reshape(b, grid, grid, d).permute(0, 3, 1, 2)
        g = len(self.channel_groups)
        with annotate("msid.encoder.fold"):
            folded = tokens.reshape(b, g, grid, grid, d).permute(0, 2, 3, 1, 4)
            return folded.reshape(b, grid, grid, g * d).permute(0, 3, 1, 2)

    @classmethod
    def from_config(cls, config: dict, dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda") -> "SatMAERestoration":
        """Build from the YAML schema's ``model:`` section on ``device``
        (the GPU unless told otherwise), computing in ``dtype``."""
        device = resolve_device(device)
        enc = config["model"]["encoder"]
        dec = config["model"]["decoder"]
        fill = config["model"].get("input_fill", {})
        preset = ENCODER_PRESETS.get(str(enc.get("name", "")), {})
        groups = enc.get("channel_groups", preset.get("channel_groups"))
        model = cls(
            image_size=int(config.get("data", {}).get("image_size", 192)),
            patch_size=int(enc.get("patch_size", 16)),
            in_channels=int(enc.get("input_channels", 13)),
            embed_dim=int(enc.get("embed_dim", preset.get("embed_dim", 768))),
            depth=int(enc.get("depth", preset.get("depth", 12))),
            num_heads=int(enc.get("num_heads", preset.get("num_heads", 12))),
            decoder_arch=str(dec.get("architecture", "unet_light")),
            decoder_channels=tuple(dec.get("channels", (384, 192, 96, 48))),
            out_channels=int(dec.get("output_channels", 13)),
            residual_output=bool(dec.get("residual", False)),
            input_fill=bool(fill.get("enabled", False)),
            fill_rms_thresh=float(fill.get("rms_thresh", DEFAULT_RMS_THRESH)),
            norm=str(dec.get("norm", "batch")),
            gradient_checkpointing=bool(enc.get("gradient_checkpointing", True)),
            channel_groups=groups,
            channel_embed=int(enc.get("channel_embed", preset.get("channel_embed", 256))),
        )
        return model.set_compute_dtype(dtype).to(device)


def count_parameters(model: nn.Module) -> dict:
    """Per-submodule parameter breakdown: encoder, decoder, total, other."""
    def _count(module) -> int:
        return sum(p.numel() for p in module.parameters())

    encoder, decoder, total = _count(model.encoder), _count(model.decoder), _count(model)
    out = {"encoder": encoder, "decoder": decoder, "total": total}
    if total - encoder - decoder:
        out["other"] = total - encoder - decoder
    return out

