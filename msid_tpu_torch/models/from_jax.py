"""Fill the port's modules from the JAX package's variables.

Takes ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, variables)`` on the JAX side)
and imports no JAX. Layout rules:

  * Conv kernels are HWIO and become OIHW;
  * ConvTranspose kernels ``[kh, kw, Cin, Cout]`` are flipped spatially
    and become ``[Cin, Cout, kh, kw]`` (``lax.conv_transpose`` applies the
    kernel flipped relative to ``F.conv_transpose2d``);
  * Dense kernels are ``[in, out]`` and are transposed;
  * attention q/k/v kernels ``[D, H, hd]`` (bias ``[H, hd]``) and the out
    kernel ``[H, hd, D]`` are flattened to ``[D, D]`` first;
  * BatchNorm ``scale/bias`` and ``mean/var`` fill the Norm's weight/bias
    and running stats; GroupNorm ``scale/bias`` its weight/bias.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from msid_tpu_torch.models.blocks import (
    ConvBlock,
    DepthwiseSeparableConv,
    Norm,
    ResidualBlock,
    SpatialAttention,
    SqueezeExcitation,
    UpsampleBlock,
)
from msid_tpu_torch.models.decoder import (
    AttentionDecoder,
    InputPyramid,
    SkipDecoder,
    UNetDecoder,
)


def _set(t: torch.Tensor, value, name: str) -> None:
    value = torch.from_numpy(np.ascontiguousarray(np.asarray(value, np.float32)))
    if tuple(t.shape) != tuple(value.shape):
        raise ValueError(f"{name}: port shape {tuple(t.shape)} != converted "
                         f"JAX shape {tuple(value.shape)}")
    with torch.no_grad():
        t.copy_(value)


def _conv(m: nn.Conv2d, p: dict, name: str) -> None:
    _set(m.weight, np.transpose(p["kernel"], (3, 2, 0, 1)), f"{name}/kernel")
    if m.bias is not None:
        _set(m.bias, p["bias"], f"{name}/bias")


def _conv_transpose(m: nn.ConvTranspose2d, p: dict, name: str) -> None:
    k = np.asarray(p["kernel"])[::-1, ::-1]
    _set(m.weight, np.transpose(k, (2, 3, 0, 1)), f"{name}/kernel")
    _set(m.bias, p["bias"], f"{name}/bias")


def _dense(m: nn.Linear, p: dict, name: str) -> None:
    _set(m.weight, np.asarray(p["kernel"]).T, f"{name}/kernel")
    _set(m.bias, p["bias"], f"{name}/bias")


def _layer_norm(m: nn.LayerNorm, p: dict, name: str) -> None:
    _set(m.weight, p["scale"], f"{name}/scale")
    _set(m.bias, p["bias"], f"{name}/bias")


def _norm(m: Norm, p: dict, s: dict | None, name: str) -> None:
    """A flax ``Norm`` holds one ``BatchNorm_0`` or ``GroupNorm_0``."""
    if m.kind == "batch":
        _set(m.weight, p["BatchNorm_0"]["scale"], f"{name}/scale")
        _set(m.bias, p["BatchNorm_0"]["bias"], f"{name}/bias")
        _set(m.running_mean, s["BatchNorm_0"]["mean"], f"{name}/mean")
        _set(m.running_var, s["BatchNorm_0"]["var"], f"{name}/var")
    else:
        _set(m.weight, p["GroupNorm_0"]["scale"], f"{name}/scale")
        _set(m.bias, p["GroupNorm_0"]["bias"], f"{name}/bias")


def _stats(s: dict | None, key: str) -> dict | None:
    return None if s is None else s.get(key)


def load_residual_block(m: ResidualBlock, p: dict, s: dict | None,
                        name: str = "res") -> None:
    _conv(m.conv0, p["Conv_0"], f"{name}/Conv_0")
    _norm(m.norm0, p["Norm_0"], _stats(s, "Norm_0"), f"{name}/Norm_0")
    _conv(m.conv1, p["Conv_1"], f"{name}/Conv_1")
    _norm(m.norm1, p["Norm_1"], _stats(s, "Norm_1"), f"{name}/Norm_1")


def load_upsample(m: UpsampleBlock, p: dict, s: dict | None,
                  name: str = "up") -> None:
    if m.use_pixel_shuffle:
        _conv(m.conv, p["Conv_0"], f"{name}/Conv_0")
    else:
        _conv_transpose(m.conv, p["ConvTranspose_0"], f"{name}/ConvTranspose_0")
    _norm(m.norm, p["Norm_0"], _stats(s, "Norm_0"), f"{name}/Norm_0")


def load_conv_block(m: ConvBlock, p: dict, s: dict | None, name: str = "conv") -> None:
    """flax numbers the convs in creation order: the 1x1 residual, when
    the block has one, is ``Conv_0``."""
    first = 0
    if m.residual is not None:
        _conv(m.residual, p["Conv_0"], f"{name}/Conv_0")
        first = 1
    _conv(m.conv0, p[f"Conv_{first}"], f"{name}/Conv_{first}")
    _norm(m.norm0, p["Norm_0"], _stats(s, "Norm_0"), f"{name}/Norm_0")
    _conv(m.conv1, p[f"Conv_{first + 1}"], f"{name}/Conv_{first + 1}")
    _norm(m.norm1, p["Norm_1"], _stats(s, "Norm_1"), f"{name}/Norm_1")


def load_depthwise_separable(m: DepthwiseSeparableConv, p: dict, s: dict | None,
                             name: str = "dsconv") -> None:
    _conv(m.depthwise, p["Conv_0"], f"{name}/Conv_0")
    _conv(m.pointwise, p["Conv_1"], f"{name}/Conv_1")
    _norm(m.norm, p["Norm_0"], _stats(s, "Norm_0"), f"{name}/Norm_0")


def load_squeeze_excitation(m: SqueezeExcitation, p: dict, name: str = "se") -> None:
    _conv(m.conv0, p["Conv_0"], f"{name}/Conv_0")
    _conv(m.conv1, p["Conv_1"], f"{name}/Conv_1")


def load_spatial_attention(m: SpatialAttention, p: dict, name: str = "sa") -> None:
    _conv(m.conv, p["Conv_0"], f"{name}/Conv_0")


def _stage_decoder(m, p: dict, s: dict | None) -> None:
    """``UNetDecoder`` or ``AttentionDecoder``."""
    for i, block in enumerate(m.conv):
        if isinstance(m, UNetDecoder):
            _conv_transpose(m.up[i], p[f"up_{i}"], f"decoder/up_{i}")
        else:
            load_upsample(m.up[i], p[f"up_{i}"], _stats(s, f"up_{i}"), f"decoder/up_{i}")
            load_spatial_attention(m.sa[i], p[f"sa_{i}"], f"decoder/sa_{i}")
        load_conv_block(block, p[f"conv_{i}"], _stats(s, f"conv_{i}"), f"decoder/conv_{i}")
    _conv(m.head, p["head"], "decoder/head")


def _decoder(m, p: dict, s: dict | None) -> None:
    if isinstance(m, (UNetDecoder, AttentionDecoder)):
        _stage_decoder(m, p, s)
        return
    for i, up in enumerate(m.up):
        load_upsample(up, p[f"up_{i}"], _stats(s, f"up_{i}"), f"decoder/up_{i}")
        if isinstance(m, SkipDecoder):
            _conv(m.fuse[i], p[f"fuse_{i}"], f"decoder/fuse_{i}")
            _norm(m.fuse_norm[i], p[f"fuse_norm_{i}"], _stats(s, f"fuse_norm_{i}"),
                  f"decoder/fuse_norm_{i}")
        for r, block in enumerate(m.res[i]):
            key = f"res_{i}_{r}"
            load_residual_block(block, p[key], _stats(s, key), f"decoder/{key}")
    _conv(m.head_conv, p["head_conv"], "decoder/head_conv")
    _norm(m.head_norm, p["head_norm"], _stats(s, "head_norm"), "decoder/head_norm")
    _conv(m.head_out, p["head_out"], "decoder/head_out")


def load_input_pyramid(m: InputPyramid, p: dict, s: dict | None) -> None:
    _conv(m.stem, p["stem"], "skip_stem/stem")
    _norm(m.stem_norm, p["stem_norm"], _stats(s, "stem_norm"), "skip_stem/stem_norm")
    for i, (conv, norm) in enumerate(zip(m.down, m.down_norm)):
        _conv(conv, p[f"down_{i}"], f"skip_stem/down_{i}")
        _norm(norm, p[f"down_norm_{i}"], _stats(s, f"down_norm_{i}"),
              f"skip_stem/down_norm_{i}")


def load_patch_embed(m, p: dict, name: str = "encoder/patch_embed") -> None:
    _conv(m.proj, p["proj"], f"{name}/proj")
    _layer_norm(m.norm, p["norm"], f"{name}/norm")


def load_vit_block(block, bp: dict, name: str = "encoder/blocks") -> None:
    _layer_norm(block.norm1, bp["norm1"], f"{name}/norm1")
    _layer_norm(block.norm2, bp["norm2"], f"{name}/norm2")
    attn = bp["attn"]
    for proj in ("query", "key", "value"):
        k = np.asarray(attn[proj]["kernel"])
        _dense(getattr(block.attn, proj),
               {"kernel": k.reshape(k.shape[0], -1),
                "bias": np.asarray(attn[proj]["bias"]).reshape(-1)},
               f"{name}/attn/{proj}")
    k = np.asarray(attn["out"]["kernel"])
    _dense(block.attn.out, {"kernel": k.reshape(-1, k.shape[-1]),
                            "bias": attn["out"]["bias"]}, f"{name}/attn/out")
    _dense(block.mlp.fc1, bp["mlp"]["fc1"], f"{name}/mlp/fc1")
    _dense(block.mlp.fc2, bp["mlp"]["fc2"], f"{name}/mlp/fc2")


def _encoder(m, p: dict) -> None:
    load_patch_embed(m.patch_embed, p["patch_embed"])
    _set(m.pos_embed, p["pos_embed"], "encoder/pos_embed")
    for i, block in enumerate(m.blocks):
        load_vit_block(block, p[f"blocks_{i}"], f"encoder/blocks_{i}")
    _layer_norm(m.norm, p["norm"], "encoder/norm")


def load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Copy JAX ``variables`` (numpy leaves) into a port ``SatMAERestoration``
    in place; returns the model. Any shape mismatch raises."""
    p = variables["params"]
    s = variables.get("batch_stats")
    _encoder(model.encoder, p["encoder"])
    _decoder(model.decoder, p["decoder"], _stats(s, "decoder"))
    if model.decoder_arch == "unet_skip":
        load_input_pyramid(model.skip_stem, p["skip_stem"], _stats(s, "skip_stem"))
    if model.input_fill:
        _set(model.fill_gram, p["fill_gram"], "fill_gram")
        _dense(model.mask_cond, p["mask_cond"], "mask_cond")
    return model
