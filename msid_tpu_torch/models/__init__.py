"""Models of the PyTorch port: encoder, decoders, composite model, JAX
weight converter (``init_model`` is flax's and has no counterpart: a
module is initialized when it is built)."""

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
    DECODER_REGISTRY,
    AttentionDecoder,
    LightweightDecoder,
    UNetDecoder,
)
from msid_tpu_torch.models.encoder import PatchEmbed, SatMAEEncoder, ViTBlock
from msid_tpu_torch.models.restoration import SatMAERestoration, count_parameters

__all__ = [
    "AttentionDecoder",
    "ConvBlock",
    "DECODER_REGISTRY",
    "DepthwiseSeparableConv",
    "LightweightDecoder",
    "Norm",
    "PatchEmbed",
    "ResidualBlock",
    "SatMAEEncoder",
    "SatMAERestoration",
    "SpatialAttention",
    "SqueezeExcitation",
    "UNetDecoder",
    "UpsampleBlock",
    "ViTBlock",
    "count_parameters",
]
