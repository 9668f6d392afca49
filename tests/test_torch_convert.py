"""The port's SatMAE converter (``msid_tpu_torch/models/convert.py``) against
the JAX package's, on the CPU: the channel inflation rule, the position
embedding's CLS strip and bicubic resampling (against
``msid_tpu.models.convert.adapt_pos_embed``, the ``jax.image.resize``
kernel), a torch SatMAE forward reproduced by the converted encoder, a
shape mismatch skipped, the converted encoder equal to the JAX
converter's after ``from_jax``, and ``load_pretrained_encoder`` from
``.pth`` and ``.npz``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models.convert import adapt_pos_embed as jax_adapt_pos_embed
from msid_tpu.models.convert import convert_satmae_encoder as jax_convert_satmae_encoder
from msid_tpu.models.encoder import SatMAEEncoder as JaxEncoder
from msid_tpu_torch.models.convert import (
    adapt_pos_embed,
    bicubic_matrix,
    convert_satmae_encoder,
    inflate_patch_embed,
    load_pretrained_encoder,
)
from msid_tpu_torch.models.encoder import SatMAEEncoder
from msid_tpu_torch.models.from_jax import _encoder
from msid_tpu_torch.models.restoration import SatMAERestoration
from test_convert import DEPTH, DIM, HEADS, IMG, PATCH, _synthetic_torch_state, _torch_forward

torch.set_num_threads(2)

# Of the embedding's largest value. jax.image.resize runs jitted, and XLA's
# float32 arithmetic there is 2.6e-6 (of 3.2) from the exact resampling of
# the 197 -> 144 case; the port's contraction is float64, rounded once.
POS_RTOL = 1e-6


def encoder():
    return SatMAEEncoder(image_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
                         num_heads=HEADS).eval()


def test_inflate_patch_embed_rule():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 3, 4, 4)).astype(np.float32)
    out = inflate_patch_embed(w, 13)
    assert out.shape == (8, 13, 4, 4)
    assert np.array_equal(out[:, :3], w)           # RGB kept
    for c in range(3, 13):
        assert np.array_equal(out[:, c], w[:, 0])  # extra bands copy ch 0
    assert inflate_patch_embed(out, 13) is out


def test_adapt_pos_embed_cls_strip_and_interp():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(1, 17, 8)).astype(np.float32)
    out = adapt_pos_embed(pos, 16)
    assert np.array_equal(out, pos[:, 1:, :])  # exact strip
    pos196 = rng.normal(size=(1, 197, 8)).astype(np.float32)  # 14x14 + CLS
    out144 = adapt_pos_embed(pos196, 144)  # -> 12x12
    assert out144.shape == (1, 144, 8) and out144.dtype == np.float32
    assert np.isfinite(out144).all()


@pytest.mark.parametrize("src,dst,cls", [(14, 12, True), (14, 12, False), (12, 16, True),
                                         (4, 3, False)])
def test_adapt_pos_embed_matches_jax(src, dst, cls):
    """The ViT-Base 197 -> 144 case of a 192px model, an upsampling and a
    small grid: jax.image.resize's Keys a=-0.5 kernel with renormalized
    edges, which F.interpolate's bicubic is not."""
    rng = np.random.default_rng(src * dst)
    pos = rng.normal(0, 1, (1, src * src + cls, 32)).astype(np.float32)
    want = jax_adapt_pos_embed(pos, dst * dst)
    got = adapt_pos_embed(pos, dst * dst)
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_RTOL * float(np.abs(want).max()))
    grid = torch.from_numpy(pos[:, cls:].reshape(1, src, src, -1)).permute(0, 3, 1, 2)
    torch_bicubic = torch.nn.functional.interpolate(grid, (dst, dst), mode="bicubic",
                                                    align_corners=False)
    assert not np.allclose(torch_bicubic.permute(0, 2, 3, 1).reshape(want.shape), want,
                           atol=1e-3)
    np.testing.assert_allclose(bicubic_matrix(src, dst).sum(axis=1), 1.0, atol=1e-6)  # fp32


def test_forward_parity_torch_vs_port():
    """Converted weights reproduce the torch SatMAE forward: RGB in bands
    0-2 and zeros elsewhere make the inflated conv the 3-channel one."""
    rng = np.random.default_rng(1)
    state = _synthetic_torch_state(rng, with_cls=True)
    x_rgb = rng.normal(0, 1, (2, 3, IMG, IMG)).astype(np.float32)
    want = _torch_forward(state, x_rgb)
    enc = encoder()
    # the reference's patch-embed LayerNorm stays at its init (strict=False)
    enc.load_state_dict(convert_satmae_encoder(state, enc.state_dict(), 13))
    x13 = np.zeros((2, 13, IMG, IMG), np.float32)
    x13[:, :3] = x_rgb
    with torch.no_grad():
        got = enc(torch.from_numpy(x13)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_shape_mismatch_skipped_not_crashed(caplog):
    rng = np.random.default_rng(2)
    state = _synthetic_torch_state(rng)
    state["norm.weight"] = np.zeros((999,), np.float32)  # wrong shape
    enc = encoder()
    before = enc.state_dict()
    converted = convert_satmae_encoder(state, before, 13)
    # the mismatched tensor keeps its initialization, the rest is loaded
    assert torch.equal(converted["norm.weight"], before["norm.weight"])
    np.testing.assert_array_equal(converted["norm.bias"].numpy(), state["norm.bias"])
    assert "skipped norm.weight" in caplog.text


def test_converted_encoder_equals_the_jax_converter():
    """The port's conversion and the JAX one (flax head axes), moved by
    ``from_jax``, give the same encoder tensor for tensor."""
    state = _synthetic_torch_state(np.random.default_rng(3), with_cls=True)
    jenc = JaxEncoder(image_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
                      num_heads=HEADS, gradient_checkpointing=False)
    init = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 13)))["params"]
    theirs = jax_convert_satmae_encoder(state, init, 13, HEADS)
    want = encoder()
    _encoder(want, jax.tree_util.tree_map(np.asarray, theirs))
    enc = encoder()
    _encoder(enc, jax.tree_util.tree_map(np.asarray, init))     # the same starting point
    got = convert_satmae_encoder(state, enc.state_dict(), 13)
    for name, value in want.state_dict().items():
        np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)


@pytest.mark.parametrize("fmt", [".pth", ".npz"])
def test_load_pretrained_encoder(tmp_path, fmt):
    state = _synthetic_torch_state(np.random.default_rng(4), with_cls=True)
    path = tmp_path / f"satmae{fmt}"
    if fmt == ".npz":
        np.savez(path, **state)
    else:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    model = SatMAERestoration(image_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
                              num_heads=HEADS, decoder_channels=(8, 8, 8, 8))
    decoder = {k: v.clone() for k, v in model.decoder.state_dict().items()}
    assert load_pretrained_encoder(path, model) is model
    got = model.encoder.state_dict()
    np.testing.assert_array_equal(got["pos_embed"].numpy(), state["pos_embed"][:, 1:])
    np.testing.assert_array_equal(got["blocks.1.attn.key.weight"].numpy(),
                                  state["blocks.1.attn.qkv.weight"][DIM:2 * DIM])
    np.testing.assert_array_equal(got["blocks.0.attn.out.bias"].numpy(),
                                  state["blocks.0.attn.proj.bias"])
    assert all(torch.equal(v, decoder[k]) for k, v in model.decoder.state_dict().items())
