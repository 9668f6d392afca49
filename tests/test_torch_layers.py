"""Single layers of the PyTorch port against their flax modules, in fp32.

Each layer is where a literal translation diverges from flax: the
ConvTranspose kernel flip and the pixel-shuffle channel order
(``UpsampleBlock``), XLA's (0, 1) SAME padding of the stride-2 convs
(``InputPyramid``), the patch-embed LayerNorm eps (``PatchEmbed``) and the
attention kernel layout and LN eps (``ViTBlock``). Parameters and BN
statistics are seeded random values, given to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models.blocks import UpsampleBlock as JaxUpsample
from msid_tpu.models.decoder import InputPyramid as JaxPyramid
from msid_tpu.models.encoder import PatchEmbed as JaxPatchEmbed
from msid_tpu.models.encoder import ViTBlock as JaxViTBlock
from msid_tpu_torch.models.blocks import UpsampleBlock
from msid_tpu_torch.models.decoder import InputPyramid
from msid_tpu_torch.models.encoder import PatchEmbed, ViTBlock
from msid_tpu_torch.models.from_jax import (
    load_input_pyramid,
    load_patch_embed,
    load_upsample,
    load_vit_block,
)

torch.set_num_threads(2)

# fp32 on both sides; only the order of summation differs.
ATOL = 1e-4


def randomized(module, x, seed):
    """flax init, then seeded random values for every leaf."""
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(v.shape[:-1])), v.shape)
        if name == "scale":
            return rng.normal(1, 0.1, v.shape)
        if name == "var":
            return rng.uniform(0.5, 2, v.shape)
        return rng.normal(0, 0.1, v.shape)

    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax.tree_util.tree_map_with_path(leaf, variables))


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("pixel_shuffle", [False, True])
def test_upsample_block(pixel_shuffle):
    x = np.random.default_rng(0).normal(0, 1, (2, 5, 6, 12)).astype(np.float32)
    jm = JaxUpsample(8, use_pixel_shuffle=pixel_shuffle)
    variables = randomized(jm, x, seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    block = UpsampleBlock(12, 8, use_pixel_shuffle=pixel_shuffle).eval()
    load_upsample(block, variables["params"], variables["batch_stats"])
    got = nhwc(block(nchw(x)))
    assert got.shape == (2, 10, 12, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv_transpose_needs_the_flip():
    """Without the spatial flip the converted ConvTranspose is wrong."""
    x = np.random.default_rng(2).normal(0, 1, (1, 4, 4, 6)).astype(np.float32)
    jm = JaxUpsample(6)
    variables = randomized(jm, x, seed=3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    block = UpsampleBlock(6, 6).eval()
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    k = params["ConvTranspose_0"]["kernel"]
    params["ConvTranspose_0"]["kernel"] = k[::-1, ::-1]   # cancels the flip
    load_upsample(block, params, variables["batch_stats"])
    assert np.abs(nhwc(block(nchw(x))) - want).max() > 1e-2


@pytest.mark.parametrize("size", [32, 24])
def test_input_pyramid(size):
    x = np.random.default_rng(4).normal(0, 1, (2, size, size, 13)).astype(np.float32)
    jm = JaxPyramid(num_levels=4, width=8)
    variables = randomized(jm, x, seed=5)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    pyramid = InputPyramid(13, num_levels=4, width=8).eval()
    load_input_pyramid(pyramid, variables["params"], variables["batch_stats"])
    got = pyramid(nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert nhwc(g).shape == w.shape
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=ATOL)


def test_patch_embed():
    x = np.random.default_rng(6).normal(0, 1, (2, 32, 32, 13)).astype(np.float32)
    jm = JaxPatchEmbed(embed_dim=24, patch_size=16)
    variables = randomized(jm, x, seed=7)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    embed = PatchEmbed(13, 24, 16)
    load_patch_embed(embed, variables["params"])
    got = embed(nchw(x)).detach().numpy()
    assert got.shape == want.shape == (2, 4, 24)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_vit_block():
    x = np.random.default_rng(8).normal(0, 1, (2, 9, 32)).astype(np.float32)
    jm = JaxViTBlock(dim=32, num_heads=4)
    variables = randomized(jm, x, seed=9)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    block = ViTBlock(32, 4)
    load_vit_block(block, variables["params"])
    got = block(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
