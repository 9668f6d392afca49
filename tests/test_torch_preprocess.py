"""The port's preprocessing (``ops/preprocess.py``) against the JAX package's,
on the CPU: the per-image range heuristic, the half-pixel bilinear resize
(``F.interpolate`` without antialias against ``jax.image.resize``), the
model-range affine, band permutation and spectral normalization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.ops import preprocess as jax_pre
from msid_tpu_torch.ops import preprocess as pre

RESIZE_ATOL = 1e-5   # bilinear weights summed in another order, model range ~[-2, 2]


def mixed_scale_tiles(size, seed=0):
    """A Sentinel-2 DN tile, an 8-bit tile, a [0, 1] tile and a 1.5 < max <= 10
    tile in one batch: each must keep its own scale."""
    rng = np.random.default_rng(seed)
    shape = (size, size, 13)
    return np.stack([rng.uniform(0, 10000, shape), rng.uniform(0, 255, shape),
                     rng.uniform(0, 1, shape), rng.uniform(0, 8, shape)]).astype(np.float32)


@pytest.mark.parametrize("size,target", [(32, 96), (64, 192), (64, 64)])
def test_preprocess_tiles_matches_jax(size, target):
    x = mixed_scale_tiles(size, seed=size)
    want = np.asarray(jax_pre.preprocess_tiles(jnp.asarray(x), target))
    got = pre.preprocess_tiles(torch.from_numpy(x), target)
    assert got.dtype == torch.float32 and got.shape == (4, target, target, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)


def test_normalize_raw_per_image_and_rank():
    x = mixed_scale_tiles(8)
    np.testing.assert_allclose(pre.normalize_raw(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_pre.normalize_raw(jnp.asarray(x))), rtol=1e-7)
    tile = torch.full((4, 4, 13), 5000.0)
    tile[0] = 20.0
    out = pre.normalize_raw(tile)
    assert float(out.max()) == pytest.approx(0.5)
    assert float(out[0, 0, 0]) == pytest.approx(20.0 / 10000.0)
    assert pre.normalize_raw(torch.ones(3, 2, 4, 4, 13)).shape == (3, 2, 4, 4, 13)
    with pytest.raises(ValueError, match="H, W, C"):
        pre.normalize_raw(torch.ones(4, 4))


def test_model_range_roundtrip_matches_jax():
    x = np.random.default_rng(1).uniform(-0.2, 1.2, (2, 8, 8, 13)).astype(np.float32)
    y = pre.to_model_range(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_pre.to_model_range(jnp.asarray(x))),
                               atol=1e-7)
    np.testing.assert_allclose(pre.from_model_range(y).numpy(),
                               np.asarray(jax_pre.from_model_range(jnp.asarray(y.numpy()))),
                               atol=1e-7)


def test_random_band_permutation():
    x = torch.arange(3 * 4 * 4 * 13, dtype=torch.float32).reshape(3, 4, 4, 13)
    y = pre.random_band_permutation(x, 1.0, torch.Generator().manual_seed(0))
    for b in range(3):
        assert sorted(x[b, 0, 0].tolist()) == sorted(y[b, 0, 0].tolist())
        # one permutation per sample, the same at every pixel
        assert torch.equal(y[b] - y[b, :1, :1], x[b] - x[b, :1, :1])
    assert not torch.equal(x, y)
    assert torch.equal(pre.random_band_permutation(x, 0.0, torch.Generator().manual_seed(0)), x)
    a = pre.random_band_permutation(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, pre.random_band_permutation(x, 0.5, torch.Generator().manual_seed(4)))


def test_spectral_normalization_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 8, 8, 13)).astype(np.float32)
    mean = rng.uniform(0.2, 0.6, 13).astype(np.float32)
    std = rng.uniform(0.1, 0.3, 13).astype(np.float32)
    std[3] = 0.0                                   # clamped to 1e-8 on both sides
    z = pre.normalize_spectral(torch.from_numpy(x), mean, std)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jax_pre.normalize_spectral(jnp.asarray(x), mean, std)),
        rtol=1e-6)
    back = pre.denormalize_spectral(z, mean, std)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_pre.denormalize_spectral(jnp.asarray(z.numpy()),
                                                              mean, std)), rtol=1e-6)
