"""The PyTorch port's whole forward against the JAX model, in fp32 on the CPU.

Both sides get the same numpy inputs and the same weights: the JAX model's
variables are initialized, every parameter and BatchNorm statistic is
overwritten with seeded random values (the zero-init ``head_out`` and
``mask_cond`` and the identity ``fill_gram`` would otherwise hide the
encoder and decoder from the comparison), and the converter copies them
into the port. Inputs hold killed bands so that the fill path runs.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.utils.config import load_config as jax_load_config
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration, count_parameters
from msid_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def randomize_variables(variables, seed=0):
    """Seeded random values for every leaf, keeping shapes and dtypes."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        name, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
        shape = x.shape
        if name == "fill_gram":
            a = rng.normal(0, 1, shape)
            v = a @ a.T / shape[0] + 0.1 * np.eye(shape[0])
        elif name == "kernel":
            fan_in = shape[0] if parent in ("query", "key", "value") else \
                int(np.prod(shape[:-1]))
            v = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif name == "scale":
            v = rng.normal(1, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name == "pos_embed":
            v = rng.normal(0, 0.02, shape)
        else:  # bias, mean
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def noisy_tiles(shape, seed=0, killed=((0, 3), (0, 7), (1, 11))):
    """Model-space tiles with the listed (sample, band) pairs killed: zero
    signal plus thermal noise, RMS far below the 0.05 detection threshold."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    for b, c in killed:
        if b < shape[0]:
            x[b, :, :, c] = rng.normal(0, 0.005, shape[1:3])
    return x


def run_both(kwargs, x, seed=0):
    jmodel = JaxModel(**kwargs, dtype=jnp.float32, gradient_checkpointing=False)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(seed)), seed)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    port_kwargs = {k: v for k, v in kwargs.items()}
    model = SatMAERestoration(**port_kwargs).eval()
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return got, want, model, variables


TINY = dict(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            decoder_channels=(16, 16, 8, 8))


@pytest.mark.parametrize("arch,residual,fill", [
    ("unet_skip", True, True),     # the flagship's wiring
    ("unet_light", False, False),  # the model bench.py serves
])
def test_tiny_model_matches_jax(arch, residual, fill):
    x = noisy_tiles((2, 32, 32, 13))
    got, want, _, _ = run_both(
        dict(TINY, decoder_arch=arch, residual_output=residual, input_fill=fill), x)
    assert got.shape == want.shape == x.shape
    # fp32 on both sides; only the order of summation differs, ~1e-6
    # relative per op through ~20 layers: 1e-4 of the output's scale.
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_fill_path_changes_output():
    """The killed bands are detected and the randomized fill stage acts:
    the flagship's output differs from the same model without fill."""
    x = noisy_tiles((2, 32, 32, 13))
    got, _, model, _ = run_both(
        dict(TINY, decoder_arch="unet_skip", residual_output=True, input_fill=True), x)
    model.input_fill = False
    with torch.no_grad():
        unfilled = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - unfilled).max() > 1e-2


def test_full_width_depth1_matches_jax():
    """Full widths (embed 768, 12 heads, decoder 384/192/96/48, 192^2) at
    depth 1, B=1: the kernel-shaped ResidualBlocks at their real sizes."""
    x = noisy_tiles((1, 192, 192, 13))
    got, want, model, variables = run_both(
        dict(image_size=192, patch_size=16, embed_dim=768, depth=1, num_heads=12,
             decoder_arch="unet_skip", residual_output=True, input_fill=True), x)
    # fp32 both sides; wider sums (K = 9*384) than the tiny model: 1e-4 of
    # the output's scale still holds with margin.
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    counts = count_parameters(model)
    total = sum(int(np.prod(v.shape))
                for v in jax.tree_util.tree_leaves(variables["params"]))
    assert counts["total"] == total


@pytest.mark.parametrize("path", [
    "experiments/long_skip_fill.yaml",
    "base.yaml",
])
def test_from_config_matches_jax(path):
    cfg = load_config(CONFIGS / path)
    assert cfg == jax_load_config(CONFIGS / path)
    jm = JaxModel.from_config(cfg)
    pm = SatMAERestoration.from_config(cfg, device="cpu")
    assert pm.image_size == jm.image_size
    assert pm.patch_size == jm.patch_size
    assert pm.in_channels == jm.in_channels
    assert pm.embed_dim == jm.embed_dim
    assert len(pm.encoder.blocks) == jm.depth
    assert pm.encoder.blocks[0].attn.num_heads == jm.num_heads
    assert pm.decoder_arch == jm.decoder_arch
    assert [u.conv.out_channels for u in pm.decoder.up] == list(jm.decoder_channels)
    assert pm.decoder.head_out.out_channels == jm.out_channels
    assert pm.residual_output == jm.residual_output
    assert pm.input_fill == jm.input_fill
    assert pm.fill_rms_thresh == jm.fill_rms_thresh
    assert pm.decoder.head_norm.kind == jm.norm


def test_bf16_compute_dtype_keeps_fp32_state():
    cfg = load_config(CONFIGS / "experiments/long_skip_fill.yaml")
    cfg["model"]["encoder"].update(embed_dim=64, depth=1, num_heads=4)
    cfg["model"]["decoder"]["channels"] = [16, 16, 8, 8]
    cfg["data"]["image_size"] = 32
    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16, device="cpu")
    assert model.encoder.blocks[0].attn.query.weight.dtype == torch.bfloat16
    assert model.decoder.res[0][0].conv0.weight.dtype == torch.bfloat16
    assert model.encoder.pos_embed.dtype == torch.bfloat16
    assert model.fill_gram.dtype == torch.float32
    assert model.mask_cond.weight.dtype == torch.float32
    assert model.decoder.res[0][0].norm0.running_var.dtype == torch.float32
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(noisy_tiles((1, 32, 32, 13))).bfloat16())
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_capacity_2x_full_width_decoder_matches_jax():
    """``capacity_2x.yaml`` (decoder 768/384/192/96, ``unet_light``) with its
    decoder at full width, the ViT at depth 1 and a 64^2 image: the eval
    ResidualBlocks at C=768 and the other widths against the flax model,
    fp32 within 1e-4 relative RMS."""
    cfg = load_config(CONFIGS / "experiments/capacity_2x.yaml")
    assert cfg == jax_load_config(CONFIGS / "experiments/capacity_2x.yaml")
    assert cfg["model"]["decoder"]["channels"] == [768, 384, 192, 96]
    cfg["model"]["encoder"]["depth"] = 1
    cfg["data"]["image_size"] = 64
    jmodel = JaxModel.from_config(cfg)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(0)), seed=0)
    x = noisy_tiles((1, 64, 64, 13))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    assert [r[0].conv0.out_channels for r in model.decoder.res] == [768, 384, 192, 96]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    rel = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    assert rel <= 1e-4, rel
