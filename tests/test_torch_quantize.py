"""The port's int8 weight quantization (``msid_tpu_torch/deployment/quantize.py``)
against the JAX package's, on the CPU: quantize -> dequantize of the port's
weights equals, tensor for tensor, the JAX ``quantize_params`` ->
``dequantize_params`` of the same weights moved by the converter; the same
tensors are quantized; ``quantization_report`` has the JAX keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.deployment.quantize import dequantize_params as jax_dequantize_params
from msid_tpu.deployment.quantize import quantization_report as jax_quantization_report
from msid_tpu.deployment.quantize import quantize_params as jax_quantize_params
from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu_torch.deployment.quantize import (
    dequantize_params,
    kernel_layouts,
    quantization_report,
    quantize_params,
    quantized_size_bytes,
)
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration

torch.set_num_threads(2)

# Every layer kind the quantizer groups differently: attention q/k/v and
# out, convs, conv-transposes (unet_skip's upsample), the skip stem, the
# fill stage's mask_cond Dense, fill_gram (not a kernel).
KINDS = {
    "flagship": dict(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                     decoder_arch="unet_skip", decoder_channels=(16, 16, 8, 8),
                     residual_output=True, input_fill=True),
    "unet_light": dict(image_size=32, patch_size=16, embed_dim=48, depth=1, num_heads=3,
                       decoder_channels=(16, 8, 8, 8)),
}


def jax_and_port(kwargs, seed=0):
    jmodel = JaxModel(**kwargs, dtype=jnp.float32, gradient_checkpointing=False)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.2, x.shape).astype(np.float32),
        init_model(jmodel, jax.random.PRNGKey(seed)))
    # one all-zero output channel: its scale is 1, as in the JAX rule
    variables["params"]["decoder"]["head_out"]["kernel"][..., 0] = 0.0
    model = SatMAERestoration(**kwargs).eval()
    load_jax_variables(model, variables)
    return jmodel, variables, model


def port_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dequantized_weights_equal_the_jax_quantizer_after_conversion(kind):
    jmodel, variables, model = jax_and_port(KINDS[kind])
    qtree, stree = jax_quantize_params(variables["params"])
    hat = jax.tree_util.tree_map(np.asarray, jax_dequantize_params(qtree, stree))
    want = SatMAERestoration(**KINDS[kind]).eval()
    load_jax_variables(want, {"params": hat, "batch_stats": variables["batch_stats"]})

    q, s = quantize_params(port_state(model), model)
    got = dequantize_params(q, s)
    want_state = port_state(want)
    assert list(got) == list(want_state)
    for name, value in want_state.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_same_tensors_are_quantized(kind):
    jmodel, variables, model = jax_and_port(KINDS[kind])
    _, jax_scales = jax_quantize_params(variables["params"])
    jax_kernels = sum(np.asarray(s).size > 0 for s in jax.tree_util.tree_leaves(jax_scales))
    q, s = quantize_params(port_state(model), model)
    quantized = {k for k, v in s.items() if v.size}
    assert len(quantized) == jax_kernels
    assert quantized == set(kernel_layouts(model))
    assert all(q[k].dtype == np.int8 and np.abs(q[k]).max() <= 127 for k in quantized)
    kept = {"encoder.pos_embed", "fill_gram", "encoder.blocks.0.attn.query.bias",
            "decoder.head_norm.weight", "decoder.head_norm.running_var"}
    assert not kept & quantized
    assert all(q[k].dtype == np.float32 for k in kept if k in q)
    # query/key/value share one scale per head_dim position across heads
    hd = model.embed_dim // model.encoder.blocks[0].attn.num_heads
    scale = s["encoder.blocks.0.attn.key.weight"].ravel()
    np.testing.assert_array_equal(scale, np.tile(scale[:hd], len(scale) // hd))
    # the conv-transpose's output channel is its dim 1
    if KINDS[kind].get("decoder_arch") != "unet_skip":
        assert s["decoder.up.0.conv.weight"].shape == (1, 16, 1, 1)
    assert s["decoder.head_out.weight"].ravel()[0] == 1.0     # the all-zero channel


def test_quantization_report_has_the_jax_keys():
    jmodel, variables, model = jax_and_port(KINDS["unet_light"])
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32, 13)).astype(np.float32)
    want = jax_quantization_report(variables, jmodel, jnp.asarray(x))
    got = quantization_report(port_state(model), model, torch.from_numpy(x))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["original_mb"], want["original_mb"], rtol=1e-9)
    # the port keeps q/k/v scales per row, not per head_dim: a few bytes more
    np.testing.assert_allclose(got["quantized_mb"], want["quantized_mb"], rtol=2e-2)
    np.testing.assert_allclose(got["max_abs_err"], want["max_abs_err"], rtol=1e-3)
    q, s = quantize_params(port_state(model), model)
    assert quantized_size_bytes(q) < sum(v.nbytes for v in port_state(model).values()) / 3
    assert model.training is False
