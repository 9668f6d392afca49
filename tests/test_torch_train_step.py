"""The port's train and eval steps against the JAX package's, fp32 on the CPU.

A tiny flagship (``unet_skip`` decoder, input fill, global residual, embed
96, depth 2, block 0 frozen) gets every parameter and BatchNorm statistic
randomised on the JAX side and converted into the port. Both steps then
take the same raw tiles with every noise component off (so both sides see
the same input), one of whose bands is a constant 0.5 reflectance that the
fill stage detects as dead. Updated weights are compared by converting the
JAX result into a fresh port model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.ops.noise import NoiseConfig as JaxNoiseConfig
from msid_tpu.training.losses import LossConfig as JaxLossConfig
from msid_tpu.training.optim import build_optimizer as jax_build_optimizer
from msid_tpu.training.schedules import cosine_warm_restarts as jax_sgdr
from msid_tpu.training.train_state import TrainState as JaxTrainState
from msid_tpu.training.train_state import make_eval_step as jax_make_eval_step
from msid_tpu.training.train_state import make_train_step as jax_make_train_step
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.training.optim import build_optimizer
from msid_tpu_torch.training.schedules import cosine_warm_restarts
from msid_tpu_torch.training.train_state import TrainState, make_eval_step, make_train_step
from test_torch_model import randomize_variables

torch.set_num_threads(2)

TINY_FLAGSHIP = dict(image_size=32, patch_size=16, embed_dim=96, depth=2, num_heads=4,
                     decoder_arch="unet_skip", decoder_channels=(16, 16, 8, 8),
                     residual_output=True, input_fill=True)
OPT = dict(weight_decay=0.05, gradient_clip=0.5, encoder_lr_scale=0.1, freeze_layers=(0,))
SGDR = (1e-3, 10, 2, 1e-6)
ZERO_NOISE = dict(gaussian_sigma=0.0, speckle_sigma=0.0, dead_band_prob=0.0,
                  thermal_scale=0.0, enable_striping=False)
LOSS = dict(mse_weight=1.0, ssim_weight=0.1, sam_weight=0.05, perceptual_weight=0.1)
RTOL = 1e-4             # loss, mse, grad_norm: fp32 sums in another order
PARAM_ATOL = 2e-6       # one AdamW step of lr 1e-3 on fp32 weights
# AdamW's first step is g / (|g| + 1e-8): where |g| is of the order of eps it
# follows the fp32 rounding of g, so at most this share of the elements may
# differ by up to one step, 2 * lr. The biases of convs that feed a train-mode
# BatchNorm have a zero gradient in exact arithmetic, so all of theirs may.
ILL_CONDITIONED_SHARE = 1e-3


def zero_gradient(name):
    return name == "decoder.head_conv.bias" or (
        name.startswith("decoder.up.") and name.endswith("conv.bias"))


def raw_tiles(b=4, size=16, seed=0):
    """Raw DN tiles; sample 0's band 5 is 5000 DN (0.0 in model space), which
    the fill stage detects as dead."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(500, 9500, (b, size, size, 13)).astype(np.float32)
    x[0, :, :, 5] = 5000.0
    return x


@pytest.fixture(scope="module")
def jax_setup():
    model = JaxModel(**TINY_FLAGSHIP, dtype=jnp.float32, gradient_checkpointing=False)
    variables = randomize_variables(init_model(model, jax.random.PRNGKey(0)), seed=3)
    return model, variables


def port_model(variables):
    model = SatMAERestoration(**TINY_FLAGSHIP, gradient_checkpointing=True)
    return load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))


EMA_DECAY = 0.9


@pytest.fixture(scope="module")
def jax_runs(jax_setup):
    """The JAX step's (state, metrics) on the clean batch with one and two
    micro-batches, and on a batch holding a NaN; EMA on throughout."""
    model, variables = jax_setup
    tx = jax_build_optimizer(jax_sgdr(*SGDR), params=variables["params"], **OPT)
    state = JaxTrainState.create(variables, tx, ema=True)
    runs = {}
    for accum in (1, 2):
        step = jax_make_train_step(model, tx, JaxLossConfig(**LOSS),
                                   JaxNoiseConfig(**ZERO_NOISE), accum_steps=accum,
                                   image_size=32, noise_impl="jnp", ema_decay=EMA_DECAY)
        runs[accum] = step(state, jnp.asarray(raw_tiles()), jax.random.PRNGKey(0))
    runs["nan"] = step(state, jnp.asarray(nan_tiles()), jax.random.PRNGKey(0))
    return runs


def nan_tiles():
    batch = raw_tiles()
    batch[1, 3, 3, 2] = np.nan
    return batch


def run_port(variables, batch, accum_steps=1):
    model = port_model(variables)
    optimizer = build_optimizer(model, cosine_warm_restarts(*SGDR), **OPT)
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, LossConfig(**LOSS), NoiseConfig(**ZERO_NOISE),
                           accum_steps=accum_steps, image_size=32, noise_impl="jnp",
                           ema_decay=EMA_DECAY)
    state, metrics = step(state, batch, 0)
    return model, state, metrics


def assert_close_to_a_step(got: dict, want: dict):
    """Every tensor within one AdamW step of the JAX one, and all but
    ``ILL_CONDITIONED_SHARE`` of the elements of tensors with a gradient
    within ``PARAM_ATOL``."""
    off = total = 0
    for name, value in want.items():
        diff = np.abs(got[name] - value)
        assert diff.max() <= 2 * SGDR[0], (name, float(diff.max()))
        if not zero_gradient(name):
            off += int((diff > PARAM_ATOL + 1e-5 * np.abs(value)).sum())
            total += diff.size
    assert off <= ILL_CONDITIONED_SHARE * total, (off, total)


def numpy_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(jax_setup, jax_runs, accum_steps):
    jstate, jmetrics = jax_runs[accum_steps]
    model, state, metrics = run_port(jax_setup[1], raw_tiles(), accum_steps)
    for key in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=RTOL,
                                   err_msg=key)
    assert float(jmetrics["grad_norm"]) > OPT["gradient_clip"]   # the clip acted
    assert metrics["skipped"] == 0 and state.step == 1 and state.nan_skips == 0
    want = port_model({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert_close_to_a_step(numpy_state(model), numpy_state(want))


def test_frozen_block_and_gram_stay_and_others_move(jax_setup):
    variables = jax_setup[1]
    before = port_model(variables).state_dict()
    model, _, _ = run_port(variables, raw_tiles())
    after = model.state_dict()
    for name in before:
        unchanged = torch.equal(before[name], after[name])
        if name == "fill_gram" or name.startswith("encoder.blocks.0."):
            assert unchanged, name
        elif name.endswith(("weight", "bias", "pos_embed")):
            assert not unchanged, name


def test_ema_matches_jax(jax_setup, jax_runs):
    jstate, _ = jax_runs[1]
    _, state, _ = run_port(jax_setup[1], raw_tiles())
    shadow = port_model({"params": jstate.ema_params,
                         "batch_stats": jax_setup[1]["batch_stats"]})
    assert_close_to_a_step({k: v.numpy() for k, v in state.ema.items()},
                           {k: v.detach().numpy() for k, v in shadow.named_parameters()})


def test_nan_tile_leaves_state_unchanged(jax_setup, jax_runs):
    jstate, jmetrics = jax_runs["nan"]
    assert int(jstate.nan_skips) == 1 and int(jmetrics["skipped"]) == 1
    before = port_model(jax_setup[1]).state_dict()
    model, state, metrics = run_port(jax_setup[1], nan_tiles())
    assert metrics["skipped"] == 1 and state.step == 0 and state.nan_skips == 1
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]), name
    for name, p in model.named_parameters():
        assert torch.equal(state.ema[name], before[name]), name
    assert all(not s for s in state.optimizer.adamw.state.values())


def test_eval_step_masked_sums_match_jax(jax_setup):
    model, variables = jax_setup
    batch = raw_tiles(seed=1)
    jstep = jax_make_eval_step(model, JaxLossConfig(**LOSS), JaxNoiseConfig(**ZERO_NOISE),
                               image_size=32, noise_impl="jnp")
    want = jstep(variables, jnp.asarray(batch), jax.random.PRNGKey(0), jnp.int32(3))
    step = make_eval_step(port_model(variables), LossConfig(**LOSS),
                          NoiseConfig(**ZERO_NOISE), image_size=32, noise_impl="jnp")
    got = step(batch, 0, 3)
    assert float(got["count"]) == 3.0
    for key in ("loss", "psnr", "ssim", "sam", "rmse"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(tta=0), ValueError, "num_transforms"),
    (dict(forward_impl="hybrid"), ValueError, "input_fill models"),   # the flagship has a fill stage
    (dict(ensemble_size=2, forward_impl="hybrid"), ValueError, "not hybrid"),
    (dict(forward_impl="bogus"), ValueError, "forward_impl"),
    (dict(tta=9), ValueError, "num_transforms"),
    (dict(ensemble_size=0), ValueError, "ensemble_size"),
])
def test_eval_step_refuses_what_is_not_ported(jax_setup, kwargs, error, match):
    with pytest.raises(error, match=match):
        make_eval_step(port_model(jax_setup[1]), **kwargs)
