"""bf16 compute over fp32 parameters, the training path's autocast, on the CPU.

Training keeps fp32 parameters and runs forward and backward under
``torch.autocast`` with bf16. These tests hold that path to the JAX model's
casts: the model casts to the compute dtype where the JAX model does, the
fill stage, ``mask_cond``, SSIM, the losses and the metrics stay fp32, an
eval-mode ResidualBlock hands the fused kernel bf16 operands, and a bf16
train step updates fp32 parameters close to an fp32 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu_torch.models import blocks, restoration
from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.cuda_decoder import fused_residual_block_reference
from msid_tpu_torch.ops.metrics import batch_metric_sums
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.ops.ssim import ssim_per_sample
from msid_tpu_torch.training.losses import LossConfig, combined_loss, combined_loss_per_sample
from msid_tpu_torch.training.optim import build_optimizer
from msid_tpu_torch.training.schedules import constant
from msid_tpu_torch.training.train_state import TrainState, make_eval_step, make_train_step
from test_torch_model import noisy_tiles, randomize_variables

torch.set_num_threads(2)

TINY_FLAGSHIP = dict(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                     decoder_arch="unet_skip", decoder_channels=(16, 16, 8, 8),
                     residual_output=True, input_fill=True)
BF16 = torch.bfloat16
# bf16 keeps 8 significant bits; through ~20 layers the two frameworks round
# at different places. Each bf16 forward is ~2.5e-3 of the output's RMS from
# the fp32 one, and ~2e-3 from the other (fp32 forwards agree to 1e-6);
# the network's part alone, without the filled tile, ~7e-3 from fp32.
BF16_REL_RMS = 5e-3
BF16_RESIDUAL_REL_RMS = 2e-2
# One train step in bf16 against the same step in fp32: the bounds that
# chip_smoke.py holds the card's bf16 step to against the CPU's fp32 step.
STEP_LOSS_RTOL = 1e-2
STEP_GNORM_RTOL = 5e-2
ZERO_NOISE = NoiseConfig(gaussian_sigma=0.0, speckle_sigma=0.0, dead_band_prob=0.0,
                         thermal_scale=0.0)
LOSS = LossConfig(mse_weight=1.0, ssim_weight=0.1, sam_weight=0.05, perceptual_weight=0.1)


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxModel(**TINY_FLAGSHIP, dtype=jnp.float32, gradient_checkpointing=False)
    return jax.tree_util.tree_map(
        np.asarray, randomize_variables(init_model(model, jax.random.PRNGKey(0)), seed=4))


def port_model(variables):
    model = SatMAERestoration(**TINY_FLAGSHIP, gradient_checkpointing=True)
    return load_jax_variables(model, variables)


def rel_rms(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def test_autocast_forward_matches_jax_bf16(jax_variables):
    """fp32 parameters under bf16 autocast against the JAX model with
    ``dtype=bf16`` (fp32 params cast per layer), eval mode: the fused
    ResidualBlock's plain version runs on the bf16 operands."""
    x = noisy_tiles((2, 32, 32, 13))
    jmodel = JaxModel(**TINY_FLAGSHIP, dtype=jnp.bfloat16, gradient_checkpointing=False)
    want = np.asarray(jmodel.apply(jax_variables, jnp.asarray(x, jnp.bfloat16),
                                   train=False), np.float32)
    model = port_model(jax_variables).eval()
    with torch.no_grad(), torch.autocast("cpu", dtype=BF16):
        got = model(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert rel_rms(got.float().numpy(), want) <= BF16_REL_RMS
    # the part the network adds on top of the filled tile agrees too
    with torch.no_grad():
        filled = model(torch.from_numpy(x)).numpy()
    assert rel_rms(got.float().numpy() - x, filled - x) <= BF16_RESIDUAL_REL_RMS


@pytest.mark.parametrize("train", [False, True])
def test_fp32_islands_and_compute_casts(jax_variables, monkeypatch, train):
    """Under autocast the fill stage and ``mask_cond`` see fp32 with autocast
    off; the encoder, the skip stem and the residual add see the compute
    dtype (the JAX model's four casts)."""
    model = port_model(jax_variables).train(train)
    seen = {}
    real_fill = restoration.detect_and_fill

    def fill(x, gram, rms):
        seen["fill"] = (x.dtype, gram.dtype, torch.is_autocast_enabled("cpu"))
        return real_fill(x, gram, rms)

    def record(name):
        def hook(module, args, out):
            seen[name] = (args[0].dtype, (out[0] if isinstance(out, list) else out).dtype)
        return hook

    monkeypatch.setattr(restoration, "detect_and_fill", fill)
    model.mask_cond.register_forward_hook(record("mask_cond"))
    model.encoder.patch_embed.register_forward_hook(record("encoder"))
    model.skip_stem.register_forward_hook(record("skip_stem"))
    with torch.autocast("cpu", dtype=BF16):
        out = model(torch.from_numpy(noisy_tiles((2, 32, 32, 13))))
    f32 = torch.float32
    assert seen["fill"] == (f32, f32, False)
    assert seen["mask_cond"] == (f32, f32)
    assert seen["encoder"] == (BF16, BF16)
    assert seen["skip_stem"][0] == BF16
    assert out.dtype == BF16


def test_eval_residual_block_hands_the_kernel_bf16(monkeypatch):
    """fp32 conv weights under autocast: x and both weights reach the fused
    kernel's wrapper in bf16 (the card's kernel raises on anything else)."""
    torch.manual_seed(0)
    block = ResidualBlock(16).eval()
    for norm in (block.norm0, block.norm1):
        norm.running_var.uniform_(0.5, 2.0)
        norm.running_mean.normal_(0.0, 0.1)
    seen = []

    def kernel(x, w1, w2, affines):
        seen.append((x.dtype, w1.dtype, w2.dtype, affines.dtype))
        return fused_residual_block_reference(x, w1, w2, affines)

    monkeypatch.setattr(blocks, "fused_residual_block", kernel)
    x = torch.randn(2, 16, 8, 8)
    with torch.no_grad():
        with torch.autocast("cpu", dtype=BF16):
            got = block(x)
        want = block(x)
    assert seen == [(BF16, BF16, BF16, torch.float32), (torch.float32,) * 4]
    assert got.dtype == BF16 and want.dtype == torch.float32
    # one bf16 rounding of x, the weights, h and the output: 2e-2 of the scale
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=2e-2 * float(want.abs().max()))


def test_losses_metrics_and_ssim_stay_fp32_under_autocast():
    rng = np.random.default_rng(0)
    pred = torch.from_numpy(rng.normal(0, 1, (3, 24, 24, 13)).astype(np.float32)).to(BF16)
    target = torch.from_numpy(rng.normal(0, 1, (3, 24, 24, 13)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0])

    def everything():
        total, aux = combined_loss(pred, target, LOSS)
        return ([total, aux["mse"], combined_loss_per_sample(pred, target, LOSS),
                 ssim_per_sample(pred, target)]
                + list(batch_metric_sums(pred, target, mask=mask).values()))

    want = everything()
    with torch.autocast("cpu", dtype=BF16):
        got = everything()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def one_step(variables, batch, compute_dtype):
    model = port_model(variables)
    optimizer = build_optimizer(model, constant(1e-3), gradient_clip=1.0,
                                freeze_layers=(0,))
    step = make_train_step(model, LOSS, ZERO_NOISE, image_size=32, noise_impl="jnp",
                           compute_dtype=compute_dtype)
    state, metrics = step(TrainState.create(model, optimizer), batch, 0)
    return model, state, {k: float(metrics[k]) for k in ("loss", "mse", "grad_norm")}


def test_bf16_train_step_updates_fp32_params(jax_variables):
    rng = np.random.default_rng(1)
    batch = rng.uniform(500, 9500, (4, 16, 16, 13)).astype(np.float32)
    batch[0, :, :, 5] = 5000.0                       # a dead band for the fill stage
    model32, _, want = one_step(jax_variables, batch, torch.float32)
    model16, state, got = one_step(jax_variables, batch, BF16)
    assert state.step == 1 and state.nan_skips == 0
    for key, rtol in (("loss", STEP_LOSS_RTOL), ("mse", STEP_LOSS_RTOL),
                      ("grad_norm", STEP_GNORM_RTOL)):
        assert abs(got[key] - want[key]) <= rtol * abs(want[key]), (key, got, want)
    moments = [s["exp_avg"] for s in state.optimizer.adamw.state.values()]
    assert moments and all(m.dtype == torch.float32 for m in moments)
    before = dict(port_model(jax_variables).named_parameters())
    for name, value in model16.named_parameters():
        assert value.dtype == torch.float32, name
        if name == "fill_gram" or name.startswith("encoder.blocks.0."):
            assert torch.equal(value, before[name]), name
        else:   # one AdamW step of lr 1e-3 (weight decay adds lr * 0.05 * |p|)
            assert 0 < float((value - before[name]).detach().abs().max()) <= 1.1e-3, name


def test_bf16_eval_step_is_close_to_fp32(jax_variables):
    rng = np.random.default_rng(2)
    batch = rng.uniform(500, 9500, (3, 16, 16, 13)).astype(np.float32)
    sums = {}
    for dtype in (torch.float32, BF16):
        step = make_eval_step(port_model(jax_variables), LOSS, ZERO_NOISE, image_size=32,
                              noise_impl="jnp", compute_dtype=dtype)
        sums[dtype] = {k: float(v) for k, v in step(batch, 0, 2).items()}
    assert sums[BF16]["count"] == 2.0
    # the bf16 forward is ~2.5e-3 of the output's RMS from fp32 (see
    # BF16_REL_RMS): a few hundredths of a dB of PSNR at most
    assert abs(sums[BF16]["psnr"] - sums[torch.float32]["psnr"]) <= 0.1
    assert abs(sums[BF16]["ssim"] - sums[torch.float32]["ssim"]) <= 2e-3
