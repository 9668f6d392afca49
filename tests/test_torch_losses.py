"""The port's SSIM, metrics and losses against the JAX package's, on the CPU,
and the combined loss's gradient with respect to ``pred`` against
``jax.grad``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax_metrics = importlib.import_module("msid_tpu.ops.metrics")
jax_ssim = importlib.import_module("msid_tpu.ops.ssim")
jax_losses = importlib.import_module("msid_tpu.training.losses")
metrics = importlib.import_module("msid_tpu_torch.ops.metrics")
ssim = importlib.import_module("msid_tpu_torch.ops.ssim")
losses = importlib.import_module("msid_tpu_torch.training.losses")
init_vgg16_params = importlib.import_module("msid_tpu_torch.training.perceptual").init_vgg16_params
jax_init_vgg16_params = importlib.import_module("msid_tpu.training.perceptual").init_vgg16_params

torch.set_num_threads(2)

ATOL = 1e-5     # fp32 statistics summed in another order
RTOL = 1e-5
LOSS_ATOL = 1e-6   # 1 - SSIM near 0 keeps SSIM's absolute, not relative, error


def pair(shape=(3, 24, 24, 13), seed=0):
    """A target in model range and a restoration close to it (a converging
    model: small SAM angles), as fp32 numpy."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-2, 2, shape).astype(np.float32)
    pred = (target + rng.normal(0, 0.1, shape)).astype(np.float32)
    return pred, target


def to_t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_ssim_matches_jax():
    p, t = pair()
    want_map = np.asarray(jax_ssim.ssim_map(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(ssim.ssim_map(*to_t(p, t)).numpy(), want_map, atol=ATOL)
    np.testing.assert_allclose(float(ssim.ssim(*to_t(p, t))),
                               float(jax_ssim.ssim(jnp.asarray(p), jnp.asarray(t))), atol=ATOL)
    np.testing.assert_allclose(ssim.ssim_per_sample(*to_t(p, t)).numpy(),
                               np.asarray(jax_ssim.ssim_per_sample(jnp.asarray(p),
                                                                   jnp.asarray(t))), atol=ATOL)
    np.testing.assert_allclose(ssim.gaussian_window().numpy(),
                               np.asarray(jax_ssim.gaussian_window()), rtol=1e-7)


def test_ssim_in_bf16_keeps_fp32_statistics():
    p, t = pair()
    got = ssim.ssim_per_sample(torch.from_numpy(p).bfloat16(), torch.from_numpy(t))
    want = jax_ssim.ssim_per_sample(jnp.asarray(p, jnp.bfloat16), jnp.asarray(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["mse", "psnr", "sam", "rmse", "mae"])
def test_per_sample_and_batch_metrics_match_jax(name):
    p, t = pair(seed=1)
    per = getattr(metrics, f"{name}_per_sample")(*to_t(p, t))
    want = getattr(jax_metrics, f"{name}_per_sample")(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(per.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if name != "mse":
        whole = getattr(metrics, f"calculate_{name}")(*to_t(p, t))
        want = getattr(jax_metrics, f"calculate_{name}")(jnp.asarray(p), jnp.asarray(t))
        np.testing.assert_allclose(float(whole), float(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mask", [None, [1.0, 1.0, 0.0]])
def test_batch_metric_sums_match_jax(mask):
    p, t = pair(seed=2)
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax_metrics.batch_metric_sums(jnp.asarray(p), jnp.asarray(t), mask=jmask)
    got = metrics.batch_metric_sums(*to_t(p, t),
                                    mask=None if mask is None else torch.tensor(mask))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, err_msg=key)


def test_metrics_tracker_matches_jax():
    ours, theirs = metrics.MetricsTracker(), jax_metrics.MetricsTracker()
    assert ours.compute() == theirs.compute()
    for seed in (3, 4):
        p, t = pair(seed=seed)
        ours.update(*to_t(p, t))
        theirs.update(jnp.asarray(p), jnp.asarray(t))
    got, want = ours.compute(), theirs.compute()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=RTOL)
    assert "PSNR" in repr(ours)


LOSS_CONFIGS = [
    dict(),
    dict(mse_weight=0.7, ssim_weight=0.2, sam_weight=0.1, perceptual_weight=0.3),
]


@pytest.mark.parametrize("kwargs", LOSS_CONFIGS)
def test_combined_loss_matches_jax(kwargs):
    p, t = pair(seed=5)
    jcfg, cfg = jax_losses.LossConfig(**kwargs), losses.LossConfig(**kwargs)
    want_total, want_aux = jax_losses.combined_loss(jnp.asarray(p), jnp.asarray(t), jcfg)
    total, aux = losses.combined_loss(*to_t(p, t), cfg)
    assert set(aux) == set(want_aux)
    for key in want_aux:
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), rtol=RTOL,
                                   atol=LOSS_ATOL, err_msg=key)
    per = losses.combined_loss_per_sample(*to_t(p, t), cfg)
    want_per = jax_losses.combined_loss_per_sample(jnp.asarray(p), jnp.asarray(t), jcfg)
    np.testing.assert_allclose(per.numpy(), np.asarray(want_per), rtol=RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(float(per.mean()), float(total), rtol=RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("kwargs", LOSS_CONFIGS)
def test_combined_loss_gradient_matches_jax_grad(kwargs):
    p, t = pair((2, 16, 16, 13), seed=6)
    jcfg, cfg = jax_losses.LossConfig(**kwargs), losses.LossConfig(**kwargs)
    want = jax.grad(lambda x: jax_losses.combined_loss(x, jnp.asarray(t), jcfg)[0])(
        jnp.asarray(p))
    pred = torch.from_numpy(p).requires_grad_(True)
    losses.combined_loss(pred, torch.from_numpy(t), cfg)[0].backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * scale)


def test_sam_and_edge_losses_match_jax():
    p, t = pair(seed=7)
    np.testing.assert_allclose(losses.sam_loss_per_sample(*to_t(p, t)).numpy(),
                               np.asarray(jax_losses.sam_loss_per_sample(jnp.asarray(p),
                                                                         jnp.asarray(t))),
                               rtol=RTOL)
    # the atan2 loss is the arccos metric in radians
    np.testing.assert_allclose(np.degrees(losses.sam_loss_per_sample(*to_t(p, t)).numpy()),
                               metrics.sam_per_sample(*to_t(p, t)).numpy(), atol=1e-3)
    np.testing.assert_allclose(float(losses.edge_perceptual_loss(*to_t(p, t))),
                               float(jax_losses.edge_perceptual_loss(jnp.asarray(p),
                                                                     jnp.asarray(t))),
                               rtol=RTOL)
    np.testing.assert_allclose(float(losses.l1_loss(*to_t(p, t))),
                               float(jax_losses.l1_loss(jnp.asarray(p), jnp.asarray(t))),
                               rtol=RTOL)


def test_loss_config_and_vgg_refusal():
    config = {"training": {"loss": {"mse_weight": 0.5, "ssim_weight": 0.2,
                                    "perceptual_weight": 0.1, "sam_weight": 0.05}}}
    assert (losses.LossConfig.from_config(config).__dict__
            == jax_losses.LossConfig.from_config(config).__dict__)
    # VGG weights switch the perceptual term to the VGG16 feature MSE, as in
    # the JAX package (same seeded weights, OIHW here, HWIO there)
    cfg = losses.LossConfig.from_config(config)
    jcfg = jax_losses.LossConfig.from_config(config)
    p, t = pair()
    total, aux = losses.combined_loss(*to_t(p, t), cfg, vgg_params=init_vgg16_params(0))
    want, want_aux = jax_losses.combined_loss(jnp.asarray(p), jnp.asarray(t), jcfg,
                                              vgg_params=jax_init_vgg16_params(0))
    np.testing.assert_allclose(float(aux["perceptual"]), float(want_aux["perceptual"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(total), float(want), rtol=RTOL)
    assert float(aux["perceptual"]) != float(losses.edge_perceptual_loss(*to_t(p, t)))
