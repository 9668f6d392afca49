"""The port's VGG16 perceptual loss (``msid_tpu_torch/training/perceptual.py``)
against the JAX package's, on the CPU: features and both losses on the
same seeded weights (``init_vgg16_params(0)``), loading ``.pth`` and
``.npz`` weights in either layout, ``resolve_perceptual``, and one train
step of a tiny flagship with the VGG term against the JAX step."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.ops.noise import NoiseConfig as JaxNoiseConfig
from msid_tpu.training import perceptual as jax_perceptual
from msid_tpu.training.losses import LossConfig as JaxLossConfig
from msid_tpu.training.optim import build_optimizer as jax_build_optimizer
from msid_tpu.training.schedules import cosine_warm_restarts as jax_sgdr
from msid_tpu.training.train_state import TrainState as JaxTrainState
from msid_tpu.training.train_state import make_train_step as jax_make_train_step
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.training import perceptual
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.training.optim import build_optimizer
from msid_tpu_torch.training.schedules import cosine_warm_restarts
from msid_tpu_torch.training.train_state import TrainState, make_train_step
from test_torch_model import randomize_variables
from test_torch_train_step import OPT, SGDR, TINY_FLAGSHIP, ZERO_NOISE, port_model, raw_tiles

torch.set_num_threads(2)

RTOL = 1e-5          # fp32 convs summed in another order
STEP_RTOL = 1e-4     # loss, mse, grad_norm of a step (test_torch_train_step's)
LOSS = dict(mse_weight=1.0, ssim_weight=0.1, sam_weight=0.0, perceptual_weight=0.1)


def images(shape=(2, 32, 32, 13), seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-2, 2, shape).astype(np.float32)
    return (target + rng.normal(0, 0.3, shape)).astype(np.float32), target


@pytest.fixture(scope="module")
def weights():
    return perceptual.init_vgg16_params(0), jax_perceptual.init_vgg16_params(0)


def test_init_draws_the_jax_weights_in_oihw(weights):
    ours, theirs = weights
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        np.testing.assert_array_equal(ours[k].numpy(), want)


def test_features_match_jax(weights):
    ours, theirs = weights
    x = images()[0][..., :3]
    got = perceptual.vgg16_features(ours, torch.from_numpy(x))
    want = jax_perceptual.vgg16_features(theirs, jnp.asarray(x))
    assert list(got) == list(want) == ["3", "8", "15", "22"]
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_losses_match_jax(weights, dtype):
    """Both losses, fp32 whatever the images' dtype and under autocast."""
    ours, theirs = weights
    p, t = images()
    pt, tt = torch.from_numpy(p).to(dtype), torch.from_numpy(t)
    pj, tj = jnp.asarray(pt.float().numpy()), jnp.asarray(t)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype != torch.float32):
        loss = perceptual.vgg_perceptual_loss(ours, pt, tt)
        per = perceptual.vgg_perceptual_per_sample(ours, pt, tt)
    assert loss.dtype == per.dtype == torch.float32 and per.shape == (2,)
    np.testing.assert_allclose(float(loss), float(jax_perceptual.vgg_perceptual_loss(
        theirs, pj, tj)), rtol=RTOL)
    np.testing.assert_allclose(per.numpy(), np.asarray(
        jax_perceptual.vgg_perceptual_per_sample(theirs, pj, tj)), rtol=RTOL)
    np.testing.assert_allclose(float(per.mean()), float(loss), rtol=1e-6)
    lw = {"8": 0.5, "22": 2.0}
    np.testing.assert_allclose(float(perceptual.vgg_perceptual_loss(ours, pt, tt, lw)),
                               float(jax_perceptual.vgg_perceptual_loss(theirs, pj, tj, lw)),
                               rtol=RTOL)


@pytest.mark.parametrize("fmt,layout", [(".npz", "oihw"), (".npz", "hwio"), (".pth", "oihw")])
def test_load_weights(weights, tmp_path, fmt, layout):
    """torchvision's OIHW or the JAX package's HWIO, from .npz or a .pth
    state dict with classifier weights beside; both packages load the
    same network."""
    ours, theirs = weights
    arrays = {k: v.numpy() for k, v in ours.items()} if layout == "oihw" else theirs
    path = tmp_path / f"vgg16{fmt}"
    if fmt == ".npz":
        np.savez(path, **arrays)
    else:
        torch.save({**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()},
                    "classifier.0.weight": torch.zeros(4, 4)}, path)
    got = perceptual.load_vgg16_weights(path)
    assert list(got) == list(ours)
    for k in ours:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], ours[k]), k
    if layout == "oihw":
        want = jax_perceptual.load_vgg16_weights(path)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), theirs[k])
    bad = tmp_path / "bad.npz"
    np.savez(bad, **{k: v for k, v in arrays.items() if k != "features.21.weight"})
    with pytest.raises(KeyError, match="features.21.weight"):
        perceptual.load_vgg16_weights(bad)


def test_resolve_perceptual(weights, tmp_path, caplog):
    ours, _ = weights
    path = tmp_path / "vgg16.npz"
    np.savez(path, **{k: v.numpy() for k, v in ours.items()})
    section = {"perceptual_impl": "vgg", "perceptual_weights_path": str(path)}
    impl, params = perceptual.resolve_perceptual(section)
    assert impl == jax_perceptual.resolve_perceptual(section)[0] == "vgg"
    assert all(torch.equal(params[k], ours[k]) for k in ours)
    assert perceptual.resolve_perceptual({"perceptual_impl": "edge"}) == ("edge", None)
    with caplog.at_level(logging.WARNING):
        missing = dict(section, perceptual_weights_path=str(tmp_path / "none.npz"))
        assert perceptual.resolve_perceptual(missing) == ("edge", None)
    assert "falling back" in caplog.text
    with pytest.raises(ValueError, match="unknown perceptual_impl"):
        perceptual.resolve_perceptual({"perceptual_impl": "alex"})


def test_train_step_with_vgg_matches_jax(weights):
    """One fp32 train step of a tiny flagship with the VGG16 term: loss,
    MSE and gradient norm within the train-step test's tolerance."""
    ours, theirs = weights
    jmodel = JaxModel(**TINY_FLAGSHIP, dtype=jnp.float32, gradient_checkpointing=False)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(0)), seed=3)
    tx = jax_build_optimizer(jax_sgdr(*SGDR), params=variables["params"], **OPT)
    step = jax_make_train_step(jmodel, tx, JaxLossConfig(**LOSS), JaxNoiseConfig(**ZERO_NOISE),
                               image_size=32, noise_impl="jnp", vgg_params=theirs)
    _, want = step(JaxTrainState.create(variables, tx), jnp.asarray(raw_tiles()),
                   jax.random.PRNGKey(0))

    model = port_model(variables)
    optimizer = build_optimizer(model, cosine_warm_restarts(*SGDR), **OPT)
    port_step = make_train_step(model, LossConfig(**LOSS), NoiseConfig(**ZERO_NOISE),
                                image_size=32, noise_impl="jnp", vgg_params=ours)
    state, got = port_step(TrainState.create(model, optimizer), raw_tiles(), 0)
    assert state.step == 1 and got["skipped"] == 0
    for key in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=STEP_RTOL,
                                   err_msg=key)
    # the VGG term is in the loss: the edge stand-in gives another one
    model_edge = port_model(variables)
    edge_step = make_train_step(model_edge, LossConfig(**LOSS), NoiseConfig(**ZERO_NOISE),
                                image_size=32, noise_impl="jnp")
    edge = edge_step(TrainState.create(model_edge, build_optimizer(
        model_edge, cosine_warm_restarts(*SGDR), **OPT)), raw_tiles(), 0)[1]
    assert abs(float(edge["loss"]) - float(got["loss"])) > 1e-4 * float(got["loss"])
