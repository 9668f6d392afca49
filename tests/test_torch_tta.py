"""The port's dihedral test-time self-ensemble (``ops/tta.py``) against the
JAX package's, on the CPU: every orbit element and its inverse exactly, the
orbit's validation, the 8-view ensemble of a tiny flagship with converted
weights in fp32, and ``InferenceSession(tta=N)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.ops import tta as jax_tta
from msid_tpu_torch.deployment.inference import InferenceSession
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.tta import (
    DIHEDRAL_ORBIT,
    dihedral_ensemble,
    dihedral_inverse,
    dihedral_transform,
    orbit_prefix,
    wrap_forward,
)
from test_torch_model import noisy_tiles, randomize_variables

torch.set_num_threads(2)

TINY_FLAGSHIP = dict(image_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                     decoder_arch="unet_skip", decoder_channels=(8, 8, 8, 8),
                     residual_output=True, input_fill=True)
ENSEMBLE_ATOL = 1e-5     # fp32 forwards on both sides, 8 views averaged


def test_orbit_is_the_jax_orbit():
    assert DIHEDRAL_ORBIT == jax_tta.DIHEDRAL_ORBIT


@pytest.mark.parametrize("k,flip", DIHEDRAL_ORBIT)
@pytest.mark.parametrize("shape", [(2, 6, 6, 3), (1, 4, 6, 2)])
def test_transform_and_inverse_equal_jax(k, flip, shape):
    x = np.random.default_rng(k + 2 * flip).normal(size=shape).astype(np.float32)
    got = dihedral_transform(torch.from_numpy(x), k, flip)
    want = np.asarray(jax_tta.dihedral_transform(jnp.asarray(x), k, flip))
    np.testing.assert_array_equal(got.numpy(), want)
    back = dihedral_inverse(got, k, flip)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_tta.dihedral_inverse(jnp.asarray(want), k, flip)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("n,h,w", [(0, 8, 8), (9, 8, 8), (-1, 8, 8), (5, 4, 6), (8, 6, 4)])
def test_orbit_prefix_refuses_what_jax_refuses(n, h, w):
    with pytest.raises(ValueError):
        jax_tta.orbit_prefix(n, h, w)
    with pytest.raises(ValueError, match="num_transforms|square"):
        orbit_prefix(n, h, w)


@pytest.mark.parametrize("n,h,w", [(1, 8, 8), (4, 4, 6), (8, 8, 8)])
def test_orbit_prefix_matches_jax(n, h, w):
    assert tuple(orbit_prefix(n, h, w)) == tuple(jax_tta.orbit_prefix(n, h, w))


def test_wrap_forward_keeps_one_view_and_checks_the_shape():
    def forward(z):
        return z

    assert wrap_forward(forward, 1, 8, 8) is forward
    with pytest.raises(ValueError, match="square"):
        wrap_forward(forward, 8, 8, 6)
    x = torch.randn(1, 8, 8, 2)
    torch.testing.assert_close(wrap_forward(torch.tanh, 8, 8, 8)(x), torch.tanh(x))


def test_ensemble_accumulates_in_fp32():
    x = torch.randn(1, 8, 8, 3).bfloat16()
    out = dihedral_ensemble(lambda z: z * 2, x, 4)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.float() * 2)


@pytest.fixture(scope="module")
def tiny_flagship():
    jmodel = JaxModel(**TINY_FLAGSHIP, dtype=jnp.float32, gradient_checkpointing=False)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(0)), seed=5)
    model = SatMAERestoration(**TINY_FLAGSHIP)
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("n", [3, 8])
def test_ensemble_of_the_tiny_flagship_matches_jax(tiny_flagship, n):
    jmodel, variables, model = tiny_flagship
    x = noisy_tiles((2, 32, 32, 13), seed=n)
    forward = jax.jit(lambda z: jax_tta.dihedral_ensemble(
        lambda v: jmodel.apply(variables, v, train=False), z, n))
    want = np.asarray(forward(jnp.asarray(x)))
    with torch.no_grad():
        got = dihedral_ensemble(model, torch.from_numpy(x), n)
    np.testing.assert_allclose(got.numpy(), want, atol=ENSEMBLE_ATOL)


def test_inference_session_tta(tiny_flagship):
    model = tiny_flagship[2]
    x = noisy_tiles((2, 32, 32, 13), seed=11)
    plain = InferenceSession(model, batch_size=2, image_size=32, device="cpu")
    session = InferenceSession(model, batch_size=2, image_size=32, device="cpu", tta=8)
    assert session.tta == 8
    with torch.no_grad():
        want = dihedral_ensemble(model, torch.from_numpy(x), 8).numpy()
    got = session.predict(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, plain.predict(x))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="num_transforms"):
            InferenceSession(model, batch_size=2, image_size=32, device="cpu", tta=bad)
