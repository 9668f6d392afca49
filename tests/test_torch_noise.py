"""The port's corruption (``ops/noise.py``, K2's ``ops/cuda_noise.py``) against
the JAX package, on the CPU.

Random streams differ between the frameworks, so the compositions are held
to JAX with the draws given to both sides: the threefry draws of
``jax.random.split(key, 6)`` for the reference composition, and the draws
that Pallas interpret mode stubs in (all-zero random bits) for K2. The
distributions of the port's own Philox stream are checked as the JAX
package checks its TPU kernel's. On a CPU tensor K2's wrapper is its plain
version; the Hopper kernel itself is held to it on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msid_tpu.ops.noise import NoiseConfig as JaxNoiseConfig
from msid_tpu.ops.noise import apply_sensor_noise as jax_apply_sensor_noise
from msid_tpu.ops.pallas_noise import apply_sensor_noise_pallas
from msid_tpu_torch.ops import _build, cuda_noise
from msid_tpu_torch.ops.cuda_noise import (
    apply_sensor_noise_kernel,
    apply_sensor_noise_kernel_reference,
    compose,
    kernel_draws,
    philox4x32,
)
from msid_tpu_torch.ops.noise import (
    NoiseConfig,
    apply_sensor_noise,
    apply_sensor_noise_from_draws,
    corrupt,
    dead_band_mask,
    default_noise_impl,
    fold_in,
)

torch.set_num_threads(2)

ATOL = 1e-6   # fp32 compositions of the same draws, another rounding order

CONFIGS = [
    dict(),
    dict(enable_striping=True, stripe_prob=0.5),
    dict(gaussian_sigma=0.1, speckle_sigma=0.0, dead_band_prob=0.3, thermal_scale=0.05),
    dict(gaussian_sigma=0.0, speckle_sigma=0.05, dead_band_prob=0.0, thermal_scale=0.0,
         enable_striping=True, stripe_prob=1.0),
]


def tiles(shape=(2, 16, 16, 13), seed=0):
    return np.random.default_rng(seed).uniform(-2.5, 2.5, shape).astype(np.float32)


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_reference_composition_matches_jax_with_its_draws(kwargs):
    x = tiles()
    b, h, w, c = x.shape
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_apply_sensor_noise(key, jnp.asarray(x), JaxNoiseConfig(**kwargs)))
    k = jax.random.split(key, 6)
    draws = {
        "gauss": jax.random.normal(k[0], x.shape, jnp.float32),
        "speckle": jax.random.normal(k[1], x.shape, jnp.float32),
        "dead": jax.random.uniform(k[2], (b, 1, 1, c)),
        "thermal": jax.random.normal(k[3], x.shape, jnp.float32),
        "stripe_gate": jax.random.uniform(k[4], (b, 1, 1, 1)),
        "stripe": jax.random.normal(k[5], (b, 1, w, c), jnp.float32),
    }
    draws = {name: torch.from_numpy(np.asarray(v)) for name, v in draws.items()}
    got = apply_sensor_noise_from_draws(torch.from_numpy(x), NoiseConfig(**kwargs), draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def interpret_mode_draws(b, n, wc, c):
    """The draws of the TPU kernel in interpret mode, whose PRNG yields zero
    bits: its uniforms are 0 * 2^-32 + (0.5 + 2^-33) and its Irwin-Hall
    normals 0 * 2^-32 + 12 * 2^-33, both in fp32."""
    u = float(np.float32(0.5 + 2.0 ** -33))
    z = float(np.float32(12 * 2.0 ** -33))
    return {"u_dead": torch.full((b, c), u), "u_gate": torch.full((b,), u),
            "stripe": torch.full((b, wc), z), "n1": torch.full((b, n), z),
            "n2": torch.full((b, n), z)}


@pytest.mark.parametrize("kwargs", [
    dict(enable_striping=True, stripe_prob=0.6),     # gate open: u = 0.5 < 0.6
    dict(dead_band_prob=0.6),                        # every band dead: 0.5 < 0.6
    dict(gaussian_sigma=0.3, thermal_scale=0.2, speckle_sigma=0.1),
])
def test_kernel_composition_matches_pallas_interpret(kwargs):
    x = tiles((2, 8, 16, 13), seed=1)
    b, h, w, c = x.shape
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(apply_sensor_noise_pallas(jnp.int32(1), jnp.asarray(x),
                                                    JaxNoiseConfig(**kwargs)))
    got, masks = compose(torch.from_numpy(x), NoiseConfig(**kwargs),
                         interpret_mode_draws(b, h * w * c, w * c, c), return_masks=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert masks.shape == (b, c + 1)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, (k0, k1), want in cases:
        got = philox4x32(*ctr, seed=k0 | (k1 << 32))
        assert tuple(int(v) for v in got) == want


def test_kernel_statistics():
    """The JAX package's TPU statistics test, on the plain version."""
    zeros = torch.zeros(4, 192, 192, 13)
    g = apply_sensor_noise_kernel_reference(
        3, zeros, NoiseConfig(gaussian_sigma=0.02, speckle_sigma=0, dead_band_prob=0,
                              thermal_scale=0))
    assert abs(float(g.mean())) < 1e-3 and abs(float(g.std()) - 0.02) < 1e-3
    t = apply_sensor_noise_kernel_reference(
        5, zeros, NoiseConfig(gaussian_sigma=0, speckle_sigma=0, dead_band_prob=0,
                              thermal_scale=0.01))
    assert abs(float(t[..., 0].std()) - 0.01) < 1e-3    # band 1 weight 1.0
    assert abs(float(t[..., 12].std()) - 0.02) < 2e-3   # band 13 weight 2.0
    y = apply_sensor_noise_kernel_reference(7, torch.ones(8, 192, 192, 13), NoiseConfig())
    dead = y.abs().mean(dim=(1, 2)) < 0.1
    assert 1 <= int(dead.sum()) <= 20   # Binomial(104, 0.08): ~8.3 +- 2.8


def test_kernel_normals_and_uniforms_are_standard():
    d = kernel_draws(11, 4, 20000, 52, 13)
    for name in ("n1", "n2"):
        assert abs(float(d[name].mean())) < 0.01 and abs(float(d[name].std()) - 1) < 0.01
    assert abs(float(torch.corrcoef(torch.stack([d["n1"].flatten(),
                                                 d["n2"].flatten()]))[0, 1])) < 0.01
    assert 0 < float(d["u_dead"].min()) and float(d["u_dead"].max()) < 1


def test_kernel_draws_depend_on_seed_and_sample_only():
    x = torch.from_numpy(tiles((4, 8, 8, 13), seed=2))
    cfg = NoiseConfig(enable_striping=True, stripe_prob=0.5)
    a = apply_sensor_noise_kernel_reference(5, x, cfg)
    assert torch.equal(a, apply_sensor_noise_kernel_reference(5, x, cfg))
    assert not torch.equal(a, apply_sensor_noise_kernel_reference(6, x, cfg))
    # sample b's draws do not depend on how many samples follow it
    assert torch.equal(a[:2], apply_sensor_noise_kernel_reference(5, x[:2], cfg))
    # nor on the sample's own contents
    b = apply_sensor_noise_kernel_reference(5, x.flip(0), cfg, return_masks=True)[1]
    assert torch.equal(b, apply_sensor_noise_kernel_reference(5, x, cfg, return_masks=True)[1])


def test_single_band_guard():
    """C = 1: the thermal weight is 1 (linspace(1, 2, 1) in JAX), not 0/0."""
    x = torch.zeros(2, 64, 64, 1)
    cfg = NoiseConfig(gaussian_sigma=0, speckle_sigma=0, dead_band_prob=0,
                      thermal_scale=0.1)
    y = apply_sensor_noise_kernel_reference(3, x, cfg)
    assert torch.isfinite(y).all() and abs(float(y.std()) - 0.1) < 0.01
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(apply_sensor_noise_pallas(jnp.int32(1), jnp.zeros((1, 8, 8, 1)),
                                                    JaxNoiseConfig(thermal_scale=0.1)))
    got = compose(torch.zeros(1, 8, 8, 1), NoiseConfig(thermal_scale=0.1),
                  interpret_mode_draws(1, 64, 8, 1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    ref = apply_sensor_noise(0, torch.zeros(1, 8, 8, 1), cfg)
    assert torch.isfinite(ref).all()


def test_clamp_and_dtype():
    x = torch.full((2, 8, 8, 13), 2.9)
    for fn in (apply_sensor_noise_kernel_reference, apply_sensor_noise):
        y = fn(1, x, NoiseConfig(gaussian_sigma=1.0))
        assert float(y.max()) <= 3.0 and float(y.min()) >= -3.0
        assert fn(1, x.bfloat16(), NoiseConfig()).dtype == torch.bfloat16


def test_nan_input_stays_nan():
    x = torch.zeros(1, 4, 4, 13)
    x[0, 1, 1, 1] = float("nan")
    assert torch.isnan(apply_sensor_noise_kernel_reference(1, x, NoiseConfig())).sum() == 1


def test_dead_band_mask_matches_corruption():
    cfg = NoiseConfig(gaussian_sigma=0.0, speckle_sigma=0.0, dead_band_prob=0.3,
                      thermal_scale=0.0)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 2.5, (4, 8, 8, 13))
                         .astype(np.float32))
    noisy = apply_sensor_noise(123, x, cfg)
    alive = dead_band_mask(123, x.shape, cfg)
    assert torch.equal(noisy, x * alive.float())
    assert 0 < int(alive.sum()) < alive.numel()


def test_noise_config_from_config_matches_jax():
    config = {"noise": {"gaussian_sigma": 0.02, "thermal_noise_scale": 0.01,
                        "enable_striping": True, "stripe_prob": 0.3}}
    assert (NoiseConfig.from_config(config).__dict__
            == JaxNoiseConfig.from_config(config).__dict__)


def test_corrupt_dispatch(monkeypatch):
    x = torch.from_numpy(tiles((1, 8, 8, 13)))
    assert torch.equal(corrupt(4, x, impl="pallas"),
                       apply_sensor_noise_kernel_reference(4, x))
    assert torch.equal(corrupt(4, x, impl="jnp"), apply_sensor_noise(4, x))
    assert torch.equal(corrupt(4, x), apply_sensor_noise(4, x))    # auto on the CPU
    assert default_noise_impl("cuda") == "pallas" and default_noise_impl("cpu") == "jnp"
    with pytest.raises(ValueError, match="impl"):
        corrupt(4, x, impl="kernel")


def test_wrapper_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(cuda_noise, "apply_sensor_noise_kernel_reference", forbidden)
    before = _build.launched.copy()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = torch.empty(2, 8, 8, 13, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            apply_sensor_noise_kernel(1, x)
    assert _build.launched == before


def test_fold_in():
    assert fold_in(42, 3) == fold_in(42, 3)
    seeds = {fold_in(s, v) for s in range(4) for v in range(50)}
    assert len(seeds) == 200 and all(0 <= s < 2 ** 64 for s in seeds)


@pytest.mark.parametrize("shape", [
    (64, 192, 192, 13),       # the flagship's batch
    (3, 8, 8, 13),            # fewer groups than threads
    (2, 64, 64, 1),           # one band
    (3, 37, 29, 13),          # n % 4 != 0: a last group that is not whole
    (5, 6, 10, 5),
])
def test_launch_shape_covers_every_element_of_a_sample_once(shape):
    """K2's grid split: CTA x of a sample takes the groups of 4 elements
    [x * per_cta, (x + 1) * per_cta) of it (the last group cut at n): every
    element once, no CTA idle, about the target grid."""
    b, h, w, c = shape
    n = h * w * c
    chunks, per_cta = cuda_noise.launch_shape(b, n)
    groups = -(-n // 4)
    covered = np.zeros(n, np.int64)
    for x in range(chunks):
        first, last = x * per_cta, min(groups, (x + 1) * per_cta)
        assert first < last                              # no CTA is idle
        covered[first * 4:min(n, last * 4)] += 1
    assert (covered == 1).all()
    assert chunks * b < cuda_noise._TARGET_CTAS + b      # about the target grid
