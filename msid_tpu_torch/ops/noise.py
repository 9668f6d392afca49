"""Sensor-degradation simulator (PyTorch): counterpart of ``msid_tpu/ops/noise.py``.

Additive Gaussian, multiplicative speckle, per-(sample, band) dead-band
dropout, wavelength-dependent thermal noise (weight 1 -> 2 across the
bands), optional per-sample push-broom striping, clamp to [-3, 3]. NHWC.

Two implementations behind ``corrupt(seed, x, cfg, impl)``:

  * ``jnp`` (the JAX package's name, kept so configs read the same): the
    reference composition ``apply_sensor_noise``, six separate draws from a
    ``torch.Generator`` seeded with ``seed``, about 15 launches and several
    passes over the batch;
  * ``pallas``: the fused kernel K2 (``ops/cuda_noise.py``), one pass,
    counter-based Philox draws. On a CUDA tensor it is the hand-written
    Hopper kernel; on a CPU tensor its plain PyTorch version.

``auto`` resolves to ``pallas`` on a CUDA tensor and ``jnp`` elsewhere.
The JAX package defaults to ``jnp`` because a Pallas call inside its jitted
step broke XLA's fusion of the surrounding work (``msid_tpu/ops/noise.py``
``default_noise_impl``). Eager PyTorch has no such fusion to break, so on
the card the one-pass kernel is the default; ``PERF.md`` has both impls'
times inside the train step. The two impls draw different streams with
the same distributions.

Under data parallelism a rank holds rows ``[offset, offset + B)`` of a
global batch of ``global_batch`` samples, and ``corrupt`` gives those rows
what one device corrupting the whole batch gives them: ``pallas`` keys its
draws by the global sample (K2's ``sample_offset``), ``jnp`` draws at the
global shape and keeps the rank's rows.

Seeds replace JAX's key threading: ``fold_in(seed, value)`` derives a
64-bit seed from a seed and an integer, so the trainer's per-(epoch,
batch) seeds and the fixed per-batch validation seeds are pure functions
of the run's seed, computed on the host with no device sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CLAMP_LO = -3.0
CLAMP_HI = 3.0
IMPLS = ("auto", "jnp", "pallas")


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Noise parameters; defaults as in the JAX package's ``NoiseConfig``."""

    gaussian_sigma: float = 0.015
    speckle_sigma: float = 0.008
    dead_band_prob: float = 0.08
    thermal_scale: float = 0.005
    enable_striping: bool = False
    stripe_prob: float = 0.1
    stripe_sigma: float = 0.02

    @classmethod
    def from_config(cls, config: dict) -> "NoiseConfig":
        """Build from the YAML schema's ``noise:`` section."""
        noise = config.get("noise", {})
        return cls(
            gaussian_sigma=float(noise.get("gaussian_sigma", 0.015)),
            speckle_sigma=float(noise.get("speckle_sigma", 0.008)),
            dead_band_prob=float(noise.get("dead_band_prob", 0.08)),
            thermal_scale=float(
                noise.get("thermal_noise_scale", noise.get("thermal_scale", 0.005))
            ),
            enable_striping=bool(noise.get("enable_striping", False)),
            stripe_prob=float(noise.get("stripe_prob", 0.1)),
            stripe_sigma=float(noise.get("stripe_sigma", 0.02)),
        )


def fold_in(seed: int, value: int) -> int:
    """A new 64-bit seed from ``seed`` and the integer ``value`` (numpy's
    ``SeedSequence`` hash): the port's ``jax.random.fold_in``."""
    words = np.random.SeedSequence([int(seed), int(value)]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def sensor_noise_draws(seed: int, shape, cfg: NoiseConfig = NoiseConfig(),
                       device: torch.device | str = "cpu") -> dict:
    """The six draws of ``apply_sensor_noise`` from a generator seeded with
    ``seed`` on ``device``, in the JAX split order: ``gauss``, ``speckle``,
    ``thermal`` (N(0,1) of x's shape), ``dead`` ([B,1,1,C]) and
    ``stripe_gate`` ([B,1,1,1]) uniforms, ``stripe`` normals [B,1,W,C]. A
    disabled component draws nothing."""
    b, h, w, c = shape
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)

    def normal(size):
        return torch.randn(size, generator=g, device=device)

    def uniform(size):
        return torch.rand(size, generator=g, device=device)

    draws = {}
    if cfg.gaussian_sigma > 0:
        draws["gauss"] = normal(shape)
    if cfg.speckle_sigma > 0:
        draws["speckle"] = normal(shape)
    if cfg.dead_band_prob > 0:
        draws["dead"] = uniform((b, 1, 1, c))
    if cfg.thermal_scale > 0:
        draws["thermal"] = normal(shape)
    if cfg.enable_striping and cfg.stripe_prob > 0:
        draws["stripe_gate"] = uniform((b, 1, 1, 1))
        draws["stripe"] = normal((b, 1, w, c))
    return draws


def apply_sensor_noise_from_draws(x: torch.Tensor, cfg: NoiseConfig,
                                  draws: dict) -> torch.Tensor:
    """The reference composition on given draws (see ``sensor_noise_draws``):
    fp32 arithmetic, clamp, cast back to x's dtype."""
    c = x.shape[-1]
    out = x.float()
    if cfg.gaussian_sigma > 0:
        out = out + draws["gauss"] * cfg.gaussian_sigma
    if cfg.speckle_sigma > 0:
        out = out * (1.0 + draws["speckle"] * cfg.speckle_sigma)
    if cfg.dead_band_prob > 0:
        out = out * (draws["dead"] >= cfg.dead_band_prob).float()
    if cfg.thermal_scale > 0:
        weights = torch.linspace(1.0, 2.0, c, dtype=torch.float32,
                                 device=x.device).reshape(1, 1, 1, c)
        out = out + draws["thermal"] * cfg.thermal_scale * weights
    if cfg.enable_striping and cfg.stripe_prob > 0:
        gate = (draws["stripe_gate"] < cfg.stripe_prob).float()
        out = out + gate * (draws["stripe"] * cfg.stripe_sigma)
    return torch.clamp(out, CLAMP_LO, CLAMP_HI).to(x.dtype)


def apply_sensor_noise(seed: int, x: torch.Tensor,
                       cfg: NoiseConfig = NoiseConfig()) -> torch.Tensor:
    """Corrupt a clean NHWC batch with the reference composition (the
    ``jnp`` impl), drawing from a generator seeded with ``seed``."""
    return apply_sensor_noise_from_draws(
        x, cfg, sensor_noise_draws(seed, x.shape, cfg, x.device))


def dead_band_mask(seed: int, batch_shape, cfg: NoiseConfig = NoiseConfig(),
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The boolean alive mask ``[B, 1, 1, C]`` that ``apply_sensor_noise``
    draws for ``seed`` (True = band survives)."""
    b, _, _, c = batch_shape
    draws = sensor_noise_draws(seed, batch_shape, cfg, device)
    if "dead" not in draws:
        return torch.ones((b, 1, 1, c), dtype=torch.bool, device=device)
    return draws["dead"] >= cfg.dead_band_prob


def default_noise_impl(device: torch.device | str) -> str:
    """What ``auto`` means on ``device``: the fused kernel on CUDA, the
    reference composition elsewhere (see the module docstring)."""
    return "pallas" if torch.device(device).type == "cuda" else "jnp"


def corrupt(seed: int, x: torch.Tensor, cfg: NoiseConfig = NoiseConfig(),
            impl: str = "auto", sample_offset: int = 0,
            global_batch: int | None = None) -> torch.Tensor:
    """Corrupt ``x`` with the ``impl`` the config names: ``auto``, ``jnp``
    (reference composition) or ``pallas`` (the fused kernel K2). ``x`` is
    rows ``[sample_offset, sample_offset + B)`` of a batch of
    ``global_batch`` samples (default: x is the whole batch)."""
    if impl not in IMPLS:
        raise ValueError(f"noise impl must be one of {IMPLS}, got {impl!r}")
    b = x.shape[0]
    if global_batch is None:
        if sample_offset:
            raise ValueError("a sample_offset needs the global_batch it is an offset in")
        global_batch = b
    if not 0 <= sample_offset <= global_batch - b:
        raise ValueError(f"rows [{sample_offset}, {sample_offset + b}) are not in a "
                         f"batch of {global_batch}")
    if impl == "auto":
        impl = default_noise_impl(x.device)
    if impl == "pallas":
        from msid_tpu_torch.ops.cuda_noise import apply_sensor_noise_kernel

        return apply_sensor_noise_kernel(seed, x, cfg, sample_offset=sample_offset)
    if global_batch == b:
        return apply_sensor_noise(seed, x, cfg)
    draws = sensor_noise_draws(seed, (global_batch, *x.shape[1:]), cfg, x.device)
    rows = slice(sample_offset, sample_offset + b)
    return apply_sensor_noise_from_draws(x, cfg, {k: v[rows] for k, v in draws.items()})
