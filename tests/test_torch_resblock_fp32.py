"""The port's fp32 fused ResidualBlock (K4) against the JAX package, on the CPU.

On a CPU tensor ``fused_residual_block`` is its plain PyTorch version, which
keeps fp32 x in fp32 end to end; these tests hold it to the TPU kernel v1
(``fused_residual_block``) in Pallas interpret mode at the golden shapes of
``tests/test_pallas_decoder.py`` and to the fp32 XLA block at the widths of
the repo's configs. The kernel itself runs only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``); here the wrapper's
routing, its refusals and its tile choice are checked.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from msid_tpu.ops.pallas_decoder import fold_batchnorm
from msid_tpu.ops.pallas_decoder import fused_residual_block as jax_fused_residual_block
from msid_tpu_torch.models import blocks as port_blocks
from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.ops import _build, cuda_decoder
from msid_tpu_torch.ops.cuda_decoder import (
    FP32_KCS,
    FP32_MAX_CLUSTER,
    FP32_MT,
    FP32_UNITS,
    MAX_SMEM,
    fp32_channel_block,
    fp32_cluster,
    fp32_smem_bytes,
    fp32_steps,
    fp32_tiling,
    fused_residual_block,
    fused_residual_block_reference,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# Every decoder width of the repo's configs (tiny_cpu, the flagship, capacity_2x).
CONFIG_WIDTHS = (8, 12, 24, 48, 96, 192, 384, 768)
GOLDEN_ATOL = 1e-5       # v1's own golden tolerance against the fp32 XLA block


def block_inputs(shape, seed, w_std=None):
    """fp32 x, w1, w2 (HWIO) and a folded [4, C] affine, as numpy arrays."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    std = w_std or 1 / np.sqrt(9 * c)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w1 = rng.normal(0, std, (3, 3, c, c)).astype(np.float32)
    w2 = rng.normal(0, std, (3, 3, c, c)).astype(np.float32)
    folds = [fold_batchnorm(rng.normal(1, 0.1, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.uniform(0.5, 2, c).astype(np.float32)) for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]])
    return x, w1, w2, aff.astype(np.float32)


def port_plain(x, w1, w2, aff):
    out = fused_residual_block(*(torch.from_numpy(a) for a in (x, w1, w2, aff)))
    assert out.dtype == torch.float32
    return out.numpy()


def xla_fp32_block(x, w1, w2, aff):
    def conv(u, k):
        return lax.conv_general_dilated(u, k, (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        precision=lax.Precision.HIGHEST)

    y = jax.nn.gelu(conv(jnp.asarray(x), w1) * aff[0] + aff[1], approximate=True)
    y = conv(y, w2) * aff[2] + aff[3]
    return np.asarray(jax.nn.gelu(y + x, approximate=True))


@pytest.mark.parametrize("shape,row_block", [
    ((2, 16, 16, 8), 8),      # multi-tile rows
    ((1, 8, 8, 8), 8),        # single tile
    ((2, 24, 16, 8), 8),      # 3 row tiles
])
def test_plain_matches_pallas_v1(shape, row_block):
    x, w1, w2, aff = block_inputs(shape, seed=1, w_std=0.2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_residual_block(
            jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(aff),
            row_block=row_block, col_block=8))
    np.testing.assert_allclose(port_plain(x, w1, w2, aff), want, atol=GOLDEN_ATOL)


@pytest.mark.parametrize("c", [8, 12, 24, 48])
def test_plain_matches_xla_fp32_at_config_widths(c):
    x, w1, w2, aff = block_inputs((1, 12, 12, c), seed=c)
    np.testing.assert_allclose(port_plain(x, w1, w2, aff), xla_fp32_block(x, w1, w2, aff),
                               atol=GOLDEN_ATOL)


def test_fp32_eval_block_takes_the_plain_version_on_the_cpu(monkeypatch):
    """An fp32 eval ``ResidualBlock`` with BatchNorm goes through the fused
    wrapper with fp32 x and weights, also with autocast off, and the
    wrapper computes a CPU tensor with the plain version."""
    seen = []

    def spy(x, w1, w2, affines):
        seen.append((x.dtype, w1.dtype, w2.dtype, affines.dtype))
        return fused_residual_block_reference(x, w1, w2, affines)

    monkeypatch.setattr(cuda_decoder, "fused_residual_block_reference", spy)
    block = ResidualBlock(12).eval()
    x = torch.randn(2, 12, 8, 8)
    with torch.no_grad():
        out = block(x)
        with torch.autocast("cpu", enabled=False):
            again = block(x)
    assert seen == [(torch.float32,) * 4] * 2
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert torch.equal(out, again)
    assert cuda_decoder.launches_fp32 == 0


def test_fp32_eval_block_matches_the_unfused_block():
    """The folded fp32 path equals the block's own convs and BNs in eval."""
    block = ResidualBlock(24).eval()
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for norm in (block.norm0, block.norm1):
            norm.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, 24)))
            norm.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 24)))
        x = torch.randn(1, 24, 10, 10)
        fused = block(x)
        y = port_blocks.gelu(block.norm0(block.conv0(x)))
        plain = port_blocks.gelu(x + block.norm1(block.conv1(y)))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=GOLDEN_ATOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_only_bf16_and_fp32_reach_a_kernel(dtype):
    x = torch.empty(1, 8, 8, 48, dtype=dtype, device="meta")
    w = torch.empty(3, 3, 48, 48, dtype=dtype, device="meta")
    with pytest.raises(NotImplementedError, match="fp32 \\(K4\\)"):
        fused_residual_block(x, w, w, torch.empty(4, 48, device="meta"))


def test_a_failed_build_raises_and_never_falls_back(monkeypatch):
    """On the CUDA path, a build or load that fails raises; the plain
    version is not computed and no launch is counted."""
    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    def forbidden(*args):
        raise AssertionError("plain version called on the CUDA path")

    monkeypatch.setattr(_build, "load_library", failed_build)
    monkeypatch.setattr(cuda_decoder, "fused_residual_block_reference", forbidden)
    x = torch.empty(1, 16, 16, 12, device="meta")
    w = torch.empty(3, 3, 12, 12, device="meta")
    before = cuda_decoder.launches_fp32
    with pytest.raises(RuntimeError, match="resblock_fp32.cu"):
        cuda_decoder._fused_residual_block_fp32(x, w, w, torch.empty(4, 12, device="meta"))
    assert cuda_decoder.launches_fp32 == before


def test_config_widths_are_the_repos():
    widths = set()
    for path in (ROOT / "configs").rglob("*.yaml"):
        channels = (((yaml.safe_load(path.read_text()) or {}).get("model") or {})
                    .get("decoder") or {}).get("channels")
        widths.update(channels or ())
    assert widths and widths <= set(CONFIG_WIDTHS)


@pytest.mark.parametrize("c", CONFIG_WIDTHS)
def test_fp32_tiling_fits_every_config_width(c):
    nt = fp32_channel_block(c)
    assert nt in (1, 2, 3, 4, 6)
    units = -(-c // (8 * nt))
    assert 8 * nt * units - c < 8 * nt              # no unit is all padding
    for size in (8, 24, 64, 192):
        for b in (1, 16, 64):
            th, tw, got_nt, nu, g, kc = fp32_tiling(c, size, size, b)
            assert got_nt == nt and th >= 2 and tw >= 2
            assert (g, nu) in fp32_cluster(c, nt)
            assert nu in FP32_UNITS and 1 <= g <= FP32_MAX_CLUSTER
            # the cluster's CTAs cover C, and none is left without a channel
            assert g * nu * 8 * nt >= c > (g - 1) * nu * 8 * nt
            assert kc in FP32_KCS and (nu * 8 * nt) % kc == 0
            for m in ((th + 2) * (tw + 2), th * tw):
                passes, per = fp32_steps(m, nu)
                assert 1 <= per <= FP32_MT and passes * per * (8 // nu) * 16 >= m
            assert fp32_smem_bytes(th, tw, nt, nu, kc) <= MAX_SMEM
