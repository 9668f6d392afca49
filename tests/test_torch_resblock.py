"""The port's fused ResidualBlock (K1) against the JAX package, on the CPU.

On a CPU tensor ``fused_residual_block`` is its plain PyTorch version, so
these tests hold the plain version (the yardstick the Hopper kernel is
checked against on the card by ``chip_smoke.py``) to the TPU kernel v3 in
Pallas interpret mode and to the XLA block, and the eval-mode
``ResidualBlock`` module to the flax module. Inputs are seeded numpy arrays
given to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from msid_tpu.models.blocks import ResidualBlock as JaxResidualBlock
from msid_tpu.ops.pallas_decoder import fold_batchnorm as jax_fold_batchnorm
from msid_tpu.ops.pallas_decoder import fused_residual_block_v3
from msid_tpu_torch.models import blocks as port_blocks
from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.models.from_jax import load_residual_block
from msid_tpu_torch.ops import cuda_decoder
from msid_tpu_torch.ops.cuda_decoder import (
    fold_batchnorm,
    fused_residual_block,
    fused_residual_block_reference,
)

torch.set_num_threads(2)


def block_inputs(shape, seed):
    """bf16-representable x, w1, w2 and a folded [4, C] affine (numpy f32)."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape

    def bf16(a):
        return np.array(jnp.asarray(a.astype(np.float32), jnp.bfloat16)
                        .astype(jnp.float32))

    x = bf16(rng.normal(0, 1, shape))
    w1 = bf16(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)))
    w2 = bf16(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)))
    folds = [fold_batchnorm(rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                            rng.normal(0, 0.1, c), rng.uniform(0.5, 2, c))
             for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]])
    return x, w1, w2, aff.astype(np.float32)


def port_plain(x, w1, w2, aff):
    out = fused_residual_block(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w1).bfloat16(),
        torch.from_numpy(w2).bfloat16(), torch.from_numpy(aff))
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def xla_bf16_block(x, w1, w2, aff):
    """The XLA block on bf16 operands with fp32 accumulation, h in bf16
    (tests/test_pallas_decoder.py's v3 golden)."""
    def conv(u, k):
        return lax.conv_general_dilated(
            u, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)

    v = jnp.asarray(x, jnp.bfloat16)
    y1 = jax.nn.gelu(conv(v, jnp.asarray(w1, jnp.bfloat16)) * aff[0] + aff[1],
                     approximate=True)
    y2 = conv(y1.astype(jnp.bfloat16), jnp.asarray(w2, jnp.bfloat16)) * aff[2] + aff[3]
    return np.asarray(jax.nn.gelu(y2 + v.astype(jnp.float32), approximate=True))


@pytest.mark.parametrize("shape,row_block,im2col", [
    ((2, 16, 16, 8), 8, True),
    ((2, 16, 16, 8), 8, False),
    ((1, 8, 8, 8), 8, True),
    ((2, 24, 16, 8), 8, True),
])
def test_plain_matches_pallas_v3(shape, row_block, im2col):
    x, w1, w2, aff = block_inputs(shape, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_residual_block_v3(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16),
            jnp.asarray(w2, jnp.bfloat16), jnp.asarray(aff),
            row_block=row_block, im2col=im2col).astype(jnp.float32))
    # Both sides round the output to bf16; v3's own golden tolerance.
    np.testing.assert_allclose(port_plain(x, w1, w2, aff), want, rtol=0.03, atol=0.02)


@pytest.mark.parametrize("c,size", [(384, 24), (192, 48), (96, 96), (48, 192)])
def test_plain_matches_xla_at_flagship_widths(c, size):
    x, w1, w2, aff = block_inputs((1, size, size, c), seed=c)
    want = xla_bf16_block(x, w1, w2, aff)
    # bf16 output against the fp32 reference: one bf16 ulp plus
    # accumulation-order noise (v3's golden tolerance).
    np.testing.assert_allclose(port_plain(x, w1, w2, aff), want, rtol=0.03, atol=0.02)


def random_block_variables(c, seed):
    rng = np.random.default_rng(seed)

    def bn():
        return ({"BatchNorm_0": {"scale": rng.normal(1, 0.1, c), "bias": rng.normal(0, 0.1, c)}},
                {"BatchNorm_0": {"mean": rng.normal(0, 0.1, c), "var": rng.uniform(0.5, 2, c)}})

    (p0, s0), (p1, s1) = bn(), bn()
    params = {"Conv_0": {"kernel": rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c))},
              "Conv_1": {"kernel": rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c))},
              "Norm_0": p0, "Norm_1": p1}
    cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return cast({"params": params, "batch_stats": {"Norm_0": s0, "Norm_1": s1}})


def test_residual_block_eval_matches_flax():
    c = 16
    x = np.random.default_rng(3).normal(0, 1, (2, 12, 12, c)).astype(np.float32)
    variables = random_block_variables(c, seed=4)
    want = np.asarray(JaxResidualBlock(c).apply(variables, jnp.asarray(x), train=False))
    block = ResidualBlock(c).eval()
    load_residual_block(block, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    # fp32 both sides (the plain version keeps fp32 x in fp32).
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_residual_block_train_matches_flax():
    """Train mode: plain convs, BN on biased batch statistics, running stats
    updated with flax momentum 0.9."""
    c = 16
    x = np.random.default_rng(5).normal(0, 1, (2, 12, 12, c)).astype(np.float32)
    variables = random_block_variables(c, seed=6)
    want, updated = JaxResidualBlock(c).apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    block = ResidualBlock(c).train()
    load_residual_block(block, variables["params"], variables["batch_stats"])
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    for i, norm in enumerate((block.norm0, block.norm1)):
        stats = updated["batch_stats"][f"Norm_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(norm.running_mean.numpy(), stats["mean"], atol=1e-5)
        np.testing.assert_allclose(norm.running_var.numpy(), stats["var"], atol=1e-5)


def test_eval_block_goes_through_the_wrapper(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fused_residual_block(*args)

    monkeypatch.setattr(port_blocks, "fused_residual_block", spy)
    block = ResidualBlock(8).eval()
    x = torch.randn(1, 8, 6, 6)
    block(x)
    assert calls == [(1, 6, 6, 8)]
    block.train()
    block(x)
    assert len(calls) == 1


def test_fold_batchnorm():
    rng = np.random.default_rng(0)
    scale, bias = rng.normal(1, 0.1, 8), rng.normal(0, 0.1, 8)
    mean, var = rng.normal(0, 0.2, 8), rng.uniform(0.5, 2, 8)
    a, b = fold_batchnorm(scale, bias, mean, var)
    x = rng.normal(0, 1, (4, 8)).astype(np.float32)
    want = (x - mean) / np.sqrt(var + 1e-5) * scale + bias
    np.testing.assert_allclose(x * a + b, want, rtol=1e-5)
    ja, jb = jax_fold_batchnorm(scale, bias, mean, var)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)


def test_norm_folded_matches_fold_batchnorm():
    norm = port_blocks.Norm(8)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.normal(1, 0.1, 8)))
        norm.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 8)))
        norm.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, 8)))
    a, b = norm.folded()
    want_a, want_b = fold_batchnorm(norm.weight.detach().numpy(), norm.bias.detach().numpy(),
                                    norm.running_mean.numpy(), norm.running_var.numpy())
    np.testing.assert_allclose(a.detach().numpy(), want_a, rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), want_b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype,error,match", [
    (torch.bfloat16, ValueError, "CUDA"),
    (torch.float32, NotImplementedError, "K4"),
])
def test_wrapper_never_takes_the_plain_version_off_the_cpu(monkeypatch, dtype, error, match):
    """A tensor that is not on the CPU launches the kernel or raises; it
    never computes with the plain version."""
    def forbidden(*args):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(cuda_decoder, "fused_residual_block_reference", forbidden)
    x = torch.empty(1, 8, 8, 48, dtype=dtype, device="meta")
    w = torch.empty(3, 3, 48, 48, dtype=dtype, device="meta")
    aff = torch.empty(4, 48, device="meta")
    before = cuda_decoder.launches
    with pytest.raises(error, match=match):
        cuda_decoder.fused_residual_block(x, w, w, aff)
    assert cuda_decoder.launches == before


def test_cpu_plain_version_keeps_fp32_and_bf16_numerics():
    x, w1, w2, aff = block_inputs((1, 8, 8, 16), seed=7)
    args32 = [torch.from_numpy(a) for a in (x, w1, w2, aff)]
    out32 = fused_residual_block_reference(*args32)
    assert out32.dtype == torch.float32
    out16 = fused_residual_block_reference(
        args32[0].bfloat16(), args32[1].bfloat16(), args32[2].bfloat16(), args32[3])
    assert out16.dtype == torch.bfloat16
    # h rounded to bf16 and a bf16 output: close to, not equal to, fp32.
    diff = (out16.float() - out32).abs().max().item()
    assert 0 < diff < 0.05

