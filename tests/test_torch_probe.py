"""The kernel probe and its two kernels (K3, K5) against the JAX package, on
the CPU.

On a CPU tensor ``fused_residual_block_v2`` and ``any_dma_scale`` are their
plain PyTorch versions, the yardsticks the Hopper kernels are held to on
the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``). Here the plain
versions are held to the TPU kernels in Pallas interpret mode, on seeded
numpy inputs given to both sides, and the probe's entry point runs every
variant at a small shape.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from torch.utils.weak import WeakIdKeyDictionary

from msid_tpu.ops.pallas_decoder import fused_residual_block_v2 as jax_v2
from msid_tpu_torch.benchmarks import kernel_probe
from msid_tpu_torch.ops import cuda_decoder, cuda_probe
from msid_tpu_torch.ops.cuda_decoder import (
    fold_batchnorm,
    fused_residual_block,
    fused_residual_block_v2,
    fused_residual_block_v2_reference,
)

torch.set_num_threads(2)


def block_inputs(shape, seed):
    """bf16-representable x, w1, w2 and a folded [4, C] affine (numpy f32)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def bf16(a):
        return np.array(jnp.asarray(a.astype(np.float32), jnp.bfloat16).astype(jnp.float32))

    x = bf16(rng.normal(0, 1, shape))
    w1 = bf16(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)))
    w2 = bf16(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)))
    folds = [fold_batchnorm(rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                            rng.normal(0, 0.1, c), rng.uniform(0.5, 2, c))
             for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]])
    return x, w1, w2, aff.astype(np.float32)


def port_args(x, w1, w2, aff):
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(w1).bfloat16(),
            torch.from_numpy(w2).bfloat16(), torch.from_numpy(aff))


@pytest.mark.parametrize("shape,row_block,col_block", [
    ((2, 16, 16, 8), 8, 8),
    ((2, 16, 16, 8), 16, 16),     # one tile: the whole image
    ((1, 24, 16, 8), 8, 16),      # not square
    ((1, 8, 24, 16), 8, 8),
])
def test_plain_v2_matches_pallas_v2(shape, row_block, col_block):
    x, w1, w2, aff = block_inputs(shape, seed=11)
    want = np.asarray(jax_v2(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16),
        jnp.asarray(w2, jnp.bfloat16), jnp.asarray(aff),
        row_block=row_block, col_block=col_block, interpret=True).astype(jnp.float32))
    got = fused_residual_block_v2(*port_args(x, w1, w2, aff),
                                  row_block=row_block, col_block=col_block)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    # Both sides round h and the output to bf16 and sum nine fp32 tap
    # products in their own order: the TPU kernels' golden tolerance.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.03, atol=0.02)


def test_plain_v2_does_not_depend_on_the_tile_and_agrees_with_v3():
    x, w1, w2, aff = block_inputs((2, 16, 12, 8), seed=12)
    args = port_args(x, w1, w2, aff)
    a = fused_residual_block_v2(*args, row_block=8, col_block=8)
    b = fused_residual_block_v2(*args, row_block=5, col_block=3)    # divides neither side
    c = fused_residual_block_v2(*args)
    assert torch.equal(a, b) and torch.equal(a, c)
    # K1's plain version sums the same products as one conv: same tolerance.
    v3 = fused_residual_block(*args).float()
    np.testing.assert_allclose(a.float().numpy(), v3.numpy(), rtol=0.03, atol=0.02)


def test_plain_v2_zeroes_h_outside_the_image():
    """With b1 large, gelu(b1) != 0 at the border of h unless h is masked:
    the plain version must match a conv with zero padding of h."""
    x, w1, w2, aff = block_inputs((1, 6, 6, 8), seed=13)
    aff[1] = 3.0
    args = port_args(x, w1, w2, aff)
    got = fused_residual_block_v2_reference(*args).float()
    want = cuda_decoder.fused_residual_block_reference(*args).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.03, atol=0.02)


@pytest.mark.parametrize("shape", [(8, 16, 8), (3, 5, 4)])
def test_plain_any_dma_matches_the_tpu_probe_kernel(shape):
    """The TPU probe's kernel is an inner function of ``main()``
    (``benchmarks/pallas_probe.py:145-163``) and cannot be imported; it is
    restated here line for line and run in interpret mode."""
    def kernel(x_any, o_ref, scratch, sem):
        cp = pltpu.make_async_copy(x_any, scratch, sem)
        cp.start()
        cp.wait()
        o_ref[...] = scratch[...] * 2.0

    xs = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    fn = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(xs.shape, xs.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM(xs.shape, xs.dtype), pltpu.SemaphoreType.DMA],
        interpret=True,
    )
    want = np.asarray(fn(jnp.asarray(xs)))
    before = cuda_probe.launches_any_dma
    got = cuda_probe.any_dma_scale(torch.from_numpy(xs))
    assert cuda_probe.launches_any_dma == before       # the plain version is no launch
    np.testing.assert_array_equal(got.numpy(), want)    # doubling is exact


@pytest.mark.parametrize("variant", ["xla", "xla_bf16", "fused", "v3", "v2", "v2:4:6", "any_dma"])
def test_probe_runs_every_variant_on_the_cpu(variant, capsys):
    counts = (cuda_decoder.launches, cuda_decoder.launches_fp32, cuda_decoder.launches_v2,
              cuda_probe.launches_any_dma)
    result = kernel_probe.main([variant, "--device", "cpu", "--shape", "2,16,12,8",
                                "--iters", "2"])
    out = capsys.readouterr().out
    assert result["variant"] == variant and result["device"] == "cpu"
    assert result["shape"] == [2, 16, 12, 8]
    if variant == "any_dma":
        assert result["correct"] is True and "any_dma: RAN, correct=True" in out
    else:
        assert f"{variant}: " in out and "TF/s effective" in out
        assert np.isfinite(result["ms"]) and result["ms"] > 0
        # the GFLOP count of the JAX probe: two convs of 2*9*C*C per pixel
        gflop = 2 * 2 * 2 * 16 * 12 * 9 * 8 * 8 / 1e9
        assert result["tflops"] == pytest.approx(gflop / result["ms"])
    if variant in ("v3", "v2", "v2:4:6"):
        assert "max|d| vs xla:" in out
        assert result["max_abs_vs_xla"] <= 0.05      # bf16 outputs of the same block
    # on the CPU every variant is a plain version: no launch is counted
    assert counts == (cuda_decoder.launches, cuda_decoder.launches_fp32,
                      cuda_decoder.launches_v2, cuda_probe.launches_any_dma)


def test_probe_inputs_are_the_jax_probes():
    """``make_inputs`` draws what ``pallas_probe.make_inputs`` draws (numpy
    seed 0, the same order and scales), rounded to bf16 the same way."""
    shape = (2, 8, 8, 8)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w1 = rng.normal(0, 0.05, (3, 3, 8, 8)).astype(np.float32)
    got = kernel_probe.make_inputs(shape, torch.device("cpu"))
    want_x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want_w1 = np.asarray(jnp.asarray(w1, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got[0].float().numpy(), want_x)
    np.testing.assert_array_equal(got[1].float().numpy(), want_w1)
    assert got[3].dtype == torch.float32 and tuple(got[3].shape) == (4, 8)


def test_probe_blocks_match_the_jax_probes():
    """``xla_block`` and ``xla_bf16_block`` against the JAX probe's functions
    of the same names, restated (the probe module reads its shape from the
    environment at import and is not importable as a library)."""
    def conv(v, w, **kw):
        return jax.lax.conv_general_dilated(
            v, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"), **kw)

    def jax_xla_block(x, w1, w2, aff):           # pallas_probe.py:57-73
        y1 = conv(x, w1, preferred_element_type=jnp.float32) * aff[0] + aff[1]
        y1 = jax.nn.gelu(y1, approximate=True).astype(x.dtype)
        y2 = conv(y1, w2, preferred_element_type=jnp.float32) * aff[2] + aff[3]
        return jax.nn.gelu(y2 + x.astype(jnp.float32), approximate=True).astype(x.dtype)

    def jax_xla_bf16_block(x, w1, w2, aff):      # pallas_probe.py:76-89
        def c(v, w, b):
            return conv(v, w.astype(v.dtype)) + b.astype(v.dtype)
        z = jax.nn.gelu(c(x, w1 * aff[0], aff[1]))
        z = c(z, w2 * aff[2], aff[3])
        return jax.nn.gelu(x + z)

    x, w1, w2, aff = block_inputs((2, 12, 12, 8), seed=14)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16),
             jnp.asarray(w2, jnp.bfloat16), jnp.asarray(aff))
    args = port_args(x, w1, w2, aff)
    for port_fn, jax_fn in ((kernel_probe.xla_block, jax_xla_block),
                            (kernel_probe.xla_bf16_block, jax_xla_bf16_block)):
        got = port_fn(*args)
        want = np.asarray(jax_fn(*jargs).astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        # bf16 outputs; the pure-bf16 form also rounds every intermediate
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.03, atol=0.03)


def _meta_block(c=48, dtype=torch.bfloat16, shape=(1, 8, 8)):
    x = torch.empty(*shape, c, dtype=dtype, device="meta")
    w = torch.empty(3, 3, c, c, dtype=dtype, device="meta")
    return x, w, w, torch.empty(4, c, device="meta")


@pytest.mark.parametrize("case,match", [
    ("dtype", "bf16"),
    ("width", "not supported"),
    ("device", "CUDA"),
    ("contiguous", "contiguous"),
    ("weights", "w1"),
    ("rank", "NHWC"),
])
def test_v2_wrapper_refuses_and_never_takes_the_plain_version_off_the_cpu(
        monkeypatch, case, match):
    def forbidden(*args):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(cuda_decoder, "fused_residual_block_v2_reference", forbidden)
    x, w1, w2, aff = _meta_block()
    if case == "dtype":
        x, w1, w2, aff = _meta_block(dtype=torch.float32)
    elif case == "width":
        x, w1, w2, aff = _meta_block(c=40)
    elif case == "contiguous":
        x = torch.empty(1, 8, 48, 8, dtype=torch.bfloat16, device="meta").transpose(2, 3)
    elif case == "weights":
        w1 = torch.empty(3, 3, 48, 24, dtype=torch.bfloat16, device="meta")
    elif case == "rank":
        x = x[0]
    before = cuda_decoder.launches_v2
    with pytest.raises(ValueError, match=match):
        fused_residual_block_v2(x, w1, w2, aff)
    assert cuda_decoder.launches_v2 == before


@pytest.mark.parametrize("c,tile", [(48, (16, 96)), (384, (16, 16)), (96, (300, 8)), (48, (0, 8))])
def test_v2_tile_that_does_not_fit_raises_and_names_one_that_does(c, tile):
    """The TPU default (16, 96) at C=48 needs more shared memory than a CTA
    has, even with K3's smallest weight ring; the refusal comes before any
    device dispatch, on the CPU too, and the tile it names fits."""
    x, w1, w2, aff = block_inputs((1, 8, 8, c), seed=1)
    with pytest.raises(ValueError, match="tile") as err:
        fused_residual_block_v2(*port_args(x, w1, w2, aff), row_block=tile[0], col_block=tile[1])
    if 1 <= tile[0] <= cuda_decoder.V2_MAX_TILE:
        default = cuda_decoder.V2_DEFAULT_TILES[c]
        assert f"({default[0]}, {default[1]}) fits" in str(err.value)
        th, tw, g, stages = cuda_decoder.v2_tile(c, 8, 8, 1, *default)
        assert cuda_decoder.bf16_smem_bytes(c, th, tw, g, stages) <= cuda_decoder.MAX_SMEM


@pytest.mark.parametrize("c", cuda_decoder.SUPPORTED_WIDTHS)
def test_v2_default_tiles_fit_a_cta(c):
    """Each width's default tile, in the smallest cluster at that width
    whose CTA holds it, with the deepest weight ring that fits: K1's layout (the
    swizzled window chunks, the ring of [C/g][64] weight tiles, h at a pitch
    of C/g + 8, the barriers)."""
    rb, cb = cuda_decoder.V2_DEFAULT_TILES[c]
    th, tw, g, stages = cuda_decoder.v2_tile(c, 24, 24, 1, rb, cb)
    assert (th, tw) == (rb, cb)
    assert g == min(k for width, k in cuda_decoder.BF16_VARIANTS if width == c
                    and cuda_decoder.bf16_smem_bytes(c, rb, cb, k, cuda_decoder.BF16_MIN_STAGES)
                    <= cuda_decoder.MAX_SMEM)
    need = cuda_decoder.bf16_smem_bytes(c, th, tw, g, stages)
    assert need <= cuda_decoder.MAX_SMEM
    assert stages == cuda_decoder.BF16_MAX_STAGES or cuda_decoder.bf16_smem_bytes(
        c, th, tw, g, stages + 1) > cuda_decoder.MAX_SMEM
    ck = cuda_decoder.v2_chunk(c)
    assert c % ck == 0 and ck in (16, 32, 64)
    chunk = ((th + 4) * (tw + 4) * ck * 2 + 1023) // 1024 * 1024
    h = ((th + 2) * (tw + 2) * (c // g + 8) * 2 + 15) // 16 * 16
    assert need == c // ck * chunk + stages * (c // g) * 128 + h + 8 * 9 + 1024


@pytest.mark.parametrize("case,match", [
    ("dtype", "float32"),
    ("rank", "rows, W, C"),
    ("row", "16 bytes"),
    ("device", "CUDA"),
    ("contiguous", "contiguous"),
])
def test_any_dma_wrapper_refusals(monkeypatch, case, match):
    def forbidden(*args):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(cuda_probe, "any_dma_scale_reference", forbidden)
    x = torch.empty(8, 16, 8, device="meta")
    if case == "dtype":
        x = x.bfloat16()
    elif case == "rank":
        x = x[0]
    elif case == "row":
        x = torch.empty(8, 3, 2, device="meta")
    elif case == "contiguous":
        x = x.transpose(0, 1)
    before = cuda_probe.launches_any_dma
    with pytest.raises(ValueError, match=match):
        cuda_probe.any_dma_scale(x)
    assert cuda_probe.launches_any_dma == before


def test_probe_refuses_unknown_variant_and_bad_shape():
    with pytest.raises(SystemExit, match="unknown probe"):
        kernel_probe.main(["v9", "--device", "cpu", "--shape", "1,8,8,8"])
    with pytest.raises(SystemExit, match="B,H,W,C"):
        kernel_probe.main(["xla", "--device", "cpu", "--shape", "8,8,8"])


RAGGED = (23, 37)        # divides by no even tile


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("c", cuda_decoder.SUPPORTED_WIDTHS)
def test_v2_picker_fits_a_cta_and_covers_a_ragged_image(c, b):
    """K3's geometry, picked (no tile named: K1's) or around a caller's
    tile, for the flagship's stage of each width and a ragged image: a
    build of csrc/resblock.cu (clusters over the output channels at C >= 192
    only), a CTA's shared memory, a ring of 2..4 stages, and tiles that
    cover the image."""
    flagship = 192 * 48 // c
    for (h, w), tile in (((flagship, flagship), (None, None)), (RAGGED, (None, None)),
                         (RAGGED, (5, 7)), ((flagship, flagship), (5, 7))):
        th, tw, g, stages = cuda_decoder.v2_tile(c, h, w, b, *tile)
        assert (c, g) in cuda_decoder.BF16_VARIANTS and (g == 1 or c >= 192)
        if tile[0] is None:
            assert (th, tw, g, stages) == cuda_decoder.bf16_tiling(c, h, w, b)
        assert cuda_decoder.BF16_MIN_STAGES <= stages <= cuda_decoder.BF16_MAX_STAGES
        assert cuda_decoder.bf16_smem_bytes(c, th, tw, g, stages) <= cuda_decoder.MAX_SMEM
        if tile[0] is not None:
            assert (th, tw) == tile
        rows, cols = -(-h // th), -(-w // tw)
        assert rows * th >= h > (rows - 1) * th and cols * tw >= w > (cols - 1) * tw
        nw, mw, nsplit = cuda_decoder.BF16_VARIANTS[(c, g)]
        assert nw * (2 if nsplit else 1) == c // g       # the warpgroups cover the CTA's N


def test_v2_prepared_weights_are_made_once_and_follow_the_tensor(monkeypatch):
    """The functional entry's K-major copies: one per weight tensor, made
    again after an in-place write or for another dtype or device, never
    handed to another tensor at a reused address, and let go with the
    tensor they were made of."""
    made = []
    prepare = cuda_decoder.prepare_bf16_weights
    monkeypatch.setattr(cuda_decoder, "prepare_bf16_weights",
                        lambda w: made.append(w.dtype) or prepare(w))
    monkeypatch.setattr(cuda_decoder, "_v2_weights", WeakIdKeyDictionary())
    w = torch.from_numpy(block_inputs((1, 4, 4, 48), seed=3)[1]).bfloat16()
    first = cuda_decoder.v2_prepared_weights(w)
    assert cuda_decoder.v2_prepared_weights(w) is first and len(made) == 1
    assert torch.equal(first, prepare(w))
    w.mul_(2)                                            # in place: a new _version
    second = cuda_decoder.v2_prepared_weights(w)
    assert len(made) == 2 and torch.equal(second, prepare(w))
    assert cuda_decoder.v2_prepared_weights(w) is second
    assert cuda_decoder.v2_prepared_weights(w.float()).dtype == torch.float32
    assert cuda_decoder.v2_prepared_weights(w.to("meta")).device.type == "meta"
    assert len(made) == 4
    # the same address, shape and version in another tensor is not a hit
    alias = w.detach()
    assert alias.data_ptr() == w.data_ptr() and alias._version == w._version
    cuda_decoder.v2_prepared_weights(alias)
    assert len(made) == 5
    trained = torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16, requires_grad=True)
    cuda_decoder.v2_prepared_weights(trained)
    kept = len(cuda_decoder._v2_weights)
    del alias, trained                       # their copies go with them
    gc.collect()
    assert len(cuda_decoder._v2_weights) == kept - 2
