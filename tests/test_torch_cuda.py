"""The port's hand-written kernels on the card (tests marked ``cuda``).

These need an NVIDIA GPU and ``nvcc``: a CUDA kernel has no CPU mode. Each
test decides inside itself whether there is a card and skips without one.
The file imports only torch, numpy and the port, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.models.restoration import exact_fp32
from msid_tpu_torch.ops import cuda_decoder, cuda_probe
from msid_tpu_torch.ops.cuda_decoder import (
    fold_batchnorm,
    fused_residual_block,
    fused_residual_block_reference,
    fused_residual_block_v2,
    fused_residual_block_v2_reference,
)

K4_MAX_ABS = 1e-4      # fp32 against fp32, sums in another order over K = 9C
K4_MAX_REL_RMS = 1e-5
K3_RTOL, K3_ATOL = 0.03, 0.02   # the TPU kernels' golden tolerance in bf16


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels are CUDA C++ with no CPU mode")


def block_inputs(shape, seed):
    """fp32 x, w1, w2 (HWIO) and a folded [4, C] affine, on the card."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    w1, w2 = (rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)).astype(np.float32)
              for _ in range(2))
    folds = [fold_batchnorm(rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                            rng.normal(0, 0.1, c), rng.uniform(0.5, 2, c)) for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]]).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, w1, w2, aff)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 32, 48), (2, 24, 24, 384), (2, 20, 20, 12),
                                   (2, 64, 64, 8), (1, 20, 36, 24), (1, 9, 13, 10)])
def test_k4_matches_plain_on_the_card(shape):
    """Flagship and tiny widths, a ragged image, and a width (10) that is
    no multiple of 4 (4-byte staging copies, channels padded to 16)."""
    need_card()
    args = block_inputs(shape, seed=shape[-1])
    before = cuda_decoder.launches_fp32
    got = fused_residual_block(*args)
    with exact_fp32(torch.float32):                  # the plain version's cuDNN convs
        want = fused_residual_block_reference(*args)
    torch.cuda.synchronize()
    assert cuda_decoder.launches_fp32 == before + 1
    assert float((got - want).abs().max()) <= K4_MAX_ABS
    assert float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= K4_MAX_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("c,geometries", [
    (24, [(4, 8, 3, 1, 1, 8), (10, 6, 3, 2, 1, 8), (6, 6, 3, 4, 1, 8)]),
    (96, [(8, 12, 6, 1, 2, 16), (8, 12, 6, 2, 1, 8), (5, 7, 6, 2, 1, 16)]),
    (384, [(6, 12, 6, 4, 2, 8), (6, 12, 6, 1, 8, 16), (4, 6, 6, 2, 4, 16)]),
])
def test_k4_geometry_does_not_change_the_result_beyond_rounding(c, geometries):
    """Tile, channel units per CTA, cluster size and staging depth only
    change which CTA computes a value, and the order of its fp32 sums."""
    need_card()
    args = block_inputs((1, 20, 36, c), seed=c)
    with exact_fp32(torch.float32):
        want = fused_residual_block_reference(*args)
    for geometry in geometries:
        got = cuda_decoder._fused_residual_block_fp32(*args, geometry=geometry)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= K4_MAX_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("c,g", sorted(cuda_decoder.BF16_VARIANTS))
def test_k1_matches_plain_on_the_card(c, g):
    """Every (width, cluster size) K1 is built for, on a ragged image with
    a tile that divides neither side, and with the picker's own choice."""
    need_card()
    args = [a if i == 3 else a.bfloat16()
            for i, a in enumerate(block_inputs((2, 20, 36, c), seed=c + g))]
    want = fused_residual_block_reference(*args).float()
    prepared = [cuda_decoder.prepare_bf16_weights(w) for w in args[1:3]]
    before = cuda_decoder.launches
    outs = [cuda_decoder._fused_residual_block_bf16(args[0], *prepared, args[3],
                                                    geometry=(6, 8, g, 2)),
            fused_residual_block(args[0], *prepared, args[3]),
            fused_residual_block(*args)]
    torch.cuda.synchronize()
    assert cuda_decoder.launches == before + 3
    for got in outs:
        assert bool(((got.float() - want).abs() <= K3_ATOL + K3_RTOL * want.abs()).all())
    assert torch.equal(outs[1], outs[2])      # prepared operands or HWIO: the same launch


@pytest.mark.cuda
def test_bf16_eval_block_launches_k1_with_its_kept_operands_on_the_card():
    need_card()
    torch.manual_seed(0)
    block = ResidualBlock(48).eval()
    x = torch.randn(2, 48, 16, 16)
    with torch.no_grad():
        want = block(x)                            # fp32 plain version on the CPU
        block.cuda()
        before = cuda_decoder.launches
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = block(x.cuda())
            kept = block.prepared_operands(torch.bfloat16, torch.device("cuda", 0))
            again = block(x.cuda())
            assert block.prepared_operands(torch.bfloat16, torch.device("cuda", 0)) is kept
        assert kept[0].shape == (9 * 48, 64)       # K1's K-major operand
        block.conv1.weight.mul_(2.0)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            changed = block(x.cuda())
    assert cuda_decoder.launches == before + 3
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert not torch.equal(changed, got)
    assert float((got.float().cpu() - want).abs().max()) <= 0.1


@pytest.mark.cuda
def test_fp32_eval_block_launches_k4_on_the_card():
    need_card()
    torch.manual_seed(0)
    block = ResidualBlock(24).eval()
    x = torch.randn(2, 24, 16, 16)
    with torch.no_grad():
        want = block(x)                            # the plain version on the CPU
        block.cuda()
        before = cuda_decoder.launches, cuda_decoder.launches_fp32
        got = block(x.cuda()).cpu()
    assert (cuda_decoder.launches, cuda_decoder.launches_fp32) == (before[0], before[1] + 1)
    assert float((got - want).abs().max()) <= K4_MAX_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 192, 48), (5, 7, 12), (33, 50, 6), (70, 1, 1028)])
def test_k5_equals_scale_on_the_card(shape):
    """Whole boxes, a box smaller than the array, and ragged rows and
    columns: the copy engine's zero fill past the edge is never stored."""
    need_card()
    x = torch.from_numpy(np.random.default_rng(shape[0]).normal(0, 1, shape)
                         .astype(np.float32)).cuda()
    before = cuda_probe.launches_any_dma
    got = cuda_probe.any_dma_scale(x)
    torch.cuda.synchronize()
    assert cuda_probe.launches_any_dma == before + 1
    assert torch.equal(got, cuda_probe.any_dma_scale_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [
    ((2, 16, 16, 48), [None, (8, 8), (16, 16)]),
    ((1, 20, 36, 48), [None, (5, 7), (3, 40)]),      # ragged rows and columns
    ((2, 24, 24, 96), [None, (8, 8)]),
    ((1, 12, 20, 192), [None, (4, 8)]),
    ((2, 24, 24, 384), [None, (4, 4)]),
])
def test_k3_matches_plain_and_k1_on_the_card(shape, tiles):
    need_card()
    args = [a if i == 3 else a.bfloat16() for i, a in enumerate(block_inputs(shape, seed=3))]
    want = fused_residual_block_v2_reference(*args).float()
    k1 = fused_residual_block(*args).float()
    outs = []
    for tile in tiles:
        before = cuda_decoder.launches_v2, cuda_decoder.launches
        rb, cb = tile or (None, None)
        got = fused_residual_block_v2(*args, row_block=rb, col_block=cb)
        torch.cuda.synchronize()
        assert (cuda_decoder.launches_v2, cuda_decoder.launches) == (before[0] + 1, before[1])
        outs.append(got)
        for ref in (want, k1):
            assert bool(((got.float() - ref).abs() <= K3_ATOL + K3_RTOL * ref.abs()).all())
    # the tile only changes which CTA computes a pixel, not its arithmetic
    for other in outs[1:]:
        assert torch.equal(outs[0], other)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["unet_light", "unet_skip"])
def test_folded_graphs_match_apply_and_launch_no_block_kernel_on_the_card(arch):
    """fp32 (each graph turns TF32 off itself): the fastpath and hybrid
    graphs against the module's forward (which launches K4), with every
    fused-block counter still."""
    need_card()
    from msid_tpu_torch.deployment import fastpath
    from msid_tpu_torch.models.restoration import SatMAERestoration

    torch.manual_seed(0)
    model = SatMAERestoration(image_size=32, patch_size=16, embed_dim=64, depth=2,
                              num_heads=4, decoder_channels=(16, 16, 8, 8),
                              decoder_arch=arch).cuda().eval()
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    x = torch.randn(2, 32, 32, 13, device="cuda")
    with torch.no_grad():
        want = model(x)
        before = (cuda_decoder.launches, cuda_decoder.launches_fp32, cuda_decoder.launches_v2)
        tree = fastpath.optimize_for_inference(model)
        outs = [fastpath.make_fast_inference_fn(model, mm)(tree, x) for mm in (True, False)]
        outs.append(fastpath.make_hybrid_inference_fn(model)(
            fastpath.optimize_for_hybrid(model), x))
        outs.append(fastpath.make_hybrid_forward(model)(None, x))
    torch.cuda.synchronize()
    assert before == (cuda_decoder.launches, cuda_decoder.launches_fp32,
                      cuda_decoder.launches_v2)
    for got in outs:
        assert float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= 1e-4


@pytest.mark.cuda
def test_fp32_session_is_fp32_with_the_flags_at_torch_defaults_on_the_card():
    """An fp32 InferenceSession turns TF32 off around its forward: with
    cuDNN's TF32 left on (torch's default) it still agrees with the CPU."""
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration

    torch.manual_seed(0)
    model = SatMAERestoration(image_size=32, patch_size=16, embed_dim=64, depth=2,
                              num_heads=4, decoder_channels=(16, 16, 8, 8)).eval()
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 13)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        got = InferenceSession(model.cuda(), batch_size=2, image_size=32).predict(x)
        assert torch.backends.cudnn.allow_tf32
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 1e-4
