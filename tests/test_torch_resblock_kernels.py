"""What surrounds the redesigned fused ResidualBlock kernels (K1 bf16 on
wgmma, K4 fp32 as 3xTF32), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: the arithmetic of K4's operand split in plain
PyTorch, which shows why three TF32 terms are needed and one is not
enough; the pure-Python pickers of tile, cluster and shared memory for
every channel width of the repo's configs; K1's K-major weight operand;
and the operands a ``ResidualBlock`` prepares once and keeps.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msid_tpu_torch.models import blocks as port_blocks
from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.ops import cuda_decoder
from msid_tpu_torch.ops.cuda_decoder import (
    BF16_MAX_STAGES,
    BF16_MIN_STAGES,
    BF16_VARIANTS,
    MAX_SMEM,
    SUPPORTED_WIDTHS,
    bf16_check_tile,
    bf16_smem_bytes,
    bf16_steps,
    bf16_tiling,
    conv3x3_split_tf32,
    fp32_candidates,
    fp32_check_tile,
    fp32_smem_bytes,
    fp32_tiling,
    fused_residual_block_reference,
    prepare_bf16_weights,
    split_tf32,
)

torch.set_num_threads(2)

# Every decoder width of the repo's configs (tiny_cpu, the flagship, capacity_2x).
CONFIG_WIDTHS = (8, 12, 24, 48, 96, 192, 384, 768)
RAGGED = (20, 36)        # an image no picked tile divides on both sides


def rel_rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def test_split_tf32_parts_are_tf32_and_sum_to_the_value():
    v = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 4096).astype(np.float32))
    big, small = split_tf32(v)
    for part in (big, small):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0   # 10 mantissa bits
    # big is v rounded to nearest: off by at most half a tf32 ulp (2^-11 relative)
    assert float(((v - big).abs() / v.abs()).max()) <= 2.0 ** -11
    # and the two parts give v back to ~2^-22 relative
    assert float(((v.double() - big.double() - small.double()).abs() / v.abs()).max()) <= 2.0 ** -21


def test_split_tf32_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between the tf32 neighbours 1 and 1 + 2^-10.
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    big, _ = split_tf32(v)
    assert big.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


def test_three_tf32_terms_match_fp64_where_one_pass_does_not():
    """K = 9 * 384, the deepest sum of the flagship: three terms are as
    good as an fp32 product (relative RMS <= 1e-6), a single TF32 pass
    misses K4's 1e-5 limit by more than an order of magnitude."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (1, 6, 6, 384)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (3, 3, 384, 16)).astype(np.float32))
    ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    three, one = conv3x3_split_tf32(x, w, terms=3), conv3x3_split_tf32(x, w, terms=1)
    assert rel_rms(three, ref) <= 1e-6
    assert rel_rms(one, ref) > 1e-5
    assert rel_rms(conv3x3_split_tf32(x, w, terms=4), ref) <= rel_rms(three, ref) * 1.5
    with pytest.raises(ValueError, match="terms"):
        conv3x3_split_tf32(x, w, terms=2)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("c", CONFIG_WIDTHS)
def test_fp32_picker_fits_and_covers_a_ragged_image(c, b):
    h, w = RAGGED
    th, tw, nt, nu, g, kc = fp32_tiling(c, h, w, b)
    fp32_check_tile(c, th, tw, nt, nu, g, kc)            # the kernel takes it
    assert fp32_smem_bytes(th, tw, nt, nu, kc) <= MAX_SMEM
    assert g * nu * 8 * nt >= c
    rows, cols = -(-h // th), -(-w // tw)                # the launch's grid, per sample
    assert rows * th >= h > (rows - 1) * th and cols * tw >= w > (cols - 1) * tw
    assert (th, tw, nt, nu, g, kc) == fp32_candidates(c, h, w, b)[0][1]


@pytest.mark.parametrize("c", CONFIG_WIDTHS)
def test_fp32_tile_that_does_not_fit_raises(c):
    _, _, nt, nu, g, kc = fp32_tiling(c, 192, 192, 16)
    assert fp32_smem_bytes(128, 128, nt, nu, kc) > MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        fp32_check_tile(c, 128, 128, nt, nu, g, kc)
    with pytest.raises(ValueError, match="no geometry"):
        fp32_check_tile(c, 8, 8, 5, nu, g, kc)           # no kernel is built for nt=5


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("c", SUPPORTED_WIDTHS)
def test_bf16_picker_fits_and_covers_a_ragged_image(c, b):
    for h, w in (RAGGED, (192 * 48 // c // 2 * 2,) * 2):
        th, tw, g, stages = bf16_tiling(c, h, w, b)
        bf16_check_tile(c, th, tw, g, stages)
        assert (c, g) in BF16_VARIANTS and c % g == 0
        assert BF16_MIN_STAGES <= stages <= BF16_MAX_STAGES
        assert bf16_smem_bytes(c, th, tw, g, stages) <= MAX_SMEM
        rows, cols = -(-h // th), -(-w // tw)
        assert rows * th >= h > (rows - 1) * th and cols * tw >= w > (cols - 1) * tw
        nw, mw, nsplit = BF16_VARIANTS[(c, g)]
        assert nw * (2 if nsplit else 1) == c // g       # the warpgroups cover the CTA's N
        for m in ((th + 2) * (tw + 2), th * tw):
            passes, share = bf16_steps(m, mw, nsplit)
            assert passes * mw >= share and share * (1 if nsplit else 2) * 64 >= m


@pytest.mark.parametrize("c", SUPPORTED_WIDTHS)
def test_bf16_tile_that_does_not_fit_raises(c):
    _, _, g, stages = bf16_tiling(c, 192, 192, 16)
    with pytest.raises(ValueError, match="shared memory"):
        bf16_check_tile(c, 64, 64, g, stages)
    with pytest.raises(ValueError, match="no geometry"):
        bf16_check_tile(c, 8, 8, 8, stages)              # no kernel for a cluster of 8
    with pytest.raises(ValueError, match="not supported"):
        bf16_tiling(c + 8, 24, 24, 1)


@pytest.mark.parametrize("c", SUPPORTED_WIDTHS)
def test_prepared_bf16_weights_are_k_major_and_padded(c):
    w = torch.from_numpy(np.random.default_rng(c).normal(0, 1, (3, 3, c, c))
                         .astype(np.float32)).bfloat16()
    k = prepare_bf16_weights(w)
    cp = -(-c // 64) * 64
    assert k.shape == (9 * c, cp) and k.dtype == torch.bfloat16 and k.is_contiguous()
    # row tap * C + cout, column cin
    assert torch.equal(k[:, :c].reshape(3, 3, c, c), w.permute(0, 1, 3, 2))
    assert not k[:, c:].any()


def randomize_block(block: ResidualBlock, seed: int) -> None:
    rng = np.random.default_rng(seed)
    c = block.conv0.weight.shape[0]
    with torch.no_grad():
        for norm in (block.norm0, block.norm1):
            norm.weight.copy_(torch.from_numpy(rng.normal(1, 0.1, c)))
            norm.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c)))
            norm.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c)))
            norm.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, c)))


def unfused(block: ResidualBlock, x: torch.Tensor) -> torch.Tensor:
    y = port_blocks.gelu(block.norm0(block.conv0(x)))
    return port_blocks.gelu(x + block.norm1(block.conv1(y)))


def test_prepared_operands_are_made_once_and_follow_their_sources(monkeypatch):
    """The folded affine and the weights are kept between forwards and made
    again after an in-place write to a weight or a running statistic."""
    folds = []
    folded = port_blocks.Norm.folded
    monkeypatch.setattr(port_blocks.Norm, "folded",
                        lambda self: folds.append(1) or folded(self))
    block = ResidualBlock(12).eval()
    randomize_block(block, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 12, 8, 8)).astype(np.float32))

    def forward_counting_folds():
        before = len(folds)
        return block(x), len(folds) - before

    with torch.no_grad():
        first, n = forward_counting_folds()
        assert n == 2                                # both norms, once
        kept = block.prepared_operands(torch.float32, x.device)
        again, n = forward_counting_folds()
        assert n == 0 and torch.equal(again, first)
        assert block.prepared_operands(torch.float32, x.device) is kept
        np.testing.assert_allclose(first.numpy(), unfused(block, x).numpy(), atol=1e-5)

        block.conv0.weight.mul_(1.5)                 # a weight, in place
        second, n = forward_counting_folds()
        assert n == 2 and not torch.allclose(second, first)
        np.testing.assert_allclose(second.numpy(), unfused(block, x).numpy(), atol=1e-5)

        block.norm1.running_var.add_(0.7)            # a running statistic, in place
        third, n = forward_counting_folds()
        assert n == 2 and not torch.allclose(third, second)
        np.testing.assert_allclose(third.numpy(), unfused(block, x).numpy(), atol=1e-5)


def test_prepared_operands_follow_dtype_state_dict_and_train_mode():
    block = ResidualBlock(8).eval()
    randomize_block(block, seed=2)
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        fp32 = block.prepared_operands(torch.float32, x.device)
        bf16 = block.prepared_operands(torch.bfloat16, x.device)
        assert fp32[0].dtype == torch.float32 and bf16[0].dtype == torch.bfloat16
        assert bf16[2].dtype == torch.float32        # the affine stays fp32
        assert bf16[0].shape == (3, 3, 8, 8)         # HWIO on the CPU
        before = block(x)
        other = ResidualBlock(8)
        randomize_block(other, seed=4)
        block.load_state_dict(other.state_dict())    # copies in place
        after = block(x)
        assert not torch.allclose(after, before)
        np.testing.assert_allclose(after.numpy(), unfused(block, x).numpy(), atol=1e-5)
    block.train()
    assert block._prepared is None                   # dropped: training rewrites the sources
    block(x)
    assert block._prepared is None                   # and train mode prepares nothing


def test_autocast_eval_block_prepares_bf16_operands_once():
    block = ResidualBlock(16).eval()
    randomize_block(block, seed=5)
    x = torch.randn(1, 16, 6, 6, generator=torch.Generator().manual_seed(6))
    seen = []
    reference = fused_residual_block_reference

    def spy(x, w1, w2, affines):
        seen.append((x.dtype, w1.dtype, w1.data_ptr()))
        return reference(x, w1, w2, affines)

    cuda_decoder.fused_residual_block_reference = spy
    try:
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            out = block(x)
            block(x)
    finally:
        cuda_decoder.fused_residual_block_reference = reference
    assert out.dtype == torch.bfloat16
    assert [s[:2] for s in seen] == [(torch.bfloat16, torch.bfloat16)] * 2
    assert seen[0][2] == seen[1][2]                  # the same cast weight both times
