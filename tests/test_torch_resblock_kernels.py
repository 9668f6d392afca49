"""What surrounds the redesigned fused ResidualBlock kernels (K1 bf16 on
wgmma, K4 fp32 as 3xTF32), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: the arithmetic of K4's operand split in plain
PyTorch, which shows why three TF32 terms are needed and one is not
enough; the pure-Python pickers of tile, cluster and shared memory for
every channel width from 8 to 768 and every width of the repo's configs;
K1's K-major weight operand, padded to its build's width; and the
operands a ``ResidualBlock`` prepares once and keeps.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msid_tpu_torch.models import blocks as port_blocks
from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.ops import cuda_decoder
from msid_tpu_torch.ops.cuda_decoder import (
    BF16_BUILDS,
    BF16_MAX_STAGES,
    BF16_MAX_WIDTH,
    BF16_MIN_STAGES,
    BF16_MIN_WIDTH,
    BF16_VARIANTS,
    MAX_SMEM,
    SUPPORTED_WIDTHS,
    bf16_check_tile,
    bf16_padded,
    bf16_smem_bytes,
    bf16_steps,
    bf16_tiling,
    fp32_candidates,
    fp32_channel_block,
    fp32_cluster,
    fp32_check_tile,
    fp32_smem_bytes,
    fp32_tiling,
    fused_residual_block_reference,
    prepare_bf16_weights,
)
from msid_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"

# Every decoder width of the repo's configs (tiny_cpu, the flagship, capacity_2x).
CONFIG_WIDTHS = (8, 12, 24, 48, 96, 192, 384, 768)
RAGGED = (20, 36)        # an image no picked tile divides on both sides


def rel_rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's operand split, in plain PyTorch: ``big = tf32(v)`` (10 mantissa
    bits, round to nearest with ties away from zero, by integer arithmetic
    on the fp32 bits as the kernel does it) and ``small = tf32(v - big)``,
    both fp32 tensors whose low 13 bits are clear. ``v - big`` is exact in
    fp32, so ``v = big + small`` up to ~2^-22 |v|."""
    def tf32(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    big = tf32(v.float())
    return big, tf32(v.float() - big)


def conv3x3_split_tf32(x: torch.Tensor, w: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """The 3x3 'same' conv of NHWC x with HWIO w as K4's tensor cores see
    it: the sum of ``small_x * big_w + big_x * small_w + big_x * big_w``
    (``terms=3``), of ``big_x * big_w`` alone (``terms=1``, a single TF32
    pass, which K4 does not use) or with ``small_x * small_w`` too
    (``terms=4``). Products and sums are taken in float64, so the result
    shows the error of the split alone. Returns NHWC float64."""
    if terms not in (1, 3, 4):
        raise ValueError(f"terms must be 1, 3 or 4, got {terms}")
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)

    def conv(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return F.conv2d(u.double().permute(0, 3, 1, 2), k.double().permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    pairs = {1: [(xb, wb)], 3: [(xs, wb), (xb, ws), (xb, wb)],
             4: [(xs, ws), (xs, wb), (xb, ws), (xb, wb)]}[terms]
    out = conv(*pairs[0])
    for u, k in pairs[1:]:
        out = out + conv(u, k)
    return out


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
@pytest.mark.parametrize("c", CONFIG_WIDTHS)
def test_bf16_picker_fits_and_covers_a_ragged_image(c, b):
    for h, w in (RAGGED, (192 * 48 // c // 2 * 2,) * 2):
        th, tw, g, stages = bf16_tiling(c, h, w, b)
        bf16_check_tile(c, th, tw, g, stages)
        cp = bf16_padded(c)
        assert (cp, g) in BF16_VARIANTS and cp % g == 0 and cp >= c
        assert BF16_MIN_STAGES <= stages <= BF16_MAX_STAGES
        rows, cols = -(-h // th), -(-w // tw)
        assert rows * th >= h > (rows - 1) * th and cols * tw >= w > (cols - 1) * tw
        nw, mw, nsplit, body, taps = BF16_VARIANTS[(cp, g)]
        assert bf16_smem_bytes(c, th, tw, g, stages, body, taps) <= MAX_SMEM
        assert body == ("stream" if cp >= 256 else "window")
        assert taps in ((1, 3) if body == "stream" else (0,))
        assert nw * (2 if nsplit else 1) == cp // g      # the warpgroups cover the CTA's N
        assert mw in (2, 4)              # three tiles a pass went wrong on the card
        for m in cuda_decoder.bf16_regions(th, tw, body):
            passes, share = bf16_steps(m, mw, nsplit)
            assert passes * mw >= share and share * (1 if nsplit else 2) * 64 >= m


@pytest.mark.parametrize("c", CONFIG_WIDTHS)
def test_bf16_tile_that_does_not_fit_raises(c):
    _, _, g, stages = bf16_tiling(c, 192, 192, 16)
    with pytest.raises(ValueError, match="shared memory"):
        bf16_check_tile(c, 64, 64, g, stages)
    with pytest.raises(ValueError, match="no geometry"):
        bf16_check_tile(c, 8, 8, 3, stages)              # no kernel for a cluster of 3
    for outside in (BF16_MIN_WIDTH - 1, BF16_MAX_WIDTH + 1):
        with pytest.raises(ValueError, match="not supported"):
            bf16_tiling(outside, 24, 24, 1)


@pytest.mark.parametrize("c", CONFIG_WIDTHS)
def test_prepared_bf16_weights_are_k_major_and_padded(c):
    """K1's operand at the padded width CP of C's build: [9 * CP, KP] with
    KP = CP rounded up to 64, row tap * CP + cout, column cin, zeros in
    every row and column past C."""
    w = torch.from_numpy(np.random.default_rng(c).normal(0, 1, (3, 3, c, c))
                         .astype(np.float32)).bfloat16()
    k = prepare_bf16_weights(w)
    cp = bf16_padded(c)
    kp = -(-cp // 64) * 64
    assert cp in BF16_BUILDS and cp >= c
    assert k.shape == (9 * cp, kp) and k.dtype == torch.bfloat16 and k.is_contiguous()
    taps = k.reshape(3, 3, cp, kp)
    assert torch.equal(taps[:, :, :c, :c], w.permute(0, 1, 3, 2))
    assert not taps[:, :, c:].any() and not taps[:, :, :, c:].any()


@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_every_width_gets_a_geometry_that_fits(kernel, b):
    """Every C from 8 to 768: the picker's geometry is one the kernel takes,
    fits a CTA's shared memory in the body its build compiles for that
    cluster (K1: the streamed window from 256 up, the resident one below)
    and covers a ragged image; K4's cluster is one whose occupancy is
    known."""
    h, w = RAGGED
    for c in SUPPORTED_WIDTHS:
        rows, cols = None, None
        if kernel == "k1":
            th, tw, g, stages = bf16_tiling(c, h, w, b)
            bf16_check_tile(c, th, tw, g, stages)
            cp = bf16_padded(c)
            body, taps = BF16_VARIANTS[(cp, g)][3:]
            assert body == ("stream" if cp >= 256 else "window"), c
            assert bf16_smem_bytes(c, th, tw, g, stages, body, taps) <= MAX_SMEM
            assert cp >= c
        else:
            th, tw, nt, nu, g, kc = fp32_tiling(c, h, w, b)
            fp32_check_tile(c, th, tw, nt, nu, g, kc)
            assert fp32_smem_bytes(th, tw, nt, nu, kc) <= MAX_SMEM
            assert g * nu * 8 * nt >= c and g in cuda_decoder.FP32_ACTIVE_CLUSTERS
        rows, cols = -(-h // th), -(-w // tw)
        assert rows * th >= h > (rows - 1) * th and cols * tw >= w > (cols - 1) * tw, c


HEADER = Path(__file__).resolve().parent.parent / "msid_tpu_torch" / "csrc" / "hopper_common.cuh"
WIDE_BUILDS = (256, 384, 512, 768)


def header_constant(name: str) -> int:
    found = re.search(rf"constexpr\s+(?:int|uint32_t)\s+{name}\s*=\s*(\d+)",
                      HEADER.read_text())
    assert found, name
    return int(found.group(1))


@pytest.mark.parametrize("cp", WIDE_BUILDS)
def test_streamed_smem_matches_the_header_layout(cp):
    """The streamed body's shared memory as resblock_stream_cta lays it out
    (constants read from csrc/hopper_common.cuh): kWindowSlots slots of
    TH + 4 rows at a pitch of TW + 4 rounded up to 8 pixels of kBK channels,
    each slot a whole number of 1024-byte swizzle periods; the weight ring,
    the variant's taps (1 or 3) tiles of N = CP / g rows of 128 bytes a
    stage; h at a pitch of N + 8; window
    and weight barriers; 1024 bytes of alignment slack. The picked geometry
    at every stage shape and batch fits, and the resident window would not
    hold C = 768's."""
    slots, stages_max, bk = (header_constant(k) for k in ("kWindowSlots", "kMaxStages", "kBK"))
    assert (slots, stages_max, bk) == (cuda_decoder.STREAM_SLOTS, BF16_MAX_STAGES, 64)
    clusters = [g for width, g in BF16_VARIANTS if width == cp]
    assert clusters and all(BF16_VARIANTS[(cp, g)][3] == "stream" for g in clusters)
    for g in clusters:
        n = cp // g
        taps = BF16_VARIANTS[(cp, g)][4]
        assert taps in (1, 3)
        for th, tw in ((2, 2), (4, 12), (6, 8), (12, 12), (8, 24), (24, 12), (13, 7)):
            pitch = (tw + 4 + 7) // 8 * 8
            slot = (th + 4) * pitch * bk * 2
            assert slot % 1024 == 0
            for stages in range(BF16_MIN_STAGES, BF16_MAX_STAGES + 1):
                h = ((th + 2) * (tw + 2) * (n + 8) * 2 + 15) // 16 * 16
                want = (slots * slot + stages * taps * n * 128 + h
                        + 8 * (2 * slots + 2 * stages_max) + 1024)
                assert bf16_smem_bytes(cp, th, tw, g, stages, "stream", taps) == want
    for s in (24, 48):
        for b in (1, 16, 64):
            th, tw, g, stages = bf16_tiling(cp, s, s, b)
            assert bf16_smem_bytes(cp, th, tw, g, stages, *BF16_VARIANTS[(cp, g)][3:]) <= MAX_SMEM
    th, tw, g, stages = bf16_tiling(768, 24, 24, 16)
    assert bf16_smem_bytes(768, th, tw, g, stages, "window") > MAX_SMEM


@pytest.mark.parametrize("cp", WIDE_BUILDS)
def test_streamed_tile_that_does_not_fit_raises(cp):
    """``bf16_check_tile`` holds a wide build's geometry to the streamed
    body's layout: a tile whose window slots, ring and h exceed a CTA raises
    ``ValueError`` naming the body; a 12 x 12 tile that the streamed body
    holds and the resident window does not passes for K1 and raises for K3;
    a ring of one stage raises."""
    least = BF16_MIN_STAGES
    g = max(k for width, k in BF16_VARIANTS if width == cp)
    for tile in ((32, 64), (30, 30)):
        assert bf16_smem_bytes(cp, *tile, g, least, *BF16_VARIANTS[(cp, g)][3:]) > MAX_SMEM
        with pytest.raises(ValueError, match=r"stream body\) needs"):
            bf16_check_tile(cp, *tile, g, least)
    bf16_check_tile(cp, 12, 12, g, least)
    if bf16_smem_bytes(cp, 12, 12, g, least, "window") > MAX_SMEM:
        with pytest.raises(ValueError, match=r"window body\) needs"):
            bf16_check_tile(cp, 12, 12, g, least, "k3")
    with pytest.raises(ValueError, match="no geometry"):
        bf16_check_tile(cp, 12, 12, g, least - 1)
    with pytest.raises(ValueError, match="no geometry"):
        bf16_check_tile(cp, 12, 12, 3, least)


def test_pickers_raise_value_error_outside_their_widths():
    """K1 takes 8..768 and raises ``ValueError`` naming the width outside
    them; K4 takes wider widths (1024) and raises ``ValueError``, never a
    ``KeyError``, at one it cannot take."""
    for c in (0, 7, 769, 1024):
        with pytest.raises(ValueError, match=f"channel width {c} not supported"):
            bf16_tiling(c, 24, 24, 1)
        with pytest.raises(ValueError, match="not supported"):
            bf16_padded(c)
    th, tw, nt, nu, g, kc = fp32_tiling(1024, 24, 24, 16)
    fp32_check_tile(1024, th, tw, nt, nu, g, kc)
    widest = 8 * max(cuda_decoder.FP32_UNITS) * 8 * 4      # 8 CTAs x 8 units x 32
    fp32_tiling(widest, 8, 8, 1)
    assert fp32_cluster(widest + 1, fp32_channel_block(widest + 1)) == []
    with pytest.raises(ValueError, match="does not fit"):
        fp32_tiling(widest + 1, 8, 8, 1)


def test_every_config_decoder_width_is_in_both_kernels_domains():
    """Each decoder width of every config under configs/ is one K1 and K4
    take: the bf16 and the fp32 eval block run on the card at all of them."""
    widths = set()
    for path in sorted(CONFIGS.rglob("*.yaml")):
        cfg = load_config(path)
        if "model" not in cfg:
            continue
        widths.update(cfg["model"].get("decoder", {}).get("channels", (384, 192, 96, 48)))
    assert {8, 12, 24, 48, 96, 192, 384, 768} <= widths
    for c in sorted(widths):
        assert c in SUPPORTED_WIDTHS
        bf16_tiling(c, 24, 24, 16)
        fp32_tiling(c, 24, 24, 16)
        assert c in CONFIG_WIDTHS


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


def test_weight_maps_are_encoded_once_per_operand_and_cluster(monkeypatch):
    """K1's and K3's weight maps: encoded on first use per (operand address,
    cluster size), kept on the operand, so a prepared operand the block
    keeps is encoded once, and a new operand (new weights) again."""
    from msid_tpu_torch.ops import _build

    encoded = []

    def encode(ptr, c, g, buf):
        encoded.append((ptr, c, g))
        buf.raw = bytes([g]) * cuda_decoder.TENSOR_MAP_BYTES
        return 0

    monkeypatch.setattr(_build, "bind", lambda name, entry, types, restype=None,
                        defines=(): encode)
    w = torch.zeros(3, 3, 96, 96, dtype=torch.bfloat16)
    wk = cuda_decoder.prepare_bf16_weights(w)
    first = cuda_decoder.weight_map(wk, 1)
    assert cuda_decoder.weight_map(wk, 1) is first
    assert encoded == [(wk.data_ptr(), 96, 1)] and first.raw[0] == 1
    assert cuda_decoder.weight_map(wk, 2).raw[0] == 2 and len(encoded) == 2
    again = cuda_decoder.prepare_bf16_weights(w)          # a new operand
    cuda_decoder.weight_map(again, 1)
    assert len(encoded) == 3 and len(wk._tensor_maps) == 2


def test_a_copied_block_prepares_its_own_operands():
    """A deep copy (what a session keeps of its model) or a pickled block
    carries no prepared operands: it makes its own from its own weights,
    bit-equal to the original's forward, and the original keeps its own
    (``kept_operands``, what a captured graph reads)."""
    import copy
    import pickle

    block = ResidualBlock(8).eval()
    randomize_block(block, seed=7)
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want = block(x)
        kept = block.kept_operands
        assert kept is block.prepared_operands(torch.float32, x.device)
        for other in (copy.deepcopy(block), pickle.loads(pickle.dumps(block))):
            assert other.kept_operands is None
            assert torch.equal(other(x), want)
            assert other.kept_operands is not None
            assert other.kept_operands[0].data_ptr() != kept[0].data_ptr()
    assert block.kept_operands is kept
    block.train()
    assert block.kept_operands is None


@pytest.mark.parametrize("c", [12, 768, 1024])
def test_block_prepares_k_major_operands_at_every_k1_width(c):
    """An eval block makes K1's K-major operands for a bf16 x on a card at
    every width K1 takes (on the block's own device, so it runs here), and
    HWIO weights beyond them (the fused block then raises there)."""
    block = ResidualBlock(c).eval()
    w1, w2, affines = block._operands(torch.bfloat16, torch.device("cuda"))
    assert affines.shape == (4, c) and affines.dtype == torch.float32
    for w, conv in ((w1, block.conv0), (w2, block.conv1)):
        hwio = conv.weight.detach().bfloat16().permute(2, 3, 1, 0)
        if c in SUPPORTED_WIDTHS:
            cp = bf16_padded(c)
            assert w.shape == (9 * cp, -(-cp // 64) * 64) and w.is_contiguous()
            assert torch.equal(w, prepare_bf16_weights(hwio))
        else:
            assert w.shape == (3, 3, c, c) and torch.equal(w, hwio)
