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
from msid_tpu_torch.models.restormer import LN_EPS, RestormerRestoration, bias_free_norm_plain
from msid_tpu_torch.ops import _build, cuda_decoder, cuda_probe
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


def since(before) -> dict:
    """The device kernels launched since ``before`` (a copy of
    ``_build.launched``), by entry point."""
    return dict(_build.launched - before)


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


# K4's picked cluster at each (2, 20, 20, C) of K4_CLUSTER_WIDTHS: every
# size from 3 to 8 (1, 2, 4 and 8 come with the shapes above them).
K4_CLUSTER_WIDTHS = {72: 3, 136: 5, 168: 6, 200: 7, 768: 8, 1024: 8}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 32, 48), (2, 24, 24, 384), (2, 20, 20, 12),
                                   (2, 64, 64, 8), (1, 20, 36, 24), (1, 9, 13, 10)]
                         + [(2, 20, 20, c) for c in K4_CLUSTER_WIDTHS])
def test_k4_matches_plain_on_the_card(shape):
    """Flagship and tiny widths, a ragged image, a width (10) that is no
    multiple of 4 (4-byte staging copies, channels padded to 16), and widths
    whose picked cluster is 3, 5, 6, 7 and 8 CTAs, up to 1024."""
    need_card()
    args = block_inputs(shape, seed=shape[-1])
    if shape[-1] in K4_CLUSTER_WIDTHS:
        b, h, w, c = shape
        assert cuda_decoder.fp32_tiling(c, h, w, b)[4] == K4_CLUSTER_WIDTHS[c]
    before = _build.launched.copy()
    got = fused_residual_block(*args)
    with exact_fp32(torch.float32):                  # the plain version's cuDNN convs
        want = fused_residual_block_reference(*args)
    torch.cuda.synchronize()
    assert since(before) == {"msid_resblock_fp32_forward": 1}
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


def k1_cases():
    """(C, g) for every padded width and cluster size K1 is built for: the
    padded width itself, a width 1 below it (odd: the window by plain
    loads, the output one element at a time) and one 8 below it (a
    multiple of 8: the window by TMA with zeros past C); and at the wide
    builds' streamed body, the off-grid widths 300, 500 and 700 (chunks by
    plain loads), 640 (two chunks past C skipped) and 320 and 520 (an odd
    number of window chunks by TMA, so that conv2's chunks of h start in
    the second slot)."""
    cases = [(c, g) for cp, g in sorted(cuda_decoder.BF16_VARIANTS)
             for c in sorted({cp, cp - 1, max(8, cp - 8)})]
    return cases + [(c, g) for c in (300, 320, 500, 520, 640, 700)
                    for cp, g in sorted(cuda_decoder.BF16_VARIANTS)
                    if cp == cuda_decoder.bf16_padded(c)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,g", k1_cases())
def test_k1_matches_plain_on_the_card(c, g):
    """Every (padded width, cluster size) K1 is built for, at widths on and
    off its build's width, on a ragged image with a tile that divides
    neither side, at the tile of this cluster size that takes the most
    passes over the weights (several, where one fits: for the streamed
    body, the window chunks come through the ring again in every pass), and
    with the picker's own choice."""
    need_card()
    args = [a if i == 3 else a.bfloat16()
            for i, a in enumerate(block_inputs((2, 20, 36, c), seed=c + g))]
    want = fused_residual_block_reference(*args).float()
    prepared = [cuda_decoder.prepare_bf16_weights(w) for w in args[1:3]]
    nw, mw, nsplit, body, _ = cuda_decoder.BF16_VARIANTS[(cuda_decoder.bf16_padded(c), g)]
    def passes(geo):
        return cuda_decoder.bf16_steps(cuda_decoder.bf16_regions(geo[0], geo[1], body)[0],
                                       mw, nsplit)[0]

    deepest = max((geo for _, geo in cuda_decoder.bf16_candidates(c, 20, 36, 2) if geo[2] == g),
                  key=passes)
    if body == "stream":
        assert passes(deepest) >= 2
    before = _build.launched.copy()
    outs = [cuda_decoder._fused_residual_block_bf16(args[0], *prepared, args[3],
                                                    geometry=(6, 8, g, 2)),
            cuda_decoder._fused_residual_block_bf16(args[0], *prepared, args[3],
                                                    geometry=deepest),
            fused_residual_block(args[0], *prepared, args[3]),
            fused_residual_block(*args)]
    torch.cuda.synchronize()
    assert since(before) == {"msid_resblock_forward": 4}
    for got in outs:
        assert bool(((got.float() - want).abs() <= K3_ATOL + K3_RTOL * want.abs()).all())
    assert torch.equal(outs[2], outs[3])      # prepared operands or HWIO: the same launch


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 384, 512, 768])
@pytest.mark.parametrize("b", [1, 16, 64])
def test_k1_wide_builds_match_plain_at_the_stage_shape_on_the_card(c, b):
    """The wide builds' streamed body at the 24 x 24 stage of a 768-wide
    decoder (capacity_2x's) and the picker's geometry for each batch."""
    need_card()
    args = [a if i == 3 else a.bfloat16()
            for i, a in enumerate(block_inputs((b, 24, 24, c), seed=c + b))]
    want = fused_residual_block_reference(*args).float()
    got = fused_residual_block(*args)
    torch.cuda.synchronize()
    assert bool(((got.float() - want).abs() <= K3_ATOL + K3_RTOL * want.abs()).all())


@pytest.mark.cuda
def test_bf16_eval_block_launches_k1_with_its_kept_operands_on_the_card():
    need_card()
    torch.manual_seed(0)
    block = ResidualBlock(48).eval()
    x = torch.randn(2, 48, 16, 16)
    with torch.no_grad():
        want = block(x)                            # fp32 plain version on the CPU
        block.cuda()
        before = _build.launched.copy()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = block(x.cuda())
            kept = block.prepared_operands(torch.bfloat16, torch.device("cuda", 0))
            again = block(x.cuda())
            assert block.prepared_operands(torch.bfloat16, torch.device("cuda", 0)) is kept
        assert kept[0].shape == (9 * 48, 64)       # K1's K-major operand
        block.conv1.weight.mul_(2.0)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            changed = block(x.cuda())
    assert since(before) == {"msid_resblock_forward": 3}
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
        before = _build.launched.copy()
        got = block(x.cuda()).cpu()
    assert since(before) == {"msid_resblock_fp32_forward": 1}
    assert float((got - want).abs().max()) <= K4_MAX_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 192, 48), (5, 7, 12), (33, 50, 6), (70, 1, 1028),
                                   (3072, 192, 48), (1000, 193, 12)])
def test_k5_equals_scale_on_the_card(shape):
    """Whole boxes, a box smaller than the array, ragged rows and columns,
    and the large array of 3456 boxes: the copy engine's zero fill past the
    edge is never stored."""
    need_card()
    x = torch.from_numpy(np.random.default_rng(shape[0]).normal(0, 1, shape)
                         .astype(np.float32)).cuda()
    before = _build.launched.copy()
    got = cuda_probe.any_dma_scale(x)
    torch.cuda.synchronize()
    assert since(before) == {"msid_any_dma_scale": 1}
    assert torch.equal(got, cuda_probe.any_dma_scale_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [
    ((2, 16, 16, 48), [None, (8, 8), (16, 16)]),
    ((1, 20, 36, 48), [None, (5, 7), (3, 40)]),      # ragged rows and columns
    ((2, 24, 24, 96), [None, (8, 8)]),
    ((1, 12, 20, 192), [None, (4, 8)]),
    ((2, 24, 24, 384), [None, (4, 4)]),
    ((1, 20, 20, 12), [None, (5, 7)]),                # K1's build of 16, the window by plain loads
    ((1, 12, 12, 200), [None, (4, 4)]),               # the build of 256, zeros past C
    ((1, 12, 12, 768), [None, (2, 2)]),               # the build of 768, a cluster of 8
])
def test_k3_matches_plain_and_k1_on_the_card(shape, tiles):
    need_card()
    args = [a if i == 3 else a.bfloat16() for i, a in enumerate(block_inputs(shape, seed=3))]
    want = fused_residual_block_v2_reference(*args).float()
    k1 = fused_residual_block(*args).float()
    outs = []
    for tile in tiles:
        before = _build.launched.copy()
        rb, cb = tile or (None, None)
        got = fused_residual_block_v2(*args, row_block=rb, col_block=cb)
        torch.cuda.synchronize()
        assert since(before) == {"msid_resblock_v2_forward": 1}
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
        before = _build.launched.copy()
        tree = fastpath.optimize_for_inference(model)
        outs = [fastpath.make_fast_inference_fn(model, mm)(tree, x) for mm in (True, False)]
        outs.append(fastpath.make_hybrid_inference_fn(model)(
            fastpath.optimize_for_hybrid(model), x))
        outs.append(fastpath.make_hybrid_forward(model)(None, x))
    torch.cuda.synchronize()
    assert since(before) == {}
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


@pytest.mark.cuda
def test_k5_encodes_each_map_once_on_the_card():
    """Repeated calls on one tensor encode no map after the first (x's, kept
    in the library's table); a tensor of another shape does."""
    need_card()
    x = torch.randn(8, 192, 48, device="cuda")
    cuda_probe.any_dma_scale(x)
    torch.cuda.synchronize()
    first = _build.tensor_map_encodes("any_dma")
    for _ in range(5):
        cuda_probe.any_dma_scale(x)             # out freed each time: the same address
    torch.cuda.synchronize()
    assert _build.tensor_map_encodes("any_dma") == first
    y = torch.randn(16, 192, 48, device="cuda")
    assert torch.equal(cuda_probe.any_dma_scale(y), y * 2)
    assert _build.tensor_map_encodes("any_dma") > first


@pytest.mark.cuda
def test_k1_encodes_weight_maps_once_per_operand_on_the_card():
    """The two weight maps are encoded once per prepared operand and cluster
    size and kept on the operand; x's map once per x; so a repeated launch
    encodes nothing, and its output is bit-equal to the first."""
    need_card()
    args = [a if i == 3 else a.bfloat16() for i, a in enumerate(block_inputs((2, 24, 24, 96),
                                                                            seed=4))]
    p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in args[1:3])
    defines = cuda_decoder.bf16_defines(96)
    got = fused_residual_block(args[0], p1, p2, args[3])
    torch.cuda.synchronize()
    encodes = _build.tensor_map_encodes("resblock", defines)
    assert len(p1._tensor_maps) == len(p2._tensor_maps) == 1
    for _ in range(3):
        again = fused_residual_block(args[0], p1, p2, args[3])
    torch.cuda.synchronize()
    assert _build.tensor_map_encodes("resblock", defines) == encodes
    assert torch.equal(got, again)


def flagship_like(dtype, decoder_arch="unet_skip", fill=True):
    """The flagship's layers at a tiny size (K1's widths in bf16)."""
    from msid_tpu_torch.models.restoration import SatMAERestoration

    torch.manual_seed(0)
    model = SatMAERestoration(image_size=32, patch_size=16, embed_dim=64, depth=2,
                              num_heads=4, decoder_arch=decoder_arch,
                              decoder_channels=(96, 48, 48, 48),
                              residual_output=fill, input_fill=fill).eval()
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    return model.set_compute_dtype(dtype).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tta,optimize,blocks", [
    (torch.bfloat16, 1, 1, "auto", 8), (torch.bfloat16, 16, 1, False, 8),
    (torch.float32, 1, 1, "auto", 8), (torch.float32, 16, 1, False, 8),
    (torch.bfloat16, 1, 8, "auto", 64), (torch.bfloat16, 16, 1, "hybrid", 0),
    (torch.bfloat16, 1, 1, True, 0),
])
def test_session_graph_replays_what_eager_computes_on_the_card(dtype, b, tta, optimize,
                                                               blocks):
    """A session on the card is a captured CUDA graph that replays the
    kernels of its eager forward, in order: bit-equal outputs; the block
    kernel launches captured; predict's result a copy, not the graph's
    buffer. The folded graphs run on unet_light (no fill stage)."""
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession

    folded = optimize in ("hybrid", True)
    model = flagship_like(dtype, "unet_light" if folded else "unet_skip", fill=not folded)
    session = InferenceSession(model, batch_size=b, image_size=32, tta=tta,
                               optimize="auto" if optimize == "hybrid" else optimize)
    assert session.compiled == "cuda_graph"
    assert session.captured_launches == blocks
    assert session.optimized == {"hybrid": "hybrid", True: "fastpath"}.get(optimize, False)
    x = np.random.default_rng(b).normal(0, 0.5, (b, 32, 32, 13)).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    before = session.replays
    got = session.predict(x)
    again = session.forward(xd)
    want = session.forward_eager(xd)
    torch.cuda.synchronize()
    assert session.replays == before + 2
    assert torch.equal(again, want)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    session.predict(np.zeros_like(x))             # the next replay leaves got alone
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [False, True])
def test_session_benchmark_replays_with_and_without_donation_on_the_card(donate):
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession

    session = InferenceSession(flagship_like(torch.bfloat16), batch_size=2, image_size=32,
                               donate_input=donate)
    before = session.replays
    result = session.benchmark(warmup_runs=1, benchmark_iterations=3)
    assert session.donate_input is donate and session.replays == before + 4
    assert result["p50_ms"] > 0 and result["fps"] == 1e3 / result["mean_ms"]
    assert session.benchmark(warmup_runs=0, benchmark_iterations=2,
                             pipelined=True)["p50_ms"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_session_keeps_what_its_graph_reads_on_the_card(dtype):
    """The graph reads the blocks' prepared operands (K1's or K4's) by
    address. Train mode drops the blocks' own references to them, memory of
    their sizes is then taken and filled with NaN, an eager forward
    prepares new operands, and the caller's model is written and run: every
    later predict is still bit-equal to the first."""
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = flagship_like(dtype)
    session = InferenceSession(model, batch_size=2, image_size=32)
    x = np.random.default_rng(5).normal(0, 0.5, (2, 32, 32, 13)).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    first = session.predict(x)
    blocks = [m for m in session.model.modules() if isinstance(m, ResidualBlock)]
    sizes = [t.nbytes for m in blocks for t in m.kept_operands]
    assert len(sizes) == 3 * 8
    session.model.train()
    session.model.eval()
    junk = [torch.full((n // 4,), float("nan"), device="cuda") for n in sizes for _ in range(4)]
    with torch.inference_mode():
        session.model(xd)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.5)
        model.train()
        model.eval()
        model(xd)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(session.predict(x), first)
    assert torch.equal(session.forward(xd).cpu(), torch.from_numpy(first))
    del junk


class _HostRead(torch.nn.Module):
    """A forward that reads a value to the host: it cannot be captured."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale if float(x.sum()) >= 0 else -x


@pytest.mark.cuda
def test_session_capture_failure_raises_on_the_card():
    """Last in the file: a forward with a host read fails its capture, and
    the session raises with the reason instead of serving eagerly."""
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession

    with pytest.raises(RuntimeError, match="CUDA graph"):
        InferenceSession(_HostRead(), batch_size=1, image_size=8, num_bands=2)
    torch.cuda.synchronize()
    x = torch.ones(3, device="cuda")
    assert float((x * 2).sum()) == 6.0                # the card still works


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scene_paths_agree_and_replay_their_eager_step_on_the_card(dtype):
    """A ragged uint16 scene through the three assemblies on the card: host
    and device within 1e-4, streaming and device within 1e-5; each step
    captured once with the 8 block launches and replayed once a batch; a
    replay bit-equal to the step's eager forward; in fp32 the device path
    within 1e-4 of the same restore on the CPU."""
    need_card()
    from msid_tpu_torch.deployment import sliding_window as sw

    model = flagship_like(dtype)
    scene = np.random.default_rng(5).integers(0, 10000, (80, 100, 13), dtype=np.uint16)
    kw = dict(window=32, overlap=8, model_size=32, batch_size=4)
    host_step = sw.make_scene_step(model, None, 32, 32)
    dev_step = sw.make_device_scene_step(model, None, 32, 32, 8)
    host = sw.restore_scene(None, None, scene, step=host_step, **kw)
    dev = sw.restore_scene(None, None, scene, step=dev_step, device_assembly=True, **kw)
    streamed = sw.restore_scene_streaming(None, None, scene, step=dev_step, band_origin_rows=2,
                                          output_dtype=np.float32, **kw)
    np.testing.assert_allclose(host, dev, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(streamed, dev, rtol=1e-5, atol=1e-5)
    windows = len(sw._window_origins(80, 32, 24)) * len(sw._window_origins(100, 32, 24))
    assert host_step.compiled == dev_step.compiled == "cuda_graph"
    assert host_step.captured_launches == dev_step.captured_launches == 8
    assert host_step.replays == -(-windows // 4)
    batch = torch.from_numpy(scene[None, :32, :32]).repeat(4, 1, 1, 1).cuda()
    assert torch.equal(dev_step.run(batch).clone(), dev_step._raw(batch))
    if dtype == torch.float32:
        cpu = sw.restore_scene(model.cpu(), None, scene, device_assembly=True, device="cpu",
                               **kw)
        np.testing.assert_allclose(dev, cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_restormer_is_served_and_restores_scenes_through_its_module_forward_on_the_card(dtype):
    """Restormer at its published widths on the card: a session and a device
    scene step each capture its module forward (no block kernel: the folded
    graphs refuse it; N2 at each of its 88 norms, one forward a capture),
    replay what they captured bit for bit, and in fp32 the scene is within
    1e-4 of the same restore on the CPU."""
    need_card()
    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.deployment.inference import InferenceSession

    torch.manual_seed(7)
    model = RestormerRestoration().eval().set_compute_dtype(dtype).cuda()
    session = InferenceSession(model, batch_size=2, image_size=64)
    assert session.compiled == "cuda_graph" and session.optimized is False
    assert session.captured_launches == RESTORMER_NORMS
    x = np.random.default_rng(2).normal(-1, 0.5, (2, 64, 64, 13)).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    got = session.predict(x)
    want = session.forward_eager(xd)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want.cpu().numpy())
    scene = np.random.default_rng(5).integers(500, 4000, (80, 100, 13), dtype=np.uint16)
    kw = dict(window=32, overlap=8, model_size=32, batch_size=4)
    step = sw.make_device_scene_step(model, None, 32, 32, 8)
    dev = sw.restore_scene(None, None, scene, step=step, device_assembly=True, **kw)
    assert step.compiled == "cuda_graph" and step.captured_launches == RESTORMER_NORMS
    batch = torch.from_numpy(scene[None, :32, :32]).repeat(4, 1, 1, 1).cuda()
    assert torch.equal(step.run(batch).clone(), step._raw(batch))
    if dtype == torch.float32:
        cpu = sw.restore_scene(model.cpu(), None, scene, device_assembly=True, device="cpu",
                               **kw)
        np.testing.assert_allclose(dev, cpu, rtol=1e-4, atol=1e-4)


def swinir_on_card(dtype, seed: int = 7):
    from msid_tpu_torch.models.swinir import SwinIRRestoration

    torch.manual_seed(seed)
    model = SwinIRRestoration().eval()
    with torch.no_grad():             # the release starts the tables at 0: let them count
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 2.0)
    return model.set_compute_dtype(dtype).cuda()


SWINIR_BLOCKS = 36


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swinir_is_served_and_restores_scenes_through_its_module_forward_on_the_card(dtype):
    """SwinIR at its published widths on the card: a session and a device
    scene step each capture its module forward (the folded graphs refuse
    it; no kernel of the port's own), replay what they captured bit for
    bit, and in fp32 the scene is within 1e-4 of the same restore on the
    CPU."""
    need_card()
    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = swinir_on_card(dtype)
    session = InferenceSession(model, batch_size=2, image_size=64)
    assert session.compiled == "cuda_graph" and session.optimized is False
    assert session.captured_launches == 0
    x = np.random.default_rng(2).normal(-1, 0.5, (2, 64, 64, 13)).astype(np.float32)
    got = session.predict(x)
    want = session.forward_eager(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want.cpu().numpy())
    scene = np.random.default_rng(5).integers(500, 4000, (80, 100, 13), dtype=np.uint16)
    kw = dict(window=32, overlap=8, model_size=32, batch_size=4)
    step = sw.make_device_scene_step(model, None, 32, 32, 8)
    dev = sw.restore_scene(None, None, scene, step=step, device_assembly=True, **kw)
    assert step.compiled == "cuda_graph"
    batch = torch.from_numpy(scene[None, :32, :32]).repeat(4, 1, 1, 1).cuda()
    assert torch.equal(step.run(batch).clone(), step._raw(batch))
    if dtype == torch.float32:
        cpu = sw.restore_scene(model.cpu(), None, scene, device_assembly=True, device="cpu",
                               **kw)
        np.testing.assert_allclose(dev, cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_a_swinir_artifact_is_served_by_a_captured_session_on_the_card(tmp_path):
    """A bf16 SwinIR exported on the card builds its shift mask in the
    graph from arithmetic alone, so its session captures the graph (a copy
    from the host would break the capture), replays it bit for bit, and
    serves what the live session serves on the same weights."""
    need_card()
    from msid_tpu_torch.deployment.export import export_program
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = swinir_on_card(torch.bfloat16)
    path = export_program(model, tmp_path / "a", input_shape=(1, 32, 32, 13))
    session = InferenceSession(artifact_path=path, batch_size=2, image_size=32)
    assert session.compiled == "cuda_graph"
    x = np.random.default_rng(0).normal(-1, 0.5, (2, 32, 32, 13)).astype(np.float32)
    got = session.predict(x)
    eager = session.forward_eager(torch.from_numpy(x).cuda())
    np.testing.assert_array_equal(got, eager.cpu().numpy())
    want = InferenceSession(model, batch_size=2, image_size=32).predict(x)
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 1e-3


@pytest.mark.cuda
def test_swinir_window_attention_takes_the_cudnn_back_end_on_the_card(monkeypatch):
    """At the cell's shapes (a B=8 batch of 512-px windows) each block's
    attention, unshifted (the windows as SDPA's batch, the bias broadcast
    over them) and shifted (the images as SDPA's batch, B + M broadcast
    over them), goes to cuDNN's fused attention: the dispatcher's own
    choice on the very operands of each call, and one launch of cuDNN's
    ``..._sdpa_...`` kernel a block in the device record."""
    need_card()
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile

    from msid_tpu_torch.models import swinir

    choices = []
    plain = swinir.WindowAttention._attend

    def spy(self, q, k, v, mask):
        choices.append(int(torch._fused_sdp_choice(
            q, k, v, attn_mask=mask, scale=(self.dim // self.num_heads) ** -0.5)))
        return plain(self, q, k, v, mask)

    monkeypatch.setattr(swinir.WindowAttention, "_attend", spy)
    model = swinir_on_card(torch.bfloat16)
    x = (torch.randn(8, 512, 512, 13, device="cuda") * 0.5 - 1.0).bfloat16()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    assert choices == [int(SDPBackend.CUDNN_ATTENTION)] * SWINIR_BLOCKS
    launches = sum(e.count for e in prof.key_averages() if "_sdpa_" in e.key)
    assert launches == SWINIR_BLOCKS


@pytest.mark.cuda
def test_swinir_bf16_forward_at_the_cells_size_is_within_the_cells_limit():
    """The published SwinIR in bf16 on a B=8 batch of 512-px windows of the
    benchmark's scene, on the benchmark's seeded weights, against the plain
    float32 reference (TF32 off): every window's worst 64-px block within
    the limit of the cell ``swinir.scene512.b8``."""
    need_card()
    from pathlib import Path

    from msid_tpu_torch.models.restoration import restorer_from_config
    from portbench import registry, traffic
    from portbench.kinds import worst_block_rel_rms
    from portbench.reference import scene as ref_scene
    from portbench.reference import swinir as reference
    from portbench.reference.precision import exact_fp32

    root = Path(__file__).resolve().parent.parent
    cell = registry.cell(registry.load_benchmark(root), "swinir.scene512.b8")
    config, limit = cell["config"]["config"], cell["checks"]["worst_block_rel_rms"]["limit"]
    device, seed = torch.device("cuda"), 1294967311
    scene = traffic.scenes(cell["traffic"], seed, device)[0]
    raw = torch.stack([torch.from_numpy(scene[y:y + 512, x:x + 512].astype(np.float32))
                       for y, x in ref_scene.windows_of(scene.shape, 512, 32)[:8]]).to(device)
    x = ref_scene.preprocess(raw, 512)
    state = reference.seeded_state(config, seed, device)
    model = restorer_from_config(config, dtype=torch.bfloat16, device=device).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(x.bfloat16()).float().cpu()
    del model
    ref = reference.reference_model(config, state, device).eval()
    with torch.no_grad(), exact_fp32():
        want = torch.cat([ref(x[i:i + 4]) for i in (0, 4)]).cpu()
    worst = max(worst_block_rel_rms(got[i], want[i], 64) for i in range(8))
    assert worst <= limit, worst


RESTORMER_NORMS = 88   # two bias-free LayerNorms in each of the preset's 44 blocks
with torch.device("meta"):
    # (C, H=W) of the norms of each level of a 512-px window of the preset
    N2_LEVELS = [(c, side) for c, side, _ in RestormerRestoration().norm_shapes(512)]
N2_BATCH = 8           # the scene cell's window batch


def n2_case(c: int, side: int, dtype, seed: int, batch: int = N2_BATCH, loc: float = 0.0):
    """x, channels-last ``[batch, c, side, side]`` in ``dtype`` on the card,
    each pixel's channels around a mean of its own (``loc`` plus a standard
    normal) with a spread of its own, and w in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mean = loc + torch.randn(batch, 1, side, side, device="cuda", generator=g)
    spread = 0.5 + torch.rand(batch, 1, side, side, device="cuda", generator=g)
    x = torch.randn(batch, c, side, side, device="cuda", generator=g) * spread + mean
    w = torch.rand(c, device="cuda", generator=g) + 0.5
    return x.to(dtype).contiguous(memory_format=torch.channels_last), w.to(dtype)


def n2_exact(x, w):
    """The same rows evaluated in float64 from x's and w's values."""
    y = x.double().permute(0, 2, 3, 1)
    var = y.var(dim=-1, keepdim=True, correction=0)
    return (y * torch.rsqrt(var + LN_EPS) * w.double()).permute(0, 3, 1, 2)


# x's and w's dtypes: the scene cell's bf16, the fp32 path, and bf16 x with
# fp32 w (an fp32 model under bf16 autocast, as the eval step runs it)
N2_KINDS = {"bf16": (torch.bfloat16, torch.bfloat16), "fp32": (torch.float32, torch.float32),
            "bf16_x_fp32_w": (torch.bfloat16, torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(N2_KINDS))
@pytest.mark.parametrize("c,side", sorted(set(N2_LEVELS)))
def test_n2_matches_the_composition_at_every_level(c, side, kind):
    """N2 against the composition at each width and side of a 512-px
    window's levels, B=8, one launch, channels-last out in the dtype torch
    promotes x's and w's to. fp32: the same fp32 arithmetic but for the
    variance's order of sums and rsqrt's last bits, so 1e-5 relative (1e-7
    of the largest for a product that underflows). A bf16 x: the
    composition rounds up to three times to bf16 (rsqrt, then each bf16
    product), the kernel at most once, each rounding within 2^-8 of the
    value (8 bits of precision): within 2^-6 of each other, and 2^-5 leaves
    twice that."""
    need_card()
    from msid_tpu_torch.ops import cuda_layernorm

    x_dtype, w_dtype = N2_KINDS[kind]
    x, w = n2_case(c, side, x_dtype, seed=c + side)
    w = w.to(w_dtype)
    before = _build.launched.copy()
    got = cuda_layernorm.bias_free_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert since(before) == {"msid_bias_free_norm": 1}
    want = bias_free_norm_plain(x, w)
    assert got.dtype == want.dtype == torch.promote_types(x_dtype, w_dtype)
    assert got.shape == x.shape and got.is_contiguous(memory_format=torch.channels_last)
    rel = 2.0 ** -5 if x_dtype == torch.bfloat16 else 1e-5
    err = (got.float() - want.float()).abs()
    bound = rel * want.float().abs() + 1e-7 * want.float().abs().max()
    assert bool((err <= bound).all()), float((err / want.float().abs().clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,side", [(48, 512), (384, 64)])
def test_n2_bf16_error_is_no_larger_than_the_compositions(c, side):
    """Against a float64 evaluation of the same bf16 rows, N2 (one rounding)
    is no further off than the composition (three), in RMS and at worst."""
    need_card()
    from msid_tpu_torch.ops import cuda_layernorm

    x, w = n2_case(c, side, torch.bfloat16, seed=3 * c)
    exact = n2_exact(x, w)
    kernel = (cuda_layernorm.bias_free_norm(x, w, 1e-5).double() - exact).abs()
    plain = (bias_free_norm_plain(x, w).double() - exact).abs()
    assert float(kernel.pow(2).mean()) <= float(plain.pow(2).mean())
    assert float(kernel.max()) <= float(plain.max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,side", [(48, 512), (384, 64)])
def test_n2_is_deterministic(c, side):
    """No atomics, a fixed order of shuffles: two calls give the same bits."""
    need_card()
    from msid_tpu_torch.ops import cuda_layernorm

    x, w = n2_case(c, side, torch.bfloat16, seed=c)
    assert torch.equal(cuda_layernorm.bias_free_norm(x, w, 1e-5),
                       cuda_layernorm.bias_free_norm(x, w, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [48, 384])
def test_n2_holds_rows_whose_mean_is_far_above_their_spread(c):
    """fp32 rows at a mean of 1e3 times their spread: the variance about the
    row's own mean (two passes) keeps N2 within 1e-5 of a float64
    evaluation, where E[x^2] - E[x]^2 in fp32 would lose most of it."""
    need_card()
    from msid_tpu_torch.ops import cuda_layernorm

    x, w = n2_case(c, 32, torch.float32, seed=c, loc=1e3)
    exact = n2_exact(x, w)
    got = cuda_layernorm.bias_free_norm(x, w, 1e-5).double()
    err = (got - exact).abs()
    assert bool((err <= 1e-5 * exact.abs() + 1e-7 * exact.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nchw", "width", "fp16"])
def test_n2_refuses_a_tensor_it_cannot_read_on_the_card(case):
    """A contiguous NCHW tensor, a width with no instance and an fp16 tensor
    each raise before any launch: no copy, no silent composition."""
    need_card()
    from msid_tpu_torch.ops import cuda_layernorm

    x, w = n2_case(48, 16, torch.bfloat16, seed=1)
    if case == "nchw":
        x = x.contiguous()
    elif case == "width":
        x, w = n2_case(64, 16, torch.bfloat16, seed=1)
    else:
        x, w = x.half(), w.half()
    before = _build.launched.copy()
    with pytest.raises(ValueError):
        cuda_layernorm.bias_free_norm(x, w, 1e-5)
    assert since(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("c,side", [(48, 64), (384, 16)])
def test_n2_backward_is_the_compositions_gradient(c, side):
    """The operator's backward (the closed form in float32) against autograd
    through the composition in float64, on fp32 rows around a mean of 10:
    dx and dw within 1e-5 of their largest, one N2 launch for the forward."""
    need_card()
    from msid_tpu_torch.ops import cuda_layernorm

    x, w = n2_case(c, side, torch.float32, seed=5 * c, batch=2, loc=10.0)
    dy = torch.randn(x.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(c))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = _build.launched.copy()
    y = cuda_layernorm.bias_free_norm_op(xr, wr, LN_EPS)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    assert since(before) == {"msid_bias_free_norm": 1}
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    want_dx, want_dw = torch.autograd.grad(n2_exact(x64, w64), (x64, w64), dy.double())
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert got.dtype == torch.float32
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def restormer_on_card(dtype, seed: int = 7):
    torch.manual_seed(seed)
    return RestormerRestoration().eval().set_compute_dtype(dtype).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,autocast", [(torch.bfloat16, False), (torch.float32, False),
                                            (torch.float32, True)])
def test_every_restormer_norm_reaches_n2_and_a_replay_launches_none(dtype, autocast,
                                                                    monkeypatch):
    """A forward at the published widths calls ``bias_free_norm`` 88 times
    and N2 launches 88 times (so no norm input is anything but
    channels-last: N2 raises on one), at an eager call and at a capture, in
    bf16, in fp32 and for fp32 weights under bf16 autocast (bf16 x, fp32
    w); a replay moves no count, and replays the eager output bit for bit."""
    need_card()
    from msid_tpu_torch.deployment.inference import CapturedForward
    from msid_tpu_torch.models import restormer

    model = restormer_on_card(dtype)
    calls = []
    plain = restormer.bias_free_norm
    monkeypatch.setattr(restormer, "bias_free_norm",
                        lambda x, w: calls.append(x.shape) or plain(x, w))

    def forward(t):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            return model(t)

    x = (torch.randn(2, 64, 64, 13, device="cuda") * 0.5 - 1.0).to(dtype)
    before = _build.launched.copy()
    with torch.no_grad():
        eager = forward(x)
    torch.cuda.synchronize()
    assert len(calls) == RESTORMER_NORMS
    assert since(before) == {"msid_bias_free_norm": RESTORMER_NORMS}
    with torch.no_grad():
        graph = CapturedForward(forward, x, model, warmup=1)
        assert graph.launches == RESTORMER_NORMS
        before = _build.launched.copy()
        out = graph(x).clone()
        graph(x)
        torch.cuda.synchronize()
    assert since(before) == {}
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_a_restormer_forward_under_autograd_on_the_card_runs_n2_and_its_backward():
    """With a gradient asked, every norm is still N2 (88 launches) and the
    gradient flows through the operator's backward: in fp32 the output
    matches the no-grad forward and the CPU's within 1e-4, and the input's
    gradient the CPU's (the composition under autograd) within 1e-4 in
    relative RMS."""
    need_card()
    model = restormer_on_card(torch.float32)
    x = (torch.randn(1, 32, 32, 13, device="cuda") * 0.5 - 1.0).requires_grad_()
    before = _build.launched.copy()
    with exact_fp32(torch.float32):
        out = model(x)
        out.square().mean().backward()
    torch.cuda.synchronize()
    assert since(before) == {"msid_bias_free_norm": RESTORMER_NORMS}
    with torch.no_grad():
        kernel = model(x.detach())
    cpu_model = model.cpu()
    xc = x.detach().cpu().requires_grad_()
    cpu = cpu_model(xc)
    cpu.square().mean().backward()
    np.testing.assert_allclose(out.detach().cpu().numpy(), kernel.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().cpu().numpy(), cpu.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    gap = (x.grad.cpu() - xc.grad).pow(2).mean().sqrt() / xc.grad.pow(2).mean().sqrt()
    assert float(gap) <= 1e-4


@pytest.mark.cuda
def test_a_restormer_artifact_keeps_n2_on_the_card(tmp_path):
    """A bf16 Restormer exported on the card holds one msid::bias_free_norm
    node a norm (88), and its session's captured graph launches N2 at each:
    88 at the capture, replays equal to eager and close to the live
    session on the same weights."""
    need_card()
    from msid_tpu_torch.deployment.export import MODULE_FILE, export_program
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = restormer_on_card(torch.bfloat16)
    path = export_program(model, tmp_path / "a", input_shape=(1, 32, 32, 13))
    program = torch.export.load(path / MODULE_FILE)
    nodes = [n for n in program.graph.nodes if n.target == torch.ops.msid.bias_free_norm.default]
    assert len(nodes) == RESTORMER_NORMS
    before = _build.launched.copy()
    session = InferenceSession(artifact_path=path, batch_size=2, image_size=32)
    assert session.compiled == "cuda_graph" and session.captured_launches == RESTORMER_NORMS
    assert list(since(before)) == ["msid_bias_free_norm"]
    x = np.random.default_rng(0).normal(-1, 0.5, (2, 32, 32, 13)).astype(np.float32)
    got = session.predict(x)
    eager = session.forward_eager(torch.from_numpy(x).cuda())
    np.testing.assert_array_equal(got, eager.cpu().numpy())
    want = InferenceSession(model, batch_size=2, image_size=32).predict(x)
    rms = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    assert rms <= 1e-3


@pytest.mark.cuda
def test_a_band_major_scene_restores_as_its_contiguous_copy_on_the_card():
    """The flagship (``long_skip_fill.yaml``) in bf16 through one captured
    device step: a band-major 1000x1111x13 uint16 scene, uploaded as it lies
    in memory and laid out on the card, restores to the bytes of its
    pixel-major copy."""
    need_card()
    from pathlib import Path

    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.utils.config import load_config

    cfg = load_config(Path(__file__).resolve().parent.parent
                      / "configs" / "experiments" / "long_skip_fill.yaml")
    torch.manual_seed(0)
    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16).eval()
    step = sw.make_device_scene_step(model, None, 64, 192, 16)
    del model
    bsq = np.random.default_rng(8).integers(100, 4500, (13, 1000, 1111), dtype=np.uint16)
    view = bsq.transpose(1, 2, 0)
    kw = dict(window=64, overlap=16, model_size=192, batch_size=64, step=step,
              device_assembly=True)
    got = sw.restore_scene(None, None, view, **kw)
    want = sw.restore_scene(None, None, np.ascontiguousarray(view), **kw)
    assert step.compiled == "cuda_graph" and step.captured_launches == 8
    assert got.shape == (1000, 1111, 13) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_a_host_step_result_outlives_the_next_replay_on_the_card():
    """The host assembly keeps one batch in flight: a result copied out
    before the next replay must not change when that replay overwrites the
    graph's output."""
    need_card()
    from msid_tpu_torch.deployment import sliding_window as sw

    step = sw.make_scene_step(flagship_like(torch.bfloat16), None, 32, 32)
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(0, 10000, (4, 32, 32, 13)).astype(np.float32) for _ in range(2))
    first = step(a)
    second = step(b)
    got_a, got_b = sw.device_get(*first), sw.device_get(*second)
    assert np.array_equal(got_a, step._raw(torch.from_numpy(a).cuda()).cpu().numpy())
    assert np.array_equal(got_b, step._raw(torch.from_numpy(b).cuda()).cpu().numpy())
    assert not np.array_equal(got_a, got_b)


@pytest.mark.cuda
def test_device_cache_gathers_uint16_tiles_on_the_card():
    need_card()
    from msid_tpu_torch.data.pipeline import BatchLoader, DeviceCachedLoader

    tiles = [np.random.default_rng(i).integers(0, 10000, (8, 8, 13)).astype(np.float32)
             for i in range(10)]
    cached = DeviceCachedLoader(tiles, batch_size=4, shuffle=True, drop_last=False,
                                pad_last=True, seed=2, storage_dtype="auto")
    assert cached._tiles.is_cuda and cached._tiles.dtype == torch.uint16
    host = BatchLoader(tiles, batch_size=4, shuffle=True, drop_last=False, pad_last=True,
                       seed=2)
    for (cb, cn), (hb, hn) in zip(cached, host):
        assert cb.is_cuda and cn == hn
        np.testing.assert_array_equal(cb.float().cpu().numpy(), hb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "msid_resblock_forward"),
                                          (torch.float32, "msid_resblock_fp32_forward")])
def test_artifact_session_launches_the_block_kernels_on_the_card(dtype, kernel, tmp_path):
    """An artifact exported on the card serves from a captured graph whose
    eight msid::fused_residual_block nodes launch K1 (bf16) or K4 (fp32),
    close to the live session on the same weights; replay equals eager."""
    need_card()
    from msid_tpu_torch.deployment.export import export_program
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = flagship_like(dtype)
    path = export_program(model, tmp_path / "a", input_shape=(1, 32, 32, 13))
    before = _build.launched.copy()
    session = InferenceSession(artifact_path=path, batch_size=2, image_size=32)
    assert session.compiled == "cuda_graph" and session.captured_launches == 8
    assert list(since(before)) == [kernel]
    x = np.random.default_rng(0).normal(0, 0.5, (2, 32, 32, 13)).astype(np.float32)
    got = session.predict(x)
    eager = session.forward_eager(torch.from_numpy(x).cuda())
    np.testing.assert_array_equal(got, eager.cpu().numpy())
    want = InferenceSession(model, batch_size=2, image_size=32).predict(x)
    rms = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    assert rms <= (1e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_artifact_is_fp32_and_keeps_its_device_on_the_card(tmp_path):
    """An fp32 artifact agrees with the CPU forward with cuDNN's TF32 left
    on (torch's default); one exported on the CPU refuses the card."""
    need_card()
    from msid_tpu_torch.deployment.export import export_program, load_exported

    model = flagship_like(torch.float32).cpu()
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (2, 32, 32, 13))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x).numpy()
    cpu_path = export_program(model, tmp_path / "cpu", input_shape=(1, 32, 32, 13))
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        load_exported(cpu_path, "cuda")
    path = export_program(model.cuda(), tmp_path / "cuda", input_shape=(1, 32, 32, 13))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        got = load_exported(path)(x).cpu().numpy()
        assert torch.backends.cudnn.allow_tf32
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 1e-4


@pytest.mark.cuda
def test_vgg_perceptual_loss_on_the_card_matches_the_cpu():
    need_card()
    from msid_tpu_torch.training.perceptual import init_vgg16_params, vgg_perceptual_per_sample

    rng = np.random.default_rng(2)
    p, t = (torch.from_numpy(rng.uniform(-2, 2, (2, 32, 32, 13)).astype(np.float32))
            for _ in range(2))
    want = vgg_perceptual_per_sample(init_vgg16_params(0), p, t)
    with exact_fp32(torch.float32):
        got = vgg_perceptual_per_sample(init_vgg16_params(0, "cuda"), p.cuda(), t.cuda())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_with_a_sample_offset_draws_the_rows_of_the_whole_batch_on_the_card(dtype):
    need_card()
    from msid_tpu_torch.ops.cuda_noise import (
        apply_sensor_noise_kernel,
        apply_sensor_noise_kernel_reference,
    )
    from msid_tpu_torch.ops.noise import NoiseConfig

    cfg = NoiseConfig(enable_striping=True, stripe_prob=0.5)
    x = (torch.rand(6, 24, 20, 13, device="cuda") * 4 - 2).to(dtype)
    whole, masks = apply_sensor_noise_kernel(3, x, cfg, return_masks=True)
    rows, row_masks = apply_sensor_noise_kernel(3, x[2:5].contiguous(), cfg,
                                                return_masks=True, sample_offset=2)
    assert torch.equal(rows, whole[2:5]) and torch.equal(row_masks, masks[2:5])
    plain = apply_sensor_noise_kernel_reference(3, x[2:5], cfg, sample_offset=2)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7 * 3 + 1e-6
    assert float((rows.float() - plain.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_mesh_session_replicas_serve_their_halves_on_the_card():
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.parallel import make_mesh

    model = flagship_like(torch.bfloat16)
    x = np.random.default_rng(4).normal(0, 0.5, (4, 32, 32, 13)).astype(np.float32)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    session = InferenceSession(model, batch_size=4, image_size=32, mesh=mesh)
    half = InferenceSession(model, batch_size=2, image_size=32)
    got = session.predict(x)
    assert session.compiled == "cuda_graph"
    assert session.captured_launches == 2 * half.captured_launches == 16
    assert np.array_equal(got[:2], half.predict(x[:2]))
    assert np.array_equal(got[2:], half.predict(x[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_mesh_session_benchmark_replays_every_replica_on_the_card(pipelined):
    """Two replicas on one card: ``benchmark`` returns the reference's keys
    at the whole batch, and each timed call replays both replicas."""
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.parallel import make_mesh

    session = InferenceSession(flagship_like(torch.bfloat16), batch_size=4, image_size=32,
                               mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    before = [r.replays for r in session.replicas]
    result = session.benchmark(warmup_runs=2, benchmark_iterations=5, pipelined=pipelined)
    assert [r.replays - n for r, n in zip(session.replicas, before)] == [7, 7]
    assert result["batch_size"] == 4 and result["iterations"] == 5
    assert result["mean_ms"] > 0 and (result["p50_ms"] is None) == pipelined
    assert result["images_per_sec"] == pytest.approx(4e3 / result["mean_ms"])


@pytest.mark.cuda
def test_artifact_session_captures_a_graph_per_new_batch_on_the_card(tmp_path):
    """A B=1 artifact session serves a batch of 3 from a second captured
    graph (never eagerly), close to a live B=3 session; ``captured_launches``
    stays B=1's and a static artifact refuses the batch."""
    need_card()
    from msid_tpu_torch.deployment.export import export_program
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = flagship_like(torch.bfloat16)
    session = InferenceSession(artifact_path=export_program(
        model, tmp_path / "a", input_shape=(1, 32, 32, 13)), batch_size=1, image_size=32)
    x = np.random.default_rng(5).normal(0, 0.5, (3, 32, 32, 13)).astype(np.float32)
    got = session.predict(x)
    assert sorted(session.graphs) == [1, 3] and session.captured_launches == 8
    assert session.graphs[3].launches == 8 and session.graphs[3].replays == 1
    again = session.predict(x)
    assert session.graphs[3].replays == 2 and np.array_equal(got, again)
    want = InferenceSession(model, batch_size=3, image_size=32).predict(x)
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 1e-3
    static = InferenceSession(artifact_path=export_program(
        model, tmp_path / "s", input_shape=(1, 32, 32, 13), dynamic_batch=False),
        batch_size=1, image_size=32)
    with pytest.raises(ValueError, match="expected same constant"):
        static.predict(x)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["unet", "attention"])
def test_new_decoders_in_bf16_on_the_card_match_the_cpu(arch):
    """The ``unet`` and ``attention`` decoders (cuDNN convs, no fused block)
    served in bf16 on the card against fp32 on the CPU."""
    need_card()
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = flagship_like(torch.float32, decoder_arch=arch).cpu()
    x = np.random.default_rng(6).normal(0, 0.5, (2, 32, 32, 13)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    before = _build.launched.copy()
    session = InferenceSession(model.set_compute_dtype(torch.bfloat16).cuda(), batch_size=2,
                               image_size=32)
    got = session.predict(x)
    assert session.optimized is False and session.captured_launches == 0
    assert since(before) == {}
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 2e-2


@pytest.mark.cuda
def test_capacity_2x_bf16_session_launches_k1_and_matches_the_cpu():
    """``capacity_2x.yaml``'s decoder (768/384/192/96) at full width, the
    ViT at depth 2 and a 64^2 image, served by a captured bf16 session of
    the module's forward: 8 K1 launches captured, within relative RMS 2e-2
    of fp32 on the CPU."""
    need_card()
    from pathlib import Path

    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.utils.config import load_config

    cfg = load_config(Path(__file__).resolve().parent.parent
                      / "configs" / "experiments" / "capacity_2x.yaml")
    cfg["model"]["encoder"]["depth"] = 2
    cfg["data"]["image_size"] = 64
    torch.manual_seed(0)
    model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    x = np.random.default_rng(7).normal(0, 0.5, (2, 64, 64, 13)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    before = _build.launched.copy()
    session = InferenceSession(model.set_compute_dtype(torch.bfloat16).cuda(), batch_size=2,
                               image_size=64, optimize=False)
    got = session.predict(x)
    assert session.compiled == "cuda_graph" and session.captured_launches == 8
    assert since(before)["msid_resblock_forward"] > 0
    assert got.shape == x.shape and np.isfinite(got).all()
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 2e-2


# N1, train-mode BatchNorm (ops/cuda_norm.py, csrc/batchnorm.cu): every
# (C, side) a Norm trains at in the flagship (InputPyramid 32 at 192..24,
# SkipDecoder 384/192/96/48 and the head) and capacity_2x (768/384/192/96),
# at B=64.
N1_STAGES = [(32, 192), (32, 96), (32, 48), (32, 24), (384, 24), (192, 48), (96, 96),
             (48, 192), (768, 24), (384, 48), (192, 96), (96, 192)]


def n1_case(c, side, layout, dtype, seed, batch=64):
    """A seeded train-mode Norm and x (a mean and scale of its own per
    channel) and dy on the card, channels-last ("rows") or NCHW ("planes")."""
    from msid_tpu_torch.models.blocks import Norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    norm = Norm(c).cuda().train()
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, device="cuda", generator=g) + 0.5)
        norm.bias.copy_(torch.rand(c, device="cuda", generator=g) - 0.5)
        norm.running_var.uniform_(0.5, 1.5, generator=g)
    shape = (batch, c, side, side)
    loc = torch.randn(c, 1, 1, device="cuda", generator=g)
    x = torch.randn(shape, device="cuda", generator=g) * (1 + torch.rand(c, 1, 1, device="cuda",
                                                                         generator=g)) + loc
    dy = torch.randn(shape, device="cuda", generator=g)
    memory = torch.channels_last if layout == "rows" else torch.contiguous_format
    x, dy = (t.to(dtype).contiguous(memory_format=memory) for t in (x, dy))
    return norm, x, dy


def n1_step(norm, x, dy):
    """y, dx, dw, db and the running statistics after one train-mode step."""
    import copy

    norm = copy.deepcopy(norm)
    xr = x.clone().requires_grad_()
    y = norm(xr)
    y.backward(dy)
    torch.cuda.synchronize()
    return [y.detach(), xr.grad, norm.weight.grad, norm.bias.grad, norm.running_mean,
            norm.running_var]


def n1_close(got, want, dtype):
    """bf16: one fp32 value rounded on both sides, an element one ulp apart
    (2 ** -8 of it) or a cancellation near zero (1e-4 of the largest);
    fp32, and the fp32 gradients and statistics: sums in another order."""
    got, want = got.float(), want.float()
    bound = (2.0 ** -7 * want.abs() + 1e-4 * want.abs().max() if dtype == torch.bfloat16
             else 1e-4 * want.abs() + 1e-5 * want.abs().max())
    err = (got - want).abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,side,layout,dtype",
                         [(c, s, "rows", torch.bfloat16) for c, s in N1_STAGES]
                         + [(96, 96, "rows", torch.float32), (768, 24, "rows", torch.float32)])
def test_n1_matches_the_composition_at_every_stage(monkeypatch, c, side, layout, dtype):
    """The kernel set against autograd of ``Norm``'s fp32 composition on the
    card (``serves`` refused for it): y, dx, dw, db, the running mean and
    the biased running variance; six launches, the channels-last layout kept."""
    need_card()
    from msid_tpu_torch.ops import cuda_norm

    norm, x, dy = n1_case(c, side, layout, dtype, seed=c + side)
    assert cuda_norm.serves(x)
    before = _build.launched.copy()
    got = n1_step(norm, x, dy)
    assert since(before) == {"msid_bn_forward": 3, "msid_bn_backward": 3}
    with monkeypatch.context() as m:
        m.setattr(cuda_norm, "serves", lambda x: False)
        want = n1_step(norm, x, dy)
    assert got[0].stride() == got[1].stride() == x.stride()
    for i, (g, w) in enumerate(zip(got, want)):
        n1_close(g, w, dtype if i < 2 else torch.float32)


@pytest.mark.cuda
def test_an_nchw_tensor_raises_on_the_card():
    """No norm of the decoders sees an NCHW tensor; one that did would be
    refused aloud (no kernel launch, no copy, no silent composition)."""
    need_card()
    norm, x, dy = n1_case(48, 24, "planes", torch.bfloat16, seed=5, batch=4)
    before = _build.launched.copy()
    with pytest.raises(ValueError, match="not channels-last"):
        n1_step(norm, x, dy)
    assert since(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("c,side", [(48, 192), (384, 24), (768, 24)])
def test_n1_is_deterministic(c, side):
    """No atomics: two calls on the same input give the same bits."""
    need_card()
    norm, x, dy = n1_case(c, side, "rows", torch.bfloat16, seed=c)
    first, second = n1_step(norm, x, dy), n1_step(norm, x, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_eval_mode_launches_no_n1_kernel():
    """Eval-mode Norm stays ``x * a + b`` (the scene cells' path); train
    mode makes one call of the library forward (three kernels) and one
    backward (three more)."""
    need_card()
    norm, x, dy = n1_case(96, 48, "rows", torch.bfloat16, seed=1, batch=4)
    before = _build.launched.copy()
    with torch.no_grad():
        norm.eval()(x)
    torch.cuda.synchronize()
    assert since(before) == {}
    xr = x.clone().requires_grad_()
    y = norm.train()(xr)
    assert since(before) == {"msid_bn_forward": 3}
    y.backward(dy)
    assert since(before) == {"msid_bn_forward": 3, "msid_bn_backward": 3}


# The train step replayed as CUDA graphs (training/train_state.py,
# StepGraphs) against the same step run eagerly, two models seeded alike: a
# tiny flagship (unet_skip with fill and BatchNorm on N1, checkpointed ViT
# blocks, bf16 autocast, K2, AdamW, EMA).
GRAPH_STEPS = 5
GRAPH_NAN_STEP = 3          # its tiles are made non-finite: a skipped step


def graph_trainer(accum_steps=1):
    """A seeded tiny flagship on the card, its train state and its step."""
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer
    from msid_tpu_torch.training.schedules import cosine_warm_restarts
    from msid_tpu_torch.training.train_state import TrainState, make_train_step

    torch.manual_seed(0)
    model = SatMAERestoration(image_size=32, patch_size=16, embed_dim=64, depth=2,
                              num_heads=4, decoder_arch="unet_skip",
                              decoder_channels=(96, 48, 48, 48), residual_output=True,
                              input_fill=True, gradient_checkpointing=True)
    with torch.no_grad():                            # a head that is not zero
        for p in model.decoder.parameters():
            p.add_(0.01 * torch.randn_like(p))
    model.cuda()
    optimizer = build_optimizer(model, cosine_warm_restarts(1e-3, 4, 2, 1e-5),
                                gradient_clip=0.5, freeze_layers=(0,))
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, LossConfig(mse_weight=1.0, ssim_weight=0.1), NoiseConfig(),
                           accum_steps=accum_steps, image_size=32, ema_decay=0.9,
                           compute_dtype=torch.bfloat16)
    return model, state, step


def graph_tiles(i, b=8):
    tiles = np.random.default_rng(i).uniform(500, 9500, (b, 16, 16, 13)).astype(np.float32)
    if i == GRAPH_NAN_STEP:
        tiles[1] = np.nan
    return tiles


def graph_run(monkeypatch, accum_steps, eager, steps=GRAPH_STEPS):
    """Each step's metrics (read at once) and LRs, the state after, and the
    N1 and K2 launches counted over the run."""
    from msid_tpu_torch.training import train_state

    with monkeypatch.context() as m:
        if eager:
            m.setattr(train_state, "CAPTURE_AFTER", 10 ** 9)
        model, state, step = graph_trainer(accum_steps)
        groups = state.optimizer.adamw.param_groups
        before = _build.launched.copy()
        rows = []
        for i in range(1, steps + 1):
            state, metrics = step(state, graph_tiles(i), 100 + i)
            row = {k: float(metrics[k]) for k in ("loss", "mse", "grad_norm")}
            row.update(skipped=metrics["skipped"], step=state.step, nan_skips=state.nan_skips,
                       lr=None if metrics["skipped"] else [float(g["lr"]) for g in groups])
            rows.append(row)
        torch.cuda.synchronize()
    return rows, model, state, step, since(before)


def graph_state_close(a, b):
    """Parameters, BN statistics, AdamW moments and counts, and the EMA of
    two train states within N1's bf16 tolerance."""
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        n1_close(x, y, torch.bfloat16)
    for name in a.ema:
        n1_close(a.ema[name], b.ema[name], torch.bfloat16)
    sa, sb = a.optimizer.adamw.state, b.optimizer.adamw.state
    for pa, pb in zip(a.optimizer.params, b.optimizer.params):
        assert set(sa.get(pa, {})) == set(sb.get(pb, {}))
        for key in sa.get(pa, {}):
            n1_close(sa[pa][key], sb[pb][key], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("accum_steps", [1, 2])
def test_a_replayed_train_step_is_the_eager_step(monkeypatch, accum_steps):
    """Five steps, the third skipped: step 1 runs eagerly, step 2 captures
    the graphs and replays them, steps 3-5 replay. Per step the loss, mse
    and grad norm agree with the eager run within N1's bf16 tolerance, and
    the update count, skips, skip flags and each update's LRs exactly; so do
    the state after the run. N1 counts at the eager step and the capture
    only, K2 in every step."""
    need_card()
    got, _, graphed, step, launches = graph_run(monkeypatch, accum_steps, eager=False)
    want, _, eager, eager_step, eager_launches = graph_run(monkeypatch, accum_steps, eager=True)
    assert eager_step.graphs == {}
    (graphs,) = step.graphs.values()
    assert graphs.replays == GRAPH_STEPS - 1 and graphs.launches > 0
    for i, (g, w) in enumerate(zip(got, want), start=1):
        for key in ("skipped", "step", "nan_skips", "lr"):
            assert g[key] == w[key], (i, key, g[key], w[key])
        if i == GRAPH_NAN_STEP:
            assert g["skipped"] == 1 and not np.isfinite(g["loss"])
            continue
        for key in ("loss", "mse", "grad_norm"):
            n1_close(torch.tensor(g[key]), torch.tensor(w[key]), torch.bfloat16)
    assert graphed.step == GRAPH_STEPS - 1 and graphed.nan_skips == 1
    graph_state_close(graphed, eager)
    assert launches["msid_noise_forward"] == eager_launches["msid_noise_forward"] == GRAPH_STEPS
    # a capture records one micro-batch's forward and backward
    for entry in ("msid_bn_forward", "msid_bn_backward"):
        assert (launches[entry] * GRAPH_STEPS * accum_steps
                == eager_launches[entry] * (accum_steps + 1))
    assert graphs.launches * accum_steps == sum(eager_launches.values()) // GRAPH_STEPS - 1


@pytest.mark.cuda
def test_held_losses_of_replayed_steps_are_their_own(monkeypatch):
    """The harness's pattern: the loss tensors of steps 1-3 (eager, capture,
    replay), held and read after step 3, are three different values, each
    the eager run's."""
    need_card()
    from msid_tpu_torch.training import train_state

    held = {}
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(train_state, "CAPTURE_AFTER", 10 ** 9)
            _, state, step = graph_trainer()
            losses = []
            for i in (1, 2, 4):                       # three finite batches
                state, metrics = step(state, graph_tiles(i), 100 + i)
                losses.append(metrics["loss"])
            held[eager] = [float(v) for v in losses]
            assert len(step.graphs) == (0 if eager else 1)
    assert len(set(held[False])) == 3
    n1_close(torch.tensor(held[False]), torch.tensor(held[True]), torch.bfloat16)


@pytest.mark.cuda
def test_a_loaded_state_drops_the_graphs_and_steps_as_a_fresh_one(monkeypatch):
    """``TrainState.load_state_dict`` after a capture replaces the AdamW
    state and the EMA shadow the graphs captured: the next step captures
    anew, and it and the one after match a fresh eager state loaded alike."""
    need_card()
    import copy

    from msid_tpu_torch.training import train_state

    _, state, step = graph_trainer()
    state, _ = step(state, graph_tiles(1), 101)
    saved = copy.deepcopy(state.state_dict())
    for i in (2, 4):
        state, _ = step(state, graph_tiles(i), 100 + i)
    (first,) = step.graphs.values()
    state.load_state_dict(copy.deepcopy(saved))      # keeps the tensors it is given
    got = []
    for i in (5, 6):
        state, metrics = step(state, graph_tiles(i), 100 + i)
        got.append(float(metrics["loss"]))
    (second,) = step.graphs.values()
    assert second is not first and second.replays == 2 and second.holds(state)
    with monkeypatch.context() as m:
        m.setattr(train_state, "CAPTURE_AFTER", 10 ** 9)
        _, fresh, eager_step = graph_trainer()
        fresh.load_state_dict(copy.deepcopy(saved))
        want = []
        for i in (5, 6):
            fresh, metrics = eager_step(fresh, graph_tiles(i), 100 + i)
            want.append(float(metrics["loss"]))
    assert state.step == fresh.step == 3
    n1_close(torch.tensor(got), torch.tensor(want), torch.bfloat16)
    graph_state_close(state, fresh)
