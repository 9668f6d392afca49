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
    before = cuda_decoder.launches
    outs = [cuda_decoder._fused_residual_block_bf16(args[0], *prepared, args[3],
                                                    geometry=(6, 8, g, 2)),
            cuda_decoder._fused_residual_block_bf16(args[0], *prepared, args[3],
                                                    geometry=deepest),
            fused_residual_block(args[0], *prepared, args[3]),
            fused_residual_block(*args)]
    torch.cuda.synchronize()
    assert cuda_decoder.launches == before + 4
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
@pytest.mark.parametrize("shape", [(8, 192, 48), (5, 7, 12), (33, 50, 6), (70, 1, 1028),
                                   (3072, 192, 48), (1000, 193, 12)])
def test_k5_equals_scale_on_the_card(shape):
    """Whole boxes, a box smaller than the array, ragged rows and columns,
    and the large array of 3456 boxes: the copy engine's zero fill past the
    edge is never stored."""
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
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "launches"),
                                          (torch.float32, "launches_fp32")])
def test_artifact_session_launches_the_block_kernels_on_the_card(dtype, kernel, tmp_path):
    """An artifact exported on the card serves from a captured graph whose
    eight msid::fused_residual_block nodes launch K1 (bf16) or K4 (fp32),
    close to the live session on the same weights; replay equals eager."""
    need_card()
    from msid_tpu_torch.deployment.export import export_program
    from msid_tpu_torch.deployment.inference import InferenceSession

    model = flagship_like(dtype)
    path = export_program(model, tmp_path / "a", input_shape=(1, 32, 32, 13))
    before = getattr(cuda_decoder, kernel)
    session = InferenceSession(artifact_path=path, batch_size=2, image_size=32)
    assert session.compiled == "cuda_graph" and session.captured_launches == 8
    assert getattr(cuda_decoder, kernel) > before
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
    before = cuda_decoder.launches
    session = InferenceSession(model.set_compute_dtype(torch.bfloat16).cuda(), batch_size=2,
                               image_size=32)
    got = session.predict(x)
    assert session.optimized is False and session.captured_launches == 0
    assert cuda_decoder.launches == before
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
    before = cuda_decoder.launches
    session = InferenceSession(model.set_compute_dtype(torch.bfloat16).cuda(), batch_size=2,
                               image_size=64, optimize=False)
    got = session.predict(x)
    assert session.compiled == "cuda_graph" and session.captured_launches == 8
    assert cuda_decoder.launches > before
    assert got.shape == x.shape and np.isfinite(got).all()
    assert float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))) <= 2e-2
