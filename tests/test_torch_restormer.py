"""Restormer (``models/restormer.py``) on the CPU, against the benchmark's
plain reference (``portbench/reference/restormer.py``) on its seeded
weights, at a small size: dim 8, blocks (1, 1, 1, 2), one refinement block,
heads (1, 2, 4, 8), 13 bands, 32 px, B=2; the published widths from the
YAML on the meta device; the normal path (the factory, scenes, sessions,
the folded graphs' refusals, the spans); the LayerNorm's plain form on the
CPU, what its kernel N2 refuses, its operator's fake and backward, and the
norm shapes a forward runs; the counts of
``portbench/roofline_restormer.py`` and the readers of its three metrics."""

from __future__ import annotations

import ast
import copy
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msid_tpu_torch.deployment import fastpath
from msid_tpu_torch.deployment.export import export_program
from msid_tpu_torch.deployment.inference import InferenceSession, resolve_graph
from msid_tpu_torch.deployment.sliding_window import make_device_scene_step, restore_scene
from msid_tpu_torch.models import restormer
from msid_tpu_torch.models.restoration import (
    SatMAERestoration,
    count_parameters,
    restorer_from_config,
)
from msid_tpu_torch.models.restormer import RestormerRestoration
from msid_tpu_torch.ops import cuda_layernorm
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.setup_helpers import create_model_from_config
from portbench import registry, roofline_restormer, weights
from portbench.reference import grouped
from portbench.reference import restormer as reference
from portbench.trace import Trace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "experiments" / "restormer_s2.yaml"
CPU = torch.device("cpu")
SEED = 2 ** 40 + 23

# fp32 on both sides, the same products in another order and layout: ~1e-6
# relative (0.4e-6 measured). 1e-5 leaves an order of margin.
FORWARD_RTOL = 1e-5
# bf16 against the fp32 reference: the residual stream, every conv and
# both attention products round to 8 mantissa bits (~4e-3 a rounding) over
# 9 blocks and the convs between them: 0.0098 measured; 0.03 leaves three
# times that, and each fault below lands 9x above it (0.28-0.80 measured).
BF16_RTOL = 0.03


def tiny_config() -> dict:
    cfg = load_config(YAML)
    cfg["model"]["encoder"].update(dim=8, num_blocks=[1, 1, 1, 2], heads=[1, 2, 4, 8])
    cfg["model"]["decoder"]["num_refinement_blocks"] = 1
    return cfg


def pair(cfg: dict, dtype=torch.float32):
    """The port's Restormer and the reference holding the same seeded state."""
    state = reference.seeded_state(cfg, SEED, CPU)
    model = restorer_from_config(cfg, dtype=dtype, device="cpu").eval()
    model.load_state_dict(state)
    return model, reference.reference_model(cfg, state, CPU).eval()


def tiles(seed: int = 0, side: int = 32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, side, side, 13, generator=g) * 0.5 - 1.0


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b) ** 2) / torch.mean(b ** 2)))


def test_forward_matches_the_reference_in_fp32_and_bf16():
    model, ref = pair(tiny_config())
    x = tiles()
    with torch.no_grad():
        want = ref(x)
        assert rel_rms(model(x), want) < FORWARD_RTOL
        low, _ = pair(tiny_config(), torch.bfloat16)
        gap = rel_rms(low(x.bfloat16()), want)
        assert 10 * FORWARD_RTOL < gap < BF16_RTOL, gap
        # the network, not the global residual, carries the comparison
        assert rel_rms(x, want) > 0.5


def mean_subtracting_norm(x, weight):
    y = x.permute(0, 2, 3, 1)
    y = y - y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    return (y * torch.rsqrt(var + restormer.LN_EPS) * weight).permute(0, 3, 1, 2)


def permute_q_within_heads(heads: int):
    """A forward hook for ``qkv_dwconv``: q's channels reversed inside each head."""
    def hook(module, args, out):
        c = out.shape[1] // 3
        q = out[:, :c].unflatten(1, (heads, c // heads)).flip(2).flatten(1, 2)
        return torch.cat([q, out[:, c:]], dim=1)
    return hook


@pytest.mark.parametrize("fault", ["no_l2_norm", "mean_subtracting_norm", "q_permuted"])
def test_the_bf16_tolerance_catches_a_wrong_block(fault, monkeypatch):
    """Each fault, planted in the fp32 port, moves the output past the bf16
    tolerance by a wide margin: q and k left unnormalised (the softmax over
    raw sums over the pixels), a LayerNorm that takes the mean from x, or
    q's channels reversed within each head (levels with more than one
    channel a head)."""
    model, ref = pair(tiny_config())
    if fault == "no_l2_norm":
        monkeypatch.setattr(restormer, "l2_normalize", lambda t: t)
    elif fault == "mean_subtracting_norm":
        monkeypatch.setattr(restormer, "bias_free_norm", mean_subtracting_norm)
    else:
        for m in model.modules():
            if isinstance(m, restormer.Attention):
                m.qkv_dwconv.register_forward_hook(permute_q_within_heads(m.num_heads))
    x = tiles(1)
    with torch.no_grad():
        gap = rel_rms(model(x), ref(x))
    assert gap > 4 * BF16_RTOL, (fault, gap)


def composition(x, weight):
    """The bias-free LayerNorm as PyTorch passes: an fp32 variance, its
    rsqrt in x's dtype, two multiplies."""
    y = x.permute(0, 2, 3, 1)
    var = y.float().var(dim=-1, keepdim=True, correction=0)
    return (y * torch.rsqrt(var + restormer.LN_EPS).to(x.dtype) * weight).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_free_norm_on_the_cpu_is_the_composition_bit_for_bit(dtype):
    """On the CPU, with or without a gradient asked, ``bias_free_norm`` is
    the composition: the same bits, dtype and channels-last layout."""
    g = torch.Generator().manual_seed(3)
    x = restormer.channels_last(torch.randn(2, 48, 8, 8, generator=g) * 3 + 5).to(dtype)
    w = (torch.rand(48, generator=g) + 0.5).to(dtype)
    want = composition(x, w)
    with torch.no_grad():
        got = restormer.bias_free_norm(x, w)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    xr = x.clone().requires_grad_()
    graded = restormer.bias_free_norm(xr, w)
    assert torch.equal(graded.detach(), want)
    graded.float().sum().backward()
    assert xr.grad is not None and xr.grad.shape == x.shape


@pytest.mark.parametrize("case,match", [
    ("fp16", "dtypes"), ("fp32_x_bf16_w", "dtypes"), ("nchw", "not channels-last"),
    ("width", "width other than"), ("weight", "weight other than"), ("cpu", "off the card")])
def test_the_norm_kernel_refuses_what_it_cannot_read(case, match):
    """N2's wrapper names what it cannot read, before any launch: an fp16
    tensor, an fp32 x with a bf16 w (no instance), a contiguous NCHW tensor,
    a width with no instance, a weight of another width, a tensor off the
    card."""
    x, w = restormer.channels_last(torch.zeros(2, 48, 4, 4)), torch.ones(48)
    if case == "fp16":
        x, w = x.half(), w.half()
    elif case == "fp32_x_bf16_w":
        w = w.bfloat16()
    elif case == "nchw":
        x = x.contiguous()
    elif case == "width":
        x, w = restormer.channels_last(torch.zeros(2, 64, 4, 4)), torch.ones(64)
    elif case == "weight":
        w = torch.ones(96)
    with pytest.raises(ValueError, match=match):
        cuda_layernorm.check(x, w)


def test_the_norm_kernel_has_an_instance_for_every_norm_of_the_model():
    """The source's instances are the wrapper's widths and dtype pairs, its
    entry takes what the wrapper passes (the stream last, as a pointer), and
    every norm of the published preset (88) has a width among them."""
    src = (ROOT / "msid_tpu_torch" / "csrc" / "layernorm.cu").read_text()
    widths = tuple(int(c) for c in re.findall(r"case (\d+): return launch_rows", src))
    assert widths == cuda_layernorm.WIDTHS
    names = {torch.bfloat16: "bf16", torch.float32: "float"}
    kinds = {int(k): (x, w, y) for k, x, w, y in re.findall(
        r"case (\d+): return by_width<(\w+), (\w+), (\w+)>", src)}
    assert kinds == {k: (names[x], names[w], names[torch.promote_types(x, w)])
                     for (x, w), k in cuda_layernorm.KINDS.items()}
    params = re.search(r'extern "C" int msid_bias_free_norm\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(cuda_layernorm._ARGS)   # the stream last, a pointer
    assert params.split()[-1] == "stream" and cuda_layernorm._ARGS[-1] is ctypes.c_void_p
    with torch.device("meta"):
        model = restorer_from_config(load_config(YAML), device="meta")
    norms = [m for m in model.modules() if isinstance(m, restormer.BiasFreeLayerNorm)]
    assert len(norms) == 88
    assert {m.weight.shape[0] for m in norms} <= set(cuda_layernorm.WIDTHS)


@pytest.mark.parametrize("kind", list(cuda_layernorm.KINDS))
def test_the_norm_operators_fake_is_the_kernels_output(kind):
    """``msid::bias_free_norm`` on tensors without memory (what a trace by
    ``torch.export`` hands it) gives N2's output: x's shape, channels-last,
    in torch's promotion of x's and w's dtypes, on x's device."""
    x_dtype, w_dtype = kind
    x = restormer.channels_last(torch.empty(2, 96, 8, 8, dtype=x_dtype, device="meta"))
    y = torch.ops.msid.bias_free_norm(x, torch.empty(96, dtype=w_dtype, device="meta"), 1e-5)
    assert y.device.type == "meta" and y.shape == x.shape
    assert y.dtype == torch.promote_types(x_dtype, w_dtype)
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("c,loc", [(48, 0.0), (96, 10.0), (384, 0.0)])
def test_the_norm_backward_is_the_gradient_of_the_norm(c, loc):
    """The operator's backward, the closed form in float32, against autograd
    through ``x * rsqrt(var_c(x) + eps) * w`` in float64: dx and dw within
    1e-5 of their largest, in x's and w's dtypes."""
    g = torch.Generator().manual_seed(c)
    x = restormer.channels_last(torch.randn(2, c, 6, 6, generator=g) * 2 + loc)
    w = torch.rand(c, generator=g) + 0.5
    dy = torch.randn(x.shape, generator=g)
    dx, dw = cuda_layernorm.bias_free_norm_backward(x, w, dy, restormer.LN_EPS)
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    y = x64.permute(0, 2, 3, 1)
    var = y.var(dim=-1, keepdim=True, correction=0)
    out = (y * torch.rsqrt(var + restormer.LN_EPS) * w64).permute(0, 3, 1, 2)
    want_dx, want_dw = torch.autograd.grad(out, (x64, w64), dy.double())
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    dx16, dw16 = cuda_layernorm.bias_free_norm_backward(x.bfloat16(), w, dy.bfloat16(),
                                                        restormer.LN_EPS)
    assert dx16.dtype == torch.bfloat16 and dw16.dtype == torch.float32


def test_norm_shapes_are_the_norms_a_forward_runs():
    """``norm_shapes`` lists, in order, the (C, side) of every LayerNorm a
    forward runs (hooks on a small model at 32 px); for the published
    preset at 512 px, the eight levels' widths and sides and 88 norms."""
    model, _ = pair(tiny_config())
    seen = []
    for m in model.modules():
        if isinstance(m, restormer.BiasFreeLayerNorm):
            m.register_forward_hook(lambda mod, args, out: seen.append(tuple(args[0].shape[1:3])))
    with torch.no_grad():
        model(tiles(1))
    assert seen == [(c, s) for c, s, n in model.norm_shapes(32) for _ in range(n)]
    with torch.device("meta"):
        preset = restorer_from_config(load_config(YAML), device="meta")
    assert preset.norm_shapes(512) == [(48, 512, 8), (96, 256, 12), (192, 128, 12),
                                       (384, 64, 16), (192, 128, 12), (96, 256, 12),
                                       (96, 512, 8), (96, 512, 8)]


def test_the_published_preset_from_the_yaml():
    with torch.device("meta"):
        model = restorer_from_config(load_config(YAML), device="meta")
    assert isinstance(model, RestormerRestoration)
    assert count_parameters(model) == {"total": 26_124_628}
    levels = [model.encoder_level1, model.encoder_level2, model.encoder_level3, model.latent]
    assert [len(lv) for lv in levels] == [4, 6, 6, 8]
    assert [lv[0].ffn.project_out.in_channels for lv in levels] == [127, 255, 510, 1021]
    assert [lv[0].attn.num_heads for lv in levels] == [1, 2, 4, 8]
    assert [lv[0].norm1.weight.shape[0] for lv in levels] == [48, 96, 192, 384]
    tail = [model.decoder_level3, model.decoder_level2, model.decoder_level1, model.refinement]
    assert [len(lv) for lv in tail] == [6, 6, 4, 4]
    assert [lv[0].norm1.weight.shape[0] for lv in tail] == [192, 96, 96, 96]
    assert [lv[0].attn.num_heads for lv in tail] == [4, 2, 1, 1]
    assert not any(m.bias is not None for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    with torch.device("meta"):
        ref = reference.RestormerReference(load_config(YAML))
    assert set(ref.state_dict()) == set(model.state_dict())


def test_the_factory_and_create_model_from_config():
    cfg = tiny_config()
    model, counts = create_model_from_config(cfg, 0, "cpu")
    assert isinstance(model, RestormerRestoration) and counts == count_parameters(model)
    assert model.dtype == torch.float32
    satmae = load_config(ROOT / "configs" / "experiments" / "tiny_cpu.yaml")
    assert "architecture" not in satmae["model"]
    assert isinstance(restorer_from_config(satmae, device="cpu"), SatMAERestoration)
    for bad, match in (({"architecture": "unknown"}, "architecture"),
                       ({"encoder": dict(cfg["model"]["encoder"], bias=True)}, "biases")):
        broken = copy.deepcopy(cfg)
        broken["model"].update(bad)
        with pytest.raises(ValueError, match=match):
            restorer_from_config(broken, device="cpu")


def test_sides_must_be_multiples_of_eight():
    model, _ = pair(tiny_config())
    with pytest.raises(ValueError, match="multiples of 8"):
        model(torch.zeros(1, 36, 32, 13))
    with pytest.raises(ValueError, match="13 bands"):
        model(torch.zeros(1, 32, 32, 12))


def test_the_folded_graphs_refuse_restormer():
    model, _ = pair(tiny_config())
    assert not fastpath.supports_fastpath(model)
    with pytest.raises(ValueError, match="RestormerRestoration"):
        fastpath._refuse_unsupported(model, "the folded decoder")
    for build in (fastpath.optimize_for_inference, fastpath.optimize_for_hybrid,
                  fastpath.make_hybrid_forward):
        with pytest.raises(ValueError, match="RestormerRestoration"):
            build(model)
    for batch in (1, 8, 64, 128):
        assert resolve_graph(model, batch, "auto") is False
    for graph in ("fastpath", "hybrid", True):
        with pytest.raises(ValueError, match="RestormerRestoration"):
            InferenceSession(model, batch_size=2, image_size=32, device="cpu", optimize=graph)
    with pytest.raises(ValueError, match="RestormerRestoration"):
        make_device_scene_step(model, None, 32, 32, 8, optimize=True, device="cpu")


def test_an_optimized_export_refuses_restormer(tmp_path):
    model, _ = pair(tiny_config())
    with pytest.raises(ValueError, match="RestormerRestoration"):
        export_program(model, tmp_path / "artifact", input_shape=(1, 32, 32, 13), optimize=True)
    assert not (tmp_path / "artifact").exists()


def test_served_by_a_session_and_a_scene_as_the_module_forward():
    model, ref = pair(tiny_config())
    session = InferenceSession(model, batch_size=2, image_size=32, device="cpu")
    assert session.optimized is False
    x = tiles(2)
    with torch.no_grad():
        want = ref(x)
    assert rel_rms(torch.from_numpy(session.predict(x.numpy())), want) < FORWARD_RTOL
    scene = np.random.default_rng(3).integers(500, 4000, (40, 56, 13), dtype=np.uint16)
    out = restore_scene(model, None, scene, window=32, overlap=8, model_size=32,
                        batch_size=4, device_assembly=True, device="cpu")
    assert out.shape == scene.shape and np.isfinite(out).all()
    # at the window's own size the step does not resize: one window is the forward
    one = scene[:32, :32]
    tile = torch.from_numpy((np.clip(one * 1e-4, 0, 1) - 0.5) * 4.0).float()[None]
    got = restore_scene(model, None, one, window=32, overlap=8, model_size=32, batch_size=1,
                        device_assembly=True, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(got, ref(tile)[0].numpy(), rtol=1e-4, atol=1e-4)


def test_an_eager_forward_spans_each_block_and_level():
    model, _ = pair(tiny_config())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(tiles(side=16))
    names = [e.name for e in prof.events() if e.name.startswith("msid.restormer.")]
    blocks = 1 + 1 + 1 + 2 + 1 + 1 + 1 + 1
    assert names.count("msid.restormer.mdta") == names.count("msid.restormer.gdfn") == blocks
    assert names.count("msid.restormer.level") == 8
    parents = {e.cpu_parent.name for e in prof.events() if e.name == "msid.restormer.mdta"}
    assert parents == {"msid.restormer.level"}


def test_module_state_is_the_benchmarks_draw_on_its_other_restorers():
    """``module_state`` gives ``weights.seeded_state``'s and
    ``grouped.seeded_state``'s draws on their restorers, so those copies
    can be pointed at it; on Restormer it draws the temperatures log-normal."""
    cfg = load_config(ROOT / "configs" / "experiments" / "long_skip_fill.yaml")
    cfg["data"]["image_size"] = 32
    cfg["model"]["encoder"].update(embed_dim=32, depth=1, num_heads=2)
    cfg["model"]["decoder"]["channels"] = [16, 8, 8, 8]
    gcfg = load_config(ROOT / "configs" / "experiments" / "satmae_group_large.yaml")
    gcfg["data"]["image_size"] = 32
    gcfg["model"]["encoder"].update(embed_dim=32, channel_embed=8, depth=1, num_heads=2)
    gcfg["model"]["decoder"]["channels"] = [16, 8, 8]
    from portbench.reference.model import Restorer

    for build, theirs, config in ((Restorer, weights.seeded_state, cfg),
                                  (grouped.GroupRestorer, grouped.seeded_state, gcfg)):
        with torch.device("meta"):
            module = build(config)
        ours, want = reference.module_state(module, 11, CPU), theirs(config, 11, CPU)
        assert set(ours) == set(want)
        for name, t in want.items():
            assert torch.equal(ours[name], t), name
    state = reference.seeded_state(load_config(YAML), SEED, CPU)
    temps = torch.cat([t.flatten() for n, t in state.items() if n.endswith("temperature")])
    assert temps.numel() == 4 * 1 + 6 * 2 + 6 * 4 + 8 * 8 + 6 * 4 + 6 * 2 + 4 + 4
    assert bool((temps > 0).all()) and 1.5 < float(temps.log().mean().exp()) < 2.7
    norms = torch.cat([t for n, t in state.items() if n.endswith("norm1.weight")])
    assert abs(float(norms.mean()) - 1.0) < 0.05


def test_roofline_restormer_against_the_published_count_and_a_hand_count():
    cfg = load_config(YAML)
    three = copy.deepcopy(cfg)
    three["model"]["encoder"]["input_channels"] = 3
    convs = sum(f for f, kind in roofline_restormer.forward_ops(three, 256)
                if kind != "attention")
    assert convs / 2 == pytest.approx(140.99e9, abs=0.01e9)       # the paper's 256^2 GMACs
    ops = roofline_restormer.forward_ops(cfg, 512)
    attention = sum(f for f, kind in ops if kind == "attention") / 2
    assert attention == pytest.approx(55.566e9, abs=0.001e9)
    tiny = tiny_config()
    px = [32 * 32, 16 * 16, 8 * 8, 4 * 4]

    def block(c, h, p):
        hid = int(c * 2.66)
        return 2 * p * (3 * c * c + 27 * c + 2 * c * c // h + c * c + 3 * hid * c + 18 * hid)

    want = 2 * px[0] * 9 * 13 * 8 + 2 * px[0] * 9 * 16 * 13
    want += block(8, 1, px[0]) + block(16, 2, px[1]) + block(32, 4, px[2]) + 2 * block(64, 8, px[3])
    want += block(32, 4, px[2]) + block(16, 2, px[1]) + 2 * block(16, 1, px[0])
    want += 2 * 9 * (px[0] * 8 * 4 + px[1] * 16 * 8 + px[2] * 32 * 16)       # downsamples
    want += 2 * 9 * (px[3] * 64 * 128 + px[2] * 32 * 64 + px[1] * 16 * 32)   # upsamples
    want += 2 * (px[2] * 64 * 32 + px[1] * 32 * 16)                          # reductions
    assert roofline_restormer.forward_flops(tiny, 32) == want
    convs = roofline_restormer.depthwise_convs(tiny, 32)
    assert convs[:2] == [(24, 32), (42, 32)] and len(convs) == 2 * 9
    assert roofline_restormer.depthwise_bound(8, 24, 32) == pytest.approx(
        (2 * 8 * 24 * 32 * 32 + 9 * 24) * 2 / 3.35e12)


DWCONV = "conv2d_c1_k1_nhwc_specialized"


def restormer_cell() -> dict:
    return registry.cell(registry.load_benchmark(ROOT), "restormer.scene512.b8")


def test_the_restormer_readers_on_a_synthetic_trace():
    config = restormer_cell()["config"]["config"]
    extra = {"config": config, "tiles": 32, "batch": 8, "scenes": 2, "model_size": 512}
    convs = roofline_restormer.depthwise_convs(config, 512)
    least = [roofline_restormer.depthwise_bound(8, c, s) for c, s in convs]
    device = [("sm90_xmma_fprop_implicit_gemm", 0.0, 0.1)]
    at = 0.1
    for _ in range(4):                       # four forwards of a batch of 8
        for t in least:
            device.append((DWCONV, at, at + 2 * t))
            at += 2 * t
    trace = Trace(device=device, spans=[], window_s=1.0, extra=extra)
    assert registry.metric_reader("scene.dwconv_roofline")(trace) == pytest.approx(50.0)
    want = 100 * roofline_restormer.forward_flops(config, 512) * 32 / 989e12
    assert registry.metric_reader("scene.restormer_mfu")(trace) == pytest.approx(want)
    assert 0 < want < 100
    assert registry.metric_reader("scene.dwconv_roofline")(
        Trace(device[:1], [], 1.0, extra=extra)) is None
    assert registry.metric_reader("scene.restormer_mfu")(Trace([], [], 1.0, extra=extra)) is None
    flagship = registry.cell(registry.load_benchmark(ROOT), "flagship.scene.b64")
    other = dict(extra, config=flagship["config"]["config"])
    for name in ("scene.dwconv_roofline", "scene.restormer_mfu"):
        assert registry.metric_reader(name)(Trace(device, [], 1.0, extra=other)) is None
        assert registry.metric_reader(name)(Trace(device, [], 1.0)) is None


N2 = ("void (anonymous namespace)::bias_free_norm_rows<__nv_bfloat16, __nv_bfloat16, "
      "__nv_bfloat16, 48>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
      "long long, float)")


def test_the_norm_kernel_share_on_a_synthetic_trace():
    """100 with N2 at each of the 88 norms of every traced forward, 50 with
    half of them, 0 on a trace of PyTorch's norm kernels alone (the
    parent's), null on another architecture or an empty record. Its name
    fragment is the kernel's in the source, and no other reader's fragment
    or PyTorch's LayerNorm matches N2."""
    config = restormer_cell()["config"]["config"]
    extra = {"config": config, "tiles": 32, "batch": 8, "scenes": 2, "model_size": 512}
    read = registry.metric_reader("scene.norm_kernel_share")
    name = read.__globals__["NAME"]
    assert name in (ROOT / "msid_tpu_torch" / "csrc" / "layernorm.cu").read_text()
    assert name in N2
    others = [(DWCONV, 0.0, 0.1), ("void at::native::reduce_kernel<512, 1>", 0.1, 0.2),
              ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel", 0.2, 0.3)]
    assert not any(name in n for n, _, _ in others)
    for part in registry.metric_reader("scene.dwconv_roofline").__globals__["NAMES"] + (
            "resblock_kernel", "sdpa"):
        assert part not in N2
    norms = [(N2, 1.0 + i * 1e-4, 1.0 + (i + 0.5) * 1e-4) for i in range(4 * 88)]
    assert read(Trace(others + norms, [], 2.0, extra=extra)) == pytest.approx(100.0)
    assert read(Trace(others + norms[::2], [], 2.0, extra=extra)) == pytest.approx(50.0)
    assert read(Trace(others, [], 2.0, extra=extra)) == 0.0
    flagship = registry.cell(registry.load_benchmark(ROOT), "flagship.scene.b64")
    assert read(Trace(others + norms, [], 2.0,
                      extra=dict(extra, config=flagship["config"]["config"]))) is None
    assert read(Trace([], [], 2.0, extra=extra)) is None
    assert read(Trace(others + norms, [], 2.0)) is None


def imports_of(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("path", ["portbench/reference/restormer.py",
                                  "portbench/roofline_restormer.py",
                                  "portbench/metrics/scene.restormer_mfu.py",
                                  "portbench/metrics/scene.dwconv_roofline.py",
                                  "portbench/metrics/scene.norm_kernel_share.py"])
def test_the_reference_and_counts_import_neither_jax_nor_the_port(path):
    found = imports_of(ROOT / path)
    assert not found & {"jax", "jaxlib", "flax", "optax", "msid_tpu", "msid_tpu_torch"}, found


def test_the_reference_computes_in_float32_and_the_cell_is_whole():
    _, ref = pair(tiny_config())
    assert {t.dtype for t in ref.state_dict().values()} == {torch.float32}
    cell = restormer_cell()
    t = cell["traffic"]
    assert t["window"] == t["model_size"] == 512 and t["kind"] == "scene_restormer"
    assert cell["config"]["reduced"] == [] and cell["config"]["config"] == {
        **load_config(YAML), "data": dict(load_config(YAML)["data"], root_dir="portbench/no_tiles")}
