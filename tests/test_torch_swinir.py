"""SwinIR (``models/swinir.py``) on the CPU, against the benchmark's plain
reference (``portbench/reference/swinir.py``) on its seeded weights, at a
small size that keeps every mechanism: two RSTBs of two blocks (so odd
blocks shift and take the mask), width 24 with 2 and 3 heads (head widths
12, padded to 16, and 8), window 4, 13 bands, sides 16 and 18 (18 is
reflect-padded to 20), B=2; the published preset from the YAML on the meta
device; the normal path (the factory, scenes, sessions, an export, the
folded graphs' refusals, the spans, the derived tensors and their count);
the counts of ``portbench/roofline_swinir.py`` and the readers of its two
metrics."""

from __future__ import annotations

import ast
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msid_tpu_torch.deployment import fastpath
from msid_tpu_torch.deployment.export import export_program
from msid_tpu_torch.deployment.inference import InferenceSession, resolve_graph
from msid_tpu_torch.deployment.sliding_window import make_device_scene_step, restore_scene
from msid_tpu_torch.models import swinir
from msid_tpu_torch.models.restoration import count_parameters, restorer_from_config
from msid_tpu_torch.models.swinir import SwinIRRestoration
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.setup_helpers import create_model_from_config
from portbench import registry, roofline_swinir
from portbench.reference import swinir as reference
from portbench.trace import Trace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "experiments" / "swinir_s2.yaml"
CPU = torch.device("cpu")
SEED = 2 ** 40 + 23

# fp32 on both sides, the same products in another order and layout (fused
# attention with zero-padded heads against the release's composition):
# ~3e-7 relative measured. 1e-5 leaves an order of margin.
FORWARD_RTOL = 1e-5
# bf16 against the fp32 reference: the residual stream, every Linear and
# conv and both attention products round to 8 mantissa bits (~4e-3 a
# rounding) over 4 blocks and the convs between them: 0.0048-0.0065
# measured over three seeds at 16 px; 0.015 leaves over twice that, and
# each fault below lands at least 2.6x above it (0.040-0.28 measured).
BF16_RTOL = 0.015


def tiny_config() -> dict:
    cfg = load_config(YAML)
    cfg["model"]["encoder"].update(embed_dim=24, depths=[2, 2], num_heads=[2, 3], window_size=4)
    return cfg


def pair(cfg: dict, dtype=torch.float32, state=None):
    """The port's SwinIR and the reference holding the same seeded state
    (``state`` is loaded into the program instead where given)."""
    seeded = reference.seeded_state(cfg, SEED, CPU)
    model = restorer_from_config(cfg, dtype=dtype, device="cpu").eval()
    model.load_state_dict(seeded if state is None else state)
    return model, reference.reference_model(cfg, seeded, CPU).eval()


def tiles(seed: int = 0, side: int = 16) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, side, side, 13, generator=g) * 0.5 - 1.0


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b) ** 2) / torch.mean(b ** 2)))


@pytest.mark.parametrize("side", [16, 18])
def test_forward_matches_the_reference_in_fp32_and_bf16(side):
    model, ref = pair(tiny_config())
    x = tiles(side=side)
    with torch.no_grad():
        want = ref(x)
        got = model(x)
        assert got.shape == x.shape and rel_rms(got, want) < FORWARD_RTOL
        low, _ = pair(tiny_config(), torch.bfloat16)
        gap = rel_rms(low(x.bfloat16()), want)
        assert 10 * FORWARD_RTOL < gap < BF16_RTOL, gap
        # the network, not the global residual, carries the comparison
        assert rel_rms(x, want) > 0.5


def heads_in_the_wrong_order(cfg: dict) -> dict:
    """The seeded state with ``qkv``'s rows read as ``(heads, 3, d)``, where
    the release splits them ``(3, heads, d)``."""
    state = reference.seeded_state(cfg, SEED, CPU)
    enc = cfg["model"]["encoder"]
    for i, heads in enumerate(enc["num_heads"]):
        for name in [n for n in state if n.startswith(f"layers.{i}.") and ".attn.qkv." in n]:
            t = state[name]
            state[name] = t.unflatten(0, (heads, 3, t.shape[0] // (3 * heads))) \
                .transpose(0, 1).flatten(0, 2)
    return state


@pytest.mark.parametrize("fault", ["no_bias", "no_shift", "shift_without_mask", "heads_order"])
def test_the_bf16_tolerance_catches_a_wrong_block(fault, monkeypatch):
    """Each fault, planted in the fp32 port, moves the output past the bf16
    tolerance: no relative-position bias (the tables zeroed), no shift (odd
    blocks unshifted), the shift without its mask, and the heads split in
    the wrong order."""
    cfg = tiny_config()
    state = None
    if fault == "no_bias":
        state = {n: torch.zeros_like(t) if n.endswith("bias_table") else t
                 for n, t in reference.seeded_state(cfg, SEED, CPU).items()}
    elif fault == "heads_order":
        state = heads_in_the_wrong_order(cfg)
    elif fault == "shift_without_mask":
        plain = swinir.shift_mask
        monkeypatch.setattr(swinir, "shift_mask", lambda *a: torch.zeros_like(plain(*a)))
    model, ref = pair(cfg, state=state)
    if fault == "no_shift":
        for m in model.modules():
            if isinstance(m, swinir.SwinTransformerBlock):
                m.shift_size = 0
    x = tiles(1)
    with torch.no_grad():
        gap = rel_rms(model(x), ref(x))
    assert gap > BF16_RTOL, (fault, gap)


def test_the_derived_tensors_are_the_releases():
    """The index and the mask the program builds are the reference's, which
    follow the release's code (a mask at any side a multiple of the window,
    one window too)."""
    for h, w, ws in ((16, 16, 4), (20, 12, 4), (8, 8, 8), (64, 48, 8)):
        assert torch.equal(swinir.shift_mask(h, w, ws, ws // 2),
                           reference.calculate_mask(h, w, ws, ws // 2)), (h, w, ws)
    for ws in (4, 7, 8):
        assert torch.equal(swinir.relative_position_index(ws),
                           reference.relative_position_index(ws))
    mask = swinir.shift_mask(512, 512, 8, 4)
    assert mask.shape == (4096, 64, 64) and set(mask.unique().tolist()) == {-100.0, 0.0}
    assert int((mask != 0).flatten(1).any(1).sum()) == 64 + 64 - 1     # the last row and column


def test_the_mask_and_index_are_built_once_per_side():
    model, _ = pair(tiny_config())
    before = swinir.derived_builds.copy()
    with torch.no_grad():
        for side in (16, 16, 18, 20, 16):       # 18 pads to 20
            model(tiles(side=side))
    assert dict(swinir.derived_builds - before) == {"index": 2, "mask": 2}
    model.bfloat16()
    model.dtype = torch.bfloat16
    with torch.no_grad():
        model(tiles(side=16).bfloat16())
    assert dict(swinir.derived_builds - before) == {"index": 3, "mask": 3}


def test_the_published_preset_from_the_yaml():
    with torch.device("meta"):
        model = restorer_from_config(load_config(YAML), device="meta")
    assert isinstance(model, SwinIRRestoration)
    assert count_parameters(model) == {"total": 11_536_573}
    blocks = [b for m in model.layers for b in m.residual_group.blocks]
    assert len(model.layers) == 6 and len(blocks) == 36
    assert [b.shift_size for b in blocks[:6]] == [0, 4] * 3
    attn = blocks[0].attn
    assert (attn.num_heads, attn.window, attn.qkv.out_features) == (6, 8, 540)
    assert attn.relative_position_bias_table.shape == (225, 6)
    assert blocks[0].mlp.fc1.out_features == 360 and model.conv_first.in_channels == 13
    assert "layers.5.residual_group.blocks.5.attn.relative_position_bias_table" in \
        model.state_dict()
    with torch.device("meta"):
        ref = reference.SwinIRReference(load_config(YAML))
    assert set(ref.state_dict()) == set(model.state_dict())


def test_the_factory_and_create_model_from_config():
    cfg = tiny_config()
    model, counts = create_model_from_config(cfg, 0, "cpu")
    assert isinstance(model, SwinIRRestoration) and counts == count_parameters(model)
    assert model.dtype == torch.float32
    for bad in ({"upsampler": "pixelshuffle"}, {"img_range": 255.0},
                {"resi_connection": "3conv"}):
        broken = copy.deepcopy(cfg)
        broken["model"]["encoder"].update(bad)
        with pytest.raises(ValueError, match="denoising form"):
            restorer_from_config(broken, device="cpu")
    with pytest.raises(ValueError, match="13 bands"):
        model(torch.zeros(1, 16, 16, 12))


def test_other_restorers_do_not_import_swinir():
    """Building the SatMAE and Restormer restorers loads no SwinIR module,
    so their processes do not pay for it."""
    code = ("import sys, torch\n"
            "from msid_tpu_torch.utils.config import load_config\n"
            "from msid_tpu_torch.models.restoration import restorer_from_config\n"
            "for name in ('tiny_cpu', 'restormer_s2'):\n"
            "    with torch.device('meta'):\n"
            "        restorer_from_config(load_config(f'configs/experiments/{name}.yaml'),"
            " device='meta')\n"
            "assert 'msid_tpu_torch.models.swinir' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_the_folded_graphs_refuse_swinir():
    model, _ = pair(tiny_config())
    assert not fastpath.supports_fastpath(model)
    for build in (fastpath.optimize_for_inference, fastpath.optimize_for_hybrid,
                  fastpath.make_hybrid_forward):
        with pytest.raises(ValueError, match="SwinIRRestoration"):
            build(model)
    for batch in (1, 8, 64, 128):
        assert resolve_graph(model, batch, "auto") is False
    for graph in ("fastpath", "hybrid", True):
        with pytest.raises(ValueError, match="SwinIRRestoration"):
            InferenceSession(model, batch_size=2, image_size=16, device="cpu", optimize=graph)
    with pytest.raises(ValueError, match="SwinIRRestoration"):
        make_device_scene_step(model, None, 16, 16, 4, optimize=True, device="cpu")


def test_served_by_a_session_and_a_scene_as_the_module_forward():
    model, ref = pair(tiny_config())
    session = InferenceSession(model, batch_size=2, image_size=16, device="cpu")
    assert session.optimized is False
    x = tiles(2)
    with torch.no_grad():
        want = ref(x)
    assert rel_rms(torch.from_numpy(session.predict(x.numpy())), want) < FORWARD_RTOL
    scene = np.random.default_rng(3).integers(500, 4000, (40, 56, 13), dtype=np.uint16)
    out = restore_scene(model, None, scene, window=16, overlap=4, model_size=16,
                        batch_size=4, device_assembly=True, device="cpu")
    assert out.shape == scene.shape and np.isfinite(out).all()
    # at the window's own size the step does not resize: one window is the forward
    one = scene[:16, :16]
    tile = torch.from_numpy((np.clip(one * 1e-4, 0, 1) - 0.5) * 4.0).float()[None]
    got = restore_scene(model, None, one, window=16, overlap=4, model_size=16, batch_size=1,
                        device_assembly=True, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(got, ref(tile)[0].numpy(), rtol=1e-4, atol=1e-4)


def test_an_export_serves_what_the_model_computes(tmp_path):
    """An exported SwinIR (the module forward; the mask built in the graph
    from arithmetic, no tensor copied from the host) serves through a
    session what the live model computes; the export leaves the model's
    derived tensors alone, and an optimized export refuses it."""
    model, _ = pair(tiny_config())
    path = export_program(model, tmp_path / "a", input_shape=(1, 16, 16, 13))
    assert model._derived == {}
    program = torch.export.load(path / "module.pt2")
    kinds = {str(s.kind) for s in program.graph_signature.input_specs}
    assert kinds == {"InputKind.USER_INPUT"}
    session = InferenceSession(artifact_path=path, batch_size=2, image_size=16, device="cpu")
    x = tiles(3)
    with torch.no_grad():
        want = model(x)
    np.testing.assert_allclose(session.predict(x.numpy()), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="SwinIRRestoration"):
        export_program(model, tmp_path / "b", input_shape=(1, 16, 16, 13), optimize=True)
    assert not (tmp_path / "b").exists()


def test_an_eager_forward_opens_the_three_spans():
    model, _ = pair(tiny_config())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(tiles(side=16))
    names = [e.name for e in prof.events() if e.name.startswith("msid.swinir.")]
    assert names.count("msid.swinir.attention") == names.count("msid.swinir.mlp") == 4
    assert names.count("msid.swinir.rstb") == 2
    parents = {e.cpu_parent.name for e in prof.events() if e.name == "msid.swinir.attention"}
    assert parents == {"msid.swinir.rstb"}


def test_the_seeded_draw():
    """``seeded_state`` is ``module_state``'s draw with the output
    projections scaled by their stream's depth and the bias tables widened."""
    cfg = load_config(YAML)
    state = reference.seeded_state(cfg, SEED, CPU)
    with torch.device("meta"):
        plain = reference.module_state(reference.SwinIRReference(cfg), SEED, CPU)
    assert set(state) == set(plain)
    scaled = dict(reference.output_projections(cfg))
    assert len(scaled) == 36 * 2 + 6
    assert scaled["layers.0.residual_group.blocks.0.attn.proj.weight"] == pytest.approx(12 ** -0.5)
    assert scaled["layers.3.conv.weight"] == pytest.approx(6 ** -0.5)
    for name, t in plain.items():
        if name.endswith("bias_table"):
            want = t * reference.BIAS_TABLE_STD / 0.1
        else:
            want = t * scaled.get(name, 1.0)
        assert torch.allclose(state[name], want), name
    tables = torch.cat([t.flatten() for n, t in state.items() if n.endswith("bias_table")])
    assert tables.numel() == 36 * 225 * 6
    assert abs(float(tables.std()) / reference.BIAS_TABLE_STD - 1) < 0.05


def test_roofline_swinir_against_a_hand_count():
    cfg = load_config(YAML)
    mac = 12_243_960          # a pixel: convs 2,124,720, Swin blocks 36 x 282,240
    assert roofline_swinir.forward_flops(cfg, 512) == 2 * mac * 512 * 512
    blocks = sum(f for f, kind in roofline_swinir.forward_ops(cfg, 512) if kind != "conv")
    assert blocks / roofline_swinir.forward_flops(cfg, 512) == pytest.approx(0.8298, abs=1e-4)
    tiny = tiny_config()
    px = 20 * 20                                    # 18 is padded to 20
    block = 2 * px * (24 * 72 + 24 * 24 + 2 * 24 * 48 + 2 * 16 * 24)
    want = 2 * px * 9 * (13 * 24 + 2 * 24 * 24 + 24 * 24 + 24 * 13) + 4 * block
    assert roofline_swinir.forward_flops(tiny, 18) == want
    assert roofline_swinir.attention_windows(cfg, 512) == 4096
    assert roofline_swinir.attention_windows(tiny, 18) == 25
    assert roofline_swinir.attention_launches(cfg) == [(6, 30)] * 36
    least = roofline_swinir.attention_bound(8, 4096, 6, 64, 30)
    assert least == pytest.approx((4 * 8 * 4096 * 64 * 180 + 6 * 64 * 64) * 2 / 3.35e12)
    assert least * 1e3 == pytest.approx(0.9015, abs=1e-4)      # bound by the bytes


def swinir_cell() -> dict:
    return registry.cell(registry.load_benchmark(ROOT), "swinir.scene512.b8")


SDPA = ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_"
        "cga1x1x1_kernel0_0")


def test_the_swinir_readers_on_a_synthetic_trace():
    config = swinir_cell()["config"]["config"]
    extra = {"config": config, "tiles": 32, "batch": 8, "scenes": 2, "model_size": 512,
             "attention_windows": 4096}
    least = roofline_swinir.attention_bound(8, 4096, 6, 64, 30)
    device = [("sm90_xmma_gemm_bf16bf16_bf16f32", 0.0, 0.1)]
    at = 0.1
    for _ in range(4 * 36):                  # four forwards of a batch of 8, 36 blocks each
        device.append((SDPA, at, at + 4 * least))
        at += 4 * least
    trace = Trace(device=device, spans=[], window_s=1.0, extra=extra)
    read = registry.metric_reader("scene.window_attention_roofline")
    assert read(trace) == pytest.approx(25.0)
    want = 100 * roofline_swinir.forward_flops(config, 512) * 32 / 989e12
    mfu = registry.metric_reader("scene.swinir_mfu")
    assert mfu(trace) == pytest.approx(want) and 0 < want < 100
    assert read(Trace(device[:-1], [], 1.0, extra=extra)) is None     # a dropped record
    assert read(Trace(device[:1], [], 1.0, extra=extra)) is None
    assert mfu(Trace([], [], 1.0, extra=extra)) is None
    restormer = registry.cell(registry.load_benchmark(ROOT), "restormer.scene512.b8")
    other = dict(extra, config=restormer["config"]["config"])
    for reader in (read, mfu):
        assert reader(Trace(device, [], 1.0, extra=other)) is None
        assert reader(Trace(device, [], 1.0)) is None


def imports_of(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("path", ["portbench/reference/swinir.py",
                                  "portbench/roofline_swinir.py",
                                  "portbench/metrics/scene.swinir_mfu.py",
                                  "portbench/metrics/scene.window_attention_roofline.py"])
def test_the_reference_and_counts_import_neither_jax_nor_the_port(path):
    found = imports_of(ROOT / path)
    assert not found & {"jax", "jaxlib", "flax", "optax", "msid_tpu", "msid_tpu_torch"}, found


def test_the_reference_computes_in_float32_and_the_cell_is_whole():
    _, ref = pair(tiny_config())
    assert {t.dtype for t in ref.state_dict().values()} == {torch.float32}
    cell = swinir_cell()
    t = cell["traffic"]
    assert t["window"] == t["model_size"] == 512 and t["kind"] == "scene_swinir"
    restormer = registry.cell(registry.load_benchmark(ROOT), "restormer.scene512.b8")["traffic"]
    assert {k: v for k, v in t.items() if k not in ("kind", "about")} == \
        {k: v for k, v in restormer.items() if k not in ("kind", "about")}
    assert cell["config"]["reduced"] == [] and cell["config"]["config"] == {
        **load_config(YAML), "data": dict(load_config(YAML)["data"], root_dir="portbench/no_tiles")}
