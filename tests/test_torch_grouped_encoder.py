"""SatMAE's group-channel ViT restorer (``SatMAEGroupEncoder`` under
``SatMAERestoration``) on the CPU, against the benchmark's plain reference
(``portbench/reference/grouped.py``) on its seeded weights, at a small size:
D 64 with a 16-wide group embedding, depth 2, 4 heads, 32 px, patch 8, the
published three groups over 13 bands; and the published widths from the
YAML on the meta device. Also the sin-cos tables, the token layout, the
refusals of the folded graphs, fused against unfused attention, the FLOP
counts of ``portbench/roofline_grouped.py`` and the readers of its two
metrics."""

from __future__ import annotations

import ast
import copy
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msid_tpu_torch.deployment.fastpath import (
    make_hybrid_forward,
    optimize_for_hybrid,
    optimize_for_inference,
    supports_fastpath,
)
from msid_tpu_torch.deployment.inference import InferenceSession, resolve_graph
from msid_tpu_torch.models import encoder as encoder_module
from msid_tpu_torch.models.encoder import (
    SATMAE_CHANNEL_GROUPS,
    MultiHeadAttention,
    sincos_1d,
    sincos_2d,
)
from msid_tpu_torch.models.restoration import SatMAERestoration, count_parameters
from msid_tpu_torch.utils.config import load_config
from portbench import registry, roofline, roofline_grouped
from portbench.reference import grouped
from portbench.trace import Trace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "experiments" / "satmae_group_large.yaml"
CPU = torch.device("cpu")
SEED = 2 ** 40 + 19


def tiny_config() -> dict:
    cfg = load_config(YAML)
    cfg["data"]["image_size"] = 32
    cfg["model"]["encoder"].update(embed_dim=64, channel_embed=16, depth=2, num_heads=4)
    cfg["model"]["decoder"]["channels"] = [16, 8, 8]
    return cfg


def pair(cfg: dict, dtype=torch.float32):
    """The port's restorer and the reference holding the same seeded state."""
    state = grouped.seeded_state(cfg, SEED, CPU)
    model = SatMAERestoration.from_config(cfg, dtype=dtype, device="cpu")
    model.load_state_dict(state)
    return model, grouped.reference_model(cfg, state, CPU)


def tiles(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 32, 32, 13, generator=g) * 0.5
    x[1, :, :, 4] *= 1e-3                       # a dead band: the fill path
    return x


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b) ** 2) / torch.mean(b ** 2)))


# fp32 on both sides, the same products in another order (and the port's
# attention fused): ~1e-7 relative. 1e-5 leaves two orders of margin, and a
# bf16 forward (8 mantissa bits, ~4e-3 a rounding) lands far above it.
FORWARD_RTOL = 1e-5


def test_forward_matches_the_reference_in_fp32_and_bf16_fails_it():
    cfg = tiny_config()
    model, ref = pair(cfg)
    x = tiles()
    with torch.no_grad():
        got, want = model.eval()(x), ref.eval()(x)
        gap = rel_rms(got, want)
        assert gap < FORWARD_RTOL, gap
        low, _ = pair(cfg, torch.bfloat16)
        assert rel_rms(low.eval()(x.bfloat16()), want) > 10 * FORWARD_RTOL


def test_loss_and_gradients_of_one_mse_step_match_the_reference():
    """Train mode (BatchNorm on the batch's moments, gradient checkpointing
    on in the port), one MSE loss: the loss to 1e-5 relative and every
    parameter's gradient to 1e-4 of the larger of its norm and the median
    leaf's (fp32 both sides; the backward sums over the batch and the fill's
    solve in another order), against a bf16 forward's ~1e-2. The median
    keeps the keys' biases in: their gradient is zero but for rounding (a
    key bias adds the same score to a whole row, which the softmax drops)."""
    cfg = tiny_config()
    model, ref = pair(cfg)
    x, target = tiles(1), tiles(2)
    model.train()
    ref.train()
    loss = F.mse_loss(model(x), target)
    want = F.mse_loss(ref(x), target)
    loss.backward()
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * want.item()
    grads = dict(ref.named_parameters())
    median = float(np.median([float(p.grad.norm()) for p in ref.parameters()]))
    for name, p in model.named_parameters():
        theirs = grads[name].grad
        gap = float((p.grad - theirs).norm()) / max(float(theirs.norm()), median)
        assert gap < 1e-4, (name, gap)


def mae_1d(dim, pos):
    """MAE's ``get_1d_sincos_pos_embed_from_grid``, as the release writes it."""
    omega = np.arange(dim // 2, dtype=np.float64)
    omega /= dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.asarray(pos, np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def mae_2d(dim, grid_size):
    """MAE's ``get_2d_sincos_pos_embed`` without the CLS row."""
    grid = np.meshgrid(np.arange(grid_size, dtype=np.float32),
                       np.arange(grid_size, dtype=np.float32))     # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    return np.concatenate([mae_1d(dim // 2, grid[0]), mae_1d(dim // 2, grid[1])], axis=1)


def test_sincos_tables_are_maes():
    # dim 4: frequencies 1 and 1e-2
    np.testing.assert_allclose(sincos_1d(4, [0, 1, 2]),
                               [[0, 0, 1, 1], [math.sin(1), math.sin(0.01), math.cos(1),
                                               math.cos(0.01)],
                               [math.sin(2), math.sin(0.02), math.cos(2), math.cos(0.02)]],
                               rtol=0, atol=1e-15)
    # token (row 0, column 1) of a 3x3 grid: its column first, then its row
    np.testing.assert_allclose(sincos_2d(8, 3)[1], np.concatenate(
        [sincos_1d(4, [1])[0], sincos_1d(4, [0])[0]]), rtol=0, atol=1e-15)
    for dim, grid in ((768, 12), (16, 4)):
        np.testing.assert_allclose(sincos_2d(dim, grid), mae_2d(dim, grid), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sincos_1d(256, np.arange(3)), mae_1d(256, np.arange(3)),
                               rtol=0, atol=1e-12)
    enc = SatMAERestoration.from_config(tiny_config(), device="cpu").encoder
    np.testing.assert_allclose(enc.pos_embed[0].detach().numpy(), mae_2d(48, 4), atol=1e-7)
    np.testing.assert_allclose(enc.channel_embed[0].detach().numpy(),
                               mae_1d(16, np.arange(3)), atol=1e-7)


def test_tokens_are_group_major_and_each_group_sees_its_bands():
    """Perturbing B1, B9 or B10 (in no group) leaves every token as it was;
    a band of one group moves that group's 16 tokens and no other's."""
    model, _ = pair(tiny_config())
    enc = model.encoder.eval()
    length = enc.num_patches
    x = tiles().permute(0, 3, 1, 2)
    with torch.no_grad():
        base = enc.embed(x)
        assert base.shape == (3, 3 * length, 64)
        for band in (0, 9, 10):
            y = x.clone()
            y[:, band] += 1.0
            assert torch.equal(enc.embed(y), base), band
        for band in range(13):
            owner = [i for i, g in enumerate(SATMAE_CHANNEL_GROUPS) if band in g]
            y = x.clone()
            y[:, band] += 1.0
            moved = (enc.embed(y) - base).abs().amax(dim=(0, 2)).view(3, length) > 0
            assert moved.any(dim=1).tolist() == [i in owner for i in range(3)], band
            assert all(moved[i].all() for i in owner)


def test_the_published_widths_from_the_yaml():
    cfg = load_config(YAML)
    with torch.device("meta"):
        model = SatMAERestoration.from_config(cfg, device="meta")
    counts = count_parameters(model)
    assert 302e6 <= counts["encoder"] <= 304e6, counts
    enc = model.encoder
    assert enc.channel_groups == ((1, 2, 3, 7), (4, 5, 6, 8), (11, 12)) == SATMAE_CHANNEL_GROUPS
    assert len(enc.channel_groups) * enc.num_patches == 432
    assert enc.pos_embed.shape == (1, 144, 768) and enc.channel_embed.shape == (1, 3, 256)
    assert [e.proj.in_channels for e in enc.patch_embed] == [4, 4, 2]
    assert {e.proj.kernel_size for e in enc.patch_embed} == {(8, 8)}
    assert not hasattr(enc.patch_embed[0], "norm")
    assert len(enc.blocks) == 24 and enc.embed_dim == 1024
    block = enc.blocks[0]
    assert block.attn.num_heads == 16 and block.mlp.fc1.out_features == 4096
    assert block.mlp.gelu == "none" and block.norm1.eps == 1e-6
    assert block.attn.query.bias is not None
    assert model.decoder.up[0].conv.in_channels == 3072
    assert [u.conv.out_channels for u in model.decoder.up] == [384, 192, 96]
    assert model.image_size == 96 and model.patch_size == 8
    assert model.input_fill and model.residual_output and model.decoder_arch == "unet_skip"


def test_the_one_embed_encoder_keeps_tanh_gelu():
    model = SatMAERestoration.from_config(load_config(ROOT / "configs" / "base.yaml"),
                                          device="cpu")
    assert model.channel_groups is None
    assert {b.mlp.gelu for b in model.encoder.blocks} == {"tanh"}


def test_the_folded_graphs_refuse_the_grouped_encoder():
    cfg = tiny_config()
    cfg["model"]["input_fill"]["enabled"] = False      # only the encoder stands in the way
    model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    assert not supports_fastpath(model)
    for batch in (1, 8, 16, 64, 128):
        assert resolve_graph(model, batch, "auto") is False
    for build in (optimize_for_inference, optimize_for_hybrid, make_hybrid_forward):
        with pytest.raises(ValueError, match="group-channel encoder"):
            build(model)
    for graph in ("fastpath", "hybrid", True):
        with pytest.raises(ValueError, match="group-channel encoder"):
            InferenceSession(model, batch_size=2, image_size=32, device="cpu", optimize=graph)


def test_served_by_a_session_and_a_scene_as_the_module_forward():
    from msid_tpu_torch.deployment.sliding_window import restore_scene

    model, ref = pair(tiny_config())
    session = InferenceSession(model, batch_size=3, image_size=32, device="cpu")
    assert session.optimized is False
    x = tiles()
    with torch.no_grad():
        want = ref.eval()(x).numpy()
    assert rel_rms(torch.from_numpy(session.predict(x.numpy())), torch.from_numpy(want)) \
        < FORWARD_RTOL
    scene = np.random.default_rng(3).integers(100, 4000, (70, 90, 13), dtype=np.uint16)
    out = restore_scene(model.eval(), None, scene, window=32, overlap=8, model_size=32,
                        batch_size=4, device_assembly=True, device="cpu")
    assert out.shape == scene.shape and np.isfinite(out).all()


def test_one_train_step_of_the_grouped_restorer():
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState, make_train_step

    cfg = tiny_config()
    cfg["training"]["mixed_precision"] = False
    model = SatMAERestoration.from_config(cfg, device="cpu")
    optimizer, _ = build_optimizer_from_config(cfg, model)
    frozen = {n for n, label in optimizer.labels.items() if label == "frozen"}
    assert {n.split(".")[2] for n in frozen if n.startswith("encoder.blocks.")} == {"0", "1"}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, image_size=32)
    raw = np.random.default_rng(0).uniform(500, 4000, (4, 16, 16, 13)).astype(np.float32)
    state, metrics = step(state, raw, 7)
    assert metrics["skipped"] == 0 and state.step == 1 and math.isfinite(metrics["loss"])
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    assert "encoder.channel_embed" in moved and "encoder.patch_embed.2.proj.weight" in moved
    assert not moved & frozen


def unfused(q, k, v):
    s = (q / math.sqrt(q.shape[-1])) @ k.transpose(-2, -1)
    return torch.softmax(s.float(), dim=-1).to(v.dtype) @ v


@pytest.mark.parametrize("tokens,dtype,tol", [
    (432, torch.float32, 1e-5),       # fp32: summation order only
    (144, torch.float32, 1e-5),
    (48, torch.bfloat16, 2e-2),       # bf16 scores and probabilities: ~2^-8 a rounding
])
def test_fused_and_unfused_attention_agree(tokens, dtype, tol, monkeypatch):
    """The fused kernel the card runs (``F.scaled_dot_product_attention``,
    here its CPU kernel) against the unfused form, alone and as
    ``MultiHeadAttention``'s, both near a float64 reckoning."""
    g = torch.Generator().manual_seed(tokens)
    q, k, v = (torch.randn(2, 4, tokens, 16, generator=g).to(dtype) for _ in range(3))
    want = unfused(q.double(), k.double(), v.double())
    for fn in (F.scaled_dot_product_attention, encoder_module.attend, unfused):
        assert float((fn(q, k, v).double() - want).abs().max()) < tol
    attn = MultiHeadAttention(64, 4).to(dtype)
    x = torch.randn(2, tokens, 64, generator=g).to(dtype)
    with torch.no_grad():
        plain = attn(x)
        monkeypatch.setattr(encoder_module, "attend", F.scaled_dot_product_attention)
        fused = attn(x)
    assert float((fused.double() - plain.double()).abs().max()) < tol * 10


def test_attention_is_the_fused_kernel_on_the_card_and_flaxs_form_elsewhere(monkeypatch):
    calls = []

    def fused(q, k, v):
        calls.append(q.device.type)
        return unfused(q, k, v)

    monkeypatch.setattr(F, "scaled_dot_product_attention", fused)
    q = torch.randn(1, 2, 8, 4)
    assert torch.equal(encoder_module.attend(q, q, q), unfused(q, q, q)) and calls == []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    encoder_module.attend(q, q, q)
    assert calls == ["cpu"]


def gcl_config() -> dict:
    return registry.cell(registry.load_benchmark(ROOT), "satmae_gcl.scene96.b64")["config"]


def test_roofline_grouped_against_a_hand_count():
    cfg = gcl_config()["config"]
    d, n, length, mlp = 1024, 432, 144, 4096
    block = 2 * n * d * 3 * d + 2 * n * d * d + 2 * n * d * mlp * 2 + 2 * 2 * n * n * d
    embeds = 2 * length * d * 10 * 8 * 8 + 2 * 13 * d            # patch embeds, mask_cond
    assert sum(f for f, _ in roofline_grouped.encoder_ops(cfg)) == 24 * block + embeds
    # the decoder from the 12x12 grid of 3072 features: per stage the 2x2
    # upsample, the 1x1 skip fusion and two blocks of two 3x3 convs; the
    # head; the pyramid's stem and two stride-2 levels
    dec, prev = 0, 3072
    for ch, side in ((384, 24), (192, 48), (96, 96)):
        px = side * side
        dec += 2 * px * prev * ch + 2 * px * (ch + 32) * ch + 2 * 2 * 2 * 9 * ch * ch * px
        prev = ch
    px = 96 * 96
    dec += 2 * 9 * 96 * 96 * px + 2 * 96 * 13 * px + 2 * 9 * 13 * 32 * px
    dec += 2 * 9 * 32 * 32 * (px / 4 + px / 16)
    assert sum(f for f, _ in roofline_grouped.decoder_ops(cfg)) == pytest.approx(dec, rel=1e-12)
    assert roofline_grouped.forward_flops(cfg) == pytest.approx(24 * block + embeds + dec)
    assert 301e9 < roofline_grouped.forward_flops(cfg) < 303e9
    # a launch of B 64, 16 heads, 432 tokens, hd 64: its bytes bound it
    assert roofline_grouped.attention_bound(64, 16, 432, 64) == pytest.approx(
        4 * 64 * 16 * 432 * 64 * 2 / 3.35e12)
    assert roofline_grouped.attention_bound(1, 1, 4096, 128) == pytest.approx(
        4 * 4096 * 4096 * 128 / 989e12)
    bench = registry.load_benchmark(ROOT)
    for name, flops in (("flagship", 54.747483648e9), ("capacity2x", 134.770065408e9)):
        config = registry.cell(bench, f"{name}.scene.b64")["config"]["config"]
        assert roofline.forward_flops(config) == pytest.approx(flops, rel=1e-12)


def reader(name):
    return registry.metric_reader(name)


FLASH = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 64, 4>>"


def test_the_grouped_readers_on_a_synthetic_trace():
    cfg = gcl_config()["config"]
    extra = {"config": cfg, "tiles": 128, "batch": 64, "scenes": 1, "tokens": 432, "groups": 3}
    least = roofline_grouped.attention_bound(64, 16, 432, 64)
    device = [("sm90_gemm", 0.0, 0.5), (FLASH, 0.5, 0.5 + 2 * least),
              (FLASH, 0.6, 0.6 + 2 * least), ("resblock_kernel<384, 1>", 0.7, 0.8)]
    trace = Trace(device=device, spans=[], window_s=1.0, extra=extra)
    assert reader("scene.attention_roofline")(trace) == pytest.approx(50.0)
    want = 100 * roofline_grouped.forward_flops(cfg) * 128 / 1.0 / 989e12
    assert reader("scene.grouped_mfu")(trace) == pytest.approx(want)
    assert 0 < want < 100
    no_flash = Trace(device=device[:1], spans=[], window_s=1.0, extra=extra)
    assert reader("scene.attention_roofline")(no_flash) is None
    assert reader("scene.attention_roofline")(Trace(device, [], 1.0)) is None
    assert reader("scene.grouped_mfu")(Trace([], [], 1.0, extra=extra)) is None
    one_embed = dict(extra, config=registry.cell(registry.load_benchmark(ROOT),
                                                 "flagship.scene.b64")["config"]["config"])
    assert reader("scene.grouped_mfu")(Trace(device, [], 1.0, extra=one_embed)) is None


def imports_of(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("path", ["portbench/reference/grouped.py",
                                  "portbench/roofline_grouped.py",
                                  "portbench/metrics/scene.grouped_mfu.py",
                                  "portbench/metrics/scene.attention_roofline.py"])
def test_the_reference_and_counts_import_neither_jax_nor_the_port(path):
    found = imports_of(ROOT / path)
    assert not found & {"jax", "jaxlib", "flax", "optax", "msid_tpu", "msid_tpu_torch"}, found


def test_the_reference_computes_in_float32():
    model, ref = pair(tiny_config())
    assert {p.dtype for p in ref.parameters()} == {torch.float32}
    assert {t.dtype for t in ref.state_dict().values()} == {torch.float32}
    assert set(ref.state_dict()) == set(model.state_dict())
    cfg = copy.deepcopy(tiny_config())
    cfg["model"]["decoder"]["architecture"] = "unet_light"
    with pytest.raises(ValueError, match="unet_skip"):
        grouped.GroupRestorer(cfg)
