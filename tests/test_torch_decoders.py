"""The ``unet`` and ``attention`` decoders and their four blocks against the
JAX package's flax modules, on the CPU in fp32, train and eval mode, batch
and group norm.

Blocks: ``ConvBlock`` (identity and 1x1 residual; stride 2 and kernel 5,
where XLA's SAME pads (0, 1) and (1, 2)), ``DepthwiseSeparableConv``,
``SqueezeExcitation`` and ``SpatialAttention``, held to max-abs 1e-5. The
decoders and the whole ``SatMAERestoration`` with each (64^2 tiles, embed
64, depth 2, decoder 32/16/8/8) are held to relative RMS 1e-4, and so is
the loss gradient of a train-mode forward against ``jax.grad``. Weights
and statistics are seeded random values moved by the converter.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.models.blocks import ConvBlock as JaxConvBlock
from msid_tpu.models.blocks import DepthwiseSeparableConv as JaxDSConv
from msid_tpu.models.blocks import SpatialAttention as JaxSpatialAttention
from msid_tpu.models.blocks import SqueezeExcitation as JaxSqueezeExcitation
from msid_tpu.models.decoder import AttentionDecoder as JaxAttentionDecoder
from msid_tpu.models.decoder import UNetDecoder as JaxUNetDecoder
from msid_tpu_torch.deployment import fastpath
from msid_tpu_torch.deployment.export import MODULE_FILE, export_program
from msid_tpu_torch.deployment.inference import InferenceSession
from msid_tpu_torch.models.blocks import (
    ConvBlock,
    DepthwiseSeparableConv,
    SpatialAttention,
    SqueezeExcitation,
)
from msid_tpu_torch.models.decoder import AttentionDecoder, UNetDecoder
from msid_tpu_torch.models.from_jax import (
    _decoder,
    load_conv_block,
    load_depthwise_separable,
    load_jax_variables,
    load_spatial_attention,
    load_squeeze_excitation,
)
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.utils.config import load_config
from test_torch_layers import nchw, nhwc, randomized
from test_torch_model import randomize_variables

torch.set_num_threads(2)

BLOCK_ATOL = 1e-5      # fp32 blocks: one or two convs, summation order apart
MODEL_REL_RMS = 1e-4   # decoders, whole models and gradients: ~20 fp32 layers
TINY_CONFIG = Path(__file__).resolve().parent.parent / "configs/experiments/tiny_cpu.yaml"
SMALL = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             decoder_channels=(32, 16, 8, 8), gradient_checkpointing=False)


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def run_jax(module, variables, x, train, **kw):
    """The flax module's output and, in train mode, its new batch stats."""
    if not train:
        return np.asarray(module.apply(variables, jnp.asarray(x), **kw)), None
    y, updates = module.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"], **kw)
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, updates.get("batch_stats"))


def check_running_stats(port_module, loader, stats, params):
    """The port's running statistics after a train-mode forward equal the
    flax module's updated ``batch_stats`` (loaded into a fresh copy)."""
    if stats is None:
        return
    want = {k: v.clone() for k, v in port_module.state_dict().items()}
    loader(port_module, params, stats)
    for name, value in port_module.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(want[name].numpy(), value.numpy(), atol=BLOCK_ATOL)


# ---------------- the four blocks ----------------

# (name, in channels, the flax module, the port module, the loader)
BLOCK_CASES = {
    "conv_identity": (8, lambda n: JaxConvBlock(8, norm=n), lambda n: ConvBlock(8, 8, norm=n)),
    "conv_residual": (8, lambda n: JaxConvBlock(12, norm=n), lambda n: ConvBlock(8, 12, norm=n)),
    "conv_stride2": (8, lambda n: JaxConvBlock(8, stride=2, norm=n),
                     lambda n: ConvBlock(8, 8, stride=2, norm=n)),
    "conv_kernel5": (8, lambda n: JaxConvBlock(8, kernel_size=5, norm=n),
                     lambda n: ConvBlock(8, 8, kernel_size=5, norm=n)),
    "conv_kernel5_stride2": (8, lambda n: JaxConvBlock(12, kernel_size=5, stride=2, norm=n),
                             lambda n: ConvBlock(8, 12, kernel_size=5, stride=2, norm=n)),
    "dsconv": (8, lambda n: JaxDSConv(12, norm=n), lambda n: DepthwiseSeparableConv(8, 12, norm=n)),
    "dsconv_stride2": (8, lambda n: JaxDSConv(12, stride=2, norm=n),
                       lambda n: DepthwiseSeparableConv(8, 12, stride=2, norm=n)),
    "dsconv_kernel5": (8, lambda n: JaxDSConv(8, kernel_size=5, norm=n),
                       lambda n: DepthwiseSeparableConv(8, 8, kernel_size=5, norm=n)),
    "dsconv_kernel5_stride2": (8, lambda n: JaxDSConv(12, kernel_size=5, stride=2, norm=n),
                               lambda n: DepthwiseSeparableConv(8, 12, kernel_size=5,
                                                                stride=2, norm=n)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_normed_block_matches_flax(case, norm, train):
    cin, make_jax, make_port = BLOCK_CASES[case]
    loader = load_conv_block if case.startswith("conv") else load_depthwise_separable
    x = np.random.default_rng(0).normal(0, 1, (2, 16, 16, cin)).astype(np.float32)
    jm = make_jax(norm)
    variables = randomized(jm, x, seed=1)
    params, stats = variables["params"], variables.get("batch_stats")
    want, new_stats = run_jax(jm, variables, x, train)
    block = make_port(norm).train(train)
    loader(block, params, stats)
    with torch.no_grad():
        got = nhwc(block(nchw(x).contiguous(memory_format=torch.channels_last)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)
    check_running_stats(block, loader, new_stats, params)


def test_conv_block_names_its_convs_as_flax_does():
    """The 1x1 residual is ``Conv_0`` when there is one; its 3x3 convs then
    are ``Conv_1`` and ``Conv_2``."""
    x = np.zeros((1, 8, 8, 8), np.float32)
    assert set(randomized(JaxConvBlock(12), x, 0)["params"]) == {
        "Conv_0", "Conv_1", "Conv_2", "Norm_0", "Norm_1"}
    assert set(randomized(JaxConvBlock(8), x, 0)["params"]) == {
        "Conv_0", "Conv_1", "Norm_0", "Norm_1"}
    assert ConvBlock(8, 12).residual.weight.shape == (12, 8, 1, 1)
    assert ConvBlock(8, 8).residual is None
    assert ConvBlock(8, 8, stride=2).residual.stride == (2, 2)
    for block in (ConvBlock(8, 12), DepthwiseSeparableConv(8, 12)):
        assert all(m.bias is None for m in block.modules() if isinstance(m, torch.nn.Conv2d))


@pytest.mark.parametrize("channels", [8, 48])
def test_squeeze_excitation_matches_flax(channels):
    """``max(C // 4, 8)`` reduced channels: 8 for C=8, 12 for C=48."""
    x = np.random.default_rng(2).normal(0, 1, (2, 9, 7, channels)).astype(np.float32)
    jm = JaxSqueezeExcitation()
    variables = randomized(jm, x, seed=3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    se = SqueezeExcitation(channels)
    assert se.conv0.out_channels == max(channels // 4, 8)
    load_squeeze_excitation(se, variables["params"])
    with torch.no_grad():
        got = nhwc(se(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("size", [16, 11])
def test_spatial_attention_matches_flax(size):
    x = np.random.default_rng(4).normal(0, 1, (2, size, size, 8)).astype(np.float32)
    jm = JaxSpatialAttention()
    variables = randomized(jm, x, seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    sa = SpatialAttention(8)
    load_spatial_attention(sa, variables["params"])
    with torch.no_grad():
        got = nhwc(sa(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


# ---------------- the two decoders ----------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("arch", ["unet", "unet_skips", "attention"])
def test_decoder_matches_flax(arch, norm, train):
    channels = (32, 16, 8, 8)
    x = np.random.default_rng(6).normal(0, 1, (2, 4, 4, 64)).astype(np.float32)
    kwargs = {}
    if arch == "unet_skips":      # additive skips, consumed as skip_features[-(i + 1)]
        rng = np.random.default_rng(7)
        skips = [rng.normal(0, 1, (2, 4 * 2 ** (3 - k), 4 * 2 ** (3 - k), channels[2 - k]))
                 .astype(np.float32) for k in range(3)]     # stages 0-2, fine to coarse
        kwargs = {"skip_features": [jnp.asarray(s) for s in skips]}
    jm = (JaxAttentionDecoder if arch == "attention" else JaxUNetDecoder)(channels, norm=norm)
    variables = randomized(jm, x, seed=8) if not kwargs else jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), randomize_variables(
            jm.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs), 8))
    want, new_stats = run_jax(jm, variables, x, train, **kwargs)
    port = (AttentionDecoder if arch == "attention" else UNetDecoder)(
        64, channels, 13, norm).train(train)
    params, stats = variables["params"], variables.get("batch_stats")
    _decoder(port, params, stats)
    port_kwargs = {"skip_features": [nchw(s) for s in skips]} if kwargs else {}
    with torch.no_grad():
        got = nhwc(port(nchw(x), **port_kwargs))
    assert got.shape == want.shape == (2, 64, 64, 13)
    assert rel_rms(got, want) <= MODEL_REL_RMS
    check_running_stats(port, lambda m, p, s: _decoder(m, p, s), new_stats, params)


# ---------------- the whole model ----------------


def model_pair(arch, residual, seed=0):
    kwargs = dict(SMALL, decoder_arch=arch, residual_output=residual)
    jm = JaxModel(**kwargs, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, randomize_variables(
        init_model(jm, jax.random.PRNGKey(seed)), seed))
    model = SatMAERestoration(**kwargs)
    load_jax_variables(model, variables)
    return jm, variables, model


CASES = [("unet", False), ("attention", True)]


@pytest.mark.parametrize("arch,residual", CASES)
def test_model_eval_forward_matches_jax(arch, residual):
    jm, variables, model = model_pair(arch, residual)
    x = np.random.default_rng(9).normal(0, 0.5, (2, 64, 64, 13)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert rel_rms(got, want) <= MODEL_REL_RMS


@pytest.mark.parametrize("arch,residual", CASES)
def test_model_train_forward_and_loss_gradient_match_jax(arch, residual):
    """A train-mode forward (batch statistics), its new running stats, and
    the gradient of an MSE loss against ``jax.grad``; the JAX gradient tree
    goes through the converter, whose layout moves are linear."""
    jm, variables, model = model_pair(arch, residual, seed=1)
    rng = np.random.default_rng(10)
    x = rng.normal(0, 0.5, (2, 64, 64, 13)).astype(np.float32)
    target = rng.normal(0, 0.5, x.shape).astype(np.float32)

    def loss_fn(params):
        y, updates = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean((y - jnp.asarray(target)) ** 2), (y, updates["batch_stats"])

    (loss, (want, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    model.train()
    got = model(torch.from_numpy(x))
    port_loss = ((got - torch.from_numpy(target)) ** 2).mean()
    port_loss.backward()
    assert rel_rms(got.detach().numpy(), np.asarray(want)) <= MODEL_REL_RMS
    assert abs(port_loss.item() - float(loss)) <= MODEL_REL_RMS * float(loss)
    expected = SatMAERestoration(**dict(SMALL, decoder_arch=arch, residual_output=residual))
    load_jax_variables(expected, {"params": jax.tree_util.tree_map(np.asarray, grads),
                                  "batch_stats": jax.tree_util.tree_map(np.asarray, new_stats)})
    want_params = dict(expected.named_parameters())
    got_grads = np.concatenate([p.grad.numpy().ravel() for _, p in model.named_parameters()])
    want_grads = np.concatenate([want_params[n].detach().numpy().ravel()
                                 for n, _ in model.named_parameters()])
    assert rel_rms(got_grads, want_grads) <= MODEL_REL_RMS
    for name, value in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            ref = expected.state_dict()[name].numpy()
            assert rel_rms(value.numpy(), ref) <= MODEL_REL_RMS, name


@pytest.mark.parametrize("arch", ["unet", "attention"])
def test_from_config_builds_and_heads_as_jax(arch):
    """``from_config`` builds the decoder; under a global residual head only
    ``unet_light`` and ``unet_skip`` start from a zero head, as in the JAX
    model."""
    cfg = load_config(TINY_CONFIG)
    cfg["model"]["decoder"].update(architecture=arch, residual=True)
    model = SatMAERestoration.from_config(cfg, device="cpu")
    jm = JaxModel.from_config(cfg)
    assert model.decoder_arch == jm.decoder_arch == arch
    assert isinstance(model.decoder, AttentionDecoder if arch == "attention" else UNetDecoder)
    assert [c.conv0.out_channels for c in model.decoder.conv] == list(jm.decoder_channels)
    assert model.decoder.head.weight.abs().sum() > 0
    jax_head = init_model(jm, jax.random.PRNGKey(0))["params"]["decoder"]["head"]["kernel"]
    assert np.abs(np.asarray(jax_head)).sum() > 0
    cfg["model"]["decoder"]["architecture"] = "unet_light"
    assert SatMAERestoration.from_config(cfg, device="cpu").decoder.head_out.weight.abs().sum() == 0


@pytest.mark.parametrize("arch", ["unet", "attention"])
def test_served_by_the_module_forward_and_exported(arch, tmp_path):
    """The folded graphs refuse these decoders: ``optimize="auto"`` serves
    the module's forward at every batch and ``optimize=True`` raises; an
    export holds no fused-block node, and its artifact serves the model."""
    _, _, model = model_pair(arch, residual=False, seed=2)
    model.eval()
    assert not fastpath.supports_fastpath(model)
    x = np.random.default_rng(11).normal(0, 0.5, (8, 64, 64, 13)).astype(np.float32)
    for batch in (1, 8):
        session = InferenceSession(model, batch_size=batch, image_size=64, device="cpu")
        assert session.optimized is False
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    assert np.array_equal(session.predict(x), want)
    with pytest.raises(ValueError, match="unet_light/unet_skip"):
        InferenceSession(model, batch_size=1, image_size=64, device="cpu", optimize=True)
    path = export_program(model, tmp_path / arch, input_shape=(1, 64, 64, 13))
    program = torch.export.load(path / MODULE_FILE)
    assert not any(n.target is torch.ops.msid.fused_residual_block.default
                   for n in program.graph.nodes)
    artifact = InferenceSession(artifact_path=path, batch_size=1, image_size=64, device="cpu")
    np.testing.assert_allclose(artifact.predict(x[:2]), want[:2], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["unet", "attention"])
def test_export_cli_exports_and_verifies_the_decoder(arch, tmp_path):
    """``scripts.export --verify`` on the tiny recipe with the decoder set:
    its seeded model exported as a bf16 artifact whose live-vs-exported
    check passes (the CLI exits 1 otherwise)."""
    from msid_tpu_torch.scripts import export as export_cli

    config = tmp_path / "tiny.yaml"
    config.write_text("inherits: " + str(TINY_CONFIG)
                      + f"\nmodel:\n  decoder:\n    architecture: {arch}\n")
    path = export_cli.main(["--model-config", str(config), "--output", str(tmp_path / "m"),
                            "--verify", "--device", "cpu"])
    program = torch.export.load(path / MODULE_FILE)
    assert not any(n.target is torch.ops.msid.fused_residual_block.default
                   for n in program.graph.nodes)
