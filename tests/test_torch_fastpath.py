"""The port's folded-BN inference graphs against the JAX package's, on the CPU.

Counterpart of ``tests/test_fastpath.py``. Tiny ``unet_light`` and
``unet_skip`` models get seeded random weights and BatchNorm statistics
(``randomize_variables``), the converter copies them into the port, and the
same numpy input goes through the JAX function and the port's function of
the same name in fp32. Then the session's graph choice, the refusals, and
one test for each place where the two frameworks' conventions differ
(GELU form, transposed-conv flip, depth-to-space and patch layouts, the
folded attention scale, LayerNorm statistics, stride-2 padding, output
dtype, the order of fold and cast).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msid_tpu.deployment import fastpath as jfp
from msid_tpu.deployment import inference as jax_inference
from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.ops.noise import NoiseConfig as JaxNoiseConfig
from msid_tpu.training.losses import LossConfig as JaxLossConfig
from msid_tpu.training.train_state import make_eval_step as jax_make_eval_step
from msid_tpu_torch.deployment import fastpath, inference
from msid_tpu_torch.deployment.inference import InferenceSession
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.training.train_state import make_eval_step
from msid_tpu_torch.training.trainer import Trainer
from msid_tpu_torch.utils.setup_helpers import setup_training_session
from test_torch_model import randomize_variables

torch.set_num_threads(2)

TINY = dict(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            decoder_channels=(16, 16, 8, 8))
ARCHS = ("unet_light", "unet_skip")
ZERO_NOISE = dict(gaussian_sigma=0.0, speckle_sigma=0.0, dead_band_prob=0.0,
                  thermal_scale=0.0, enable_striping=False)
LOSS = dict(mse_weight=1.0, ssim_weight=0.1, sam_weight=0.05)
METRICS = ("loss", "psnr", "ssim", "sam", "rmse")


def build(arch, seed=0, **kw):
    """The JAX model with random variables and the port's copy of it."""
    kwargs = dict(TINY, decoder_arch=arch, **kw)
    jmodel = JaxModel(**kwargs, dtype=jnp.float32, gradient_checkpointing=False)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(seed)), seed)
    model = SatMAERestoration(**kwargs).eval()
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, model


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return build(request.param)


def tiles(b=2, seed=0):
    return np.random.default_rng(seed).normal(0, 0.5, (b, 32, 32, 13)).astype(np.float32)


def assert_close(got, want):
    """fp32 on both sides; only the order of summation differs, ~1e-6
    relative per op through ~20 layers: 1e-4 of the output's scale, as
    ``tests/test_torch_model.py`` holds the model."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


# ---------------- the graphs against the JAX functions of the same name ----------------


@pytest.mark.parametrize("matmul_upsample", [True, False])
def test_fast_forward_matches_jax(pair, matmul_upsample):
    jmodel, variables, model = pair
    x = tiles()
    want = jfp.make_fast_inference_fn(jmodel, matmul_upsample=matmul_upsample)(
        jfp.optimize_for_inference(jmodel, variables, dtype=jnp.float32), jnp.asarray(x))
    with torch.no_grad():
        tree = fastpath.optimize_for_inference(model, dtype=torch.float32)
        got = fastpath.make_fast_inference_fn(model, matmul_upsample=matmul_upsample)(
            tree, torch.from_numpy(x))
        apply = model(torch.from_numpy(x))
    assert_close(got, want)
    assert_close(got, apply.numpy())


def test_hybrid_inference_fn_matches_jax(pair):
    jmodel, variables, model = pair
    x = tiles(3, seed=1)
    want = jfp.make_hybrid_inference_fn(jmodel)(
        jfp.optimize_for_hybrid(jmodel, variables, dtype=jnp.float32), jnp.asarray(x))
    with torch.no_grad():
        weights = fastpath.optimize_for_hybrid(model, dtype=torch.float32)
        got = fastpath.make_hybrid_inference_fn(model)(weights, torch.from_numpy(x))
    assert set(weights) == {"enc", "dec"} and "up_ct" in weights["dec"]["stages"][0]
    assert "up_w" not in weights["dec"]["stages"][0]       # the hybrid reads only the ct form
    assert_close(got, want)


def test_hybrid_forward_folds_live_weights_like_jax(pair):
    """``make_hybrid_forward`` folds on every call: from the module's own
    weights (None) and from a dict of other weights, as the eval step hands
    it the EMA shadow."""
    jmodel, variables, model = pair
    x = tiles(2, seed=2)
    want = jfp.make_hybrid_forward(jmodel)(variables, jnp.asarray(x))
    forward = fastpath.make_hybrid_forward(model)
    with torch.no_grad():
        assert_close(forward(None, torch.from_numpy(x)), want)
        other = {k: v.clone() for k, v in model.state_dict().items()}
        for k in other:
            if k.endswith("running_var"):
                other[k] = other[k] * 1.5
        moved = forward(other, torch.from_numpy(x))
        assert float((moved - torch.from_numpy(np.array(want))).abs().max()) > 1e-3
        for k in other:
            if k.endswith("running_var"):
                other[k] = other[k] / 1.5
        assert_close(forward(other, torch.from_numpy(x)), want)


def _nchw_kernel(k):
    """A JAX HWIO conv kernel in torch's OIHW layout."""
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def test_folded_tree_equals_jax_leaf_by_leaf(pair):
    """The whole fastpath tree against ``optimize_for_inference`` of the JAX
    package, each leaf brought to the port's layout: the transposed-conv
    flip, the (di, dj, co) columns with the tiled bias, the (py, px, c)
    patch rows and the query scale all sit in these leaves."""
    jmodel, variables, model = pair
    want = jfp.optimize_for_inference(jmodel, variables, as_numpy=True)
    with torch.no_grad():
        got = fastpath.optimize_for_inference(model, dtype=torch.float32)
    close = lambda a, b, name: np.testing.assert_allclose(      # noqa: E731
        a.numpy(), np.asarray(b, np.float32), rtol=1e-5, atol=1e-6, err_msg=name)

    for name in ("patch_w", "patch_b", "pos_embed", "head_b", "out_b"):
        close(got[name], want[name], name)
    for i in range(2):
        close(got["patch_ln"][i], want["patch_ln"][i], "patch_ln")
        close(got["final_ln"][i], want["final_ln"][i], "final_ln")
    assert len(got["blocks"]) == len(want["blocks"]) == TINY["depth"]
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert set(gb) == set(wb)
        for name in ("wqkv", "bqkv", "wout", "bout", "w1", "b1", "w2", "b2"):
            close(gb[name], wb[name], name)
        for name in ("ln1", "ln2"):
            close(gb[name][0], wb[name][0], name)
            close(gb[name][1], wb[name][1], name)
    close(got["head_k"], _nchw_kernel(want["head_k"]), "head_k")
    close(got["out_k"], want["out_k"][0, 0], "out_k")
    assert len(got["stages"]) == len(want["stages"]) == 4
    for gs, ws in zip(got["stages"], want["stages"]):
        assert set(gs) == set(ws)
        close(gs["up_w"], ws["up_w"], "up_w")
        close(gs["up_b"], ws["up_b"], "up_b")
        # lax.conv_transpose applies its HWIO kernel flipped; torch's
        # [Cin, Cout, kh, kw] weight is the un-flipped one
        close(gs["up_ct"], np.transpose(ws["up_ct"][::-1, ::-1], (2, 3, 0, 1)), "up_ct")
        close(gs["up_ct_b"], ws["up_ct_b"], "up_ct_b")
        if "fuse_w" in ws:
            close(gs["fuse_w"], ws["fuse_w"], "fuse_w")
            close(gs["fuse_b"], ws["fuse_b"], "fuse_b")
        for gr, wr in zip(gs["res"], ws["res"]):
            for k, b in (("k1", "b1"), ("k2", "b2")):
                close(gr[k], _nchw_kernel(wr[k]), k)
                close(gr[b], wr[b], b)
    assert ("stem" in got) == ("stem" in want) == (model.decoder_arch == "unet_skip")
    for gl, wl in zip(got.get("stem", []), want.get("stem", [])):
        close(gl["k"], _nchw_kernel(wl["k"]), "stem k")
        close(gl["b"], wl["b"], "stem b")


def test_live_fold_equals_serving_fold_and_jax_device_fold(pair):
    """One ``fold_decoder`` serves the one-shot fold and the per-call fold
    (the JAX package needs a numpy and a traceable twin): the tree from a
    dict of weights equals the tree from the module, and the JAX device
    fold's leaves."""
    jmodel, variables, model = pair
    with torch.no_grad():
        from_module = fastpath.fold_decoder(model, None, torch.float32, upsample="ct")
        from_dict = fastpath.fold_decoder(model, dict(model.state_dict()), torch.float32,
                                          upsample="ct")
    dev = jfp.fold_decoder_jnp(
        variables["params"]["decoder"], variables["batch_stats"]["decoder"],
        num_stages=4, dtype=jnp.float32,
        stem_params=variables["params"].get("skip_stem"),
        stem_stats=variables["batch_stats"].get("skip_stem"))
    for gs, ds, ws in zip(from_module["stages"], from_dict["stages"], dev["stages"]):
        assert set(gs) == set(ds) == set(ws)
        assert torch.equal(gs["up_ct"], ds["up_ct"])
        np.testing.assert_allclose(
            gs["up_ct"].numpy(),
            np.transpose(np.asarray(ws["up_ct"])[::-1, ::-1], (2, 3, 0, 1)),
            rtol=1e-5, atol=1e-6)
        for gr, dr, wr in zip(gs["res"], ds["res"], ws["res"]):
            assert torch.equal(gr["k1"], dr["k1"]) and torch.equal(gr["b2"], dr["b2"])
            np.testing.assert_allclose(gr["k2"].numpy(), _nchw_kernel(wr["k2"]),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(from_module["head_b"].numpy(), np.asarray(dev["head_b"]),
                               rtol=1e-5, atol=1e-6)


def raw_batch(seed=3):
    return np.random.default_rng(seed).uniform(0, 10000, (4, 32, 32, 13)).astype(np.float32)


def test_eval_step_hybrid_matches_jax_and_apply(pair):
    jmodel, variables, model = pair
    batch = raw_batch()
    want = jax_make_eval_step(jmodel, JaxLossConfig(**LOSS), JaxNoiseConfig(**ZERO_NOISE),
                              image_size=32, noise_impl="jnp", forward_impl="hybrid")(
        variables, jnp.asarray(batch), jax.random.PRNGKey(0), jnp.int32(3))
    steps = {impl: make_eval_step(model, LossConfig(**LOSS), NoiseConfig(**ZERO_NOISE),
                                  image_size=32, noise_impl="jnp", forward_impl=impl)
             for impl in ("hybrid", "apply", "auto")}
    got = {impl: step(batch, 0, 3) for impl, step in steps.items()}
    assert float(got["hybrid"]["count"]) == 3.0
    for key in METRICS:
        # fp32 both sides, sums in another order (tests/test_torch_evaluate.py)
        np.testing.assert_allclose(float(got["hybrid"][key]), float(want[key]), rtol=1e-4,
                                   err_msg=key)
        np.testing.assert_allclose(float(got["hybrid"][key]), float(got["apply"][key]),
                                   rtol=1e-4, err_msg=key)
        assert float(got["auto"][key]) == float(got["apply"][key])     # auto stays apply
    # the hybrid step scores the weights it is handed, not only the module's
    shadow = {k: v.clone() for k, v in model.state_dict().items()}
    shadow["decoder.head_out.bias"] = shadow["decoder.head_out.bias"] + 0.5
    moved = steps["hybrid"](batch, 0, 3, shadow)
    assert abs(float(moved["psnr"]) - float(got["hybrid"]["psnr"])) > 1e-3
    same = steps["hybrid"](batch, 0, 3, dict(model.state_dict()))
    assert float(same["psnr"]) == pytest.approx(float(got["hybrid"]["psnr"]), rel=1e-6)


def test_eval_step_hybrid_under_bf16_autocast(pair):
    """The validation pass of a mixed-precision run: the decoder is folded
    in fp32 and cast to the autocast dtype, and the step stays close to the
    apply graph (bf16 keeps ~3 digits; the two graphs round at different
    places)."""
    _, _, model = pair
    batch = raw_batch(seed=5)
    got = {impl: make_eval_step(model, LossConfig(**LOSS), NoiseConfig(**ZERO_NOISE),
                                image_size=32, noise_impl="jnp", forward_impl=impl,
                                compute_dtype=torch.bfloat16)(batch, 0, 4)
           for impl in ("hybrid", "apply")}
    fp32 = make_eval_step(model, LossConfig(**LOSS), NoiseConfig(**ZERO_NOISE), image_size=32,
                          noise_impl="jnp", forward_impl="hybrid")(batch, 0, 4)
    for key in METRICS:
        np.testing.assert_allclose(float(got["hybrid"][key]), float(got["apply"][key]),
                                   rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(float(got["hybrid"][key]), float(fp32[key]),
                                   rtol=5e-2, err_msg=key)
    assert float(got["hybrid"]["psnr"]) != float(fp32["psnr"])      # it did run in bf16


@pytest.mark.parametrize("arch", ARCHS)
def test_residual_head_in_every_graph(arch):
    jmodel, variables, model = build(arch, seed=1, residual_output=True)
    x = tiles(2, seed=4)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        tree = fastpath.optimize_for_inference(model)
        fast = fastpath.make_fast_inference_fn(model)(tree, xt)
        hybrid = fastpath.make_hybrid_inference_fn(model)(fastpath.optimize_for_hybrid(model), xt)
        live = fastpath.make_hybrid_forward(model)(None, xt)
        # the flag is wired in: without it the output differs by the input
        bare = fastpath.fast_forward(tree, xt, patch_size=16, num_heads=4, residual=False)
    for got in (fast, hybrid, live):
        assert_close(got, want)
    np.testing.assert_allclose((fast - bare).numpy(), x, rtol=0, atol=1e-5)


def test_trainer_validates_through_the_hybrid_graph(tmp_path):
    """``training.eval_forward: hybrid`` reaches the eval step: the tiny
    recipe's validation metrics equal the apply graph's."""
    from msid_tpu_torch.utils.config import load_config
    from test_torch_evaluate import TINY_CONFIG

    config = load_config(TINY_CONFIG)
    session = setup_training_session(config, synthetic=True, device="cpu", seed=0,
                                     output_dir=tmp_path)
    out = {}
    for impl in ("apply", "hybrid"):
        trainer = Trainer(session["model"], session["state"],
                          dict(config, training=dict(config["training"], eval_forward=impl)),
                          device="cpu")
        out[impl] = trainer.validate(session["val_loader"])
    for key in METRICS:
        np.testing.assert_allclose(out["hybrid"][key], out["apply"][key], rtol=1e-4, err_msg=key)


def test_evaluate_cli_forward_hybrid_equals_apply(tmp_path):
    from msid_tpu_torch.scripts import evaluate as evaluate_cli
    from test_torch_evaluate import TINY_CONFIG

    out = {}
    for impl in ("apply", "hybrid"):
        out[impl] = evaluate_cli.main([
            "--config", str(TINY_CONFIG), "--synthetic", "--device", "cpu",
            "--forward", impl, "--output-dir", str(tmp_path / impl)])
        assert out[impl]["provenance"]["forward"] == impl
    for key in METRICS:
        np.testing.assert_allclose(out["hybrid"][key], out["apply"][key], rtol=1e-4, err_msg=key)


# ---------------- the session's choice of graph ----------------


def test_switch_points_are_the_jax_packages():
    assert inference.HYBRID_AUTO_MIN_BATCH == jax_inference.HYBRID_AUTO_MIN_BATCH == 8
    assert inference.FASTPATH_AUTO_MAX_BATCH == jax_inference.FASTPATH_AUTO_MAX_BATCH == 0


@pytest.mark.parametrize("batch,optimize,want", [
    (1, "auto", False), (7, "auto", False), (8, "auto", "hybrid"), (16, "auto", "hybrid"),
    (1, True, "fastpath"), (8, True, "fastpath"), (8, False, False), (1, False, False),
])
def test_session_optimized_by_batch_size(pair, batch, optimize, want):
    _, _, model = pair
    session = InferenceSession(model, batch_size=batch, image_size=32, device="cpu",
                               optimize=optimize)
    assert session.optimized == want and type(session.optimized) is type(want)
    x = tiles(1, seed=5)
    got = session.predict(np.repeat(x, batch, axis=0))
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4 * float(np.abs(ref).max()))


def test_session_picks_the_upsample_form_by_decoder(pair, monkeypatch):
    """``optimize=True``: matmul + depth-to-space for unet_light, the
    conv-transpose form for unet_skip, and the tree carries only that form."""
    _, _, model = pair
    seen = {}
    real = fastpath.optimize_for_inference

    def spy(model, dtype=None, upsample="both", variables=None):
        seen["upsample"] = upsample
        return real(model, dtype=dtype, upsample=upsample, variables=variables)

    monkeypatch.setattr(fastpath, "optimize_for_inference", spy)
    InferenceSession(model, batch_size=1, image_size=32, device="cpu", optimize=True)
    assert seen["upsample"] == ("ct" if model.decoder_arch == "unet_skip" else "matmul")


def test_session_tta_wraps_the_chosen_graph(pair):
    _, _, model = pair
    x = np.repeat(tiles(1, seed=6), 8, axis=0)
    plain = InferenceSession(model, batch_size=8, image_size=32, device="cpu", optimize=False,
                             tta=4)
    hybrid = InferenceSession(model, batch_size=8, image_size=32, device="cpu", tta=4)
    one = InferenceSession(model, batch_size=8, image_size=32, device="cpu")
    assert hybrid.optimized == "hybrid" and hybrid.tta == 4
    a, b, c = plain.predict(x), hybrid.predict(x), one.predict(x)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * float(np.abs(a).max()))
    assert float(np.abs(b - c).max()) > 1e-4          # four views are not one view
    with pytest.raises(ValueError, match="optimize"):
        InferenceSession(model, batch_size=1, image_size=32, device="cpu", optimize="fast")


# ---------------- refusals ----------------


def _unsupported(case):
    if case == "input_fill":
        return SatMAERestoration(**TINY, decoder_arch="unet_skip", input_fill=True).eval()
    if case == "group_norm":
        return SatMAERestoration(**TINY, norm="group").eval()
    model = SatMAERestoration(**TINY).eval()
    model.decoder_arch = "unet"           # a decoder the graphs were not scheduled for
    return model


@pytest.mark.parametrize("case,match", [
    ("input_fill", "input_fill"), ("group_norm", "norm='batch'"), ("decoder", "unet_light/unet_skip"),
])
def test_unsupported_models_are_refused_everywhere(case, match):
    model = _unsupported(case)
    assert not fastpath.supports_fastpath(model)
    for fn in (fastpath.optimize_for_inference, fastpath.optimize_for_hybrid,
               fastpath.make_hybrid_forward, fastpath.fold_decoder):
        with pytest.raises(ValueError, match=match):
            fn(model)
    with pytest.raises(ValueError, match=match):
        InferenceSession(model, batch_size=1, image_size=32, device="cpu", optimize=True)
    # "auto" serves the module's forward instead, at any batch size
    for batch in (1, 8):
        session = InferenceSession(model, batch_size=batch, image_size=32, device="cpu")
        assert session.optimized is False
        assert np.isfinite(session.predict(tiles(batch))).all()
    with pytest.raises(ValueError, match="hybrid"):
        make_eval_step(model, image_size=32, forward_impl="hybrid")
    make_eval_step(model, image_size=32, forward_impl="auto")          # auto stays apply


def test_supported_models_and_bad_upsample():
    for arch in ARCHS:
        assert fastpath.supports_fastpath(SatMAERestoration(**TINY, decoder_arch=arch))
        assert jfp.supports_fastpath(JaxModel(**TINY, decoder_arch=arch))
    assert not jfp.supports_fastpath(JaxModel(**TINY, decoder_arch="unet_skip", input_fill=True))
    with pytest.raises(ValueError, match="matmul|ct|both"):
        fastpath.optimize_for_inference(SatMAERestoration(**TINY), upsample="shuffle")


def test_hybrid_eval_refuses_ensembles():
    model = SatMAERestoration(**TINY)
    with pytest.raises(ValueError, match="not hybrid"):
        make_eval_step(model, image_size=32, forward_impl="hybrid", ensemble_size=2)


# ---------------- one test per numerics trap ----------------


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to ``approximate=True``; torch's default is erf."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = fastpath.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_conv_transpose_kernel_is_not_flipped_twice(pair):
    """The converter already un-flipped the flax kernel for
    ``ConvTranspose2d``; the matmul upsample built from it must equal the
    module's own transposed conv, and a second flip must not."""
    _, _, model = pair
    rng = np.random.default_rng(7)
    with torch.no_grad():
        tree = fastpath.fold_decoder(model, None, torch.float32, upsample="both")
        up = model.decoder.up[0]
        y = torch.from_numpy(rng.normal(0, 1, (2, TINY["embed_dim"], 2, 2)).astype(np.float32))
        want = up.norm(up.conv(y))                                  # eval-mode BN
        stage = {**tree["stages"][0], "res": []}
        if "fuse_w" in stage:
            del stage["fuse_w"]
        head = {"stages": [stage]}

        def upsampled(st, mm):
            # _fast_decode's upsample, before its GELU: invert the GELU-free part
            bb, _, hh, ww = y.shape
            if mm:
                cout = st["up_w"].shape[1] // 4
                u = y.permute(0, 2, 3, 1).reshape(bb * hh * ww, -1) @ st["up_w"] + st["up_b"]
                u = u.reshape(bb, hh, ww, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
                return u.reshape(bb, hh * 2, ww * 2, cout).permute(0, 3, 1, 2)
            return F.conv_transpose2d(y, st["up_ct"], stride=2) + st["up_ct_b"][:, None, None]

        np.testing.assert_allclose(upsampled(stage, True).numpy(), want.numpy(), atol=1e-5)
        np.testing.assert_allclose(upsampled(stage, False).numpy(), want.numpy(), atol=1e-5)
        flipped = dict(stage, up_ct=stage["up_ct"].flip(2, 3))
        assert float((upsampled(flipped, False) - want).abs().max()) > 1e-2
    assert head["stages"][0]["up_w"].shape == (TINY["embed_dim"], 4 * 16)


def test_depth_to_space_layout_and_tiled_bias():
    """``_fast_decode`` with the matmul upsample equals the conv-transpose
    form: columns ordered (di, dj, co), the bias tiled over the four block
    positions."""
    _, _, model = build("unet_light", seed=2)
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.normal(0, 1, (2, TINY["embed_dim"], 2, 2)).astype(np.float32))
    with torch.no_grad():
        tree = fastpath.fold_decoder(model, None, torch.float32, upsample="both")
        a = fastpath._fast_decode(tree, y, matmul_upsample=True)
        b = fastpath._fast_decode(tree, y, matmul_upsample=False)
        cout = tree["stages"][0]["up_ct_b"].shape[0]
        assert torch.equal(tree["stages"][0]["up_b"], tree["stages"][0]["up_ct_b"].repeat(4))
        assert tree["stages"][0]["up_b"].shape == (4 * cout,)
    assert a.shape == (2, 13, 32, 32) and a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_patch_embed_rows_are_py_px_c(pair):
    """torch's Conv2d weight is [D, C, p, p]; the patches are flattened
    (py, px, c): the matmul must equal the strided conv."""
    _, _, model = pair
    x = torch.from_numpy(tiles(2, seed=9))
    with torch.no_grad():
        tree = fastpath.optimize_for_inference(model)
        p, c = 16, 13
        patches = x.reshape(2, 2, p, 2, p, c).permute(0, 1, 3, 2, 4, 5).reshape(2, 4, p * p * c)
        got = patches @ tree["patch_w"] + tree["patch_b"]
        want = model.encoder.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_query_scale_is_folded_once(pair):
    _, _, model = pair
    with torch.no_grad():
        tree = fastpath.optimize_for_inference(model)
    d, heads = TINY["embed_dim"], TINY["num_heads"]
    attn = model.encoder.blocks[0].attn
    scale = 1.0 / np.sqrt(d // heads)
    blk = tree["blocks"][0]
    assert blk["wqkv"].shape == (d, 3 * d) and blk["bqkv"].shape == (3 * d,)
    np.testing.assert_allclose(blk["wqkv"][:, :d].numpy(),
                               attn.query.weight.detach().numpy().T * scale, rtol=1e-6)
    np.testing.assert_allclose(blk["bqkv"][:d].numpy(),
                               attn.query.bias.detach().numpy() * scale, rtol=1e-6)
    np.testing.assert_allclose(blk["wqkv"][:, d:2 * d].numpy(),
                               attn.key.weight.detach().numpy().T, rtol=1e-6)
    np.testing.assert_allclose(blk["bqkv"][2 * d:].numpy(),
                               attn.value.bias.detach().numpy(), rtol=1e-6)


def test_layer_norm_has_fp32_statistics_and_eps_1e_6():
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1e-3, (3, 5, 64)).astype(np.float32)      # small: eps matters
    scale, bias = (rng.normal(1, 0.1, 64).astype(np.float32),
                   rng.normal(0, 0.1, 64).astype(np.float32))
    for dtype, jdtype, atol in ((torch.float32, jnp.float32, 1e-5),
                                (torch.bfloat16, jnp.bfloat16, 2e-2)):
        want = np.asarray(jfp._layer_norm(jnp.asarray(x, jdtype), jnp.asarray(scale),
                                          jnp.asarray(bias)).astype(jnp.float32))
        got = fastpath._layer_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
                                   torch.from_numpy(bias))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    wrong = F.layer_norm(torch.from_numpy(x), (64,), torch.from_numpy(scale),
                         torch.from_numpy(bias), 1e-5).numpy()
    assert np.abs(wrong - want).max() > 1e-1         # torch's default eps is another function


def test_stem_stride_2_pads_like_same():
    """XLA's SAME padding of a stride-2 3x3 conv on an even size pads (0, 1),
    torch's ``padding=1`` pads (1, 1): the folded InputPyramid against the
    JAX ``_stem_features`` on the same tile."""
    jmodel, variables, model = build("unet_skip", seed=3)
    x = tiles(2, seed=11)
    jtree = jfp.optimize_for_inference(jmodel, variables, dtype=jnp.float32)
    want = jfp._stem_features(jtree["stem"], jnp.asarray(x))
    with torch.no_grad():
        tree = fastpath.fold_decoder(model, None, torch.float32)
        got = fastpath._stem_features(tree["stem"], torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [(4, 4), (8, 8), (16, 16), (32, 32)]
    for g, w in zip(got, want):                      # coarse -> fine on both sides
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)


def test_head_and_fuse_are_channel_matmuls(pair):
    _, _, model = pair
    rng = np.random.default_rng(12)
    with torch.no_grad():
        tree = fastpath.fold_decoder(model, None, torch.float32)
        y = torch.from_numpy(rng.normal(0, 1, (2, 8, 6, 6)).astype(np.float32))
        got = fastpath._channel_matmul(y, tree["out_k"], tree["out_b"])
        want = model.decoder.head_out(y)
    assert tree["out_k"].shape == (8, 13)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_bf16_tree_is_folded_in_fp32_and_cast_once(pair):
    """Weights are folded in fp32 and rounded once; biases are in the
    compute dtype; the output is fp32 and the residual adds the un-cast
    input."""
    _, _, model = pair
    with torch.no_grad():
        full = fastpath.optimize_for_inference(model, dtype=torch.float32)
        half = fastpath.optimize_for_inference(model, dtype=torch.bfloat16)
    flat = lambda t: (torch.utils._pytree.tree_leaves(t))          # noqa: E731
    for a, b in zip(flat(full), flat(half)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)
    x = torch.from_numpy(tiles(1, seed=13))
    with torch.no_grad():
        bare = fastpath.fast_forward(half, x, patch_size=16, num_heads=4)
        res = fastpath.fast_forward(half, x, patch_size=16, num_heads=4, residual=True)
        ref = fastpath.fast_forward(full, x, patch_size=16, num_heads=4)
    assert bare.dtype == torch.float32 and res.dtype == torch.float32
    # the fp32 input itself is added, not its bf16 rounding (which is off by up to 2^-9 |x|)
    np.testing.assert_allclose((res - bare).numpy(), x.numpy(), rtol=0, atol=1e-6)
    assert float((x.bfloat16().float() - x).abs().max()) > 1e-4
    rms = float((bare - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert 0 < rms < 5e-2                                        # bf16 keeps ~3 digits


def test_attention_softmax_runs_in_fp32(pair, monkeypatch):
    _, _, model = pair
    seen = []
    real = torch.softmax

    def spy(t, dim):
        seen.append(t.dtype)
        return real(t, dim=dim)

    monkeypatch.setattr(fastpath.torch, "softmax", spy)
    with torch.no_grad():
        tree = fastpath.optimize_for_inference(model, dtype=torch.bfloat16)
        fastpath.fast_forward(tree, torch.from_numpy(tiles(1)), patch_size=16, num_heads=4)
    assert seen == [torch.float32] * TINY["depth"]
