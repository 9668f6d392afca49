"""The port's export (``msid_tpu_torch/deployment/export.py``) on the CPU: the
cases of ``tests/test_export.py`` on the port, the port's artifact against
the JAX package's artifact on the same converted weights, the fused block
as one custom-op node per batch-norm ResidualBlock, the TF32 flags around
an fp32 artifact and the device-type check.

The models are the JAX test's ``SMALL`` (GroupNorm: no fused block) and a
batch-norm variant, whose eight decoder blocks are the custom operator
``msid::fused_residual_block`` in the exported graph. Weights are seeded
random values (JAX init, then every leaf redrawn) moved by the converter.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.deployment.export import export_stablehlo as jax_export_stablehlo
from msid_tpu.deployment.export import load_exported as jax_load_exported
from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu_torch.deployment.export import (
    META_FILE,
    MODULE_FILE,
    _flatten_variables,
    _unflatten_variables,
    compare_live_vs_exported,
    export_program,
    load_exported,
    make_inference_fn,
    verify_exported_model,
)
from msid_tpu_torch.deployment.inference import InferenceSession
from msid_tpu_torch.models.blocks import Norm, ResidualBlock
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops import cuda_decoder
from msid_tpu_torch.ops.tta import dihedral_ensemble

torch.set_num_threads(2)

SMALL = dict(image_size=64, patch_size=16, embed_dim=64, depth=1, num_heads=2,
             decoder_channels=(16, 8, 8, 8), gradient_checkpointing=False, norm="group")
SMALL_BN = dict(SMALL, norm="batch")
OPT_SMALL = dict(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                 decoder_channels=(16, 16, 8, 8), gradient_checkpointing=False)
SHAPE = (1, 64, 64, 13)
JAX_ARTIFACT_REL_RMS = 1e-4     # fp32 on both sides, summation order apart
OP = torch.ops.msid.fused_residual_block.default


def randomize(variables, seed=0):
    """Seeded random values for every leaf (the zero-init head and identity
    statistics would hide most of the network from a comparison)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            v = rng.uniform(0.5, 2.0, x.shape)
        elif name == "scale":
            v = rng.normal(1, 0.1, x.shape)
        elif name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(x.shape[:-1])), x.shape)
        else:
            v = rng.normal(0, 0.1, x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def models(kwargs, seed=0, dtype=torch.float32):
    """The JAX model and its variables, and the port model with them."""
    jmodel = JaxModel(**kwargs, dtype=jnp.float32)
    variables = randomize(init_model(jmodel, jax.random.PRNGKey(seed)), seed)
    model = SatMAERestoration(**kwargs).eval()
    load_jax_variables(model, variables)
    return jmodel, variables, model.set_compute_dtype(dtype)


def tiles(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-2, 2, shape)
                            .astype(np.float32))


def rel_rms(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    _, _, model = models(SMALL_BN)
    out = tmp_path_factory.mktemp("export") / "artifact"
    path = export_program(model, out, input_shape=SHAPE)
    return model, path


def test_artifact_layout_weights_not_baked(exported):
    """The weights live in params.npz and are program inputs: the program
    holds no state and no constants, and module.pt2 stays small."""
    model, path = exported
    assert (path / MODULE_FILE).exists() and (path / "params.npz").exists()
    param_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    assert (path / MODULE_FILE).stat().st_size < max(2_000_000, param_bytes // 2)
    program = torch.export.load(path / MODULE_FILE)
    assert not program.state_dict and not program.constants
    with np.load(path / "params.npz") as z:
        assert list(z.files) == list(model.state_dict())
    meta = json.loads((path / META_FILE).read_text())
    assert meta["device_type"] == "cpu" and meta["dtype"] == "float32"
    assert meta["torch"] == torch.__version__ and meta["optimized"] is False


def test_verify_and_dynamic_batch(exported):
    _, path = exported
    assert verify_exported_model(path, input_shape=SHAPE, batch_sizes=(1, 3), device="cpu")


def test_numerical_parity(exported):
    model, path = exported
    result = compare_live_vs_exported(model, None, path, input_shape=(2, 64, 64, 13))
    assert result.allclose
    assert result.cosine_similarity > 0.999999


def test_roundtrip_matches_live(exported):
    model, path = exported
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 64, 64, 13))
                         .astype(np.float32))
    with torch.no_grad():
        live = make_inference_fn(model)(None, x)
    np.testing.assert_allclose(load_exported(path, "cpu")(x).numpy(), live.numpy(), atol=1e-5)


def test_inference_session_predict_and_benchmark(exported):
    model, path = exported
    session = InferenceSession(model, batch_size=2, image_size=64, device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 13)).astype(np.float32)
    y = session.predict(x)
    assert y.shape == x.shape and np.isfinite(y).all()
    with pytest.raises(ValueError, match="4D"):
        session.predict(x[0])
    with pytest.raises(ValueError, match="batch"):
        session.predict(np.repeat(x, 2, axis=0))

    # artifact-backed session: the program with its payload, no model
    s2 = InferenceSession(artifact_path=path, batch_size=1, image_size=64, device="cpu")
    assert s2.model is None and s2.compiled is None and s2.dtype == torch.float32
    y2 = s2.predict(x[:1])
    assert y2.shape == (1, 64, 64, 13)
    np.testing.assert_allclose(y2, y[:1], atol=1e-5)
    with pytest.raises(RuntimeError, match="CUDA events"):   # no device time on the CPU
        s2.benchmark(warmup_runs=1, benchmark_iterations=2)
    with pytest.raises(ValueError, match="tta ensembling needs model"):
        InferenceSession(artifact_path=path, image_size=64, device="cpu", tta=2)
    with pytest.raises(ValueError, match="model or artifact_path"):
        InferenceSession(image_size=64, device="cpu")


def test_int8_artifact(tmp_path):
    _, _, model = models(SMALL)
    path = export_program(model, tmp_path / "q", input_shape=SHAPE, int8_weights=True)
    assert (path / "params_int8.npz").exists()
    assert not (path / "params.npz").exists()
    fp32 = sum(t.numel() * 4 for t in model.state_dict().values())
    assert (path / "params_int8.npz").stat().st_size < fp32 / 2.5
    assert verify_exported_model(path, input_shape=SHAPE, device="cpu")
    result = compare_live_vs_exported(model, None, path, input_shape=(2, 64, 64, 13),
                                      rtol=0.5, atol=0.5)
    # int8 weight rounding: outputs close but not exact
    assert result.cosine_similarity > 0.98
    assert result.max_abs_diff > 0


@pytest.fixture(scope="module")
def exported_optimized(tmp_path_factory):
    _, _, model = models(OPT_SMALL)
    out = tmp_path_factory.mktemp("export_opt") / "artifact"
    path = export_program(model, out, input_shape=(1, 32, 32, 13), optimize=True)
    return model, path


def test_optimized_artifact_meta_and_layout(exported_optimized):
    _, path = exported_optimized
    meta = json.loads((path / META_FILE).read_text())
    assert meta["optimized"] is True and meta["dtype"] == "float32"
    # the fastpath payload round-trips its nested lists (blocks#i keys)
    with np.load(path / "params.npz") as z:
        assert any("#" in k for k in z.files)
        assert any(k.startswith("blocks#0/") for k in z.files)
    # the folded graph runs library convs: no fused-block node
    program = torch.export.load(path / MODULE_FILE)
    assert not any(n.target is OP for n in program.graph.nodes)


def test_optimized_artifact_parity_and_dynamic_batch(exported_optimized):
    model, path = exported_optimized
    assert verify_exported_model(path, input_shape=(1, 32, 32, 13), batch_sizes=(1, 3),
                                 device="cpu")
    # fp32: the rewritten graph (fused QKV, folded BN) still matches the module
    result = compare_live_vs_exported(model, None, path, input_shape=(2, 32, 32, 13),
                                      rtol=2e-3, atol=1e-4)
    assert result.cosine_similarity > 0.99999
    assert result.max_abs_diff < 1e-2


def test_optimized_session_from_artifact(exported_optimized):
    _, path = exported_optimized
    s = InferenceSession(artifact_path=path, batch_size=1, image_size=32, device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (1, 32, 32, 13)).astype(np.float32)
    y = s.predict(x)
    assert y.shape == x.shape and np.isfinite(y).all()


def test_optimized_rejects_int8_combo(tmp_path):
    _, _, model = models(OPT_SMALL)
    with pytest.raises(ValueError, match="int8"):
        export_program(model, tmp_path / "bad", input_shape=(1, 32, 32, 13),
                       optimize=True, int8_weights=True)


def test_flatten_roundtrip_with_lists():
    tree = {
        "a": np.arange(3.0),
        "blocks": [
            {"w": np.ones((2, 2)), "ln": [np.zeros(2), np.ones(2)]},
            {"w": np.full((2, 2), 2.0), "ln": [np.ones(2), np.zeros(2)]},
        ],
        "nested": {"stages": [{"res": [{"k": np.eye(2)}]}]},
    }
    back = _unflatten_variables(_flatten_variables(tree))
    la, lb = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 2
    assert isinstance(back["blocks"][0]["ln"], list)
    assert isinstance(back["nested"]["stages"][0]["res"], list)


def test_flatten_roundtrip_empty_list():
    """num_residual_blocks=0 gives stage['res'] == [] — must round-trip."""
    tree = {"stages": [{"res": [], "w": np.ones(2)}], "top": []}
    back = _unflatten_variables(_flatten_variables(tree))
    assert back["stages"][0]["res"] == []
    assert back["top"] == []
    np.testing.assert_array_equal(np.asarray(back["stages"][0]["w"]), np.ones(2))
    with pytest.raises(ValueError, match="empty dict"):
        _flatten_variables({"a": {}})


def test_tta_export_matches_live_ensemble(tmp_path):
    """A tta=8 artifact bakes the dihedral ensemble into the program;
    meta.json records it and the comparator ensembles its live side."""
    _, _, model = models(SMALL_BN)
    path = export_program(model, tmp_path / "tta", input_shape=SHAPE, tta=8)
    assert json.loads((path / META_FILE).read_text())["tta"] == 8
    x = tiles((2, 64, 64, 13))
    infer = make_inference_fn(model)
    with torch.no_grad():
        want = dihedral_ensemble(lambda z: infer(None, z), x, 8).numpy()
        single = infer(None, x).numpy()
    got = load_exported(path, "cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got, single, atol=1e-4)
    program = torch.export.load(path / MODULE_FILE)
    assert sum(n.target is OP for n in program.graph.nodes) == 8 * 8
    assert compare_live_vs_exported(model, None, path, input_shape=(2, 64, 64, 13)).allclose


def test_tta_views_share_the_weight_operands(tmp_path):
    """The dihedral views of a tta artifact share their weight-only
    operands: each batch norm is folded once in the program (one rsqrt a
    norm), not once a view, while each view runs its 8 fused blocks."""
    _, _, model = models(SMALL_BN)
    norms = sum(isinstance(m, Norm) and m.kind == "batch" for m in model.modules())
    for tta in (1, 8):
        path = export_program(model, tmp_path / f"tta{tta}", input_shape=SHAPE, tta=tta)
        nodes = torch.export.load(path / MODULE_FILE).graph.nodes
        assert sum(n.target is torch.ops.aten.rsqrt.default for n in nodes) == norms == 21
        assert sum(n.target is OP for n in nodes) == 8 * tta


def test_optimized_export_unet_skip_roundtrip(tmp_path):
    """The unet_skip fastpath tree (stem list, per-stage fuse weights)
    survives the flat npz and matches the live model."""
    _, _, model = models(dict(image_size=32, patch_size=16, embed_dim=64, depth=1,
                              num_heads=4, decoder_arch="unet_skip",
                              decoder_channels=(16, 8, 8, 8), gradient_checkpointing=False))
    path = export_program(model, tmp_path / "skip_opt", input_shape=(1, 32, 32, 13),
                          optimize=True, dynamic_batch=False)
    with np.load(path / "params.npz") as z:
        assert any(k.startswith("stem#0/") for k in z.files)
        assert any("fuse_w" in k for k in z.files)
    result = compare_live_vs_exported(model, None, path, input_shape=(1, 32, 32, 13),
                                      rtol=2e-3, atol=1e-4)
    assert result.cosine_similarity > 0.99999


@pytest.mark.parametrize("kwargs", [SMALL, SMALL_BN], ids=["group", "batch"])
def test_artifact_matches_the_jax_artifact(kwargs, tmp_path):
    """The port's exported and reloaded fp32 artifact against the JAX
    package's on the same converted weights and the same input."""
    jmodel, variables, model = models(kwargs, seed=3)
    jax_path = jax_export_stablehlo(jmodel, variables, tmp_path / "jax", input_shape=SHAPE)
    path = export_program(model, tmp_path / "port", input_shape=SHAPE)
    x = tiles((2, 64, 64, 13), seed=4).numpy()
    want = np.asarray(jax_load_exported(jax_path)(jnp.asarray(x)))
    got = load_exported(path, "cpu")(x).numpy()
    assert got.shape == want.shape == x.shape
    assert rel_rms(got, want) <= JAX_ARTIFACT_REL_RMS


@pytest.mark.parametrize("kwargs,blocks", [(SMALL_BN, 8), (SMALL, 0)], ids=["batch", "group"])
def test_graph_holds_one_op_per_batchnorm_block(kwargs, blocks, tmp_path):
    """Each eval-mode batch-norm ResidualBlock is one msid::fused_residual_block
    node; GroupNorm blocks stay plain convs."""
    _, _, model = models(kwargs)
    assert sum(isinstance(m, ResidualBlock) and m.norm0.kind == "batch"
               for m in model.modules()) == blocks
    path = export_program(model, tmp_path / "a", input_shape=SHAPE)
    program = torch.export.load(path / MODULE_FILE)
    assert sum(n.target is OP for n in program.graph.nodes) == blocks
    assert not any(isinstance(m, ResidualBlock) and m.kept_operands is not None
                   for m in model.modules())     # the export kept no operands


@pytest.fixture
def tf32_on():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("dtype,inside", [(torch.float32, (False, False)),
                                          (torch.bfloat16, (True, True))])
def test_artifact_call_scopes_tf32_and_leaves_the_callers_flags(dtype, inside, tmp_path,
                                                                tf32_on, monkeypatch):
    """An fp32 artifact runs with TF32 off (a trace records no flag), a bf16
    one leaves the flags alone; the caller's flags are back afterwards."""
    _, _, model = models(SMALL_BN, dtype=dtype)
    path = export_program(model, tmp_path / "a", input_shape=SHAPE)
    seen = []
    block = cuda_decoder.fused_residual_block

    def spy(*args):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return block(*args)

    monkeypatch.setattr(cuda_decoder, "fused_residual_block", spy)
    load_exported(path, "cpu")(tiles(SHAPE))
    assert seen and set(seen) == {inside}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True,
                                                                                        True)


def test_device_type_mismatch_raises(exported, tmp_path):
    """A traced graph keeps its device: an artifact exported on another
    device type than the one asked for is refused, never run."""
    _, path = exported
    other = tmp_path / "other"
    shutil.copytree(path, other)
    meta = json.loads((other / META_FILE).read_text())
    (other / META_FILE).write_text(json.dumps(dict(meta, device_type="cuda")))
    with pytest.raises(ValueError, match="exported on 'cuda' and cannot run on 'cpu'"):
        load_exported(other, "cpu")
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        InferenceSession(artifact_path=other, image_size=64, device="cpu")
