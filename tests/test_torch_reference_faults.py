"""Where the port once parted from the reference, on the CPU: TF32 inside an
fp32 forward or step, the result of ``InferenceSession.benchmark``, the
perceptual loss's fallback, a data directory that holds no tile, the
checkpoint manager that ``setup_training_session`` always builds; and in
serving, the graph a mesh session picks, a mesh session's ``benchmark``
and the batches an artifact session serves."""

import contextlib
import copy
import inspect
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msid_tpu.data.dataset import build_dataset as jax_build_dataset
from msid_tpu.deployment.export import export_stablehlo as jax_export_stablehlo
from msid_tpu.deployment.inference import InferenceSession as JaxSession
from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.parallel.mesh import make_mesh as jax_make_mesh
from msid_tpu.training.perceptual import resolve_perceptual as jax_resolve_perceptual
from msid_tpu.utils.setup_helpers import setup_training_session as jax_setup_training_session
from msid_tpu_torch.data.dataset import build_dataset
from msid_tpu_torch.deployment import inference
from msid_tpu_torch.deployment.export import export_program
from msid_tpu_torch.deployment.inference import InferenceSession, MeshSession, benchmark_summary
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.parallel import make_mesh
from msid_tpu_torch.training.perceptual import init_vgg16_params, resolve_perceptual
from msid_tpu_torch.training import trainer as trainer_module
from msid_tpu_torch.training.train_state import make_train_step
from msid_tpu_torch.training.trainer import Trainer
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.setup_helpers import setup_training_session
from test_torch_model import randomize_variables

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
# The keys of the reference's benchmark result (msid_tpu/deployment/inference.py).
REFERENCE_BENCHMARK_KEYS = {"mean_ms", "fps", "images_per_sec", "batch_size", "iterations",
                            "std_ms", "min_ms", "max_ms", "p50_ms", "p99_ms"}


@pytest.fixture(scope="module")
def tiny_session(tmp_path_factory):
    """The tiny recipe (fp32: ``mixed_precision: false``) on the CPU."""
    session = setup_training_session(TINY, synthetic=True, device="cpu", seed=0,
                                     output_dir=tmp_path_factory.mktemp("run"))
    session["batch"] = next(iter(session["train_loader"]))
    return session


def flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def tf32_on():
    """Both TF32 flags on (cuDNN's is torch's default, the matmul one a
    caller's choice); the caller's values come back at the end."""
    saved = flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def recording_flags(model: torch.nn.Module):
    """The TF32 flags at every decoder forward and at its backward."""
    seen = []

    def hook(module, inputs, output):
        seen.append(flags())
        if output.requires_grad:
            output.register_hook(lambda grad: seen.append(flags()))

    handle = model.decoder.register_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def run_path(session: dict, path: str, dtype: torch.dtype) -> list:
    """The TF32 flags seen inside one fp32 or bf16 session forward, train
    step or eval step of the tiny recipe."""
    model = session["model"]
    if path == "session":
        if dtype != torch.float32:
            model = copy.deepcopy(model).set_compute_dtype(dtype)
        serving = InferenceSession(model, batch_size=2, image_size=model.image_size,
                                   device="cpu")
        x = np.random.default_rng(0).normal(0, 0.5, (2, model.image_size, model.image_size,
                                                     model.in_channels)).astype(np.float32)
        with recording_flags(serving.model) as seen:     # the session's own copy
            serving.predict(x)
        return seen
    trainer = session["trainer"]
    with recording_flags(model) as seen:
        if path == "train_step":
            step = make_train_step(model, trainer.loss_cfg, trainer.noise_cfg,
                                   image_size=model.image_size, compute_dtype=dtype)
            step(session["state"], session["batch"], 3)
        else:
            batch = session["batch"]
            trainer.eval_step(batch, 5, len(batch))
    return seen


@pytest.mark.parametrize("path", ["session", "train_step", "eval_step"])
def test_fp32_turns_tf32_off_inside_and_restores_the_callers_flags(tiny_session, tf32_on,
                                                                   path):
    seen = run_path(tiny_session, path, torch.float32)
    assert seen and set(seen) == {(False, False)}
    if path == "train_step":
        assert len(seen) == 2                      # the forward and its backward
    assert flags() == (True, True)


@pytest.mark.parametrize("path", ["session", "train_step"])
def test_bf16_leaves_the_tf32_flags_alone(tiny_session, tf32_on, path):
    seen = run_path(tiny_session, path, torch.bfloat16)
    assert seen and set(seen) == {(True, True)}
    assert flags() == (True, True)


def test_benchmark_result_is_the_references():
    """Throughput from the mean, the ``fps`` key, and a pipelined run that
    reports one aggregate sample and no distribution."""
    per_call = benchmark_summary(np.array([1.0, 2.0, 3.0, 6.0]), 4, 4, False, "card")
    assert set(per_call) == REFERENCE_BENCHMARK_KEYS | {"device"}
    assert per_call["mean_ms"] == 3.0 and per_call["p50_ms"] == 2.5
    assert per_call["images_per_sec"] == pytest.approx(4e3 / 3.0)
    assert per_call["fps"] == pytest.approx(1e3 / 3.0)
    pipelined = benchmark_summary(np.array([2.0]), 4, 10, True, "card")
    assert set(pipelined) == REFERENCE_BENCHMARK_KEYS | {"device"}
    assert all(pipelined[k] is None for k in ("std_ms", "min_ms", "max_ms", "p50_ms", "p99_ms"))
    assert pipelined["images_per_sec"] == 2e3 and pipelined["iterations"] == 10
    assert "pipelined" in inspect.signature(InferenceSession.benchmark).parameters


@pytest.mark.parametrize("section", [
    {}, {"perceptual_impl": "edge"}, {"perceptual_impl": "VGG"},
    {"perceptual_impl": "vgg", "perceptual_weights_path": "/nonexistent/vgg16.npz"},
    {"perceptual_impl": "resnet"},
])
def test_perceptual_impl_resolves_as_the_reference(section, caplog):
    try:
        want = jax_resolve_perceptual(section)[0]
    except ValueError:
        with pytest.raises(ValueError, match="unknown perceptual_impl"):
            resolve_perceptual(section)
        return
    with caplog.at_level(logging.WARNING):
        assert resolve_perceptual(section) == (want, None) == ("edge", None)
    assert ("falling back" in caplog.text) == (section.get("perceptual_impl") == "VGG"
                                               or "perceptual_weights_path" in section)


def test_trainer_takes_the_edge_stand_in_for_vgg_without_weights(tiny_session, tmp_path,
                                                                    monkeypatch):
    config = load_config(TINY)
    loss = dict(config["training"].get("loss", {}), perceptual_weight=0.1,
                perceptual_impl="vgg")
    config["training"] = dict(config["training"], loss=loss)
    Trainer(tiny_session["model"], tiny_session["state"], config, device="cpu")
    # with a weights file the trainer takes the VGG16 loss, as the reference's
    weights = tmp_path / "vgg16.npz"
    np.savez(weights, **{k: v.numpy() for k, v in init_vgg16_params(0).items()})
    config["training"]["loss"] = dict(loss, perceptual_weights_path=str(weights))
    assert resolve_perceptual(config["training"]["loss"])[0] == "vgg"
    built = {}

    def spy(name):
        real = getattr(trainer_module, name)

        def build(*args, **kwargs):
            built[name] = kwargs
            return real(*args, **kwargs)
        return build

    for name in ("make_train_step", "make_eval_step"):
        monkeypatch.setattr(trainer_module, name, spy(name))
    Trainer(tiny_session["model"], tiny_session["state"], config, device="cpu")
    for kwargs in built.values():
        assert torch.equal(kwargs["vgg_params"]["features.0.weight"],
                           init_vgg16_params(0)["features.0.weight"])
    assert len(built) == 2


def test_a_root_dir_without_tiles_falls_back_to_synthetic_tiles(tmp_path):
    config = load_config(TINY)
    (tmp_path / "empty_class").mkdir()
    (tmp_path / "README.txt").write_text("no tiles here")
    data = dict(config["data"], root_dir=str(tmp_path), synthetic_samples=10)
    for split in ("train", "val"):
        ours = build_dataset(dict(config, data=data), split)
        theirs = jax_build_dataset(dict(config, data=data), split)
        assert len(ours) == len(theirs) > 0
        assert np.array_equal(ours[0], theirs[0])
    strict = dict(config, data=dict(data, synthetic_fallback=False))
    for build in (build_dataset, jax_build_dataset):
        with pytest.raises(FileNotFoundError):
            build(strict, "train")


def test_setup_builds_the_checkpoint_manager_under_outputs_by_default(tmp_path, monkeypatch):
    ours = inspect.signature(setup_training_session).parameters["output_dir"].default
    theirs = inspect.signature(jax_setup_training_session).parameters["output_dir"].default
    assert ours == theirs == "outputs"
    monkeypatch.chdir(tmp_path)
    session = setup_training_session(TINY, synthetic=True, device="cpu")
    assert session["checkpoint_manager"].directory == tmp_path / "outputs" / "checkpoints"
    assert session["trainer"].ckpt is session["checkpoint_manager"]


# ---------------- serving: mesh and artifact sessions ----------------

SERVE = dict(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             decoder_channels=(16, 16, 8, 8), gradient_checkpointing=False)


def served_pair(seed=0, **kw):
    """A JAX model with seeded random variables and the port's copy."""
    kwargs = dict(SERVE, **kw)
    jmodel = JaxModel(**kwargs, dtype=jnp.float32)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(seed)), seed)
    model = SatMAERestoration(**kwargs).eval()
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, model


def serve_tiles(b, seed=0):
    return np.random.default_rng(seed).normal(0, 0.5, (b, 32, 32, 13)).astype(np.float32)


@pytest.mark.parametrize("batch,want", [(8, "hybrid"), (4, False)])
def test_mesh_session_picks_its_graph_at_the_whole_batch(batch, want):
    """The reference picks ``optimize="auto"``'s graph at the session's
    batch, the whole sharded one; so does a mesh session, for every
    replica, whatever the replica's rows."""
    jmodel, variables, model = served_pair()
    theirs = JaxSession(jmodel, variables, batch_size=batch, image_size=32,
                        mesh=jax_make_mesh(devices=jax.devices()[:2]))
    ours = InferenceSession(model, batch_size=batch, image_size=32, device="cpu",
                            mesh=make_mesh(devices=["cpu", "cpu"]))
    single = InferenceSession(model, batch_size=batch, image_size=32, device="cpu")
    assert ours.optimized == single.optimized == theirs.optimized == want
    assert [r.optimized for r in ours.replicas] == [want, want]
    x = serve_tiles(batch, seed=1)
    want_y = theirs.predict(x)
    # fp32 on both sides, summation order apart: 1e-4 of the output's scale
    np.testing.assert_allclose(ours.predict(x), want_y, rtol=0,
                               atol=1e-4 * float(np.abs(want_y).max()))


class FakeGraph:
    """Stands in for a replica's captured graph: its input buffer and a
    count of replays (with the rows each replay was handed)."""

    def __init__(self, shape):
        self.input = torch.zeros(shape)
        self.calls = []

    def __call__(self, x=None):
        if x is not None:
            self.input.copy_(x)
        self.calls.append(x)
        return self.input


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("donate", [False, True])
def test_mesh_session_benchmarks_at_the_whole_batch(pipelined, donate, monkeypatch):
    """``MeshSession.benchmark`` takes ``InferenceSession.benchmark``'s
    arguments and returns the reference's keys at the whole batch; a timed
    call replays every replica on its rows of one seeded batch. The CUDA
    timer is faked; a CPU mesh raises as a CPU session does."""
    _, _, model = served_pair()
    session = InferenceSession(model, batch_size=4, image_size=32, device="cpu",
                               donate_input=donate, mesh=make_mesh(devices=["cpu", "cpu"]))
    assert isinstance(session, MeshSession)
    assert (inspect.signature(MeshSession.benchmark).parameters.keys()
            == inspect.signature(InferenceSession.benchmark).parameters.keys())
    with pytest.raises(RuntimeError, match="CUDA events"):
        session.benchmark(warmup_runs=1, benchmark_iterations=2)
    for r in session.replicas:
        r._graph = FakeGraph(r.input_shape)
    timed = {}

    def fake_timer(call, iterations, pipelined, device):
        before = [len(r._graph.calls) for r in session.replicas]
        call()
        timed["replays_per_call"] = [len(r._graph.calls) - n
                                     for r, n in zip(session.replicas, before)]
        timed["device"] = device
        return np.array([2.0]) if pipelined else np.linspace(1.0, 3.0, iterations)

    monkeypatch.setattr(inference, "_timed_ms", fake_timer)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    result = session.benchmark(warmup_runs=2, benchmark_iterations=5, seed=3,
                               pipelined=pipelined)
    assert set(result) == REFERENCE_BENCHMARK_KEYS | {"device"}
    assert result["batch_size"] == 4 and result["iterations"] == 5
    assert result["images_per_sec"] == pytest.approx(4e3 / result["mean_ms"])
    assert (result["p50_ms"] is None) == pipelined
    assert timed == {"replays_per_call": [1, 1], "device": session.device}
    want = inference.benchmark_batch((4, 32, 32, 13), 3)
    for r, rows in zip(session.replicas, want.chunk(2)):
        assert torch.equal(r._graph.input, rows)
        assert len(r._graph.calls) == 3                      # 2 warmups and a timed call
        assert all((x is not None) == donate for x in r._graph.calls)


def test_an_artifact_session_serves_any_batch_of_a_dynamic_artifact(tmp_path):
    """The reference checks the batch only of a compiled session; its
    artifact session serves any batch of a dynamic-batch artifact and a
    static one refuses the others. A B=1 session serves a batch of 3 as
    the JAX artifact session does on the same converted weights (fp32,
    rtol 1e-4, atol 1e-5) and as the port's live B=3 session, bit for bit."""
    jmodel, variables, model = served_pair(seed=2)
    shape = (1, 32, 32, 13)
    x = serve_tiles(3, seed=4)
    theirs = JaxSession(artifact_path=jax_export_stablehlo(
        jmodel, variables, tmp_path / "jax", input_shape=shape), batch_size=1, image_size=32)
    ours = InferenceSession(artifact_path=export_program(model, tmp_path / "port",
                                                         input_shape=shape),
                            batch_size=1, image_size=32, device="cpu")
    got = ours.predict(x)
    np.testing.assert_allclose(got, theirs.predict(x), rtol=1e-4, atol=1e-5)
    live = InferenceSession(model, batch_size=3, image_size=32, device="cpu")
    assert np.array_equal(got, live.predict(x))
    with pytest.raises(ValueError, match="session built for batch 3, got 1"):
        live.predict(x[:1])                      # a session with a model keeps its batch
    static = InferenceSession(artifact_path=export_program(
        model, tmp_path / "static", input_shape=shape, dynamic_batch=False),
        batch_size=1, image_size=32, device="cpu")
    jax_static = JaxSession(artifact_path=jax_export_stablehlo(
        jmodel, variables, tmp_path / "jax_static", input_shape=shape, dynamic_batch=False),
        batch_size=1, image_size=32)
    with pytest.raises(ValueError) as their_error:
        jax_static.predict(x)
    with pytest.raises(ValueError) as our_error:
        static.predict(x)
    assert str(our_error.value) == str(their_error.value)
    assert np.array_equal(static.predict(x[:1]), ours.predict(x[:1]))
