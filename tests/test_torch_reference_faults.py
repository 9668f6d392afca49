"""Where the port once parted from the reference, on the CPU: TF32 inside an
fp32 forward or step, the result of ``InferenceSession.benchmark``, the
perceptual loss's fallback, a data directory that holds no tile, and the
checkpoint manager that ``setup_training_session`` always builds."""

import contextlib
import copy
import inspect
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from msid_tpu.data.dataset import build_dataset as jax_build_dataset
from msid_tpu.training.perceptual import resolve_perceptual as jax_resolve_perceptual
from msid_tpu.utils.setup_helpers import setup_training_session as jax_setup_training_session
from msid_tpu_torch.data.dataset import build_dataset
from msid_tpu_torch.deployment.inference import InferenceSession, benchmark_summary
from msid_tpu_torch.training.perceptual import init_vgg16_params, resolve_perceptual
from msid_tpu_torch.training import trainer as trainer_module
from msid_tpu_torch.training.train_state import make_train_step
from msid_tpu_torch.training.trainer import Trainer
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.setup_helpers import setup_training_session

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
