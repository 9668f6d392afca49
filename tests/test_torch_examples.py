"""The port's three walkthroughs (``msid_tpu_torch/examples``) run to their
end on the CPU (``--device cpu --synthetic``, the tiny recipe), each
in-process, and hold what they write and count against the JAX package at
the same config: the parameter count of the model (an init only), the
train and validation batch counts, and the keys of the evaluation results.
Stage B resumes stage A's checkpoint under another freeze set. The metric
values themselves are held to the JAX package by ``test_torch_evaluate``.
Without ``--device cpu`` and with no card each walkthrough raises."""

import ast
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.data import get_dataloaders as jax_get_dataloaders
from msid_tpu.models import SatMAERestoration as JaxModel
from msid_tpu.models import count_parameters as jax_count_parameters
from msid_tpu.models import init_model
from msid_tpu.training import evaluate_model as jax_evaluate_model
from msid_tpu.utils.setup_helpers import create_model_from_config as jax_create_model
from msid_tpu_torch.data import get_dataloaders
from msid_tpu_torch.deployment import verify_exported_model
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.setup_helpers import create_model_from_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "msid_tpu_torch" / "examples"
TINY_CONFIG = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
PNG = b"\x89PNG\r\n\x1a\n"


def run_example(name: str, *argv, monkeypatch) -> None:
    path = EXAMPLES / name
    monkeypatch.setattr(sys, "argv", [str(path), *map(str, argv)])
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(str(path), run_name="__main__")


def is_png(path: Path) -> bool:
    return path.read_bytes()[:8] == PNG


def tiny_config() -> dict:
    """The tiny recipe on synthetic tiles, as ``--synthetic`` makes it."""
    config = load_config(TINY_CONFIG)
    config["data"]["root_dir"] = "/nonexistent"
    return config


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    """02 on the tiny recipe, one epoch a stage: stage A freezes both
    encoder blocks, stage B only the first."""
    tmp = tmp_path_factory.mktemp("two_stage")
    for stage, frozen in (("a", "[0, 1]"), ("b", "[0]")):
        (tmp / f"stage_{stage}.yaml").write_text(
            f"inherits: {TINY_CONFIG}\nmodel:\n  encoder:\n    freeze_layers: {frozen}\n")
    with pytest.MonkeyPatch.context() as mp:
        run_example("02_two_stage_training.py", "--device", "cpu", "--synthetic",
                    "--stage-a-config", tmp / "stage_a.yaml",
                    "--stage-b-config", tmp / "stage_b.yaml", "--epochs", 1,
                    "--output-dir", tmp / "out", monkeypatch=mp)
    return tmp / "out"


def test_quick_start(tmp_path, monkeypatch, capsys):
    run_example("00_quick_start.py", "--device", "cpu", "--synthetic",
                "--config", TINY_CONFIG, "--output-dir", tmp_path, monkeypatch=monkeypatch)
    printed = capsys.readouterr().out
    assert is_png(tmp_path / "noise_preview.png")

    config = tiny_config()
    train, val = get_dataloaders(config, "cpu")
    jax_train, jax_val = jax_get_dataloaders(config)
    assert (len(train), len(val)) == (len(jax_train), len(jax_val))
    assert f"train batches: {len(jax_train)}, val batches: {len(jax_val)}" in printed

    _, counts = create_model_from_config(config, device="cpu")
    _, jax_variables, _ = jax_create_model(config)
    jax_counts = jax_count_parameters(jax_variables)
    assert counts == jax_counts
    assert f"params: {jax_counts['total'] / 1e6:.1f}M" in printed
    line = next(ln for ln in printed.splitlines() if ln.startswith("untrained model"))
    assert "nan" not in line


def test_two_stage_training(two_stage):
    history = json.loads((two_stage / "logs" / "training_history.json").read_text())
    assert set(history) >= {"train_loss", "val_loss", "val_psnr", "val_ssim", "lr"}
    assert all(len(v) == 2 for v in history.values()), {k: len(v) for k, v in history.items()}
    assert np.isfinite(history["train_loss"] + history["val_psnr"]).all()
    assert is_png(two_stage / "logs" / "training_curves.png")

    # Stage B resumed stage A (its steps go on) and trained block 1, which
    # stage A froze, with moments of its own.
    a, b = (torch.load(next((two_stage / f"stage_{s}" / "checkpoints").glob("*/state.pt")),
                       weights_only=True) for s in "ab")
    assert b["step"] == 2 * a["step"] > 0

    def trained(state):
        return {name for group in state["optimizer"]["param_groups"]
                for name, i in zip(group["names"], group["params"])
                if i in state["optimizer"]["state"]}

    assert not any(n.startswith("encoder.blocks.") for n in trained(a))
    assert {n for n in trained(b) if n.startswith("encoder.blocks.")} == {
        n for n in b["model"] if n.startswith("encoder.blocks.1.")
        and not n.endswith(("running_mean", "running_var"))}
    assert trained(a) < trained(b)


def jax_evaluation_keys() -> set:
    """The keys of the JAX package's ``evaluate_model`` on a micro model."""
    model = JaxModel(image_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                     decoder_channels=(8, 8, 8, 8), dtype=jnp.float32,
                     gradient_checkpointing=False)
    variables = init_model(model, jax.random.PRNGKey(0))
    batch = np.random.default_rng(0).uniform(0, 10000, (2, 16, 16, 13)).astype(np.float32)
    return set(jax_evaluate_model(model, variables, [batch], image_size=32, verbose=False))


def test_evaluation_and_export(two_stage, tmp_path, monkeypatch, capsys):
    run_example("03_evaluation_and_export.py", "--device", "cpu", "--synthetic",
                "--config", TINY_CONFIG, "--checkpoint", two_stage / "stage_b" / "checkpoints",
                "--output-dir", tmp_path, monkeypatch=monkeypatch)
    printed = capsys.readouterr().out
    assert "restored best checkpoint (step 1)" in printed      # stage B's one epoch

    results = json.loads((tmp_path / "evaluation_results.json").read_text())
    assert set(results) == jax_evaluation_keys()
    assert all(np.isfinite(results[k]) for k in ("psnr", "ssim", "sam"))
    assert results["num_samples"] == len(jax_get_dataloaders(tiny_config())[1].dataset)

    figures = sorted(p.name for p in (tmp_path / "figures").iterdir())
    assert figures == [f"sample_{i:02d}{s}.png" for i in range(3) for s in ("", "_spectra")]
    assert all(is_png(tmp_path / "figures" / f) for f in figures)

    size = load_config(TINY_CONFIG)["data"]["image_size"]
    assert verify_exported_model(tmp_path / "model", input_shape=(1, size, size, 13),
                                 device="cpu")
    assert "export verified=True" in printed and "allclose=True" in printed
    assert "inference graph: module forward (compiled: None)" in printed


@pytest.mark.parametrize("name", sorted(p.name for p in EXAMPLES.glob("*.py")))
def test_sections_and_flags_are_the_jax_walkthroughs(name):
    """The same ``# -- N. title`` sections (their parenthetical aside) and
    the same flags with the same defaults; 00 adds ``--synthetic``, which
    02 and 03 have."""
    from msid_tpu_torch.scripts.make_notebooks import (
        _argparse_defaults,
        _segment,
        _split_sections,
    )

    def sections_and_flags(path: Path):
        source = path.read_text()
        titles = [t.split(" (")[0] for t, _ in _split_sections(_segment(source)[2]) if t]
        return titles, _argparse_defaults(ast.parse(source))

    ours, theirs = (sections_and_flags(d / name) for d in (EXAMPLES, ROOT / "examples"))
    assert ours[0] == theirs[0]
    added = {"synthetic": False} if name.startswith("00_") else {}
    assert ours[1] == {**theirs[1], **added}


@pytest.mark.parametrize("name", sorted(p.name for p in EXAMPLES.glob("*.py")))
def test_examples_raise_without_a_card_unless_asked_for_the_cpu(name, tmp_path, monkeypatch):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_example(name, "--synthetic", "--output-dir", tmp_path, monkeypatch=monkeypatch)
    assert not any(tmp_path.iterdir())
