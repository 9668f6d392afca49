"""The port's restore CLI (``python -m msid_tpu_torch.scripts.restore``) on
the CPU: the tiny recipe (``tiny_cpu.yaml``, float32) is trained one epoch
by ``msid_tpu_torch.scripts.train``, and its checkpoint restores a ragged
uint16 TIFF scene.

What the CLI writes must equal ``restore_scene`` (device assembly, or the
streaming restore) on that checkpoint's eval variables bit for bit: the
same package, device and order of operations. The host-side reflectance
affine must equal the port's ``from_model_range`` and the JAX package's
within 1e-7 (one float32 rounding of ``x * 0.25 + 0.5``)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.ops.preprocess import from_model_range as jax_from_model_range
from msid_tpu_torch.data.tiff import read_tiff, write_tiff
from msid_tpu_torch.deployment.sliding_window import restore_scene, restore_scene_streaming
from msid_tpu_torch.ops.preprocess import from_model_range
from msid_tpu_torch.scripts import restore as restore_cli
from msid_tpu_torch.scripts import train as train_cli
from msid_tpu_torch.training.optim import build_optimizer_from_config
from msid_tpu_torch.training.train_state import TrainState
from msid_tpu_torch.utils.checkpointing import CheckpointManager
from msid_tpu_torch.utils.config import coerce_scheduler_params, load_config
from msid_tpu_torch.utils.setup_helpers import create_model_from_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
REFLECTANCE_ATOL = 1e-7


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``(checkpoint dir, model, eval variables, raw variables, scene path, scene)``."""
    out = tmp_path_factory.mktemp("restore_run")
    train_cli.main(["--config", str(TINY), "--synthetic", "--device", "cpu", "--epochs", "1",
                    "--output-dir", str(out)])
    ckpt = out / "checkpoints"
    config = coerce_scheduler_params(load_config(TINY))
    model, _ = create_model_from_config(config, int(config.get("seed", 42)), "cpu")
    optimizer, _ = build_optimizer_from_config(config, model)
    state, _, _ = CheckpointManager(ckpt).load_best(target=TrainState.create(model, optimizer))
    scene = np.random.default_rng(8).integers(0, 10000, (100, 131, 13), dtype=np.uint16)
    path = out / "scene.tif"
    write_tiff(path, scene)
    return ckpt, model, state.eval_variables(), state.eval_variables(raw=True), path, scene


def run(trained, tmp_path, *flags, name="restored.tif"):
    ckpt, _, _, _, path, _ = trained
    out = tmp_path / name
    restored = restore_cli.main(["--config", str(TINY), "--checkpoint", str(ckpt),
                                 "--input", str(path), "--output", str(out),
                                 "--device", "cpu", *flags])
    return restored, out


def test_restore_equals_restore_scene_on_the_checkpoint(trained, tmp_path):
    _, model, variables, _, _, scene = trained
    restored, out = run(trained, tmp_path)
    assert restored.shape == scene.shape and restored.dtype == np.float32
    want = restore_scene(model, variables, scene, window=64, overlap=16, model_size=64,
                         batch_size=64, device_assembly=True, device="cpu")
    np.testing.assert_array_equal(restored, want)
    np.testing.assert_array_equal(read_tiff(out), restored)


def test_streaming_float16_and_a_smaller_batch(trained, tmp_path):
    _, model, variables, _, _, scene = trained
    restored, out = run(trained, tmp_path, "--streaming", "on", "--output-dtype", "float16",
                        "--batch-size", "5", "--overlap", "8", name="s.npy")
    assert restored.dtype == np.float16
    want = restore_scene_streaming(model, variables, scene, window=64, overlap=8,
                                   model_size=64, batch_size=5, output_dtype=np.float16,
                                   device="cpu")
    np.testing.assert_array_equal(restored, want)
    np.testing.assert_array_equal(np.load(out), restored)


def test_raw_weights_tta_and_reflectance(trained, tmp_path):
    _, model, _, raw, _, scene = trained
    restored, _ = run(trained, tmp_path, "--raw-weights", "--tta", "2", "--reflectance")
    model_range = restore_scene(model, raw, scene, window=64, overlap=16, model_size=64,
                                device_assembly=True, tta=2, device="cpu")
    np.testing.assert_array_equal(restored, restore_cli.to_reflectance(model_range, np.float32))
    assert restored.min() >= 0.0 and restored.max() <= 1.0


def test_reflectance_is_from_model_range_of_both_packages():
    x = np.random.default_rng(5).uniform(-3.5, 3.5, (7, 9, 13)).astype(np.float32)
    host = restore_cli.to_reflectance(x, np.float32)
    np.testing.assert_allclose(host, from_model_range(torch.from_numpy(x)).numpy(),
                               rtol=0, atol=REFLECTANCE_ATOL)
    np.testing.assert_allclose(host, np.asarray(jax_from_model_range(jnp.asarray(x))),
                               rtol=0, atol=REFLECTANCE_ATOL)
    assert restore_cli.to_reflectance(x, np.float16).dtype == np.float16


def test_what_cannot_be_restored_exits_or_raises(trained, tmp_path):
    ckpt = trained[0]
    bands = tmp_path / "five.tif"
    write_tiff(bands, np.zeros((70, 70, 5), np.uint16))
    common = ["--config", str(TINY), "--output", str(tmp_path / "o.tif"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="5 bands but the model expects 13"):
        restore_cli.main([*common, "--checkpoint", str(ckpt), "--input", str(bands)])
    with pytest.raises(ValueError, match="num_transforms"):
        restore_cli.main([*common, "--checkpoint", str(ckpt), "--input", str(bands),
                          "--tta", "9"])
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        restore_cli.main([*common, "--checkpoint", str(tmp_path / "none"),
                          "--input", str(trained[4])])
    assert restore_cli.parse_args(["--checkpoint", "c", "--input", "i", "--output", "o"]
                                  ).device == "cuda"
