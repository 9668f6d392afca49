"""The port's evaluate path on the CPU: ``evaluate_model`` against the JAX
package's on a tiny flagship with converted weights (every noise component
off, since the two packages draw different random numbers; fp32), for one
view, eight dihedral views and a two-member ensemble; then the CLIs: the
tiny recipe trained by ``scripts.train`` and scored by ``scripts.evaluate``
from its checkpoint reproduces the trainer's validation line, ``--resume``
continues at the saved epoch, and the flags that cannot work raise
(``--forward hybrid`` on a model with the input fill stage among them)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.ops.noise import NoiseConfig as JaxNoiseConfig
from msid_tpu.training.eval import evaluate_model as jax_evaluate_model
from msid_tpu.training.losses import LossConfig as JaxLossConfig
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.scripts import evaluate as evaluate_cli
from msid_tpu_torch.scripts import train as train_cli
from msid_tpu_torch.training.eval import evaluate_model
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.utils.checkpointing import CheckpointManager
from test_torch_model import randomize_variables

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY_CONFIG = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
TINY_FLAGSHIP = dict(image_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                     decoder_arch="unet_skip", decoder_channels=(8, 8, 8, 8),
                     residual_output=True, input_fill=True)
ZERO_NOISE = dict(gaussian_sigma=0.0, speckle_sigma=0.0, dead_band_prob=0.0,
                  thermal_scale=0.0, enable_striping=False)
LOSS = dict(mse_weight=1.0, ssim_weight=0.1, sam_weight=0.05)
METRICS = ("loss", "psnr", "ssim", "sam", "rmse")
RTOL = 1e-4              # fp32 both sides, sums in another order
CLI_RTOL = 1e-5          # the same package on the same device


def raw_loader():
    """Two batches of raw DN tiles, the second padded (2 real of 4); one
    band of the first tile is constant, so the fill stage detects it."""
    rng = np.random.default_rng(7)
    batches = [rng.uniform(500, 9500, (4, 16, 16, 13)).astype(np.float32) for _ in range(2)]
    batches[0][0, :, :, 4] = 5000.0
    return [(batches[0], 4), (batches[1], 2)]


@pytest.fixture(scope="module")
def weights():
    """The JAX model and two random weight sets, with the port's copies."""
    jmodel = JaxModel(**TINY_FLAGSHIP, dtype=jnp.float32, gradient_checkpointing=False)
    init = init_model(jmodel, jax.random.PRNGKey(0))
    sets = [randomize_variables(init, seed=s) for s in (1, 2)]
    model = SatMAERestoration(**TINY_FLAGSHIP)
    port = []
    for v in sets:
        load_jax_variables(model, jax.tree_util.tree_map(np.asarray, v))
        port.append({k: t.clone() for k, t in model.state_dict().items()})
    return jmodel, sets, model, port


def both(weights, which, tta):
    jmodel, sets, model, port = weights
    jvars = sets[0] if which == "single" else tuple(sets)
    pvars = port[0] if which == "single" else (port[0], port[1])
    want = jax_evaluate_model(jmodel, jvars, raw_loader(), loss_cfg=JaxLossConfig(**LOSS),
                              noise_cfg=JaxNoiseConfig(**ZERO_NOISE), image_size=32,
                              tta=tta, verbose=False)
    got = evaluate_model(model, pvars, raw_loader(), loss_cfg=LossConfig(**LOSS),
                         noise_cfg=NoiseConfig(**ZERO_NOISE), image_size=32, tta=tta,
                         verbose=False, noise_impl="jnp")
    return got, want


@pytest.mark.parametrize("which,tta", [("single", 1), ("single", 8), ("ensemble", 1)])
def test_evaluate_model_matches_jax(weights, which, tta):
    got, want = both(weights, which, tta)
    assert got["num_samples"] == want["num_samples"] == 6
    for key in METRICS:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def test_ensemble_and_tta_change_the_score(weights):
    model, port = weights[2], weights[3]
    kwargs = dict(loss_cfg=LossConfig(**LOSS), noise_cfg=NoiseConfig(**ZERO_NOISE),
                  image_size=32, verbose=False, noise_impl="jnp")
    one = evaluate_model(model, port[0], raw_loader(), **kwargs)
    same_twice = evaluate_model(model, [port[0], port[0]], raw_loader(), **kwargs)
    single_list = evaluate_model(model, [port[0]], raw_loader(), **kwargs)
    pair = evaluate_model(model, (port[0], port[1]), raw_loader(), **kwargs)
    for key in METRICS:
        np.testing.assert_allclose(same_twice[key], one[key], rtol=1e-6, err_msg=key)
        assert single_list[key] == one[key]
    assert pair["psnr"] != one["psnr"]


# ---------------- the CLIs ----------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny recipe (keeping every checkpoint) trained for one epoch by
    the train CLI: ``(config path, output dir, history)``."""
    root = tmp_path_factory.mktemp("cli")
    config = root / "tiny_keep3.yaml"
    config.write_text(f"inherits: {TINY_CONFIG}\ncheckpoint:\n  keep_top_k: 3\n")
    out = root / "run"
    history = train_cli.main(["--config", str(config), "--synthetic", "--device", "cpu",
                               "--epochs", "1", "--output-dir", str(out)])
    return config, out, history


def test_train_then_evaluate_reproduces_the_validation_line(trained, tmp_path):
    config, out, history = trained
    saved = json.loads((out / "logs" / "training_history.json").read_text())
    assert saved == history and len(history["val_psnr"]) == 1
    assert CheckpointManager(out / "checkpoints").all_steps() == [1]
    results = evaluate_cli.main(["--config", str(config), "--synthetic", "--device", "cpu",
                                 "--checkpoint", str(out / "checkpoints"),
                                 "--output-dir", str(tmp_path)])
    for key in ("loss", "psnr", "ssim", "sam", "rmse"):
        np.testing.assert_allclose(results[key], history[f"val_{key}"][-1], rtol=CLI_RTOL,
                                   err_msg=key)
    written = json.loads((tmp_path / "evaluation_results.json").read_text())
    assert written["provenance"]["checkpoint_step"] == 1
    assert written["provenance"]["tta"] == 1 and "tta" not in written
    assert written["provenance"]["dtype"] == "float32"

    ensembled = evaluate_cli.main([
        "--config", str(config), "--synthetic", "--device", "cpu", "--tta", "2",
        "--checkpoint", str(out / "checkpoints"), "--ensemble", str(out / "checkpoints"),
        "--output-dir", str(tmp_path / "ens")])
    assert ensembled["tta"] == 2 and ensembled["ensemble"] == 2
    assert ensembled["provenance"]["ensemble_steps"] == [1, 1]
    assert np.isfinite([ensembled[k] for k in METRICS]).all()


def test_resume_continues_at_the_saved_epoch(trained, tmp_path):
    config, out, history = trained
    import shutil

    run = tmp_path / "run"
    shutil.copytree(out, run)
    resumed = train_cli.main(["--config", str(config), "--synthetic", "--device", "cpu",
                              "--epochs", "2", "--resume", "--output-dir", str(run)])
    assert len(resumed["val_psnr"]) == 2
    for key, values in history.items():
        assert resumed[key][0] == values[0], key
    manager = CheckpointManager(run / "checkpoints")
    assert manager.all_steps() == [1, 2]
    state, metadata, _ = manager.load_step(2)
    first, _, _ = manager.load_step(1)
    assert metadata["epoch"] == 2 and state["step"] == 2 * first["step"]

    warm = train_cli.main(["--config", str(config), "--synthetic", "--device", "cpu",
                           "--epochs", "1", "--init-from", str(run / "checkpoints"),
                           "--output-dir", str(tmp_path / "warm")])
    assert len(warm["val_psnr"]) == 1


@pytest.mark.parametrize("cli,argv,error,match", [
    ("evaluate", ["--tta", "0", "--checkpoint", "/nonexistent"], ValueError, "num_transforms"),
    ("evaluate", ["--tta", "9"], ValueError, "num_transforms"),
    ("evaluate", ["--ensemble", "/nonexistent"], SystemExit, "--checkpoint"),
    ("evaluate", ["--forward", "hybrid", "--config", "FILL"], ValueError, "input_fill models"),
    ("evaluate", ["--save_visualizations", "--ensemble", "/nonexistent"], SystemExit,
     "--checkpoint"),
    ("train", ["--init-from", "/a", "--resume"], SystemExit, "--init-from"),
    ("train", ["--init-from", "/a", "--checkpoint", "/b"], SystemExit, "--init-from"),
])
def test_cli_refusals(cli, argv, error, match, tmp_path):
    main = evaluate_cli.main if cli == "evaluate" else train_cli.main
    if "FILL" in argv:      # the tiny recipe with the dead-band input stage
        fill = tmp_path / "tiny_fill.yaml"
        fill.write_text(f"inherits: {TINY_CONFIG}\nmodel:\n  input_fill:\n    enabled: true\n")
        argv = [str(fill) if a == "FILL" else a for a in argv]
    with pytest.raises(error, match=match):
        main(["--config", str(TINY_CONFIG), "--synthetic", "--device", "cpu",
              "--output-dir", "/nonexistent-output", *argv])
