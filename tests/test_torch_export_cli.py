"""The port's export CLI (``python -m msid_tpu_torch.scripts.export``) on the
CPU: the tiny recipe (``tiny_cpu.yaml``) trained one epoch by
``msid_tpu_torch.scripts.train``, its checkpoint exported with
``--verify`` as a bf16 artifact (``configs/deployment.yaml``'s
``bf16_inference``) that serves the checkpoint's weights, and the flags of
the JAX package's ``scripts/export.py``: ``--int8``, ``--optimize`` (and
their conflict), ``--tta``, a static batch and an fp32 deployment."""

import copy
import importlib.util
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from msid_tpu_torch.deployment.export import load_exported, make_inference_fn
from msid_tpu_torch.scripts import export as export_cli
from msid_tpu_torch.scripts import train as train_cli
from msid_tpu_torch.training.optim import build_optimizer_from_config
from msid_tpu_torch.training.train_state import TrainState
from msid_tpu_torch.utils.checkpointing import CheckpointManager
from msid_tpu_torch.utils.config import coerce_scheduler_params, load_config
from msid_tpu_torch.utils.setup_helpers import create_model_from_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
DEPLOY = ROOT / "configs" / "deployment.yaml"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``(checkpoint dir, the checkpoint's fp32 model in eval mode)``."""
    out = tmp_path_factory.mktemp("export_run")
    train_cli.main(["--config", str(TINY), "--synthetic", "--device", "cpu", "--epochs", "1",
                    "--output-dir", str(out)])
    config = coerce_scheduler_params(load_config(TINY))
    model, _ = create_model_from_config(config, int(config.get("seed", 42)), "cpu")
    optimizer, _ = build_optimizer_from_config(config, model)
    state, _, _ = CheckpointManager(out / "checkpoints").load_best(
        target=TrainState.create(model, optimizer))
    model.load_state_dict(state.eval_variables())
    return out / "checkpoints", model.eval()


def export(trained, tmp_path, *flags, config=DEPLOY):
    ckpt, _ = trained
    return export_cli.main(["--config", str(config), "--model-config", str(TINY),
                            "--checkpoint", str(ckpt), "--output", str(tmp_path / "model"),
                            "--device", "cpu", *flags])


def meta(path):
    return json.loads((path / "meta.json").read_text())


def tiles(b=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (b, 64, 64, 13))
                            .astype(np.float32))


def test_verified_bf16_artifact_serves_the_checkpoint(trained, tmp_path):
    _, model = trained
    path = export(trained, tmp_path, "--verify")
    assert path == tmp_path / "model"
    assert meta(path) == {"optimized": False, "dtype": "bfloat16", "tta": 1,
                          "device_type": "cpu", "torch": torch.__version__}
    live = copy.deepcopy(model).set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        want = make_inference_fn(live)(None, tiles())
    np.testing.assert_array_equal(load_exported(path, "cpu")(tiles()).numpy(), want.numpy())


def test_int8_and_the_optimize_conflict(trained, tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        path = export(trained, tmp_path, "--verify", "--int8")
    assert (path / "params_int8.npz").exists() and not (path / "params.npz").exists()
    assert "int8 weights:" in caplog.text
    with pytest.raises(SystemExit, match="not combinable"):
        export(trained, tmp_path, "--int8", "--optimize")


def test_optimize_and_tta(trained, tmp_path):
    path = export(trained, tmp_path, "--verify", "--optimize")
    assert meta(path)["optimized"] is True
    path = export(trained, tmp_path, "--tta")           # bare --tta means 8
    assert meta(path)["tta"] == 8


def test_fp32_deployment_with_a_static_batch(trained, tmp_path):
    """bf16_inference off follows the recipe's precision (fp32 here); a
    static batch is verified at its own size only."""
    _, model = trained
    deploy = yaml.safe_load(DEPLOY.read_text())
    deploy["export"]["optimization"]["bf16_inference"] = False
    deploy["export"].update(dynamic_batch=False, input_shape=[3, 64, 64, 13])
    config = tmp_path / "deploy.yaml"
    config.write_text(yaml.safe_dump(deploy))
    path = export(trained, tmp_path, "--verify", config=config)
    assert meta(path)["dtype"] == "float32"
    fn = load_exported(path, "cpu")
    with torch.no_grad():
        want = make_inference_fn(model)(None, tiles(3))
    np.testing.assert_array_equal(fn(tiles(3)).numpy(), want.numpy())
    with pytest.raises(RuntimeError, match="equal to 3"):   # the program's own check
        fn(tiles(2))


def test_flags_are_the_jax_scripts():
    spec = importlib.util.spec_from_file_location("jax_export_cli", ROOT / "scripts" / "export.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    argv = sys.argv
    try:
        sys.argv = ["export.py"]
        theirs = vars(jax_cli.parse_args())
    finally:
        sys.argv = argv
    ours = vars(export_cli.parse_args([]))
    assert set(ours) == set(theirs)
    assert {k: v for k, v in ours.items() if k != "device"} == \
        {k: v for k, v in theirs.items() if k != "device"}
    assert ours["device"] == "cuda"
    assert export_cli.parse_args(["--tta"]).tta == 8
