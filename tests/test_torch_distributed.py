"""The port's parallel step in several gloo processes on the CPU, against
the JAX package's mesh steps and against the port's one-process step.

Each launch (``msid_tpu_torch.parallel.dryrun.spawn``) runs its ranks as
child processes under a timeout; the launches start together when the
module's first test asks for one, and the JAX references are computed in
this process meanwhile. Weights are the tiny flagship of
``test_torch_train_step.py``, randomised on the JAX side and converted.

  * 2 ranks, every noise component off, against the JAX step on a
    2-device mesh (loss within the JAX mesh test's ``rel=2e-4``, weights
    within one AdamW step as in ``test_torch_train_step.py``);
  * 2 ranks with noise on (K2's plain version with sample offsets, band
    permutation) against one process on the same global batch: noisy
    inputs bit-equal, loss within 1e-5; then an eval step on a padded
    batch, whose sums equal one process's; and a control, the same step
    with each rank's BatchNorm moments over its own rows, outside 1e-5;
  * 4 ranks as a (2 data x 2 model) mesh against the JAX (data x model)
    step;
  * a 2-rank ``Trainer.fit`` from ``setup_training_session`` against one
    process: the same history, one writer of checkpoints, every rank
    resuming; ``scripts.train`` under torchrun; the trainer's refusal of
    an indivisible global batch and its trim and skip of validation
    batches;
  * ``dryrun_multichip(2)`` and ``(4)``: the dry run's task and check,
    run in the 2-rank ``fit`` launch and the 4-rank TP launch.

The launches that need no JAX weights start before the JAX set-up, the
JAX mesh steps run in threads beside the others. Four launches of 2, 2
(under torchrun), 2 and 4 ranks run at once.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu.ops.noise import NoiseConfig as JaxNoiseConfig
from msid_tpu.parallel import make_mesh as jax_make_mesh
from msid_tpu.parallel import replicate as jax_replicate
from msid_tpu.parallel import shard_batch as jax_shard_batch
from msid_tpu.parallel import shard_train_state as jax_shard_train_state
from msid_tpu.training.losses import LossConfig as JaxLossConfig
from msid_tpu.training.optim import build_optimizer as jax_build_optimizer
from msid_tpu.training.train_state import TrainState as JaxTrainState
from msid_tpu.training.train_state import make_train_step as jax_make_train_step
from msid_tpu_torch.parallel.dryrun import (
    ROOT,
    build,
    check_dryrun,
    dryrun_run,
    run_fit,
    run_step,
    spawn,
)
from msid_tpu_torch.training.trainer import Trainer
from test_torch_model import randomize_variables
from test_torch_train_step import (
    LOSS,
    OPT,
    TINY_FLAGSHIP,
    ZERO_NOISE,
    assert_close_to_a_step,
    numpy_state,
    port_model,
    raw_tiles,
)

torch.set_num_threads(2)

LAUNCH_TIMEOUT_S = 120
LR = 1e-3
LOSS_REL = 2e-4                   # the JAX mesh test's bound (tests/test_parallel.py)
NOISY_LOSS_REL = 1e-5             # one process against two: fp32 sums in another order
EVAL_REL = 1e-5
FIT_REL = 1e-4
NOISE_ON = dict(enable_striping=True, stripe_prob=0.5)
FIT_CONFIG = "configs/experiments/tiny_cpu.yaml"


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxModel(**TINY_FLAGSHIP, dtype=jnp.float32, gradient_checkpointing=False)
    return model, randomize_variables(init_model(model, jax.random.PRNGKey(0)), seed=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory, jax_variables):
    """The converted weights, the batches and an output directory."""
    tmp = tmp_path_factory.mktemp("distributed")
    weights = tmp / "weights.pt"
    torch.save(port_model(jax_variables[1]).state_dict(), weights)     # weights.pt
    np.save(tmp / "batch.npy", raw_tiles())
    np.save(tmp / "batch_tp.npy", raw_tiles(seed=7))
    np.save(tmp / "batch5.npy", raw_tiles(b=5, seed=2))
    evals = raw_tiles(seed=1)
    evals[3] = evals[0]                     # a padded batch of 3 real tiles
    np.save(tmp / "eval.npy", evals)
    return {k: str(tmp / f"{k}.{'pt' if k == 'weights' else 'npy'}")
            for k in ("weights", "batch", "batch_tp", "batch5", "eval")} | {"tmp": tmp}


def step_spec(files, **kw) -> dict:
    return dict(dict(task="step", model=dict(TINY_FLAGSHIP, gradient_checkpointing=True),
                     weights=files["weights"], batch=files["batch"], loss=LOSS,
                     optimizer=dict(OPT, lr=LR), noise=ZERO_NOISE, noise_impl="jnp",
                     save_state=True), **kw)


def noisy_spec(files) -> dict:
    return step_spec(files, noise=NOISE_ON, noise_impl="pallas", band_permutation_prob=0.5,
                     seed=11, save_state=False,
                     eval=dict(batch=files["eval"], count=3, seed=5))


def rules_spec(files) -> dict:
    return step_spec(files, task="trainer_rules", batch=files["batch5"])


@pytest.fixture(scope="module")
def pool():
    with ThreadPoolExecutor(8) as executor:
        yield executor


@pytest.fixture(scope="module")
def early(pool, tmp_path_factory):
    """The launches that need no JAX weights, started first."""
    out = tmp_path_factory.mktemp("fit")
    fit = {"fit": dict(task="fit", config=FIT_CONFIG, output_dir=str(out / "fit2")),
           "dryrun": dryrun_run(2, str(tmp_path_factory.mktemp("dryrun2")))}
    cli = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "msid_tpu_torch.scripts.train", "--config", FIT_CONFIG, "--synthetic",
           "--device", "cpu", "--epochs", "1", "--output-dir", str(out / "cli")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return {"fit": pool.submit(spawn, 2, fit, LAUNCH_TIMEOUT_S),
            "cli": pool.submit(subprocess.run, cli, cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=LAUNCH_TIMEOUT_S),
            "out": out}


@pytest.fixture(scope="module")
def launches(early, files, jax_variables, pool, tmp_path_factory):
    """Every launch and the JAX mesh steps, each a future; the launches
    on the JAX weights start once they are written."""
    runs2 = {"jax": step_spec(files), "noisy": noisy_spec(files),
             "noisy_local_norms": dict(noisy_spec(files), local_norms=True, eval=None),
             "rules": rules_spec(files)}
    runs4 = {"tp": step_spec(files, batch=files["batch_tp"], model_parallel=2),
             "dryrun": dryrun_run(4, str(tmp_path_factory.mktemp("dryrun4")))}
    return dict(early,
                two=pool.submit(spawn, 2, runs2, LAUNCH_TIMEOUT_S),
                four=pool.submit(spawn, 4, runs4, LAUNCH_TIMEOUT_S),
                jax_dp=pool.submit(jax_mesh_step, jax_variables, raw_tiles(), 2),
                jax_tp=pool.submit(jax_mesh_step, jax_variables, raw_tiles(seed=7), 4, 2))


def jax_mesh_step(jax_variables, batch, devices, model_parallel=1):
    model, variables = jax_variables
    tx = jax_build_optimizer(optax.constant_schedule(LR), params=variables["params"], **OPT)
    mesh = jax_make_mesh(devices=jax.devices()[:devices], model_parallel=model_parallel)
    step = jax_make_train_step(model, tx, JaxLossConfig(**LOSS), JaxNoiseConfig(**ZERO_NOISE),
                               accum_steps=1, image_size=32, noise_impl="jnp", mesh=mesh)
    state = JaxTrainState.create(variables, tx)
    state = (jax_shard_train_state(state, mesh) if model_parallel > 1
             else jax_replicate(state, mesh))
    new, metrics = step(state, jax_shard_batch(batch, mesh), jax.random.PRNGKey(0))
    return ({k: float(jax.device_get(v)) for k, v in metrics.items()},
            jax.device_get({"params": new.params, "batch_stats": new.batch_stats}))


def assert_matches_jax(ranks, jax_metrics, jax_state):
    for r in ranks:
        assert r["step"] == 1 and r["metrics"]["skipped"] == 0
        for key in ("loss", "mse", "grad_norm"):
            assert r["metrics"][key] == pytest.approx(jax_metrics[key], rel=LOSS_REL), key
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    want = numpy_state(port_model(jax_state))
    got = {k: v.numpy() for k, v in ranks[0]["state"].items()}
    assert_close_to_a_step(got, want)
    for r in ranks[1:]:                                # every rank holds the same weights
        for k, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k


def test_two_ranks_match_the_jax_mesh_step(launches):
    metrics, state = launches["jax_dp"].result()
    ranks = [r["jax"] for r in launches["two"].result()]
    assert_matches_jax(ranks, metrics, state)
    assert float(metrics["grad_norm"]) > OPT["gradient_clip"]       # the clip acted


@pytest.fixture(scope="module")
def one_noisy(files):
    """The noisy step and eval sums in this process, on the whole batch."""
    return run_step(noisy_spec(files), torch.device("cpu"))


def test_two_ranks_with_noise_equal_one_process(launches, one_noisy):
    one = one_noisy
    ranks = [r["noisy"] for r in launches["two"].result()]
    assert torch.equal(torch.cat([r["noisy"] for r in ranks]), one["noisy"])
    for r in ranks:
        for key in ("loss", "mse", "grad_norm"):
            assert r["metrics"][key] == pytest.approx(one["metrics"][key],
                                                      rel=NOISY_LOSS_REL), key
        assert r["eval"]["count"] == 3.0
        for key, value in one["eval"].items():
            assert r["eval"][key] == pytest.approx(value, rel=EVAL_REL), key


def test_two_ranks_with_local_norms_fall_outside_the_bound(launches, one_noisy):
    """A control: with each rank's BatchNorm moments over its own rows, the
    same step leaves NOISY_LOSS_REL, so the bound sees the reduction."""
    ranks = [r["noisy_local_norms"] for r in launches["two"].result()]
    assert torch.equal(torch.cat([r["noisy"] for r in ranks]), one_noisy["noisy"])
    for r in ranks:
        assert r["metrics"]["loss"] != pytest.approx(one_noisy["metrics"]["loss"],
                                                     rel=NOISY_LOSS_REL)


def test_four_rank_tensor_parallel_step_matches_the_jax_data_model_step(launches):
    metrics, state = launches["jax_tp"].result()
    ranks = [r["tp"] for r in launches["four"].result()]
    assert_matches_jax(ranks, metrics, state)
    assert ranks[0]["sharding"].startswith("model-sharded ")
    assert "encoder.blocks.0.mlp.fc1.weight: dim 0 over 'model'" in ranks[0]["sharding"]


def test_two_rank_fit_equals_one_process_and_rank_zero_writes(launches):
    one = run_fit(dict(config=FIT_CONFIG, output_dir=str(launches["out"] / "fit1")),
                  torch.device("cpu"), None)
    ranks = [r["fit"] for r in launches["fit"].result()]
    assert [r["train_batch"] for r in ranks] == [one["train_batch"] // 2] * 2
    timeless = [{k: v for k, v in r["history"].items() if k != "epoch_time"} for r in ranks]
    assert timeless[0] == timeless[1]
    # After a step the weights differ by fp32 reassociation, which AdamW's
    # first step g / (|g| + eps) amplifies where |g| ~ eps (see
    # test_torch_train_step.py): one epoch's metrics agree to FIT_REL (SSIM,
    # near 0 here, to FIT_REL absolute).
    for key in ("train_loss", "val_loss", "val_psnr"):
        np.testing.assert_allclose(ranks[0]["history"][key], one["history"][key],
                                   rtol=FIT_REL, err_msg=key)
    np.testing.assert_allclose(ranks[0]["history"]["val_ssim"], one["history"]["val_ssim"],
                               atol=FIT_REL)
    assert ranks[0]["checkpoints"] == one["checkpoints"] == ["1"]
    assert ranks[0]["step"] == one["step"] > 0
    for r in ranks:                     # every rank resumes from rank 0's checkpoint
        assert (r["resumed_epoch"], r["resumed_step"]) == (1, r["step"])


def test_torchrun_train_cli_writes_from_rank_zero_the_one_process_history(launches):
    one = run_fit(dict(config=FIT_CONFIG, output_dir=str(launches["out"] / "fit1b")),
                  torch.device("cpu"), None)
    proc = launches["cli"].result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    history = json.loads((launches["out"] / "cli" / "logs" / "training_history.json")
                         .read_text())
    np.testing.assert_allclose(history["train_loss"], one["history"]["train_loss"],
                               rtol=FIT_REL)
    assert sorted(p.name for p in (launches["out"] / "cli" / "checkpoints").iterdir()) == ["1"]
    assert proc.stderr.count("epoch 1/1: train_loss") == 1           # rank 0 logs


def test_data_parallel_trainer_refuses_trims_and_skips_as_the_jax_trainer(launches, files):
    built = build(rules_spec(files), torch.device("cpu"))
    one = Trainer(built["model"], built["state"], config={}, device="cpu",
                  eval_step=built["eval_step"])
    batch = np.load(files["batch5"])
    want = one.validate([(batch[:4], 4)])           # 5 -> 4 rows; the 1-row batch skipped
    for r in (r["rules"] for r in launches["two"].result()):
        assert "not divisible by the 2-way data axis" in r["refusal"]
        for key, value in want.items():
            assert r["val"][key] == pytest.approx(value, rel=EVAL_REL), key


@pytest.mark.parametrize("n,launch,mesh", [(2, "fit", [2, 1]), (4, "four", [2, 2])])
def test_dryrun_multichip(launches, n, launch, mesh):
    """``dryrun_multichip(n)``'s run and check, in a launch of n ranks that
    also runs another test's task (fewer processes at once)."""
    results = [r["dryrun"] for r in launches[launch].result()]
    assert len(results) == n and all(r["mesh"] == mesh for r in results)
    assert np.isfinite(check_dryrun(results))
