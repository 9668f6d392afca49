"""The port's checkpoints (``utils/checkpointing.py``) on the CPU: a bit-exact
round trip of the train state, top-K retention and best step against the JAX
package's Orbax manager on the same metric sequence, the save cadence, bf16
moments, the EMA adaptations, a full restore and the weights-only warm
start across a changed freeze set, and background saves."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.utils.checkpointing import CheckpointManager as JaxCheckpointManager
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.training.optim import build_optimizer
from msid_tpu_torch.training.schedules import cosine_warm_restarts
from msid_tpu_torch.training.train_state import TrainState, make_train_step
from msid_tpu_torch.training.trainer import Trainer
from msid_tpu_torch.utils import checkpointing
from msid_tpu_torch.utils.checkpointing import CheckpointManager, load_single, save_single

torch.set_num_threads(2)

TINY = dict(image_size=32, embed_dim=32, depth=1, num_heads=2, decoder_arch="unet_skip",
            decoder_channels=(8, 8, 8, 8), residual_output=True, input_fill=True)
ZERO_NOISE = NoiseConfig(gaussian_sigma=0.0, speckle_sigma=0.0, dead_band_prob=0.0,
                         thermal_scale=0.0, enable_striping=False)
PSNR_SEQUENCE = (30.1, 31.5, 29.0, 31.5, 32.0, 28.0, 33.0, 27.5)


def new_state(freeze=(0,), ema=False, seed=0):
    torch.manual_seed(seed)
    model = SatMAERestoration(**TINY)
    optimizer = build_optimizer(model, cosine_warm_restarts(1e-3, 10, 2, 1e-6),
                                freeze_layers=freeze)
    return TrainState.create(model, optimizer, ema=ema)


def trained_state(steps=2, ema=True, seed=0):
    """A state with AdamW moments, BN statistics and an EMA that moved."""
    state = new_state(ema=ema, seed=seed)
    step = make_train_step(state.model, LossConfig(), ZERO_NOISE, image_size=32,
                           noise_impl="jnp", ema_decay=0.9 if ema else 0.0)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        state, _ = step(state, rng.uniform(500, 9500, (4, 16, 16, 13)).astype(np.float32), i)
    return state


def assert_tree_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_state_round_trips_bit_exactly(tmp_path):
    state = trained_state()
    state.nan_skips = 3
    manager = CheckpointManager(tmp_path)
    assert manager.save(2, state, metrics={"val_psnr": 30.0}, metadata={"epoch": 2})
    target = new_state(seed=1)
    restored, metadata, step = manager.load_latest(target=target)
    assert restored is target and step == 2 and metadata["epoch"] == 2
    assert metadata["_has_ema"] is True
    assert target.step == 2 and target.nan_skips == 3
    assert_tree_equal(target.state_dict(), state.state_dict())
    assert target.optimizer.state_dict()["state"], "moments were saved"
    raw, _, _ = CheckpointManager(tmp_path).load_step(2)          # no target: the dict
    assert_tree_equal(raw["model"], dict(state.model.state_dict()))


def jax_state():
    return {"w": jnp.zeros(2)}


@pytest.mark.parametrize("mode,keep", [("max", 3), ("min", 3), ("max", 2), ("min", 1)])
def test_top_k_and_best_step_match_orbax(tmp_path, mode, keep):
    metric = "val_psnr" if mode == "max" else "val_loss"
    ours = CheckpointManager(tmp_path / "port", keep_top_k=keep, metric=metric, mode=mode)
    theirs = JaxCheckpointManager(tmp_path / "jax", keep_top_k=keep, metric=metric,
                                  mode=mode, async_save=False)
    state = {"model": {"w": torch.zeros(2)}}
    for step, value in enumerate(PSNR_SEQUENCE, start=1):
        metrics = {metric: value, "val_ssim": 0.5}
        assert ours.save(step, state, metrics=metrics) == theirs.save(
            step, jax_state(), metrics=metrics)
        theirs.wait_until_finished()
        assert ours.all_steps() == theirs.all_steps(), step
        assert ours.best_step() == theirs._mgr.best_step(), step
        assert ours.latest_step() == theirs._mgr.latest_step(), step
    reopened = CheckpointManager(tmp_path / "port", metric=metric, mode=mode)
    assert reopened.all_steps() == ours.all_steps()
    assert reopened.best_step() == ours.best_step()
    theirs.close()


def test_save_cadence_and_force_match_orbax(tmp_path):
    ours = CheckpointManager(tmp_path / "port", keep_top_k=10, save_every=3)
    theirs = JaxCheckpointManager(tmp_path / "jax", keep_top_k=10, save_every=3,
                                  async_save=False)
    state = {"model": {"w": torch.zeros(2)}}
    calls = [(1, False), (2, False), (3, False), (4, True), (5, False), (6, False),
             (6, False), (5, True), (7, False)]
    for step, force in calls:
        metrics = {"val_psnr": float(step)}
        assert ours.save(step, state, metrics=metrics, force=force) == theirs.save(
            step, jax_state(), metrics=metrics, force=force), (step, force)
        theirs.wait_until_finished()
    assert ours.all_steps() == theirs.all_steps() == [3, 4, 5, 6]
    with pytest.raises(ValueError, match="already exists"):
        ours.save(6, state, force=True)
    theirs.close()


def test_bf16_moments_round_trip(tmp_path):
    state = trained_state()
    manager = CheckpointManager(tmp_path, moments_dtype="bfloat16")
    manager.save(1, state, metrics={"val_psnr": 1.0})
    raw, metadata, _ = manager.load_latest()
    assert metadata["_moments_dtype"] == "bfloat16"
    saved_moments = [e for e in raw["optimizer"]["state"].values()]
    assert saved_moments and all(e["exp_avg"].dtype == torch.bfloat16 and
                                 e["exp_avg_sq"].dtype == torch.bfloat16
                                 for e in saved_moments)
    target = new_state(seed=1)
    manager.load_latest(target=target)
    got = target.optimizer.state_dict()["state"]
    for i, entry in state.optimizer.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert got[i][key].dtype == torch.float32
            assert torch.equal(got[i][key], entry[key].bfloat16().float())
        assert torch.equal(got[i]["step"], entry["step"])
    assert_tree_equal(dict(target.model.state_dict()), dict(state.model.state_dict()))


def test_shadow_saved_into_a_target_without_one(tmp_path):
    state = trained_state(ema=True)
    manager = CheckpointManager(tmp_path)
    manager.save(1, state, metrics={})
    target = new_state(ema=False, seed=1)
    manager.load_latest(target=target)
    assert_tree_equal(target.ema, state.ema)
    variables = target.eval_variables()
    assert torch.equal(variables["decoder.head_conv.weight"],
                       state.ema["decoder.head_conv.weight"])
    raw = target.eval_variables(raw=True)
    assert torch.equal(raw["decoder.head_conv.weight"],
                       state.model.get_parameter("decoder.head_conv.weight"))


def test_target_with_ema_reseeds_from_a_checkpoint_without_one(tmp_path):
    state = trained_state(ema=False)
    manager = CheckpointManager(tmp_path)
    manager.save(1, state, metrics={})
    target = new_state(ema=True, seed=1)
    manager.load_latest(target=target)
    assert set(target.ema) == {n for n, _ in target.model.named_parameters()}
    for name, p in state.model.named_parameters():
        assert torch.equal(target.ema[name], p.detach()), name


def test_trainer_resume_drops_a_shadow_it_would_never_update(tmp_path):
    state = trained_state(ema=True)
    manager = CheckpointManager(tmp_path)
    history = {"val_loss": [0.5, 0.4], "val_psnr": [30.0, 31.0]}
    manager.save(2, state, metrics={"val_psnr": 31.0},
                 metadata={"epoch": 2, "history": history})
    target = new_state(ema=False, seed=1)
    trainer = Trainer(target.model, target, config={}, checkpoint_manager=manager,
                      device="cpu")
    assert trainer.load_checkpoint() == 2
    assert trainer.state.ema is None and trainer.state.step == 2
    assert trainer.history == history
    assert trainer.best_val_loss == 0.4 and trainer.best_val_metric == 31.0
    ema_trainer = Trainer(new_state(seed=2).model, new_state(seed=2), device="cpu",
                          config={"training": {"ema_decay": 0.99}})
    assert ema_trainer.load_checkpoint(manager) == 2
    assert_tree_equal(ema_trainer.state.ema, state.ema)


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_load_weights_across_a_changed_freeze_set(tmp_path, prefer_ema):
    source = trained_state(ema=True)
    manager = CheckpointManager(tmp_path)
    manager.save(1, source, metrics={"val_psnr": 1.0})
    target = new_state(freeze=(), ema=True, seed=1)        # other optimizer groups
    # A full restore crosses the changed freeze set too (its moments by
    # name); the warm start keeps the target's optimizer and step.
    full, _, _ = CheckpointManager(tmp_path).load_latest(target=new_state(freeze=(), seed=1))
    assert full.step == source.step and full.optimizer.state_dict()["state"]
    got, _, step = manager.load_weights(target, prefer_ema=prefer_ema)
    assert got is target and step == 1
    assert target.step == 0 and not target.optimizer.state_dict()["state"]
    want = source.ema if prefer_ema else dict(source.model.named_parameters())
    for name, p in target.model.named_parameters():
        assert torch.equal(p.detach(), want[name].detach()), name
        assert torch.equal(target.ema[name], p.detach()), name
    for name, buf in source.model.named_buffers():
        assert torch.equal(target.model.get_buffer(name), buf), name
    assert CheckpointManager(tmp_path / "empty").load_weights(target) is None


@pytest.mark.parametrize("freeze", [((0,), ()), ((), (0,))], ids=["unfreeze", "freeze"])
def test_full_restore_across_a_changed_freeze_set_keeps_moments_by_name(tmp_path, freeze):
    """Stage B of the two-stage recipe resumes stage A's checkpoint under
    another freeze set: each parameter trained on both sides gets its
    moments back, one trained only now starts with none (AdamW makes them
    at its first step), and one frozen now gets none."""
    source = new_state(freeze=freeze[0])
    step = make_train_step(source.model, LossConfig(), ZERO_NOISE, image_size=32,
                           noise_impl="jnp")
    batch = np.random.default_rng(0).uniform(500, 9500, (4, 16, 16, 13)).astype(np.float32)
    source, _ = step(source, batch, 0)
    CheckpointManager(tmp_path).save(1, source, metrics={"val_psnr": 1.0})
    target, _, _ = CheckpointManager(tmp_path).load_best(target=new_state(freeze=freeze[1],
                                                                          seed=1))

    def moments(state):
        params = dict(state.model.named_parameters())
        return {name: state.optimizer.adamw.state.get(params[name])
                for group in state.optimizer.adamw.param_groups for name in group["names"]}

    before, after = moments(source), moments(target)
    assert set(before) != set(after)
    for name, entry in after.items():
        if name in before:
            assert_tree_equal(entry, before[name], name)
        else:
            assert entry is None, name
    target, _ = make_train_step(target.model, LossConfig(), ZERO_NOISE, image_size=32,
                                noise_impl="jnp")(target, batch, 1)
    assert all(v is not None for v in moments(target).values())


def test_background_saves_are_ordered_snapshots(tmp_path, monkeypatch):
    in_flight, most = [0], [0]
    lock = threading.Lock()
    real_save = torch.save

    def slow_save(obj, path):
        with lock:
            in_flight[0] += 1
            most[0] = max(most[0], in_flight[0])
        time.sleep(0.05)
        real_save(obj, path)
        with lock:
            in_flight[0] -= 1

    monkeypatch.setattr(checkpointing.torch, "save", slow_save)
    state = trained_state(steps=1, ema=False)
    manager = CheckpointManager(tmp_path, keep_top_k=5, background_transfer=True)
    weight = state.model.get_parameter("decoder.head_conv.weight")
    values = []
    for step in (1, 2, 3):
        values.append(weight.detach().clone())
        assert manager.save(step, state, metrics={"val_psnr": float(step)})
        with torch.no_grad():
            weight.add_(1.0)                  # the caller moves on at once
    manager.wait_until_finished()
    assert manager.all_steps() == [1, 2, 3] and most[0] == 1
    for step, value in zip((1, 2, 3), values):
        raw, _, _ = manager.load_step(step)
        assert torch.equal(raw["model"]["decoder.head_conv.weight"], value), step


def test_background_save_error_raises_at_the_next_sync_point(tmp_path, monkeypatch):
    def full_disk(obj, path):
        raise OSError("no space left on device")

    state = {"model": {"w": torch.zeros(2)}}
    manager = CheckpointManager(tmp_path, background_transfer=True)
    monkeypatch.setattr(checkpointing.torch, "save", full_disk)
    assert manager.save(1, state, metrics={}) is True
    with pytest.raises(OSError, match="no space"):
        manager.wait_until_finished()
    assert manager.all_steps() == []
    assert manager.save(2, state, metrics={}) is True
    with pytest.raises(OSError, match="no space"):
        manager.save(3, state, metrics={})
    monkeypatch.undo()
    assert manager.save(4, state, metrics={}) is True
    manager.close()
    assert manager.all_steps() == [4]


def test_save_single_round_trip(tmp_path):
    state = trained_state(steps=1)
    save_single(tmp_path / "best", state, metadata={"val_psnr": 31.0})
    target = new_state(seed=1)
    restored, metadata = load_single(tmp_path / "best", target=target)
    assert restored is target and metadata == {"val_psnr": 31.0}
    assert_tree_equal(target.state_dict(), state.state_dict())
    raw, _ = load_single(tmp_path / "best")
    assert_tree_equal(raw["ema"], state.ema)
