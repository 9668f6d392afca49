"""The port's data, Gram fit, session and trainer against the JAX package,
on the CPU: synthetic tiles and loader batches bit for bit, the Gram fit to
1e-5, and the tiny CPU recipe (``tiny_cpu.yaml``) trained for two epochs
through ``setup_training_session(device="cpu")``."""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from msid_tpu.data.dataset import SyntheticEuroSAT as JaxSynthetic
from msid_tpu.data.dataset import _reference_split as jax_split
from msid_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from msid_tpu.ops.fill import fit_gram as jax_fit_gram
from msid_tpu.ops.fill import fit_gram_from_config as jax_fit_gram_from_config
from msid_tpu.utils.setup_helpers import estimate_memory as jax_estimate_memory
from msid_tpu_torch.data.dataset import (
    EuroSATMultiSpectral,
    SyntheticEuroSAT,
    _reference_split,
    build_dataset,
)
from msid_tpu_torch.data.pipeline import BatchLoader, DeviceCachedLoader, get_dataloaders
from msid_tpu_torch.data.tiff import write_tiff
from msid_tpu_torch.ops.fill import fit_gram, fit_gram_from_config
from msid_tpu_torch.training import trainer as trainer_module
from msid_tpu_torch.training.eval import run_eval_loop, split_batch_item
from msid_tpu_torch.training.trainer import MAX_NAN_SKIPS_PER_EPOCH, Trainer
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.setup_helpers import estimate_memory, setup_training_session

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
FLAGSHIP = ROOT / "configs" / "experiments" / "long_skip_fill.yaml"
GRAM_RTOL = 1e-5


@pytest.mark.parametrize("complexity", ["base", "rich", "mixed"])
def test_synthetic_tiles_equal_jax(complexity):
    for split in ("train", "val"):
        ours = SyntheticEuroSAT(40, split=split, seed=3, complexity=complexity)
        theirs = JaxSynthetic(40, split=split, seed=3, complexity=complexity)
        assert len(ours) == len(theirs)
        for i in (0, len(ours) - 1):
            assert np.array_equal(ours[i], theirs[i])
    assert all(np.array_equal(a, b) for a, b in zip(_reference_split(97, 0.8, 5),
                                                     jax_split(97, 0.8, 5)))


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, drop_last=True, prefetch=2),
    dict(shuffle=False, drop_last=False, pad_last=True, prefetch=0),
])
def test_batch_loader_equals_jax(kwargs):
    ds = SyntheticEuroSAT(30, seed=1, tile_size=8)
    ours = BatchLoader(ds, batch_size=4, seed=7, **kwargs)
    theirs = JaxBatchLoader(ds, batch_size=4, seed=7, **kwargs)
    assert len(ours) == len(theirs)
    for _ in range(2):                     # two epochs: the shuffle moves on
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a, count = split_batch_item(a)
            b, want_count = split_batch_item(b)
            assert count == want_count and np.array_equal(a, b)


def test_fit_gram_matches_jax():
    ds = SyntheticEuroSAT(24, seed=2, tile_size=16)
    loader = BatchLoader(ds, batch_size=5, shuffle=False, drop_last=False, pad_last=True)
    got = fit_gram(loader, image_size=32)
    want = jax_fit_gram(JaxBatchLoader(ds, batch_size=5, shuffle=False, drop_last=False,
                                       pad_last=True), image_size=32)
    assert got.shape == (14, 14) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=GRAM_RTOL, atol=GRAM_RTOL * np.abs(want).max())


def tiny_config(**data):
    config = load_config(TINY)
    config["data"].update(root_dir="/nonexistent-forces-synthetic", **data)
    return config


def test_fit_gram_from_config_matches_jax():
    config = tiny_config(image_size=32, synthetic_samples=20)
    want = jax_fit_gram_from_config(config)
    np.testing.assert_allclose(fit_gram_from_config(config), want, rtol=GRAM_RTOL,
                               atol=GRAM_RTOL * np.abs(want).max())


def test_estimate_memory_matches_jax():
    config = load_config(FLAGSHIP)
    assert estimate_memory(config, 123_456_789) == jax_estimate_memory(config, 123_456_789)


def test_tiny_recipe_trains_on_the_cpu(tmp_path):
    session = setup_training_session(TINY, synthetic=True, device="cpu", output_dir=tmp_path)
    trainer = session["trainer"]
    assert session["checkpoint_manager"].directory == tmp_path / "checkpoints"
    assert trainer.accum_steps == 1
    assert trainer.compute_dtype == torch.float32          # mixed_precision: false
    history = trainer.fit(session["train_loader"], session["val_loader"], epochs=2)
    assert len(history["val_psnr"]) == 2 and len(history["train_loss"]) == 2
    for key, values in history.items():
        assert np.isfinite(values).all(), key
    assert trainer.state.step == 2 * len(session["train_loader"])
    assert trainer.state.nan_skips == 0
    session["checkpoint_manager"].wait_until_finished()
    assert any(d.name.isdigit() for d in (tmp_path / "checkpoints").iterdir())


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_training_session(TINY, synthetic=True, output_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(torch.nn.Linear(1, 1), state=None)


def test_accumulation_collapses_when_it_fits(tmp_path, caplog):
    config = tiny_config()
    config["training"].update(micro_batch_size=2, gradient_accumulation_steps=4)
    with caplog.at_level(logging.INFO):
        session = setup_training_session(config, synthetic=True, device="cpu",
                                         output_dir=tmp_path)
    assert session["trainer"].accum_steps == 1
    assert "collapsing gradient accumulation 4x -> 1" in caplog.text
    config["training"]["auto_accum"] = False
    session = setup_training_session(config, synthetic=True, device="cpu", output_dir=tmp_path)
    assert session["trainer"].accum_steps == 4


def test_what_is_not_ported_raises(tmp_path):
    config = tiny_config()
    tiles = tmp_path / "tiles"
    (tiles / "River").mkdir(parents=True)
    for i in range(3):
        write_tiff(tiles / "River" / f"River_{i}.tif", np.full((64, 64, 13), i, np.uint16))
    ds = build_dataset(dict(config, data=dict(config["data"], root_dir=str(tiles))), "train")
    assert isinstance(ds, EuroSATMultiSpectral) and len(ds) == 2
    with pytest.raises(FileNotFoundError):
        build_dataset(dict(config, data=dict(config["data"], synthetic_fallback=False)), "train")
    train, val = get_dataloaders(dict(config, data=dict(config["data"], device_cache=True)),
                                 device="cpu")
    assert isinstance(train, DeviceCachedLoader) and isinstance(val, DeviceCachedLoader)
    # the folded graphs have no fill prologue: a hybrid validation pass on a
    # model with the input stage raises as the JAX package's does
    fill = dict(config, model=dict(config["model"], input_fill={"enabled": True}))
    session = setup_training_session(fill, synthetic=True, device="cpu", output_dir=tmp_path)
    with pytest.raises(ValueError, match="forward_impl='hybrid'"):
        Trainer(session["model"], session["state"],
                dict(fill, training=dict(fill["training"], eval_forward="hybrid")),
                device="cpu")
    pretrained = dict(config, model=dict(config["model"], encoder=dict(
        config["model"]["encoder"], pretrained_path=str(TINY))))
    with pytest.raises(NotImplementedError, match="convert.py"):
        setup_training_session(pretrained, synthetic=True, device="cpu", output_dir=tmp_path)


def test_too_many_skipped_steps_abort_the_epoch(tmp_path):
    session = setup_training_session(TINY, synthetic=True, device="cpu", output_dir=tmp_path)
    state = session["state"]

    def skipping_step(state, batch, seed):
        state.nan_skips += 1
        return state, {"loss": torch.tensor(float("nan"))}

    trainer = Trainer(session["model"], state, session["config"], train_step=skipping_step,
                      device="cpu")
    loader = [np.zeros((8, 64, 64, 13), np.float32)] * (MAX_NAN_SKIPS_PER_EPOCH + 2)
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.train_epoch(loader, 0)
    assert trainer_module.MAX_NAN_SKIPS_PER_EPOCH == 10


def test_run_eval_loop_means_and_seeds():
    seen = []

    def eval_step(batch, seed, count):
        seen.append(seed)
        n = float(count)
        return {k: torch.tensor(n * v) for k, v in
                dict(loss=1.0, psnr=30.0, ssim=0.5, sam=2.0, rmse=0.1).items()} | \
            {"count": torch.tensor(n)}

    out = run_eval_loop(eval_step, [(np.zeros((4, 1)), 4), (np.zeros((4, 1)), 1)], 9)
    assert out == pytest.approx(dict(loss=1.0, psnr=30.0, ssim=0.5, sam=2.0, rmse=0.1,
                                     num_samples=5))
    assert len(set(seen)) == 2
    run_eval_loop(eval_step, [(np.zeros((4, 1)), 4), (np.zeros((4, 1)), 1)], 9)
    assert seen[2:] == seen[:2]            # the same corruption every epoch
    assert run_eval_loop(eval_step, [], 9)["num_samples"] == 0
