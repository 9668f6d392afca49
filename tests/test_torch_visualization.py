"""The port's ``utils/visualization.py`` and ``utils/notebook_helpers.py`` on
the CPU: the display transforms exactly equal to the JAX functions, every
plot writes its file, the triptychs of the eval path and of
``scripts.evaluate --save_visualizations``, and the notebook helpers
(printed summaries equal to the JAX ones)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from msid_tpu.utils import notebook_helpers as jax_nb
from msid_tpu.utils import visualization as jax_vis
from msid_tpu_torch.data.dataset import SyntheticEuroSAT
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.noise import NoiseConfig
from msid_tpu_torch.scripts import evaluate as evaluate_cli
from msid_tpu_torch.utils import notebook_helpers as nb
from msid_tpu_torch.utils import visualization as vis

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY_CONFIG = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"
TINY = dict(image_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
            decoder_channels=(8, 8, 8, 8), gradient_checkpointing=False)


def tiles(shape, seed=0, raw=False):
    rng = np.random.default_rng(seed)
    if raw:          # digital numbers, as the datasets yield them
        return rng.uniform(0, 10000, shape).astype(np.float32)
    return rng.normal(0, 0.7, shape).astype(np.float32)


def test_band_tables_are_the_references():
    assert vis.RGB_BAND_INDICES == jax_vis.RGB_BAND_INDICES == (3, 2, 1)
    assert vis.SENTINEL2_WAVELENGTHS == jax_vis.SENTINEL2_WAVELENGTHS
    assert vis.SENTINEL2_BAND_NAMES == jax_vis.SENTINEL2_BAND_NAMES


@pytest.mark.parametrize("kind", ["normal", "constant", "uint16", "wide_percentiles"])
def test_display_transforms_equal_the_jax_functions(kind):
    rng = np.random.default_rng(1)
    img = {"normal": rng.normal(0, 1, (16, 12, 13)).astype(np.float32),
           "constant": np.full((8, 8, 13), 0.25, np.float32),
           "uint16": rng.integers(0, 10000, (9, 7, 13)).astype(np.uint16),
           "wide_percentiles": rng.normal(0, 1, (10, 10, 13))}[kind]
    kwargs = {"lower": 10.0, "upper": 90.0} if kind == "wide_percentiles" else {}
    ours = vis.normalize_for_display(img, **kwargs)
    theirs = jax_vis.normalize_for_display(img, **kwargs)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    ours, theirs = vis.extract_rgb(img), jax_vis.extract_rgb(img)
    assert ours.shape == img.shape[:2] + (3,)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


PLOTS = {
    "sample_grid": lambda path: vis.plot_sample_grid(tiles((5, 16, 16, 13)), path),
    "triptych": lambda path: vis.plot_restoration_triptych(
        *(tiles((16, 16, 13), s) for s in range(3)), save_path=path,
        metrics={"PSNR": 30.0, "SSIM": 0.9}),
    "spectra": lambda path: vis.plot_spectral_signatures(
        tiles((40, 40, 13)), tiles((40, 40, 13), 1), tiles((40, 40, 13), 2), save_path=path),
    "one_pixel_spectrum": lambda path: vis.plot_spectral_signatures(
        tiles((8, 8, 13)), tiles((8, 8, 13), 1), pixels=((3, 3),), save_path=path),
    "bands": lambda path: vis.plot_band_comparison(tiles((8, 8, 13)), tiles((8, 8, 13), 1),
                                                   save_path=path),
    "curves": lambda path: vis.plot_training_curves(
        {"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6], "val_psnr": [20.0, 25.0],
         "val_ssim": [0.5, 0.7], "lr": [1e-4, 5e-5]}, save_path=path),
}


@pytest.mark.parametrize("plot", list(PLOTS))
def test_every_plot_writes_its_file(plot, tmp_path):
    path = tmp_path / "nested" / f"{plot}.png"
    assert PLOTS[plot](path) is None
    assert path.stat().st_size > 0
    fig = PLOTS[plot](None)                 # without a path the figure comes back
    assert fig is not None and len(fig.axes) > 0
    vis._plt().close(fig)


def tiny_model(seed=0):
    torch.manual_seed(seed)
    return SatMAERestoration(**TINY).eval()


def test_save_restoration_triptychs_runs_the_eval_path(tmp_path):
    """The first batch (its padding dropped), corrupted with ``eval_seed``
    and restored: two files per sample; the metrics are the eval path's."""
    model = tiny_model()
    batch = tiles((6, 32, 32, 13), raw=True)
    loader = [(batch, 3)]                   # a padding loader's (batch, true count)
    cfg = NoiseConfig(gaussian_sigma=0.05)
    n = vis.save_restoration_triptychs(model, None, loader, tmp_path / "v", noise_cfg=cfg,
                                       image_size=32, num_samples=5)
    assert n == 3
    assert sorted(p.name for p in (tmp_path / "v").iterdir()) == [
        f"sample_{i:02d}{s}.png" for i in range(3) for s in ("", "_spectra")]
    clean, noisy, restored, psnr, ssim = vis.restore_batch(model, None, batch[:3], cfg, 32,
                                                           seed=1234)
    assert clean.shape == noisy.shape == restored.shape == (3, 32, 32, 13)
    assert psnr.shape == ssim.shape == (3,) and np.isfinite(psnr).all()
    assert not np.array_equal(clean, noisy)
    variables = {k: v.clone() for k, v in model.state_dict().items()}
    again = vis.restore_batch(tiny_model(seed=1), variables, batch[:3], cfg, 32, seed=1234)
    assert all(np.array_equal(a, b) for a, b in zip(again, (clean, noisy, restored, psnr, ssim)))


def test_evaluate_cli_saves_visualizations(tmp_path):
    """``--save_visualizations`` writes the reference's files (5 triptychs
    and 5 spectra) beside the results."""
    out = tmp_path / "eval"
    results = evaluate_cli.main(["--config", str(TINY_CONFIG), "--synthetic", "--device", "cpu",
                                 "--output-dir", str(out), "--save_visualizations"])
    assert np.isfinite(results["psnr"])
    assert (out / "evaluation_results.json").exists()
    assert sorted(p.name for p in (out / "visualizations").iterdir()) == [
        f"sample_{i:02d}{s}.png" for i in range(5) for s in ("", "_spectra")]


def test_visualize_batch_and_noise_impact_write_their_files(tmp_path):
    model = tiny_model()
    batch = tiles((3, 32, 32, 13), raw=True)
    assert nb.visualize_batch(model, None, batch, image_size=32, max_samples=2,
                              save_path=tmp_path / "batch.png") is None
    assert nb.visualize_noise_impact(batch, image_size=32, device="cpu",
                                     save_path=tmp_path / "noise.png") is None
    assert (tmp_path / "batch.png").stat().st_size > 0
    assert (tmp_path / "noise.png").stat().st_size > 0
    fig = nb.live_plot_history({"train_loss": [1.0], "val_loss": [1.0], "val_psnr": [20.0],
                                "val_ssim": [0.5], "lr": [1e-4]})
    assert len(fig.axes) == 4
    vis._plt().close(fig)


def test_visualize_noise_impact_corrupts_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nb.visualize_noise_impact(tiles((1, 32, 32, 13), raw=True), image_size=32)


def test_dataset_helpers_print_what_the_jax_ones_print(capsys, tmp_path):
    dataset = SyntheticEuroSAT(num_samples=5, tile_size=16, seed=0)
    info = nb.print_dataset_info(dataset, "synthetic")
    ours = capsys.readouterr().out
    assert info == jax_nb.print_dataset_info(dataset, "synthetic")
    assert ours == capsys.readouterr().out
    results = {"psnr": 31.25, "ssim": 0.91, "sam": 2.5, "rmse": 0.02, "loss": 0.1, "x": 1}
    nb.print_evaluation_summary(results)
    ours = capsys.readouterr().out
    jax_nb.print_evaluation_summary(results)
    assert ours == capsys.readouterr().out
    assert nb.explore_dataset(dataset, num_samples=3, save_path=tmp_path / "d.png") is None
    assert (tmp_path / "d.png").stat().st_size > 0


def test_figures_without_matplotlib_are_raster_pngs(tmp_path, monkeypatch):
    """Where matplotlib is missing (the machine with the card), the triptych,
    spectra and training-curve figures saved to a file are plain PNGs: the
    triptych is the three RGB composites side by side, as a PNG reader
    (matplotlib's, here) decodes them, and each line panel is framed and
    drawn."""
    import matplotlib.image as mimg

    monkeypatch.setattr(vis, "_have_matplotlib", lambda: False)
    noisy, clean, restored = (tiles((24, 20, 13), seed=s) for s in range(3))
    vis.plot_restoration_triptych(noisy, clean, restored, save_path=tmp_path / "t.png")
    gap = np.ones((24, 8, 3))
    want = np.concatenate([vis.extract_rgb(noisy), gap, vis.extract_rgb(restored), gap,
                           vis.extract_rgb(clean)], axis=1)
    got = mimg.imread(tmp_path / "t.png")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.5 / 255 + 1e-6)

    vis.plot_spectral_signatures(clean, restored, noisy, save_path=tmp_path / "s.png")
    history = {"train_loss": [1.0, 0.6, 0.5], "val_loss": [0.9, 0.7, float("nan")],
               "val_psnr": [20.0, 22.5, 23.0], "val_ssim": [0.5, 0.6, 0.65],
               "lr": [1e-4, 5e-5, 0.0]}
    vis.plot_training_curves(history, save_path=tmp_path / "c.png")
    h, w = vis.RASTER_PANEL
    for name, panels in (("s.png", 3), ("c.png", 4)):
        img = mimg.imread(tmp_path / name)
        assert img.shape == (h, panels * w + (panels - 1) * 8, 3)
        for k in range(panels):
            panel = img[:, k * (w + 8):k * (w + 8) + w]
            assert (panel[[0, -1]] == 0).all() and (panel[:, [0, -1]] == 0).all()
            colours = {tuple(px) for px in np.round(panel[1:-1, 1:-1] * 255).reshape(-1, 3)}
            assert len(colours) >= 2, (name, k)     # white and at least one line
