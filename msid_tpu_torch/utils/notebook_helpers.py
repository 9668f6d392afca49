"""Interactive-session helpers (PyTorch): counterpart of
``msid_tpu/utils/notebook_helpers.py``.

Batch views with per-sample metrics, a redrawable training-progress figure,
dataset summaries and a noise-level view. Device work runs on the model's
device (``visualize_batch``) or on ``device`` (``visualize_noise_impact``:
the card unless the CPU is asked for), one host copy per figure.
matplotlib is imported lazily (``utils/visualization.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from msid_tpu_torch.utils.visualization import (
    SENTINEL2_WAVELENGTHS,
    _finish,
    _plt,
    extract_rgb,
    plot_training_curves,
    restore_batch,
)


def visualize_batch(
    model,
    variables,
    batch: np.ndarray,
    noise_cfg=None,
    image_size: int = 192,
    max_samples: int = 4,
    seed: int = 0,
    save_path: Optional[str | Path] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """Noisy | restored | clean grid with per-sample PSNR/SSIM titles; the
    batch is corrupted with ``seed`` and restored on the model's device
    (``variables`` None: the module's own weights)."""
    clean, noisy, restored, psnr, ssim = restore_batch(
        model, variables, batch, noise_cfg, image_size, seed, compute_dtype)
    n = min(max_samples, clean.shape[0])
    plt = _plt()
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        for j, (img, name) in enumerate(
            ((noisy[i], "noisy"), (restored[i], "restored"), (clean[i], "clean"))
        ):
            ax = axes[i][j]
            ax.imshow(extract_rgb(img))
            ax.axis("off")
            if j == 1:
                ax.set_title(f"{name}  PSNR {psnr[i]:.1f} dB  SSIM {ssim[i]:.3f}",
                             fontsize=8)
            elif i == 0:
                ax.set_title(name, fontsize=9)
    fig.tight_layout()
    return _finish(fig, save_path, 110)


def visualize_noise_impact(
    batch: np.ndarray,
    sigmas: Sequence[float] = (0.01, 0.05, 0.1),
    image_size: int = 192,
    seed: int = 0,
    save_path: Optional[str | Path] = None,
    device: str | torch.device = "cuda",
):
    """One clean tile corrupted at several Gaussian levels (the other
    components at their defaults), on ``device``: the card (K2) unless
    ``device="cpu"``."""
    from msid_tpu_torch.models.restoration import resolve_device
    from msid_tpu_torch.ops.noise import NoiseConfig, corrupt
    from msid_tpu_torch.ops.preprocess import preprocess_tiles

    device = resolve_device(device)
    tile = torch.from_numpy(np.ascontiguousarray(np.asarray(batch)[:1])).to(device)
    clean = preprocess_tiles(tile, image_size)
    panels = [("clean", clean[0].cpu().numpy())]
    for s in sigmas:
        noisy = corrupt(seed, clean, NoiseConfig(gaussian_sigma=float(s)))
        panels.append((f"σ={s}", noisy[0].float().cpu().numpy()))

    plt = _plt()
    fig, axes = plt.subplots(1, len(panels), figsize=(3 * len(panels), 3.2))
    for ax, (name, img) in zip(axes, panels):
        ax.imshow(extract_rgb(img))
        ax.set_title(name, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    return _finish(fig, save_path, 110)


def live_plot_history(history: dict, save_path: Optional[str | Path] = None):
    """A redrawable training-progress figure for interactive loops (the
    panels of ``plot_training_curves``); clears the cell's output inside
    IPython."""
    try:
        from IPython import display

        display.clear_output(wait=True)
    except Exception:
        pass
    return plot_training_curves(history, save_path=save_path)


def print_dataset_info(dataset, name: str = "dataset") -> dict:
    """Count, tile shape, dtype and value range of a dataset."""
    sample = dataset[0]
    info = {
        "name": name,
        "num_samples": len(dataset),
        "tile_shape": tuple(sample.shape),
        "dtype": str(sample.dtype),
        "min": float(sample.min()),
        "max": float(sample.max()),
    }
    print(f"{name}: {info['num_samples']} tiles of {info['tile_shape']} "
          f"({info['dtype']}), range [{info['min']:.1f}, {info['max']:.1f}]")
    return info


def print_evaluation_summary(results: dict) -> None:
    """A metric table of an evaluation's results."""
    print("=" * 44)
    print("Evaluation summary")
    print("-" * 44)
    for key, unit in (("psnr", "dB"), ("ssim", ""), ("sam", "deg"),
                      ("rmse", ""), ("loss", "")):
        if key in results:
            print(f"  {key.upper():<6} {results[key]:.4f} {unit}")
    print("=" * 44)


def explore_dataset(
    dataset,
    num_samples: int = 4,
    save_path: Optional[str | Path] = None,
):
    """RGB composites and mean spectra of the first tiles of a dataset."""
    n = min(num_samples, len(dataset))
    tiles = np.stack([np.asarray(dataset[i]) for i in range(n)])
    scale = 10000.0 if tiles.max() > 10 else 1.0

    plt = _plt()
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 6), squeeze=False)
    for i in range(n):
        axes[0][i].imshow(extract_rgb(tiles[i] / scale))
        axes[0][i].set_title(f"tile {i}", fontsize=9)
        axes[0][i].axis("off")
        axes[1][i].plot(SENTINEL2_WAVELENGTHS, tiles[i].mean(axis=(0, 1)), "o-")
        axes[1][i].set_xlabel("wavelength (nm)", fontsize=8)
        axes[1][i].tick_params(labelsize=7)
    axes[1][0].set_ylabel("mean DN")
    fig.tight_layout()
    return _finish(fig, save_path, 110)
