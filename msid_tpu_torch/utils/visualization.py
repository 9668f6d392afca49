"""Visualization (PyTorch): counterpart of ``msid_tpu/utils/visualization.py``.

RGB composites, noisy/restored/clean triptychs, spectra, band comparisons
and training curves, drawn on host numpy after one device-to-host copy per
figure. Tensors arrive in model range (about [-2, 2]), NHWC.

matplotlib is imported lazily (``_plt``, the Agg backend) so that training
and serving never need it; the machines that only serve or train may not
have it. Without it, the triptych, spectra and training-curve figures that
go to a file are drawn as plain raster PNGs (``write_png``): their panels
side by side, lines in matplotlib's first colours, no text.
"""

from __future__ import annotations

import importlib.util
import itertools
import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

# Sentinel-2 band centres (nm) and names
SENTINEL2_WAVELENGTHS = (
    443, 490, 560, 665, 705, 740, 783, 842, 865, 945, 1375, 1610, 2190,
)
SENTINEL2_BAND_NAMES = (
    "B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B8A", "B9", "B10",
    "B11", "B12",
)
# True-color composite: B4 (red), B3 (green), B2 (blue) = indices 3, 2, 1
RGB_BAND_INDICES = (3, 2, 1)


# The raster figures: matplotlib's tab:blue, orange, green and red; a line
# panel's height and width in pixels, and its margin inside the frame.
RASTER_COLORS = ((0.122, 0.467, 0.706), (1.0, 0.498, 0.055), (0.173, 0.627, 0.173),
                 (0.839, 0.153, 0.157))
RASTER_PANEL = (240, 320)
RASTER_MARGIN = 8


def _have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save_path: Optional[str | Path], dpi: int):
    """Save and close the figure when a path is given (returns None), else
    return it."""
    if not save_path:
        return fig
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    _plt().close(fig)
    return None


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of an ``[H, W, 3]`` array in [0, 1], written with
    zlib alone."""
    img = np.round(np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                     + chunk(b"IEND", b""))


def _line_panel(series: Sequence[tuple]) -> np.ndarray:
    """A white ``RASTER_PANEL`` with a black frame and each ``(x, y)`` of
    ``series`` drawn as a 3-pixel polyline in its colour, all scaled to the
    finite range of every series together."""
    h, w = RASTER_PANEL
    img = np.ones((h, w, 3))
    img[[0, -1]] = 0.0
    img[:, [0, -1]] = 0.0
    series = [(np.asarray(x, np.float64), np.asarray(y, np.float64)) for x, y in series]
    xs = np.concatenate([x for x, _ in series] + [np.zeros(0)])
    ys = np.concatenate([y for _, y in series] + [np.zeros(0)])
    xs, ys = xs[np.isfinite(xs)], ys[np.isfinite(ys)]
    if not (xs.size and ys.size):
        return img

    def pixel(v, lo, hi, n):
        return RASTER_MARGIN + (v - lo) / max(hi - lo, 1e-12) * (n - 1 - 2 * RASTER_MARGIN)

    t = np.linspace(0.0, 1.0, 64)[:, None]
    for (x, y), color in zip(series, itertools.cycle(RASTER_COLORS)):
        if len(x) > 1:     # 64 points along each segment
            x, y = (x[:-1] + t * np.diff(x)).ravel(), (y[:-1] + t * np.diff(y)).ravel()
        px = pixel(x, xs.min(), xs.max(), w)
        py = h - 1 - pixel(y, ys.min(), ys.max(), h)
        keep = np.isfinite(px) & np.isfinite(py)
        px, py = np.round(px[keep]).astype(int), np.round(py[keep]).astype(int)
        for dy, dx in itertools.product((-1, 0, 1), repeat=2):
            img[np.clip(py + dy, 0, h - 1), np.clip(px + dx, 0, w - 1)] = color
    return img


def _save_panels(save_path: str | Path, panels: Sequence[np.ndarray]) -> None:
    """``panels`` (``[H, W, 3]`` in [0, 1], of one height) side by side,
    8 white pixels apart, as a PNG."""
    gap = np.ones((panels[0].shape[0], 8, 3))
    write_png(save_path, np.concatenate(
        [p for panel in panels for p in (panel, gap)][:-1], axis=1))


def normalize_for_display(
    img: np.ndarray, lower: float = 2.0, upper: float = 98.0
) -> np.ndarray:
    """Percentile contrast stretch to [0, 1]."""
    img = np.asarray(img, dtype=np.float32)
    lo, hi = np.percentile(img, [lower, upper])
    if hi - lo < 1e-8:
        return np.zeros_like(img)
    return np.clip((img - lo) / (hi - lo), 0.0, 1.0)


def extract_rgb(img_hwc: np.ndarray) -> np.ndarray:
    """[H, W, 13] -> display-normalized [H, W, 3] true-color composite
    (bands 4/3/2)."""
    img_hwc = np.asarray(img_hwc)
    rgb = img_hwc[..., list(RGB_BAND_INDICES)]
    return normalize_for_display(rgb)


def plot_sample_grid(
    images: np.ndarray,
    save_path: Optional[str | Path] = None,
    max_samples: int = 8,
    title: str = "Samples",
):
    """Grid of RGB composites from an NHWC batch."""
    plt = _plt()
    images = np.asarray(images)[:max_samples]
    n = len(images)
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(extract_rgb(images[i]))
            ax.set_title(f"sample {i}", fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    return _finish(fig, save_path, 120)


def plot_restoration_triptych(
    noisy: np.ndarray,
    clean: np.ndarray,
    restored: np.ndarray,
    save_path: Optional[str | Path] = None,
    metrics: Optional[dict] = None,
):
    """Noisy | restored | clean RGB panels for one sample."""
    if save_path and not _have_matplotlib():
        return _save_panels(save_path, [extract_rgb(np.asarray(img))
                                        for img in (noisy, restored, clean)])
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, name in zip(
        axes, (noisy, restored, clean), ("noisy input", "restored", "clean target")
    ):
        ax.imshow(extract_rgb(np.asarray(img)))
        ax.set_title(name)
        ax.axis("off")
    if metrics:
        fig.suptitle("  ".join(f"{k}={v:.3f}" for k, v in metrics.items()), fontsize=10)
    fig.tight_layout()
    return _finish(fig, save_path, 120)


def plot_spectral_signatures(
    clean: np.ndarray,
    restored: np.ndarray,
    noisy: Optional[np.ndarray] = None,
    pixels: Sequence[tuple] = ((32, 32), (96, 96), (160, 160)),
    save_path: Optional[str | Path] = None,
):
    """Per-pixel 13-band spectra, clean against restored (and noisy)."""
    clean, restored = np.asarray(clean), np.asarray(restored)
    h, w = clean.shape[:2]
    pixels = [(min(y, h - 1), min(x, w - 1)) for y, x in pixels]
    if save_path and not _have_matplotlib():
        spectra = [img for img in (clean, restored, noisy) if img is not None]
        return _save_panels(save_path, [
            _line_panel([(SENTINEL2_WAVELENGTHS, np.asarray(img)[y, x]) for img in spectra])
            for y, x in pixels])
    plt = _plt()
    fig, axes = plt.subplots(1, len(pixels), figsize=(4 * len(pixels), 3.2))
    if len(pixels) == 1:
        axes = [axes]
    wl = SENTINEL2_WAVELENGTHS
    for ax, (y, x) in zip(axes, pixels):
        ax.plot(wl, clean[y, x], "o-", label="clean", lw=1.5)
        ax.plot(wl, restored[y, x], "s--", label="restored", lw=1.5)
        if noisy is not None:
            ax.plot(wl, np.asarray(noisy)[y, x], "^:", label="noisy", lw=1, alpha=0.6)
        ax.set_title(f"pixel ({y},{x})", fontsize=9)
        ax.set_xlabel("wavelength (nm)")
        ax.legend(fontsize=7)
    fig.tight_layout()
    return _finish(fig, save_path, 120)


def plot_band_comparison(
    clean: np.ndarray,
    restored: np.ndarray,
    save_path: Optional[str | Path] = None,
):
    """All 13 bands side by side, clean against restored."""
    plt = _plt()
    clean, restored = np.asarray(clean), np.asarray(restored)
    fig, axes = plt.subplots(2, 13, figsize=(26, 4.4))
    for c in range(13):
        for row, img in ((0, clean), (1, restored)):
            ax = axes[row][c]
            ax.imshow(normalize_for_display(img[..., c]), cmap="gray")
            ax.axis("off")
            if row == 0:
                ax.set_title(SENTINEL2_BAND_NAMES[c], fontsize=8)
    fig.tight_layout()
    return _finish(fig, save_path, 100)


def plot_training_curves(history: dict, save_path: Optional[str | Path] = None):
    """2x2 loss / PSNR / SSIM / learning-rate panels from a Trainer's history."""
    epochs = np.arange(1, len(history.get("train_loss", [])) + 1)
    if save_path and not _have_matplotlib():
        lr = np.asarray(history.get("lr", []), np.float64)
        return _save_panels(save_path, [
            _line_panel([(epochs, history.get("train_loss", [])),
                         (epochs, history.get("val_loss", []))]),
            _line_panel([(epochs, history.get("val_psnr", []))]),
            _line_panel([(epochs, history.get("val_ssim", []))]),
            _line_panel([(epochs, np.log10(lr, where=lr > 0, out=np.full_like(lr, np.nan)))])])
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))

    ax = axes[0][0]
    ax.plot(epochs, history.get("train_loss", []), label="train")
    ax.plot(epochs, history.get("val_loss", []), label="val")
    ax.set_title("loss")
    ax.legend()

    ax = axes[0][1]
    ax.plot(epochs, history.get("val_psnr", []), color="tab:green")
    ax.set_title("val PSNR (dB)")

    ax = axes[1][0]
    ax.plot(epochs, history.get("val_ssim", []), color="tab:orange")
    ax.set_title("val SSIM")

    ax = axes[1][1]
    ax.plot(epochs, history.get("lr", []), color="tab:red")
    ax.set_yscale("log")
    ax.set_title("learning rate")

    for row in axes:
        for ax in row:
            ax.set_xlabel("epoch")
            ax.grid(alpha=0.3)
    fig.tight_layout()
    return _finish(fig, save_path, 120)


def restore_batch(model, variables, batch, noise_cfg=None, image_size: int = 192,
                  seed: int = 0, compute_dtype: torch.dtype = torch.float32,
                  noise_impl: str = "auto") -> tuple:
    """The eval path on one raw NHWC batch, on the model's device:
    ``preprocess_tiles``, ``corrupt`` seeded by ``seed`` (K2 on the card),
    the eval-mode forward in ``compute_dtype`` with ``variables`` (None:
    the module's own weights), and the per-sample PSNR and SSIM. Returns
    host arrays ``(clean, noisy, restored, psnr, ssim)``."""
    from torch.func import functional_call

    from msid_tpu_torch.models.restoration import exact_fp32
    from msid_tpu_torch.ops.metrics import psnr_per_sample
    from msid_tpu_torch.ops.noise import NoiseConfig, corrupt
    from msid_tpu_torch.ops.preprocess import preprocess_tiles
    from msid_tpu_torch.ops.ssim import ssim_per_sample

    device = next(model.parameters()).device
    batch = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    training = model.training
    model.eval()
    try:
        with torch.no_grad(), exact_fp32(compute_dtype), torch.autocast(
                device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32):
            clean = preprocess_tiles(batch.to(device), image_size)
            noisy = corrupt(seed, clean, noise_cfg or NoiseConfig(), impl=noise_impl)
            z = noisy.to(compute_dtype)
            restored = (model(z) if variables is None
                        else functional_call(model, variables, (z,))).float()
            psnr, ssim = psnr_per_sample(restored, clean), ssim_per_sample(restored, clean)
    finally:
        model.train(training)
    return tuple(t.float().cpu().numpy() for t in (clean, noisy, restored, psnr, ssim))


def save_restoration_triptychs(
    model,
    variables,
    loader,
    out_dir: str | Path,
    noise_cfg=None,
    image_size: int = 192,
    num_samples: int = 5,
    eval_seed: int = 1234,
    compute_dtype: torch.dtype = torch.float32,
    noise_impl: str = "auto",
):
    """Run the first batch of ``loader`` through the eval path
    (``restore_batch``, corrupted with ``eval_seed``) and save a triptych
    and the spectra of each of its first ``num_samples`` samples; returns
    how many were saved."""
    from msid_tpu_torch.training.eval import split_batch_item

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # padding loaders yield (batch, true_count): drop the padding
    batch, count = split_batch_item(next(iter(loader)))
    clean, noisy, restored, psnr, ssim = restore_batch(
        model, variables, batch[:count], noise_cfg, image_size, eval_seed, compute_dtype,
        noise_impl)
    n = min(num_samples, clean.shape[0])
    for i in range(n):
        plot_restoration_triptych(
            noisy[i], clean[i], restored[i],
            save_path=out_dir / f"sample_{i:02d}.png",
            metrics={"PSNR": float(psnr[i]), "SSIM": float(ssim[i])},
        )
        plot_spectral_signatures(
            clean[i], restored[i], noisy[i],
            save_path=out_dir / f"sample_{i:02d}_spectra.png",
        )
    return n
