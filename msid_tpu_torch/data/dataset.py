"""Host-side datasets (numpy): counterpart of ``msid_tpu/data/dataset.py``.

The host stops at raw HWC tiles (64x64x13); preprocessing and corruption
run on the device. ``EuroSATMultiSpectral`` reads the EuroSAT-MS tiles
under ``data.root_dir`` (``data/tiff.py``), sample for sample and split
for split the JAX package's; ``SyntheticEuroSAT`` is the procedural
stand-in both packages train on when no tile is on disk, tile for tile
identical to the JAX package's; ``_reference_split`` is the reference's
seeded 80/20 split.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Tuple

import numpy as np

from msid_tpu_torch.data.tiff import read_tiff

logger = logging.getLogger(__name__)

NUM_BANDS = 13
TILE_SIZE = 64


def _reference_split(n: int, train_split: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's split: ``np.random.seed(seed); permutation(n)``, first
    ``int(train_split * n)`` for training. numpy's global state is restored."""
    rng_state = np.random.get_state()
    np.random.seed(seed)
    indices = np.random.permutation(n)
    np.random.set_state(rng_state)
    split_idx = int(train_split * n)
    return indices[:split_idx], indices[split_idx:]


class EuroSATMultiSpectral:
    """Raw HWC float32 tiles read from disk, indexed within one split.

    Samples are every ``*.tif`` under ``root_dir`` (recursively, sorted),
    or the ``*.jpg``/``*.png`` files when there is no ``.tif``; the split
    is ``_reference_split``'s. A tile with fewer bands than ``num_bands``
    is zero-padded, one with more is cut; a tile of another size is cropped
    or zero-padded to ``tile_size``; an unreadable file gives a zero tile,
    as in the reference. A grey jpg/png is repeated over the bands (PIL is
    imported only for those)."""

    def __init__(self, root_dir: str | Path, split: str = "train",
                 train_split: float = 0.8, seed: int = 42,
                 num_bands: int = NUM_BANDS, tile_size: int = TILE_SIZE):
        self.root_dir = Path(root_dir)
        self.num_bands = num_bands
        self.tile_size = tile_size
        samples = sorted(self.root_dir.rglob("*.tif"))
        if not samples:
            samples = sorted(list(self.root_dir.rglob("*.jpg"))
                             + list(self.root_dir.rglob("*.png")))
        if not samples:
            raise FileNotFoundError(f"No image tiles found under {self.root_dir}")
        train_idx, val_idx = _reference_split(len(samples), train_split, seed)
        if split == "train":
            self.samples: List[Path] = [samples[i] for i in train_idx]
        elif split == "val":
            self.samples = [samples[i] for i in val_idx]
        else:
            raise ValueError(f"Invalid split: {split}. Use 'train' or 'val'")
        logger.info("%s split: %d samples", split.upper(), len(self.samples))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> np.ndarray:
        """The raw (un-normalized) float32 tile ``[tile, tile, num_bands]``."""
        path = self.samples[idx]
        try:
            if path.suffix.lower() in (".tif", ".tiff"):
                img = read_tiff(path).astype(np.float32)
            else:
                from PIL import Image

                gray = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
                img = np.repeat(gray[:, :, None], self.num_bands, axis=2)
        except Exception as e:  # unreadable: a zero tile, as the reference
            logger.error("Error reading %s: %s", path, e)
            return np.zeros((self.tile_size, self.tile_size, self.num_bands), np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        c = img.shape[2]
        if c < self.num_bands:
            pad = np.zeros((*img.shape[:2], self.num_bands - c), img.dtype)
            img = np.concatenate([img, pad], axis=2)
        elif c > self.num_bands:
            img = img[:, :, :self.num_bands]
        t = self.tile_size
        if img.shape[:2] != (t, t):
            img = img[:t, :t]
            if img.shape[0] < t or img.shape[1] < t:
                padded = np.zeros((t, t, self.num_bands), img.dtype)
                padded[:img.shape[0], :img.shape[1]] = img
                img = padded
        return np.ascontiguousarray(img, dtype=np.float32)

    def compute_statistics(self, num_samples: int = 1000) -> dict:
        """Per-band ``mean`` and ``std`` (float64, ``[num_bands]``) over the
        first ``num_samples`` tiles: the average of each tile's per-band
        mean and standard deviation, summed in the JAX package's order.
        ``ValueError`` when that is no tile."""
        n = min(num_samples, len(self))
        if n <= 0:
            raise ValueError("No valid samples for statistics")
        mean = np.zeros(self.num_bands, np.float64)
        std = np.zeros(self.num_bands, np.float64)
        for i in range(n):
            tile = self[i]
            mean += tile.mean(axis=(0, 1))
            std += tile.std(axis=(0, 1))
        return {"mean": mean / n, "std": std / n}



class SyntheticEuroSAT:
    """Procedural tiles: smooth correlated multi-band fields in the
    Sentinel-2 DN range, deterministic per (seed, index) and cached."""

    def __init__(self, num_samples: int = 512, split: str = "train",
                 train_split: float = 0.8, seed: int = 42,
                 num_bands: int = NUM_BANDS, tile_size: int = TILE_SIZE,
                 complexity: str = "base"):
        if complexity not in ("base", "rich", "mixed"):
            raise ValueError(f"unknown synthetic complexity {complexity!r}")
        self.num_bands = num_bands
        self.tile_size = tile_size
        self.seed = seed
        self.complexity = complexity
        train_idx, val_idx = _reference_split(num_samples, train_split, seed)
        self.indices = train_idx if split == "train" else val_idx
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> np.ndarray:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        tile = self._generate(int(self.indices[idx]))
        self._cache[idx] = tile
        return tile

    @staticmethod
    def _smooth_field(rng, t: int, cell: int) -> np.ndarray:
        """Random coarse grid, nearest-upsampled then box-smoothed, in [0,1]."""
        coarse = rng.normal(size=(max(t // cell, 1), max(t // cell, 1)))
        field = np.kron(coarse, np.ones((cell, cell)))[:t, :t]
        for axis in (0, 1):
            field = (np.roll(field, 1, axis) + field + np.roll(field, -1, axis)) / 3.0
        return (field - field.min()) / (np.ptp(field) + 1e-9)

    def _generate(self, gidx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + gidx)
        t = self.tile_size
        family = self.complexity
        if family == "mixed":
            # the family coin has its own stream, so a mixed tile equals the
            # same-index tile of its pure family
            coin = np.random.default_rng(self.seed * 7_777_777 + gidx)
            family = "rich" if coin.uniform() < 0.5 else "base"
        if family == "rich":
            return self._generate_rich(rng, t)
        base = self._smooth_field(rng, t, 8)
        bands = []
        for b in range(self.num_bands):
            gain = 0.6 + 0.4 * np.sin(0.5 * b + rng.uniform(0, 0.3))
            texture = rng.normal(scale=0.03, size=(t, t))
            bands.append(np.clip(base * gain + texture + 0.1, 0, 1))
        img = np.stack(bands, axis=-1) * 10000.0
        return img.astype(np.float32)

    def _generate_rich(self, rng, t: int) -> np.ndarray:
        """Land-cover-like segments with per-class spectral signatures,
        three octaves of detail and cross-band-correlated texture."""
        c = self.num_bands
        num_classes = int(rng.integers(2, 5))
        seg_field = self._smooth_field(rng, t, 16)
        thresholds = np.sort(rng.uniform(0.2, 0.8, num_classes - 1))
        seg = np.digitize(seg_field, thresholds)
        band_idx = np.arange(c)
        signatures = np.stack([
            0.35 + 0.3 * rng.uniform()
            + 0.25 * np.cos(band_idx * rng.uniform(0.2, 0.9) + rng.uniform(0, np.pi))
            + 0.1 * np.cos(band_idx * rng.uniform(1.0, 2.2) + rng.uniform(0, np.pi))
            for _ in range(num_classes)
        ])
        octaves = (
            0.50 * self._smooth_field(rng, t, 16)
            + 0.30 * self._smooth_field(rng, t, 8)
            + 0.20 * self._smooth_field(rng, t, 4)
        )
        shared_tex = rng.normal(scale=1.0, size=(t, t))
        band_tex_gain = rng.uniform(0.01, 0.05, c)
        img = signatures[seg]
        img = img * (0.6 + 0.55 * octaves[..., None])
        img += shared_tex[..., None] * band_tex_gain
        img += rng.normal(scale=0.01, size=(t, t, c))
        img = np.clip(img, 0.0, 1.0) * 10000.0
        return img.astype(np.float32)


def build_dataset(config: dict, split: str):
    """The config's dataset: the tiles under ``data.root_dir``, or
    synthetic tiles when it holds none (it does not exist, or nothing under
    it is a tile) and ``data.synthetic_fallback`` allows it (the default),
    as the reference falls back."""
    data_cfg = config.get("data", {})
    root = Path(data_cfg.get("root_dir", "./data/EuroSAT_MS"))
    kwargs = dict(train_split=float(data_cfg.get("train_split", 0.8)),
                  seed=int(config.get("seed", 42)),
                  num_bands=int(data_cfg.get("num_bands", NUM_BANDS)))
    try:
        return EuroSATMultiSpectral(root, split=split, **kwargs)
    except FileNotFoundError:
        if not data_cfg.get("synthetic_fallback", True):
            raise
    logger.warning("Dataset not found at %s — using synthetic tiles", root)
    return SyntheticEuroSAT(
        int(data_cfg.get("synthetic_samples", 512)), split=split,
        complexity=str(data_cfg.get("synthetic_complexity", "base")), **kwargs)
