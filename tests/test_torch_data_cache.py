"""The port's real-tile data path against the JAX package's, on the CPU:
``EuroSATMultiSpectral`` and ``build_dataset`` over a directory of TIFFs
written by the port's ``write_tiff``, and the device tile cache
(``DeviceCachedLoader``, ``get_dataloaders``, ``get_test_dataloader``) on
``device="cpu"``.

No tolerance anywhere: samples, splits, tiles and batches are compared bit
for bit, since both packages read the same bytes and gather the same rows.
"""

import numpy as np
import pytest
import torch

from msid_tpu.data.dataset import EuroSATMultiSpectral as JaxEuroSAT
from msid_tpu.data.dataset import build_dataset as jax_build_dataset
from msid_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from msid_tpu.data.pipeline import _tile_nbytes as jax_tile_nbytes
from msid_tpu.data.pipeline import get_dataloaders as jax_get_dataloaders
from msid_tpu.data.pipeline import get_test_dataloader as jax_get_test_dataloader
from msid_tpu_torch.data.dataset import EuroSATMultiSpectral, SyntheticEuroSAT, build_dataset
from msid_tpu_torch.data.pipeline import (
    BatchLoader,
    DeviceCachedLoader,
    DeviceCacheTooLarge,
    _device_cached_or_host,
    _tile_nbytes,
    get_dataloaders,
    get_test_dataloader,
)
from msid_tpu_torch.data.tiff import write_tiff
from msid_tpu_torch.ops.preprocess import preprocess_tiles
from msid_tpu_torch.training.eval import split_batch_item


def host(batch) -> np.ndarray:
    return batch.numpy() if isinstance(batch, torch.Tensor) else np.asarray(batch)


def assert_same_batches(a, b, epochs=1):
    for _ in range(epochs):
        got, want = list(a), list(b)
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            x, nx = split_batch_item(x)
            y, ny = split_batch_item(y)
            assert nx == ny
            assert np.array_equal(host(x).astype(np.float32), host(y).astype(np.float32))


@pytest.fixture
def tile_dir(tmp_path):
    """Two classes of uint16 EuroSAT-shaped tiles, one with 4 bands, one
    80x70 and one 40x64 (cropped and padded), and one file that is no TIFF."""
    rng = np.random.default_rng(3)
    for sub in ("AnnualCrop", "Forest"):
        (tmp_path / sub).mkdir()
        for i in range(5):
            write_tiff(tmp_path / sub / f"{sub}_{i}.tif",
                       rng.integers(0, 10000, (64, 64, 13), dtype=np.uint16))
    write_tiff(tmp_path / "AnnualCrop" / "odd.tif",
               rng.integers(0, 10000, (64, 64, 4), dtype=np.uint16))
    write_tiff(tmp_path / "Forest" / "big.tif", rng.integers(0, 100, (80, 70, 13), dtype=np.uint16))
    write_tiff(tmp_path / "Forest" / "small.tif",
               rng.integers(0, 100, (40, 64, 15), dtype=np.uint16))
    (tmp_path / "Forest" / "broken.tif").write_bytes(b"II*\x00" + bytes(8))
    return tmp_path


@pytest.mark.parametrize("split,train_split,seed", [("train", 0.8, 42), ("val", 0.8, 42),
                                                    ("train", 1.0, 7), ("val", 0.5, 3)])
def test_eurosat_samples_split_and_tiles_equal_jax(tile_dir, split, train_split, seed):
    ours = EuroSATMultiSpectral(tile_dir, split=split, train_split=train_split, seed=seed)
    theirs = JaxEuroSAT(tile_dir, split=split, train_split=train_split, seed=seed)
    assert ours.samples == theirs.samples
    for i in range(len(ours)):
        tile = ours[i]
        assert tile.shape == (64, 64, 13) and tile.dtype == np.float32
        assert np.array_equal(tile, theirs[i])


def test_eurosat_pads_cuts_crops_and_zeroes_as_jax(tile_dir):
    ours = EuroSATMultiSpectral(tile_dir, split="train", train_split=1.0)
    by_name = {p.name: i for i, p in enumerate(ours.samples)}
    assert len(ours) == 14
    assert not ours[by_name["odd.tif"]][:, :, 4:].any()          # bands 4..12 padded
    assert not ours[by_name["broken.tif"]].any()                 # unreadable: zeros
    assert not ours[by_name["small.tif"]][40:].any()             # rows 40..63 padded
    with pytest.raises(ValueError, match="Invalid split"):
        EuroSATMultiSpectral(tile_dir, split="test")
    with pytest.raises(FileNotFoundError):
        EuroSATMultiSpectral(tile_dir / "AnnualCrop" / "missing")


def test_png_tiles_when_there_is_no_tif(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    (tmp_path / "River").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / "River" / f"r{i}.png")
    ours = EuroSATMultiSpectral(tmp_path, split="train", train_split=1.0)
    theirs = JaxEuroSAT(tmp_path, split="train", train_split=1.0)
    assert ours.samples == theirs.samples and len(ours) == 3
    for i in range(3):
        assert np.array_equal(ours[i], theirs[i])
        assert np.array_equal(ours[i][:, :, 0], ours[i][:, :, 12])  # grey over 13 bands


def test_build_dataset_reads_tiles_and_falls_back_as_jax(tile_dir, tmp_path_factory):
    config = {"seed": 5, "data": {"root_dir": str(tile_dir), "train_split": 0.75}}
    for split in ("train", "val"):
        ours, theirs = build_dataset(config, split), jax_build_dataset(config, split)
        assert isinstance(ours, EuroSATMultiSpectral)
        assert ours.samples == theirs.samples
        assert all(np.array_equal(ours[i], theirs[i]) for i in range(len(ours)))
    missing = {"seed": 42, "data": {"root_dir": str(tmp_path_factory.mktemp("e") / "none"),
                                    "synthetic_samples": 16}}
    ours, theirs = build_dataset(missing, "train"), jax_build_dataset(missing, "train")
    assert isinstance(ours, SyntheticEuroSAT) and len(ours) == len(theirs) > 0
    assert np.array_equal(ours[0], theirs[0])


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, drop_last=True),
    dict(shuffle=False, drop_last=False, pad_last=True),
    dict(shuffle=False, drop_last=False),
])
def test_cached_batches_equal_both_host_loaders(kwargs):
    """Two epochs: the seeded reshuffle, the batch boundaries and the pad
    rule are the host loaders', only the gather differs."""
    ds = SyntheticEuroSAT(num_samples=50, split="train", seed=0)
    dev = DeviceCachedLoader(ds, batch_size=8, seed=3, device="cpu", **kwargs)
    assert dev._tiles.device.type == "cpu" and len(dev) == len(BatchLoader(ds, 8, **kwargs))
    assert_same_batches(dev, BatchLoader(ds, batch_size=8, seed=3, **kwargs), epochs=2)
    assert_same_batches(DeviceCachedLoader(ds, batch_size=8, seed=3, device="cpu", **kwargs),
                        JaxBatchLoader(ds, batch_size=8, seed=3, **kwargs), epochs=2)


def test_pad_last_repeats_the_first_tile_of_the_batch():
    ds = SyntheticEuroSAT(num_samples=12, split="train", train_split=1.0)
    dev = DeviceCachedLoader(ds, batch_size=8, shuffle=False, drop_last=False,
                             pad_last=True, device="cpu")
    (b0, n0), (b1, n1) = list(dev)
    assert (n0, n1) == (8, 4) and b1.shape == (8, 64, 64, 13)
    assert torch.equal(b1[4], b1[0]) and torch.equal(b1[7], b1[0])


def cache_config(**data):
    return {"data": {"root_dir": "/nonexistent-forces-synthetic", "device_cache": True, **data},
            "training": {"micro_batch_size": 4, "gradient_accumulation_steps": 1},
            "seed": 11}


def test_get_dataloaders_caches_both_splits_and_falls_back_over_budget():
    train, val = get_dataloaders(cache_config(), device="cpu")
    assert isinstance(train, DeviceCachedLoader) and isinstance(val, DeviceCachedLoader)
    host_train, host_val = get_dataloaders(cache_config(device_cache=False), device="cpu")
    assert type(host_train) is BatchLoader and type(host_val) is BatchLoader
    assert_same_batches(train, host_train, epochs=2)
    assert_same_batches(val, host_val)
    train, val = get_dataloaders(cache_config(), device="cpu")     # epoch 0 again
    jax_train, jax_val = jax_get_dataloaders(cache_config())
    assert_same_batches(train, jax_train, epochs=2)
    assert_same_batches(val, jax_val)
    # over the budget: the host loader, even with device_cache true
    c_train, c_val = get_dataloaders(cache_config(device_cache_max_gb=1e-9), device="cpu")
    assert type(c_train) is BatchLoader and type(c_val) is BatchLoader
    # "auto" caches when it fits, as true does
    a_train, _ = get_dataloaders(cache_config(device_cache="auto"), device="cpu")
    assert isinstance(a_train, DeviceCachedLoader)


def test_get_test_dataloader_is_every_sample_in_order_as_jax():
    ours = get_test_dataloader(cache_config(synthetic_samples=10), batch_size=4, device="cpu")
    theirs = jax_get_test_dataloader(cache_config(synthetic_samples=10), batch_size=4)
    assert isinstance(ours, DeviceCachedLoader) and ours.pad_last and not ours.shuffle
    assert_same_batches(ours, theirs)
    plain = get_test_dataloader(cache_config(synthetic_samples=10, device_cache=False),
                                batch_size=4, device="cpu")
    assert type(plain) is BatchLoader
    assert_same_batches(plain, theirs)


class IntegralTiles:
    """Integral float32 tiles in [0, 10000): uint16-exact."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return np.random.default_rng(i).integers(0, 10000, (8, 8, 13)).astype(np.float32)


def test_auto_narrows_exact_tiles_to_uint16():
    ds = IntegralTiles()
    auto = DeviceCachedLoader(ds, batch_size=5, shuffle=False, storage_dtype="auto",
                              device="cpu")
    assert auto._tiles.dtype == torch.uint16 and auto.nbytes == 10 * 8 * 8 * 13 * 2
    native = DeviceCachedLoader(ds, batch_size=5, shuffle=False, device="cpu")
    assert native._tiles.dtype == torch.float32 and native.nbytes == 10 * 8 * 8 * 13 * 4
    assert_same_batches(auto, native)
    # the train step's preprocessing casts first: the narrowed batch is the same input
    a, n = next(iter(auto)), next(iter(native))
    assert a.dtype == torch.uint16
    assert torch.equal(preprocess_tiles(a, 16), preprocess_tiles(n, 16))
    frac = SyntheticEuroSAT(num_samples=8, split="train", train_split=1.0)
    assert DeviceCachedLoader(frac, batch_size=4, storage_dtype="auto",
                              device="cpu")._tiles.dtype == torch.float32
    with pytest.raises(ValueError, match="integral"):
        DeviceCachedLoader(frac, batch_size=4, storage_dtype="uint16", device="cpu")
    with pytest.raises(ValueError, match="storage_dtype"):
        DeviceCachedLoader(frac, batch_size=4, storage_dtype="int8", device="cpu")


def test_an_empty_split_gets_the_host_loader():
    train, val = get_dataloaders(cache_config(synthetic_samples=4, train_split=1.0),
                                 device="cpu")
    assert isinstance(train, DeviceCachedLoader)
    assert type(val) is BatchLoader and list(val) == []


def test_tile_nbytes_estimates_the_narrowed_size_as_jax():
    ds = IntegralTiles()
    full = 10 * 8 * 8 * 13 * 4
    for storage, want in (("native", full), ("auto", full // 2), ("uint16", full // 2)):
        assert _tile_nbytes(ds, storage) == jax_tile_nbytes(ds, storage) == want
    frac = SyntheticEuroSAT(num_samples=4, split="train", train_split=1.0)
    assert _tile_nbytes(frac, "auto") == jax_tile_nbytes(frac, "auto") == frac[0].nbytes * 4
    assert _tile_nbytes([], "auto") == 0


def test_the_budget_is_checked_again_after_narrowing():
    class MixedTiles:                  # tile 0 integral, the rest fractional
        def __len__(self):
            return 6

        def __getitem__(self, i):
            t = np.random.default_rng(i).integers(0, 10000, (8, 8, 13)).astype(np.float32)
            return t if i == 0 else t + 0.5

    ds = MixedTiles()
    full = 6 * 8 * 8 * 13 * 4
    assert _tile_nbytes(ds, "auto") == full // 2          # the first tile's estimate
    with pytest.raises(DeviceCacheTooLarge):
        DeviceCachedLoader(ds, batch_size=2, storage_dtype="auto", max_bytes=full // 2,
                           device="cpu")
    loader = _device_cached_or_host(ds, "auto", full // 2, "cpu", batch_size=2)
    assert type(loader) is BatchLoader
    ok = DeviceCachedLoader(ds, batch_size=2, storage_dtype="auto", max_bytes=full,
                            device="cpu")
    assert ok.nbytes == full and ok._tiles.dtype == torch.float32


def test_the_cache_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cache builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCachedLoader(IntegralTiles(), batch_size=2)
