"""Host input pipeline (numpy): counterpart of ``msid_tpu/data/pipeline.py``.

``BatchLoader`` yields seeded, shuffled batches of raw tiles, staged by a
background thread; ``get_dataloaders`` builds the train loader (drop_last)
and the validation loader (every sample, the trailing batch padded to the
static shape and yielded as ``(batch, true_count)``).
``DeviceCachedLoader`` holds the whole tile set in device memory, narrowed
to uint16 where that is exact, and gathers each batch there by index: the
same batches as ``BatchLoader`` with the same arguments, with no host copy
of a tile per step. ``data.device_cache`` (true, false or "auto") picks it
in ``get_dataloaders`` and ``get_test_dataloader`` when the set fits
``data.device_cache_max_gb``, and the host loader otherwise.

Under data parallelism a loader is one shard of ``num_shards``: every
rank draws the same seeded permutation each epoch and yields its rows
``[i * b / n, (i + 1) * b / n)`` of each global batch of ``b`` tiles (the
padded trailing batch is padded first, then split, with the global true
count), so the ranks of an epoch see, together, the one-device epoch's
batches.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)


class DeviceCacheTooLarge(ValueError):
    """The stacked tile set exceeds the cache's byte budget after its
    storage dtype was resolved; callers fall back to the host loader."""


class BatchLoader:
    """Seeded, shuffled batches of raw tiles as numpy arrays.

    Args:
        dataset: indexable returning HWC float32 tiles.
        batch_size: tiles per batch.
        shuffle: reshuffle each epoch (seeded by ``seed`` and the epoch).
        drop_last: drop the trailing partial batch.
        prefetch: batches staged ahead by a background thread (0: none).
        pad_last: pad the trailing batch by repeating its first tile and
            yield ``(batch, true_count)``.
        num_shards, shard_index: yield shard ``shard_index`` of ``num_shards``
            of each batch of ``batch_size`` (the global batch), which they
            must divide; ``true_count`` stays the global batch's.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 pad_last: bool = False, num_shards: int = 1, shard_index: int = 0):
        if batch_size % num_shards:
            raise ValueError(f"global batch {batch_size} not divisible by {num_shards} "
                             f"data shards")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed * 100_003 + self.epoch).permutation(n)
        return np.arange(n)

    def _shard(self, idxs: np.ndarray) -> tuple[np.ndarray, int]:
        """This shard's indices of a batch and the batch's true count: a
        trailing batch padded (``pad_last``) by repeating its first index,
        then cut into ``num_shards`` parts."""
        count = len(idxs)
        if self.pad_last and count < self.batch_size:
            idxs = np.concatenate([idxs, np.repeat(idxs[:1], self.batch_size - count)])
        if self.num_shards > 1:
            per = len(idxs) // self.num_shards
            idxs = idxs[self.shard_index * per:(self.shard_index + 1) * per]
        return idxs, count

    def _make_batch(self, idxs: np.ndarray):
        idxs, count = self._shard(idxs)
        batch = np.stack([self.dataset[int(i)] for i in idxs], axis=0)
        return (batch, count) if self.pad_last else batch

    def __iter__(self) -> Iterator:
        indices = self._indices()
        n_batches = len(self)
        self.epoch += 1
        size = self.batch_size
        if self.prefetch <= 0:
            for b in range(n_batches):
                yield self._make_batch(indices[b * size:(b + 1) * size])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # Gives up when the consumer is gone, so an abandoned iterator
            # does not pin the thread and its staged batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(n_batches):
                    if not put(self._make_batch(indices[b * size:(b + 1) * size])):
                        return
            except Exception as e:  # re-raised in the consumer
                put((sentinel, e))
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
                    raise item[1]
                yield item
            t.join()
        finally:
            stop.set()


class DeviceCachedLoader(BatchLoader):
    """Batches of raw tiles gathered from a tile set held in device memory.

    The whole dataset is stacked and uploaded once at construction; each
    batch is one ``index_select`` on the device, from an index vector the
    host sends (8 bytes a tile). The seeded permutation of each epoch, the
    batch boundaries and the pad rule (``pad_last`` repeats the batch's
    first tile, here by repeating its index before the gather) are
    ``BatchLoader``'s, so the batches are the same, as device tensors.

    ``storage_dtype``: ``"native"`` keeps the tiles' dtype; ``"auto"``
    stores float tiles as uint16 when every value is an integer in
    [0, 65535] (Sentinel-2 DN decoded to float32): exact, since the train
    step casts to float32 first, and half the bytes; ``"uint16"`` requires
    it and raises ``ValueError`` otherwise. ``max_bytes`` is checked
    against the stacked set after that choice and raises
    ``DeviceCacheTooLarge`` when it is exceeded. ``nbytes`` is what the
    cache holds on the device.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, pad_last: bool = False,
                 storage_dtype: str = "native", max_bytes: Optional[int] = None,
                 device: str | torch.device = "cuda", num_shards: int = 1,
                 shard_index: int = 0):
        super().__init__(dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
                         seed=seed, prefetch=0, pad_last=pad_last, num_shards=num_shards,
                         shard_index=shard_index)
        if storage_dtype not in ("native", "auto", "uint16"):
            raise ValueError(f"storage_dtype must be native/auto/uint16, got {storage_dtype!r}")
        self.device = resolve_device(device)
        stacked = np.stack([dataset[i] for i in range(len(dataset))], axis=0)
        if storage_dtype != "native" and np.issubdtype(stacked.dtype, np.floating):
            if _uint16_exact(stacked):
                stacked = stacked.astype(np.uint16)
            elif storage_dtype == "uint16":
                raise ValueError(
                    "device_cache_dtype: uint16 requires integral tiles in [0, 65535]; "
                    "this dataset has fractional or out-of-range values — use "
                    "'native' (or 'auto' to narrow only when exact)")
        # _tile_nbytes sized the cache from the first tile only; a set that
        # stays float32 past its first tile is twice that estimate.
        if max_bytes is not None and stacked.nbytes > max_bytes:
            raise DeviceCacheTooLarge(
                f"tile set is {stacked.nbytes / 1e9:.2f} GB after dtype resolution "
                f"(> {max_bytes / 1e9:.2f} GB budget)")
        self.nbytes = stacked.nbytes
        self._tiles = torch.from_numpy(stacked).to(self.device)

    def _make_batch(self, idxs: np.ndarray):
        idxs, count = self._shard(idxs)
        with annotate("msid.data.batch"):
            index = torch.from_numpy(np.asarray(idxs, np.int64)).to(self.device)
            batch = torch.index_select(self._tiles, 0, index)
        return (batch, count) if self.pad_last else batch


def _uint16_exact(x: np.ndarray) -> bool:
    """Every value of the float array is an integer in [0, 65535]."""
    return bool(x.size and x.min() >= 0 and x.max() <= np.iinfo(np.uint16).max
                and not np.any(x != np.floor(x)))


def _device_cache_enabled(config: dict, nbytes_estimate: int) -> bool:
    """``data.device_cache``: false, or true/"auto" when the estimate fits
    ``data.device_cache_max_gb`` (true warns when it does not)."""
    data_cfg = config.get("data", {})
    mode = data_cfg.get("device_cache", False)
    if mode is False:
        return False
    cap_gb = float(data_cfg.get("device_cache_max_gb", 4.0))
    fits = nbytes_estimate <= cap_gb * 1e9
    if not fits and mode is True:
        logger.warning("data.device_cache: true but the tile set is %.2f GB "
                       "(> device_cache_max_gb %.1f) — falling back to the host "
                       "loader", nbytes_estimate / 1e9, cap_gb)
    return fits


def _tile_nbytes(dataset, storage_dtype: str = "native") -> int:
    """Estimated cache bytes of ``dataset``, from its first tile: halved when
    ``storage_dtype`` narrows and that tile is float32 and uint16-exact, so
    that a set which fits only narrowed is not refused. The loader checks
    the whole set again when it is built."""
    if len(dataset) == 0:
        return 0
    tile = np.asarray(dataset[0])
    nbytes = tile.nbytes
    if (storage_dtype in ("auto", "uint16") and np.issubdtype(tile.dtype, np.floating)
            and tile.itemsize == 4 and _uint16_exact(tile)):
        nbytes //= 2
    return nbytes * len(dataset)


def _device_cached_or_host(dataset, storage_dtype: str = "native",
                           max_bytes: Optional[int] = None,
                           device: str | torch.device = "cuda", **kw):
    """A ``DeviceCachedLoader`` of ``dataset``, or the host ``BatchLoader``
    for an empty split or a set over budget after narrowing."""
    if len(dataset) > 0:
        try:
            return DeviceCachedLoader(dataset, storage_dtype=storage_dtype,
                                      max_bytes=max_bytes, device=device, **kw)
        except DeviceCacheTooLarge as e:
            logger.warning("device cache disabled for this split: %s — using the "
                           "host loader", e)
    return BatchLoader(dataset, **kw)


def _shard_kw(mesh) -> dict:
    """The loader arguments of this rank's data shard (none without a mesh)."""
    if mesh is None:
        return {}
    return dict(num_shards=mesh.data, shard_index=mesh.data_rank)


def get_dataloaders(config: dict, device: str | torch.device = "cuda", mesh=None):
    """``(train_loader, val_loader)``; both batches are
    ``micro_batch_size * gradient_accumulation_steps`` tiles (the global
    batch: with a ``mesh`` each loader yields this data rank's shard of
    it). With ``data.device_cache`` the splits that fit are cached on
    ``device`` (the GPU unless told otherwise), the validation split in
    what the train split left of the budget."""
    from msid_tpu_torch.data.dataset import build_dataset

    training = config.get("training", {})
    data_cfg = config.get("data", {})
    batch = int(training.get("micro_batch_size", 8)) * int(
        training.get("gradient_accumulation_steps", 1))
    seed = int(config.get("seed", 42))
    train_ds, val_ds = build_dataset(config, "train"), build_dataset(config, "val")
    storage = data_cfg.get("device_cache_dtype", "auto")
    train_kw = dict(batch_size=batch, shuffle=True, drop_last=True, seed=seed,
                    **_shard_kw(mesh))
    val_kw = dict(batch_size=batch, shuffle=False, drop_last=False, seed=seed, pad_last=True,
                  **_shard_kw(mesh))
    if _device_cache_enabled(config, _tile_nbytes(train_ds, storage)
                             + _tile_nbytes(val_ds, storage)):
        cap = int(float(data_cfg.get("device_cache_max_gb", 4.0)) * 1e9)
        train_loader = _device_cached_or_host(train_ds, storage, cap, device, **train_kw)
        spent = getattr(train_loader, "nbytes", 0)
        val_loader = _device_cached_or_host(val_ds, storage, max(0, cap - spent), device,
                                            **val_kw)
        return train_loader, val_loader
    return BatchLoader(train_ds, **train_kw), BatchLoader(val_ds, **val_kw)


def get_test_dataloader(config: dict, batch_size: Optional[int] = None,
                        device: str | torch.device = "cuda", mesh=None):
    """Every sample of the dataset (``train_split`` 1.0) in order, the
    trailing batch padded, of ``batch_size`` tiles (default
    ``training.micro_batch_size``; this data rank's shard of them with a
    ``mesh``); cached on ``device`` as in ``get_dataloaders``."""
    from msid_tpu_torch.data.dataset import build_dataset

    data_cfg = config.get("data", {})
    ds = build_dataset(dict(config, data=dict(data_cfg, train_split=1.0)), "train")
    bs = batch_size or int(config.get("training", {}).get("micro_batch_size", 8))
    kw = dict(batch_size=bs, shuffle=False, drop_last=False, pad_last=True, **_shard_kw(mesh))
    storage = data_cfg.get("device_cache_dtype", "auto")
    if len(ds) > 0 and _device_cache_enabled(config, _tile_nbytes(ds, storage)):
        cap = int(float(data_cfg.get("device_cache_max_gb", 4.0)) * 1e9)
        return _device_cached_or_host(ds, storage, cap, device, **kw)
    return BatchLoader(ds, **kw)
