"""Host input pipeline (numpy): counterpart of ``msid_tpu/data/pipeline.py``.

``BatchLoader`` yields seeded, shuffled batches of raw tiles, staged by a
background thread; ``get_dataloaders`` builds the train loader (drop_last)
and the validation loader (every sample, the trailing batch padded to the
static shape and yielded as ``(batch, true_count)``). The JAX package's
``DeviceCachedLoader`` is not ported yet: it gives bit-identical batches,
so ``data.device_cache`` falls back to the host loader with a log line.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator

import numpy as np

logger = logging.getLogger(__name__)


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
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 pad_last: bool = False):
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

    def _make_batch(self, idxs: np.ndarray):
        batch = np.stack([self.dataset[int(i)] for i in idxs], axis=0)
        if self.pad_last:
            count = batch.shape[0]
            if count < self.batch_size:
                pad = np.repeat(batch[:1], self.batch_size - count, axis=0)
                batch = np.concatenate([batch, pad], axis=0)
            return batch, count
        return batch

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


def get_dataloaders(config: dict):
    """``(train_loader, val_loader)``; both batches are
    ``micro_batch_size * gradient_accumulation_steps`` tiles."""
    from msid_tpu_torch.data.dataset import build_dataset

    training = config.get("training", {})
    data_cfg = config.get("data", {})
    batch = int(training.get("micro_batch_size", 8)) * int(
        training.get("gradient_accumulation_steps", 1))
    seed = int(config.get("seed", 42))
    if data_cfg.get("device_cache", False):
        logger.info("data.device_cache is set, but the device tile cache "
                    "(DeviceCachedLoader) is not ported yet; using the host "
                    "loader, which gives the same batches")
    train_loader = BatchLoader(build_dataset(config, "train"), batch_size=batch,
                               shuffle=True, drop_last=True, seed=seed)
    val_loader = BatchLoader(build_dataset(config, "val"), batch_size=batch,
                             shuffle=False, drop_last=False, seed=seed, pad_last=True)
    return train_loader, val_loader
