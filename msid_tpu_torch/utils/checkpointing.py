"""Checkpoints of the port: counterpart of ``msid_tpu/utils/checkpointing.py``.

A ``CheckpointManager`` over a directory of steps, each written with
``torch.save`` and JSON:

    <directory>/<step>/state.pt        TrainState.state_dict(), on the CPU
    <directory>/<step>/metadata.json   the caller's metadata (epoch, history,
                                       config) and the manager's own keys
    <directory>/<step>/metrics.json    the ranking metrics of the save

A step is written into ``<step>.tmp`` and renamed into place, so a reader
never sees half a checkpoint. Retention and best tracking follow the JAX
manager's (Orbax ``BestN``): after each save the steps are ranked by
``metric`` in ``mode`` (a missing metric ranks last), the top
``keep_top_k`` stay, and the best step is the last in that order, the
later step winning a tie. A save below or at the latest step is skipped
unless forced; ``save_every`` skips steps that are not its multiples
unless forced.

``moments_dtype`` (e.g. "bfloat16") stores the AdamW moments in that
dtype; a restore casts them back to the target's. The metadata records
``_has_ema``, so a restore adapts the EMA shadow to its target: a target
without one takes the saved shadow, and a target with one restored from a
checkpoint without one re-seeds it from the restored parameters.
``background_transfer`` snapshots the state on the device and writes it
from a worker thread, one save in flight at a time; a failure is raised at
the next sync point (the next save, a load, ``wait_until_finished`` or
``close``). Orbax's own formats are not read: weights cross from the JAX
package through ``models/from_jax.py``.

Under data parallelism (``mesh``, set by the trainer) every rank keeps the
same bookkeeping but only data rank 0 writes and prunes; after each save
(at the join of its thread, with ``background_transfer``) every rank
waits at a barrier, so a rank that goes on to read finds the step whole.
Every rank loads. A tensor-parallel state is refused: its ranks hold
shards (``parallel.tp.gather_state_dict`` makes whole weights).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"
METRICS_FILE = "metrics.json"
MOMENTS = ("exp_avg", "exp_avg_sq")


def _cast_moments(state: dict, dtype: torch.dtype) -> dict:
    """A copy of a ``TrainState.state_dict()`` whose AdamW moments are in
    ``dtype``; parameters, BN statistics, counts and the EMA are shared."""
    optimizer = dict(state["optimizer"])
    optimizer["state"] = {
        i: {k: (v.to(dtype) if k in MOMENTS else v) for k, v in entry.items()}
        for i, entry in optimizer["state"].items()
    }
    return dict(state, optimizer=optimizer)


def _map_tensors(fn, obj: Any) -> Any:
    """``fn`` applied to every tensor in a nested dict/list/tuple."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def _to_cpu(obj: Any) -> Any:
    return _map_tensors(lambda t: t.detach().cpu(), obj)


def _write_step(path: Path, state: dict, metadata: dict, metrics: Optional[dict]) -> None:
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(_to_cpu(state), tmp / STATE_FILE)
    (tmp / METADATA_FILE).write_text(json.dumps(metadata))
    if metrics is not None:
        (tmp / METRICS_FILE).write_text(json.dumps(metrics))
    os.replace(tmp, path)


class CheckpointManager:
    """Top-K retention checkpoint manager over ``torch.save``."""

    def __init__(self, directory: str | Path, keep_top_k: int = 3,
                 metric: str = "val_psnr", mode: str = "max", save_every: int = 1,
                 moments_dtype: Optional[str] = None,
                 background_transfer: bool = False):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be max|min, got {mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_top_k = keep_top_k
        self.metric = metric
        self.mode = mode
        self.save_every = save_every
        self.moments_dtype = moments_dtype
        self.background_transfer = background_transfer
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        self.mesh = None                 # a data-parallel mesh: data rank 0 writes
        self._barrier_due = False
        # {step: metrics or None}, in save order; steps on disk are read in
        # step order, as a reopened Orbax manager reads them.
        self._steps: dict[int, Optional[dict]] = {}
        for path in sorted((p for p in self.directory.iterdir()
                            if p.is_dir() and p.name.isdigit()), key=lambda p: int(p.name)):
            metrics_path = path / METRICS_FILE
            self._steps[int(path.name)] = (json.loads(metrics_path.read_text())
                                           if metrics_path.exists() else None)

    # ---------------- ranking ----------------

    def _rank_key(self, metrics: dict) -> float:
        missing = float("-inf") if self.mode == "max" else float("inf")
        return float(metrics.get(self.metric, missing))

    def _ranked(self) -> list[int]:
        """Steps with metrics, worst first (best last); ties keep save order."""
        with_metrics = [(s, m) for s, m in self._steps.items() if m is not None]
        ranked = sorted(with_metrics, key=lambda sm: self._rank_key(sm[1]),
                        reverse=self.mode == "min")
        return [s for s, _ in ranked]

    def _prune(self) -> None:
        if self.keep_top_k is None or len(self._steps) <= self.keep_top_k:
            return
        keep = set(self._ranked()[-self.keep_top_k:] if self.keep_top_k else [])
        keep |= {s for s, m in self._steps.items() if m is None}
        for step in [s for s in self._steps if s not in keep]:
            if self._writes():
                shutil.rmtree(self.directory / str(step), ignore_errors=True)
            del self._steps[step]

    def all_steps(self) -> list[int]:
        return sorted(self._steps)

    def latest_step(self) -> Optional[int]:
        return max(self._steps) if self._steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    # ---------------- saving ----------------

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             metadata: Optional[dict] = None, force: bool = False) -> bool:
        """Save ``state`` (a ``TrainState`` or its state dict) at ``step`` if
        the cadence (or ``force``) says so. Returns True if saved."""
        if not force and self.save_every > 1 and step % self.save_every != 0:
            return False
        self._join_save_thread()
        latest = self.latest_step()
        if not force and latest is not None and latest >= step:
            return False
        if step in self._steps:
            raise ValueError(f"checkpoint for step {step} already exists")
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        metadata = copy.deepcopy(dict(metadata or {}))   # the caller may go on mutating it
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        if self.moments_dtype:
            sd = _cast_moments(sd, getattr(torch, str(self.moments_dtype)))
            metadata["_moments_dtype"] = str(self.moments_dtype)
        metadata["_has_ema"] = sd.get("ema") is not None
        path = self.directory / str(step)

        def finish() -> None:
            self._steps[step] = metrics
            self._prune()

        if not self._writes():
            finish()                             # the writer's bookkeeping, no files
            self._barrier_due = True
            if not self.background_transfer:
                self._barrier()
            return True
        if not self.background_transfer:
            _write_step(path, sd, metadata, metrics)
            finish()
            self._barrier_due = True
            self._barrier()
            return True

        # Snapshot on the device (a copy per tensor), then hand the
        # device-to-host copy and the write to a worker thread.
        snapshot = _map_tensors(lambda t: t.detach().clone(), sd)

        def worker() -> None:
            try:
                _write_step(path, snapshot, metadata, metrics)
                finish()
            except BaseException as exc:  # raised at the next sync point
                self._save_error = exc

        self._save_thread = threading.Thread(target=worker, name=f"ckpt-save-{step}",
                                             daemon=True)
        self._save_thread.start()
        self._barrier_due = True
        return True

    def _writes(self) -> bool:
        if self.mesh is not None and self.mesh.model > 1:
            raise ValueError("a tensor-parallel state is sharded; save the weights of "
                             "parallel.tp.gather_state_dict instead")
        return self.mesh is None or self.mesh.data_rank == 0

    def _barrier(self) -> None:
        """Every rank waits here until the writer's save is on disk."""
        if self._barrier_due and self.mesh is not None and self.mesh.distributed:
            import torch.distributed as dist

            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[self.mesh.device.index])
            else:
                dist.barrier()
        self._barrier_due = False

    def _join_save_thread(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise err
        self._barrier()

    def wait_until_finished(self) -> None:
        self._join_save_thread()

    def close(self) -> None:
        self._join_save_thread()

    # ---------------- loading ----------------

    def _read(self, step: int) -> tuple[dict, dict]:
        self.wait_until_finished()
        path = self.directory / str(step)
        state = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
        metadata = json.loads((path / METADATA_FILE).read_text())
        return state, metadata

    def _restore(self, step: int, target: Any = None):
        state, metadata = self._read(step)
        if target is None:
            return state, metadata
        if metadata.get("_moments_dtype"):
            # The target's parameters, and so its moments, are fp32.
            state = _cast_moments(state, torch.float32)
        reseed = target.ema is not None and not metadata.get("_has_ema", False)
        target.load_state_dict(state)
        if reseed:
            target.ema = {n: p.detach().clone() for n, p in target.model.named_parameters()}
            logger.info("checkpoint has no EMA shadow: re-seeded from the restored params")
        return target, metadata

    def load_latest(self, target: Any = None):
        """``(state, metadata, step)`` for the newest checkpoint, or None.
        With a ``TrainState`` target the state is restored into it."""
        step = self.latest_step()
        if step is None:
            return None
        state, metadata = self._restore(step, target)
        return state, metadata, step

    def load_best(self, target: Any = None):
        """``(state, metadata, step)`` for the best checkpoint by the
        ranking metric, or None."""
        step = self.best_step()
        if step is None:
            return None
        state, metadata = self._restore(step, target)
        return state, metadata, step

    def load_step(self, step: int, target: Any = None):
        state, metadata = self._restore(step, target)
        return state, metadata, step

    def load_weights(self, target_state: Any, best: bool = True, prefer_ema: bool = True):
        """Weights-only warm start: graft the parameters and BN statistics
        of a saved checkpoint (best, else latest) into ``target_state``'s
        module by name, keeping its optimizer, schedule position and step,
        so the freeze set may differ. ``prefer_ema`` starts from the
        source's EMA shadow when it kept one; the target's own shadow, if
        any, is re-seeded from the grafted parameters. Returns
        ``(state, metadata, step)`` or None."""
        step = self.best_step() if best else self.latest_step()
        if step is None and best:
            step = self.latest_step()
        if step is None:
            return None
        saved, metadata = self._read(step)
        weights = dict(saved["model"])
        if prefer_ema and saved.get("ema"):
            logger.info("load_weights: starting from the source EMA shadow")
            weights.update(saved["ema"])
        target_state.model.load_state_dict(weights)
        if target_state.ema is not None:
            target_state.ema = {n: p.detach().clone()
                                for n, p in target_state.model.named_parameters()}
        return target_state, metadata, step


def save_single(directory: str | Path, state: Any, metadata: Optional[dict] = None) -> None:
    """One checkpoint with no retention policy (e.g. an exported best model)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    sd = state.state_dict() if hasattr(state, "state_dict") else state
    torch.save(_to_cpu(sd), directory / STATE_FILE)
    if metadata is not None:
        (directory / METADATA_FILE).write_text(json.dumps(metadata, indent=2))


def load_single(directory: str | Path, target: Any = None):
    """Restore a :func:`save_single` checkpoint; ``(state, metadata)``."""
    directory = Path(directory).absolute()
    state = torch.load(directory / STATE_FILE, map_location="cpu", weights_only=True)
    meta_path = directory / METADATA_FILE
    metadata = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    if target is not None:
        target.load_state_dict(state)
        state = target
    return state, metadata
