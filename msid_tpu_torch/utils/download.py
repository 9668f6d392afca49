"""Presence checks and checkpoint inspection (PyTorch): counterpart of
``verify_eurosat``, ``verify_downloads`` and ``inspect_checkpoint`` of
``msid_tpu/utils/download.py``.

Nothing here downloads: the data and weights come from the user's own
files. ``inspect_checkpoint`` reads the port's checkpoints
(``utils/checkpointing.py``: a manager's directory of steps, one step's
``state.pt`` + JSON, or a ``.pth`` file) on the CPU; Orbax checkpoints of
the JAX package are not read (their weights cross through
``models/from_jax.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from msid_tpu_torch.utils.checkpointing import METADATA_FILE, STATE_FILE


def verify_eurosat(data_dir: str | Path, min_classes: int = 9) -> bool:
    """True when ``data_dir`` holds at least ``min_classes`` class
    directories with ``.tif`` tiles."""
    data_dir = Path(data_dir)
    if not data_dir.is_dir():
        return False
    class_dirs = [d for d in data_dir.iterdir() if d.is_dir() and any(d.glob("*.tif"))]
    return len(class_dirs) >= min_classes


def verify_downloads(config: dict) -> dict:
    """Whether the config's dataset and encoder weights are present (the
    weights counted only above 100 MiB), with their paths."""
    data_dir = Path(config.get("data", {}).get("root_dir", "data/EuroSAT_MS"))
    weights = config.get("model", {}).get("encoder", {}).get("pretrained_path")
    return {
        "dataset_present": verify_eurosat(data_dir),
        "dataset_path": str(data_dir),
        "weights_present": bool(weights and Path(weights).exists()
                                and Path(weights).stat().st_size > 100 << 20),
        "weights_path": str(weights),
    }


def _torch_file(path: Path) -> dict:
    """What a ``torch.save`` file holds: its top-level keys and the tensors
    of its model state (``model``, ``state_dict`` or the file itself)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt.get("state_dict", ckpt)) if isinstance(ckpt, dict) else {}
    keys = list(state.keys()) if hasattr(state, "keys") else []
    return {
        "format": "torch",
        "top_level_keys": list(ckpt.keys()) if hasattr(ckpt, "keys") else [],
        "num_tensors": len(keys),
        "sample_keys": keys[:8],
        "path": str(path),
    }


def inspect_checkpoint(path: str | Path) -> dict:
    """Describe a checkpoint without putting its weights on a device: a
    ``CheckpointManager`` directory (``format: "checkpoint_manager"``, its
    steps), one step or ``save_single`` directory (``state.pt``, with its
    metadata's keys) or a ``torch.save`` file (``format: "torch"``)."""
    path = Path(path)
    if path.is_dir() and not (path / STATE_FILE).exists():
        steps = sorted(int(p.name) for p in path.iterdir()
                       if p.is_dir() and p.name.isdigit())
        return {"format": "checkpoint_manager", "steps": steps, "path": str(path)}
    if path.is_dir():
        report = _torch_file(path / STATE_FILE)
        meta = path / METADATA_FILE
        report["metadata_keys"] = (sorted(json.loads(meta.read_text()))
                                   if meta.exists() else [])
        report["path"] = str(path)
        return report
    return _torch_file(path)
