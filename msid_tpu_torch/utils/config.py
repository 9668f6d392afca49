"""YAML configuration loading with inheritance, for the PyTorch port.

The port's own copy of ``load_config`` / ``merge_configs``,
``validate_config`` and ``coerce_scheduler_params`` of the JAX package
(``msid_tpu/utils/config.py``), so both packages read the same
``configs/`` files. Two inheritance mechanisms are accepted:

  * an explicit ``inherits: ../base.yaml`` top-level key (removed from the
    merged result);
  * the comment syntax ``# Inherits from: ../base.yaml``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

logger = logging.getLogger(__name__)

_INHERIT_KEY = "inherits"


def load_config(config_path: str | Path, _seen: tuple = ()) -> Dict[str, Any]:
    """Load a YAML config, resolving inheritance recursively.

    Override values take precedence over inherited base values (deep
    merge, dict by dict). A missing explicit base raises, and so does an
    inheritance cycle.
    """
    config_path = Path(config_path)
    if not config_path.exists():
        raise FileNotFoundError(f"Config file not found: {config_path}")

    resolved = config_path.resolve()
    if resolved in _seen:
        chain = " -> ".join(str(p) for p in _seen)
        raise ValueError(f"Config inheritance cycle: {chain} -> {resolved}")

    with open(config_path, "r") as f:
        config = yaml.safe_load(f) or {}

    base_path = _find_base_config(config_path, config)
    config.pop(_INHERIT_KEY, None)
    if base_path is not None:
        base_config = load_config(base_path, _seen=_seen + (resolved,))
        config = merge_configs(base_config, config)
    return config


def _find_base_config(config_path: Path, config: Dict[str, Any]) -> Optional[Path]:
    """Resolve the base config referenced by this file, if any: the
    ``inherits:`` key first, then the ``# Inherits from:`` comment."""
    if isinstance(config, dict) and _INHERIT_KEY in config:
        base = config_path.parent / str(config[_INHERIT_KEY])
        if base.exists():
            return base
        raise FileNotFoundError(
            f"{config_path}: inherited base config not found: {base}"
        )

    with open(config_path, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith("#") and "Inherits from:" in line:
                base = config_path.parent / line.split("Inherits from:")[1].strip()
                if base.exists():
                    return base
                logger.warning("Base config not found: %s", base)
    return None


def merge_configs(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` onto ``base`` (override wins)."""
    merged = dict(base)
    for key, value in override.items():
        if key in merged and isinstance(merged[key], dict) and isinstance(value, dict):
            merged[key] = merge_configs(merged[key], value)
        else:
            merged[key] = value
    return merged


def validate_config(config: Dict) -> bool:
    """Check the required sections and keys; raises ValueError on the
    first gap."""
    for section in ("data", "model", "training"):
        if section not in config:
            raise ValueError(f"Missing required config section: {section}")
    for key in ("root_dir", "num_bands", "image_size"):
        if key not in config["data"]:
            raise ValueError(f"Missing required data config: {key}")
    if "encoder" not in config["model"] or "decoder" not in config["model"]:
        raise ValueError("Model config must have 'encoder' and 'decoder' sections")
    for key in ("epochs", "micro_batch_size"):
        if key not in config["training"]:
            raise ValueError(f"Missing required training config: {key}")
    return True


def coerce_scheduler_params(config: Dict) -> Dict:
    """Cast optimizer/scheduler numbers that YAML parses as strings (``1e-4``
    has no dot, so PyYAML reads it as a string)."""
    training = config.get("training", {})
    opt = training.get("optimizer", {})
    for key in ("lr", "weight_decay"):
        if key in opt:
            opt[key] = float(opt[key])
    if "betas" in opt:
        opt["betas"] = [float(b) for b in opt["betas"]]
    sched = training.get("scheduler", {})
    if "eta_min" in sched:
        sched["eta_min"] = float(sched["eta_min"])
    for key in ("T_0", "T_mult"):
        if key in sched:
            sched[key] = int(sched[key])
    return config
