"""Configuration, session set-up and checkpoints of the PyTorch port.

Heavy submodules (visualization, setup_helpers, checkpointing, ...) are not
imported here; import them directly, as in the JAX package:
    from msid_tpu_torch.utils import visualization, setup_helpers
"""

from msid_tpu_torch.utils.config import (
    coerce_scheduler_params,
    get_project_root,
    load_config,
    merge_configs,
    print_config,
    save_config,
    validate_config,
)

__all__ = [
    "coerce_scheduler_params",
    "get_project_root",
    "load_config",
    "merge_configs",
    "print_config",
    "save_config",
    "validate_config",
]
