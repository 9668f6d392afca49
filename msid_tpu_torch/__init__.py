"""PyTorch/CUDA port of msid_tpu for NVIDIA Hopper (H100).

The JAX package ``msid_tpu`` is the reference; this package reads the same
``configs/`` YAML, takes and returns NHWC tensors at its public functions,
and runs its hand-written kernels (``csrc/``) on the GPU. Each subpackage
re-exports the public names of its JAX counterpart; importing one builds
no kernel (a kernel is built at its first launch).
"""

__version__ = "0.1.0"

from msid_tpu_torch.utils.config import load_config, merge_configs, save_config, validate_config

__all__ = [
    "__version__",
    "load_config",
    "merge_configs",
    "save_config",
    "validate_config",
]
