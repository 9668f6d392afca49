"""PyTorch/CUDA port of msid_tpu for NVIDIA Hopper (H100).

The JAX package ``msid_tpu`` is the reference; this package reads the same
``configs/`` YAML, takes and returns NHWC tensors at its public functions,
and runs its hand-written kernels (``csrc/``) on the GPU.
"""
