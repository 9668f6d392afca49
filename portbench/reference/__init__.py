"""Plain PyTorch and NumPy reference of what the benchmark's cells compute,
written from the model's and the recipe's equations; it imports neither JAX
nor anything of ``msid_tpu`` or ``msid_tpu_torch``."""
