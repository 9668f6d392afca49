"""Benchmarks of the PyTorch port that run on the GPU (or, with
``--device cpu``, through the kernels' plain versions)."""
