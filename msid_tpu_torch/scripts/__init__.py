"""Command-line entry points of the PyTorch port (``python -m
msid_tpu_torch.scripts.<name>``), with the flags of ``scripts/``."""
