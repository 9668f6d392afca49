"""Ops of the PyTorch port: preprocessing, corruption (kernel K2), the
dead-band fill, SSIM and metrics, and the fused ResidualBlock (kernel K1)."""
