"""Ops of the PyTorch port: the fused ResidualBlock kernel and the dead-band fill."""
