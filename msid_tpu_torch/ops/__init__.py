"""Ops of the PyTorch port: preprocessing, corruption (kernel K2), the
dead-band fill, SSIM and metrics, the fused ResidualBlock (kernels K1 in
bf16 and K4 in fp32) and the dihedral test-time self-ensemble."""
