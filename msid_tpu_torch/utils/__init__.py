"""Configuration helpers of the PyTorch port."""
