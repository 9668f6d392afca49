"""Models of the PyTorch port: encoder, decoders, composite model, JAX weight converter."""
