"""Configuration, session set-up and checkpoints of the PyTorch port."""
