"""Serving for the PyTorch port."""
