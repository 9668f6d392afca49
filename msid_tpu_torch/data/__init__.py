"""Host-side data of the PyTorch port: the synthetic EuroSAT stand-in and
the batch loader."""
