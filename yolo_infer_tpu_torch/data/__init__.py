"""data of the PyTorch port."""
