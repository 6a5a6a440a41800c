"""core of the PyTorch port."""
