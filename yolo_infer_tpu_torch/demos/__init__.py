"""demos of the PyTorch port."""
