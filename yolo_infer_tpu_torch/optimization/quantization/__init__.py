"""int8 quantizers of the PyTorch port."""
