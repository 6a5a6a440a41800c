"""optimization of the PyTorch port: the model optimizers (post-training int8 quantization)."""
