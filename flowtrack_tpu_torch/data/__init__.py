"""PyTorch port of flowtrack_tpu/data: what the port's video reader needs."""
