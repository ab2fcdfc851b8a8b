"""PyTorch port of flowtrack_tpu/eval: the optical-flow metrics."""
