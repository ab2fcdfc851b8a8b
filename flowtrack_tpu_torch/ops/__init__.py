"""PyTorch ports of flowtrack_tpu/ops: crop, correlation, decode, geometry."""
