"""PyTorch port of flowtrack_tpu/tracking: the whole-clip tracker."""
