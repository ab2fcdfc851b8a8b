"""PyTorch port of flowtrack_tpu/engine: losses, metrics, the pose and flow
train steps, the optimizer and its schedule, and checkpoints."""
