"""PyTorch ports of flowtrack_tpu/models: PoseResNet and FlowNetS/C."""
