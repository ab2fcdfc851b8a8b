"""PyTorch port of flowtrack_tpu/tracking: the whole-clip tracker and the
streaming per-frame FlowTracker."""

from flowtrack_tpu_torch.tracking.tracker import (  # noqa: F401
    FlowTracker,
    boxes_from_poses,
    greedy_match,
    propagate_poses,
)
