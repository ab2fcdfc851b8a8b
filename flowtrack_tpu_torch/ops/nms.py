"""Box geometry for suppression.

Port of ``flowtrack_tpu/ops/nms.py::iou_matrix`` (nms.py:25). The greedy
NMS functions are the streaming tracker's and not ported yet.
"""

from __future__ import annotations

import torch


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU of xyxy boxes (M, 4) x (N, 4) -> (M, N), with the
    lineage's +1 pixel-area convention."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    iw = (torch.minimum(ax2[:, None], bx2[None, :])
          - torch.maximum(ax1[:, None], bx1[None, :]) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(ay2[:, None], by2[None, :])
          - torch.maximum(ay1[:, None], by1[None, :]) + 1.0).clamp(min=0.0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)
