"""Host-side box geometry of the inference pipeline.

Port of ``flowtrack_tpu/pipeline.py::batched_box_to_center_scale``
(pipeline.py:36), numpy on the host as in the reference. The reference's
``PosePredictor`` / ``FlowPredictor`` are not ported yet.
"""

from __future__ import annotations

import numpy as np

from flowtrack_tpu.config import PIXEL_STD


def batched_box_to_center_scale(boxes_xywh: np.ndarray, aspect_ratio: float,
                                scale_padding: float = 1.25):
    """(P, 4) xywh -> centers (P, 2), scales (P, 2), float64: the box grown
    to the crop's aspect ratio, in PIXEL_STD units, padded by 1.25."""
    boxes = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)
    x, y, w, h = boxes.T.copy()
    centers = np.stack([x + w * 0.5, y + h * 0.5], axis=1)
    wide = w > aspect_ratio * h
    h = np.where(wide, w / aspect_ratio, h)
    w = np.where(~wide & (w < aspect_ratio * h), h * aspect_ratio, w)
    scales = np.stack([w, h], axis=1) / PIXEL_STD * scale_padding
    return centers, scales
