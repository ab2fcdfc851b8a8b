"""Crop affine transforms on tensors (what decode needs).

Port of ``flowtrack_tpu/ops/affine.py``: ``get_affine_transform_jax``
(affine.py:148) with ``inv=True`` and no rotation, the map from crop (or
heatmap) coordinates back to the image, and ``affine_transform_jax`` (:195).
The forward and rotated transforms (training augmentation, warps) are not
ported yet.
"""

from __future__ import annotations

import torch

from flowtrack_tpu_torch.config import PIXEL_STD


def get_affine_transform_inv(center, scale, output_size):
    """(..., 2, 3) float32 map from an ``output_size`` = (w, h) crop back to
    the image, for the crop of (center, scale) without rotation: the
    similarity the reference's 3-point construction defines, in closed
    form."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    # a true division on every device: by a Python scalar a CUDA tensor is
    # multiplied by the rounded reciprocal (48 and 72 have no exact one)
    src_w = scale[..., 0] * PIXEL_STD
    s = src_w / src_w.new_full((), dst_w)
    zero = torch.zeros_like(s)
    tx = center[..., 0] - s * dst_w * 0.5
    ty = center[..., 1] - s * dst_h * 0.5
    row0 = torch.stack([s, zero, tx], dim=-1)
    row1 = torch.stack([zero, s, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_transform(pts, t):
    """Apply (..., 2, 3) transforms to (..., K, 2) points, elementwise."""
    pts = pts.float()
    x, y = pts[..., 0], pts[..., 1]
    t = t[..., None, :, :]
    xo = t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2]
    yo = t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2]
    return torch.stack([xo, yo], dim=-1)
