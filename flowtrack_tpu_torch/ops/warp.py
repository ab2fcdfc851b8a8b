"""Sparse bilinear sampling of a flow field.

Port of ``flowtrack_tpu/ops/warp.py``: ``flow_gather`` and
``_bilinear_sample_points`` (warp.py:555-590), the tracker's joint
propagation primitive. The dense warps (``resample2d`` and the kernels K3
and K4) belong to the FlowNet2 cascade, ROADMAP slice 2.
"""

from __future__ import annotations

import torch


def _bilinear_sample_points(img, sx, sy):
    """img (H, W, C) sampled at points (sx, sy) (...,): coordinates clamped
    to the image, four-point bilinear -> (..., C)."""
    h, w = img.shape[0], img.shape[1]
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None].to(img.dtype)
    wy = (sy - y0)[..., None].to(img.dtype)
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    top = img[y0i, x0i] * (1.0 - wx) + img[y0i, x1i] * wx
    bot = img[y1i, x0i] * (1.0 - wx) + img[y1i, x1i] * wx
    return top * (1.0 - wy) + bot * wy


def flow_gather(flow, pts_xy):
    """flow (H, W, 2) sampled at points (..., 2) -> (..., 2) flow vectors."""
    return _bilinear_sample_points(flow, pts_xy[..., 0], pts_xy[..., 1])
