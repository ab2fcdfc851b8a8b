"""Object Keypoint Similarity on tensors.

Port of ``flowtrack_tpu/ops/oks.py``: ``oks_matrix`` (oks.py:64) and
``pose_area`` (:89) as the tracker calls them (no visibility masks), the
lineage's oks_iou formula with the area normalizer
``(a_i + b_j) / 2 + np.spacing(1)`` and var_k = (2 sigma_k)^2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flowtrack_tpu.config import COCO_SIGMAS

_SPACING = float(np.spacing(1))


@functools.lru_cache(maxsize=None)
def _vars(sigmas: tuple, device: torch.device):
    """(2 sigma)^2 per keypoint, made on ``device`` once (no per-call copy
    from the host inside the tracker's scans)."""
    s = torch.tensor(sigmas, dtype=torch.float32, device=device)
    return (s * 2.0) ** 2


def oks_matrix(a_xy, a_area, b_xy, b_area, sigmas=None):
    """Pairwise OKS between poses a (M, K, 2) and b (N, K, 2) -> (M, N),
    every keypoint counted (the tracker's use; the reference's candidate
    visibility filter is not ported yet)."""
    var = _vars(tuple(COCO_SIGMAS if sigmas is None else sigmas), a_xy.device)
    dx = a_xy[:, None, :, 0] - b_xy[None, :, :, 0]
    dy = a_xy[:, None, :, 1] - b_xy[None, :, :, 1]
    norm = (a_area[:, None] + b_area[None, :]) / 2.0 + _SPACING
    e = (dx * dx + dy * dy) / var[None, None, :] / norm[..., None] / 2.0
    return torch.exp(-e).mean(-1)


def pose_area(xy):
    """Area of the bounding box of a pose (N, K, 2) -> (N,)."""
    wh = (xy.amax(dim=-2) - xy.amin(dim=-2)).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]
