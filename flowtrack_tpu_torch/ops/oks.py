"""Object Keypoint Similarity on tensors, and its numpy twin.

Port of ``flowtrack_tpu/ops/oks.py``: ``oks_one_to_many`` (oks.py:37),
``oks_matrix`` (:64), ``pose_area`` (:89) and ``oks_iou_np`` (:103), the
lineage's oks_iou formula with the area normalizer
``(a_i + b_j) / 2 + np.spacing(1)`` and var_k = (2 sigma_k)^2:

    e_k = (dx_k^2 + dy_k^2) / var_k / norm / 2,  OKS = mean of exp(-e_k)

over the counted keypoints. The visibility filter is the lineage's quirk:
``list(vg > thr) and list(vd > thr)`` evaluates to the second list, so only
the CANDIDATE's visibility counts, and a candidate with no joint above the
threshold has OKS 0.

The tensor functions take leading batch dimensions (one per clip lane).
"""

from __future__ import annotations


import numpy as np
import torch

from flowtrack_tpu_torch.config import COCO_SIGMAS
from flowtrack_tpu_torch.ops import cached_constant

_SPACING = float(np.spacing(1))


_VARS: dict = {}


def _vars(sigmas: tuple, device: torch.device):
    """(2 sigma)^2 per keypoint, made on ``device`` once (no per-call copy
    from the host inside the tracker's scans)."""
    def make():
        s = torch.tensor(sigmas, dtype=torch.float32, device=device)
        return (s * 2.0) ** 2

    return cached_constant(_VARS, (sigmas, device), make)


def _var(sigmas, device):
    return _vars(tuple(COCO_SIGMAS if sigmas is None else sigmas), device)


def _masked_mean(sim, mask):
    """Mean of ``sim`` over the last axis where ``mask`` is 1; 0 where no
    entry counts. The divisor is a tensor, so the division stays a true
    one on a CUDA device."""
    cnt = mask.sum(-1)
    out = (sim * mask).sum(-1) / cnt.clamp(min=1.0)
    return torch.where(cnt > 0, out, torch.zeros_like(out))


def oks_one_to_many(g_xy, d_vis, g_area, d_xy, d_area, sigmas=None,
                    in_vis_thre=None):
    """OKS of one pose g (K, 2) of area ``g_area`` against N candidates
    d (N, K, 2) of areas (N,) -> (N,). With ``in_vis_thre``, only the
    candidates' joints whose ``d_vis`` ((N, K) or (K,)) exceeds it count."""
    var = _var(sigmas, d_xy.device)
    dx = d_xy[..., 0] - g_xy[None, :, 0]
    dy = d_xy[..., 1] - g_xy[None, :, 1]
    norm = (g_area + d_area)[:, None] / 2.0 + _SPACING
    e = (dx * dx + dy * dy) / var[None, :] / norm / 2.0
    sim = torch.exp(-e)
    if in_vis_thre is None:
        mask = torch.ones_like(sim)
    else:
        d_vis = torch.as_tensor(d_vis, device=sim.device)
        mask = torch.broadcast_to(d_vis > in_vis_thre, sim.shape).float()
    return _masked_mean(sim, mask)


def oks_matrix(a_xy, a_area, b_xy, b_area, sigmas=None, b_conf=None,
               vis_thre=None):
    """Pairwise OKS between poses a (..., M, K, 2) and b (..., N, K, 2) of
    areas (..., M) and (..., N) -> (..., M, N). With ``b_conf`` (..., N, K)
    and ``vis_thre``, only the candidates' (b's) joints above the threshold
    count."""
    var = _var(sigmas, a_xy.device)
    dx = a_xy[..., :, None, :, 0] - b_xy[..., None, :, :, 0]
    dy = a_xy[..., :, None, :, 1] - b_xy[..., None, :, :, 1]
    norm = (a_area[..., :, None] + b_area[..., None, :]) / 2.0 + _SPACING
    e = (dx * dx + dy * dy) / var / norm[..., None] / 2.0
    sim = torch.exp(-e)
    if b_conf is None or vis_thre is None:
        # the CPU's mean, with a true division on the card too
        return sim.sum(-1) / sim.new_full((), sim.shape[-1])
    mask = (b_conf > vis_thre).float()[..., None, :, :]
    return _masked_mean(sim, mask)


def pose_area(xy, vis=None):
    """Area of the bounding box of a pose (..., K, 2) -> (...), over the
    joints whose ``vis`` (..., K) is positive when given."""
    if vis is None:
        mins, maxs = xy.amin(dim=-2), xy.amax(dim=-2)
    else:
        v = (vis > 0)[..., None]
        big = torch.full((), 1e9, dtype=xy.dtype, device=xy.device)
        mins = torch.where(v, xy, big).amin(dim=-2)
        maxs = torch.where(v, xy, -big).amax(dim=-2)
    wh = (maxs - mins).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def oks_iou_np(g, d, a_g, a_d, sigmas=None, in_vis_thre=None):
    """Numpy twin in the lineage's flat layout: g (3K,) [x1, y1, v1, ...],
    d (N, 3K), areas a_g and a_d (N,) -> (N,) float64. The visibility
    filter is the candidate's (module docstring); no joint passing gives 0."""
    g = np.asarray(g, np.float64)
    if len(d) == 0:
        return np.zeros(0)
    d = np.asarray(d, np.float64).reshape(len(d), -1)
    sig = np.asarray(sigmas if sigmas is not None else COCO_SIGMAS)
    var = (sig * 2.0) ** 2
    xg, yg = g[0::3], g[1::3]
    ious = np.zeros(len(d))
    for i in range(len(d)):
        xd, yd, vd = d[i, 0::3], d[i, 1::3], d[i, 2::3]
        dx, dy = xd - xg, yd - yg
        e = (dx ** 2 + dy ** 2) / var / ((a_g + a_d[i]) / 2.0 + _SPACING) / 2.0
        if in_vis_thre is not None:
            e = e[vd > in_vis_thre]
        ious[i] = np.mean(np.exp(-e)) if len(e) else 0.0
    return ious
