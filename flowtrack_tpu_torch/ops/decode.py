"""Heatmap -> keypoint decode on the device.

Port of ``flowtrack_tpu/ops/decode.py``: ``get_max_preds`` (decode.py:27),
``_quarter_offset`` (:40), ``transform_preds_jax`` (:61), ``blur_heatmaps``
(:71), ``get_final_preds`` (:101) and ``rescore`` (:117). Layout NHWK.

1. per-joint argmax (ties: the first index, as ``jnp.argmax`` and
   ``torch.argmax`` both take) -> (x, y) and the max value; coordinates
   are zeroed where the max value is <= 0;
2. the quarter-pixel shift toward the larger neighbour, only strictly
   inside the border (1 < p < size - 1);
3. back to image coordinates through the inverse crop affine (no rotation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flowtrack_tpu_torch.ops.affine import (affine_transform_tensor,
                                          get_affine_transform_inv)


def get_max_preds(heatmaps):
    """(N, H, W, K) -> preds (N, K, 2) xy float32, maxvals (N, K)."""
    n, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(n, h * w, k)
    idx = flat.argmax(dim=1)
    maxvals = flat.amax(dim=1)
    px = (idx % w).float()
    py = (idx // w).float()
    preds = torch.stack([px, py], dim=-1)
    return preds * (maxvals > 0.0).float()[..., None], maxvals


def _quarter_offset(heatmaps, preds):
    """+-0.25 px toward the larger neighbour (reference post_process)."""
    n, h, w, k = heatmaps.shape
    px = preds[..., 0].long()
    py = preds[..., 1].long()
    bi = torch.arange(n, device=heatmaps.device)[:, None]
    ki = torch.arange(k, device=heatmaps.device)[None, :]

    def gather(y, x):
        return heatmaps[bi, y.clamp(0, h - 1), x.clamp(0, w - 1), ki]

    dx = gather(py, px + 1) - gather(py, px - 1)
    dy = gather(py + 1, px) - gather(py - 1, px)
    inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    off = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return preds + off * inside[..., None].float()


def transform_preds(coords, center, scale, heatmap_hw):
    """Heatmap coords (..., K, 2) -> image coords through the inverse crop
    affine of (center, scale) (rotation 0)."""
    hm_h, hm_w = heatmap_hw
    inv = get_affine_transform_inv(center, scale, (hm_w, hm_h))
    return affine_transform_tensor(coords, inv)


def blur_heatmaps(heatmaps, kernel_size: int):
    """Gaussian blur (odd ``kernel_size``, cv2's default sigma) that keeps
    each map's peak value: the lineage's TEST.BLUR_KERNEL."""
    if kernel_size <= 1:
        return heatmaps
    if kernel_size % 2 == 0:
        raise ValueError(f"blur_kernel must be odd, got {kernel_size}")
    k = kernel_size
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = torch.arange(k, dtype=torch.float32, device=heatmaps.device) - (k - 1) / 2.0
    g1 = torch.exp(-(x ** 2) / (2 * sigma * sigma))
    g1 = g1 / g1.sum()
    nk = heatmaps.shape[-1]
    kernel = torch.outer(g1, g1).expand(nk, 1, k, k)
    orig_max = heatmaps.amax(dim=(1, 2), keepdim=True)
    blurred = F.conv2d(heatmaps.permute(0, 3, 1, 2), kernel, padding=k // 2,
                       groups=nk).permute(0, 2, 3, 1)
    new_max = blurred.amax(dim=(1, 2), keepdim=True)
    return blurred * orig_max / new_max.clamp(min=1e-12)


def get_final_preds(heatmaps, center, scale, post_process: bool = True,
                    blur_kernel: int = 0):
    """(N, H, W, K) heatmaps + per-person center/scale (N, 2)
    -> image-space keypoints (N, K, 2) and maxvals (N, K)."""
    heatmaps = heatmaps.float()
    if blur_kernel and blur_kernel > 1:
        heatmaps = blur_heatmaps(heatmaps, blur_kernel)
    preds, maxvals = get_max_preds(heatmaps)
    if post_process:
        preds = _quarter_offset(heatmaps, preds)
    preds = transform_preds(preds, center, scale,
                            (heatmaps.shape[1], heatmaps.shape[2]))
    return preds, maxvals


def rescore(box_scores, maxvals, in_vis_thre: float = 0.2):
    """box score x mean maxval over joints above ``in_vis_thre``; 0 if none."""
    vis = (maxvals > in_vis_thre).float()
    cnt = vis.sum(-1)
    mean_conf = torch.where(cnt > 0, (maxvals * vis).sum(-1) / cnt.clamp(min=1.0),
                            torch.zeros_like(cnt))
    return box_scores * mean_conf
