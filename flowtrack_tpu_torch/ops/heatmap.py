"""Ground-truth heatmaps and the flip-test merge.

Port of ``flowtrack_tpu/ops/heatmap.py``: ``generate_target`` (the tensor
``generate_target_jax``, heatmap.py:23, batched over leading axes as its
``generate_target_batch``), ``generate_target_np`` (:72, the data
pipeline's), ``flip_back`` (:107) and ``merge_flip_test`` (:125).
Heatmaps keep the reference's NHWK layout (any strides; the tracker passes
channel-last views of the model's NCHW output).

Targets: one Gaussian per visible joint, peak 1, centred at the joint
quantised to the heatmap grid (trunc(x / stride + 0.5), as the lineage's
int()), cut at 3 sigma; a joint whose 3-sigma box lies wholly off the map
gets weight 0 (a box abutting the edge keeps weight 1).
"""

from __future__ import annotations

import numpy as np
import torch

from flowtrack_tpu_torch.ops import cached_constant


def _target_geometry(heatmap_hw, image_hw, sigma):
    hm_h, hm_w = heatmap_hw
    return hm_h, hm_w, image_hw[1] / hm_w, image_hw[0] / hm_h, int(sigma * 3)


def generate_target(joints, joints_vis, heatmap_hw, image_hw, sigma):
    """Tensor targets: joints (..., K, 2) input-image pixels (x, y),
    joints_vis (..., K) -> target (..., H, W, K) float32 and weight
    (..., K) float32."""
    hm_h, hm_w, stride_x, stride_y, tmp = _target_geometry(
        heatmap_hw, image_hw, sigma)
    joints = torch.as_tensor(joints, dtype=torch.float32)
    vis = torch.as_tensor(joints_vis, dtype=torch.float32,
                          device=joints.device).reshape(joints.shape[:-1])
    sx = joints.new_full((), stride_x)
    sy = joints.new_full((), stride_y)
    mu_x = torch.trunc(joints[..., 0] / sx + 0.5)
    mu_y = torch.trunc(joints[..., 1] / sy + 0.5)
    outside = ((mu_x - tmp >= hm_w) | (mu_y - tmp >= hm_h)
               | (mu_x + tmp + 1 < 0) | (mu_y + tmp + 1 < 0))
    weight = vis * (1.0 - outside.float())
    ys = torch.arange(hm_h, dtype=torch.float32, device=joints.device)
    xs = torch.arange(hm_w, dtype=torch.float32, device=joints.device)
    dx = xs[None, :, None] - mu_x[..., None, None, :]   # (..., 1, W, K)
    dy = ys[:, None, None] - mu_y[..., None, None, :]   # (..., H, 1, K)
    g = torch.exp(-(dx * dx + dy * dy) / joints.new_full((), 2.0 * sigma * sigma))
    inbox = (dx.abs() <= tmp) & (dy.abs() <= tmp)
    return g * inbox.float() * weight[..., None, None, :], weight


def generate_target_np(joints, joints_vis, heatmap_hw, image_hw, sigma):
    """numpy targets for one person: joints (K, 2), joints_vis (K,) ->
    target (H, W, K) float32, weight (K,) float32."""
    hm_h, hm_w, stride_x, stride_y, tmp = _target_geometry(
        heatmap_hw, image_hw, sigma)
    joints = np.asarray(joints, np.float32)
    vis = np.asarray(joints_vis, np.float32).reshape(-1)
    k = joints.shape[0]

    mu_x = np.trunc(joints[:, 0] / stride_x + 0.5)
    mu_y = np.trunc(joints[:, 1] / stride_y + 0.5)
    outside = ((mu_x - tmp >= hm_w) | (mu_y - tmp >= hm_h)
               | (mu_x + tmp + 1 < 0) | (mu_y + tmp + 1 < 0))
    weight = vis * (1.0 - outside.astype(np.float32))

    ys = np.arange(hm_h, dtype=np.float32)[:, None]
    xs = np.arange(hm_w, dtype=np.float32)[None, :]
    target = np.zeros((hm_h, hm_w, k), np.float32)
    for j in range(k):
        if weight[j] <= 0:
            continue
        dx = xs - mu_x[j]
        dy = ys - mu_y[j]
        g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
        g *= (np.abs(dx) <= tmp) & (np.abs(dy) <= tmp)
        target[:, :, j] = g
    return target, weight


_FLIP_INDEX: dict = {}


def _flip_index(k: int, flip_pairs: tuple, device: torch.device):
    """The joint permutation of ``flip_back``, made on ``device`` once."""
    perm = list(range(k))
    for a, b in flip_pairs:
        perm[a], perm[b] = b, a
    return cached_constant(_FLIP_INDEX, (k, flip_pairs, device),
                           lambda: torch.tensor(perm, device=device))


def flip_back(heatmaps, flip_pairs):
    """Mirror W, then swap each (left, right) joint channel pair. NHWK."""
    index = _flip_index(heatmaps.shape[-1],
                        tuple(tuple(p) for p in flip_pairs), heatmaps.device)
    return heatmaps.flip(2).index_select(-1, index)


def merge_flip_test(heatmaps, heatmaps_flipped, flip_pairs, shift=True):
    """Average the direct heatmaps with the flipped-back ones; ``shift``
    moves the flipped-back maps one pixel right first (the reference's
    ``output_flipped[..., 1:] = output_flipped[..., :-1]``)."""
    hf = flip_back(heatmaps_flipped, flip_pairs)
    if shift:
        hf = torch.cat([hf[:, :, :1], hf[:, :, :-1]], dim=2)
    return (heatmaps + hf) * 0.5
