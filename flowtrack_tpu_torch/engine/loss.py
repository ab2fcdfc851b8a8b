"""Losses.

Port of ``flowtrack_tpu/engine/loss.py`` (:19-61), in the reference's
channel-last layouts: ``joints_mse_loss`` (the lineage's JointsMSELoss:
the mean over joints of 0.5 * the mean over batch and pixels of the
squared error, both maps scaled by the target weight first), ``epe`` and
the FlowNet ``multiscale_epe``. Means and ``/ div_flow`` divide by a tensor
on the values' device: by a Python scalar a CUDA tensor is multiplied by
the rounded reciprocal, and a CUDA mean multiplies its sum by 1 / count.
"""

from __future__ import annotations

import math

import torch


def _mean(x, dim=None):
    """A sum over ``dim`` (all axes for None) divided by its count."""
    if dim is None:
        return x.sum() / x.new_full((), x.numel())
    count = math.prod(x.shape[d] for d in dim)
    return x.sum(dim) / x.new_full((), count)


def joints_mse_loss(pred, target, target_weight=None):
    """pred, target (N, H, W, K); target_weight (N, K) or None -> scalar."""
    n, h, w, k = pred.shape
    pred = pred.float().reshape(n, h * w, k)
    target = target.float().reshape(n, h * w, k)
    if target_weight is not None:
        tw = target_weight.float().reshape(n, 1, k)
        pred = pred * tw
        target = target * tw
    per_joint = 0.5 * _mean(torch.square(pred - target), (0, 1))   # (K,)
    return _mean(per_joint)


def epe(flow_pred, flow_gt, mean=True):
    """End-point error, the L2 norm of the flow's residual; NHWC, C = 2."""
    d = torch.sqrt(torch.square(flow_pred.float() - flow_gt.float()).sum(-1))
    return _mean(d) if mean else d


def multiscale_epe(flow_pyramid, flow_gt,
                   weights=(0.005, 0.01, 0.02, 0.08, 0.32), div_flow=20.0):
    """The FlowNet training loss over (flow2, ..., flow6), each (N, h, w, 2):
    each level's EPE against the full-resolution ground truth divided by
    ``div_flow`` and average-pooled to its size, weighted."""
    gt = flow_gt.float()
    gt = gt / gt.new_full((), div_flow)
    total = 0.0
    for f, wt in zip(flow_pyramid, weights):
        factor = flow_gt.shape[1] // f.shape[1]
        n, h, w, c = f.shape
        pooled = _mean(gt.reshape(n, h, factor, w, factor, c), (2, 4))
        total = total + wt * epe(f, pooled)
    return total
