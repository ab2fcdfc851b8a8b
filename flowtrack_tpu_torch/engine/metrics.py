"""Training-time heatmap accuracy (PCK-style) and a running mean.

Port of ``flowtrack_tpu/engine/metrics.py``: ``heatmap_accuracy`` (:22)
decodes the argmax of the predicted and the ground-truth heatmaps, divides
their distance by the heatmap size / 10 and counts a joint right under
``thr``, ignoring joints whose ground-truth peak is missing (a coordinate
<= 1). It keeps the reference's quirk: (x, y) is divided by [h, w] / 10, h
against x (:31-34). It runs on the device with no host sync; divisions are
by tensors on the values' device. ``AverageMeter`` is host-side.
"""

from __future__ import annotations

import torch

from flowtrack_tpu_torch.ops.decode import get_max_preds


def heatmap_accuracy(pred_hm, gt_hm, thr: float = 0.5):
    """pred_hm, gt_hm (N, H, W, K) -> (mean accuracy, per-joint accuracy
    (K,) with -1 for joints never visible, visible count), tensors."""
    return accuracy_from_counts(*joint_counts(pred_hm, gt_hm, thr))


def joint_counts(pred_hm, gt_hm, thr: float = 0.5):
    """pred_hm, gt_hm (N, H, W, K) -> per joint, (right, visible) counts
    (K,): what ``heatmap_accuracy`` takes of a batch, which sums over the
    shards of a batch split across devices."""
    n, h, w, k = pred_hm.shape
    pred, _ = get_max_preds(pred_hm)
    target, _ = get_max_preds(gt_hm)
    # made on the device, not copied from the host (a captured step takes
    # no host data); divided by a tensor, as a CUDA division by a Python
    # number multiplies by its rounded reciprocal
    dev = pred.device
    norm = (torch.where(torch.arange(2, device=dev) == 0, float(h), float(w))
            / torch.full((), 10.0, device=dev))
    dists = torch.linalg.norm((pred - target) / norm, dim=-1)     # (N, K)
    visible = (target[..., 0] > 1.0) & (target[..., 1] > 1.0)     # (N, K)
    correct = (dists < thr) & visible
    return correct.sum(0), visible.sum(0)                          # (K,)


def accuracy_from_counts(correct, cnt_per_joint):
    """``joint_counts``' sums -> ``heatmap_accuracy``'s triple."""
    acc_per_joint = torch.where(
        cnt_per_joint > 0,
        correct / cnt_per_joint.clamp(min=1),
        torch.full((), -1.0, device=correct.device))
    valid = acc_per_joint >= 0
    avg = (torch.where(valid, acc_per_joint, 0.0).sum()
           / valid.sum().clamp(min=1))
    return avg, acc_per_joint, cnt_per_joint.sum()


class AverageMeter:
    """Running average of host values."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0
