"""Greedy suppression: box IoU NMS and OKS-NMS on tensors, and numpy twins.

Port of ``flowtrack_tpu/ops/nms.py``: ``iou_matrix`` (nms.py:25),
``greedy_nms_from_matrix`` (:45), ``nms_boxes`` (:85), ``oks_nms`` (:90)
and the host twins ``oks_nms_np``, ``nms_boxes_np`` and ``soft_oks_nms_np``
(:105-174). Greedy NMS takes candidates in descending score order and keeps
one iff its similarity to every candidate kept before is <= the threshold;
equal scores go to the HIGHER index, as the twins' ``argsort(kind="stable")
[::-1]`` orders them.

The tensor version is a loop of N masked rounds over a precomputed
similarity matrix, with its state in tensors: no host sync, a static trip
count. Invalid (padded) candidates score -inf and are never kept and never
suppress.
"""

from __future__ import annotations

import numpy as np
import torch

from flowtrack_tpu_torch.ops.oks import oks_iou_np, oks_matrix


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU of xyxy boxes (..., M, 4) x (..., N, 4) -> (..., M, N),
    with the lineage's +1 pixel-area convention."""
    ax1, ay1, ax2, ay2 = boxes_a[..., :, None, :].unbind(-1)
    bx1, by1, bx2, by2 = boxes_b[..., None, :, :].unbind(-1)
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1.0).clamp(min=0.0)
    inter = iw * ih
    return inter / (area_a + area_b - inter)


def greedy_nms_from_matrix(sim, scores, thresh, valid=None):
    """Greedy NMS over a pairwise similarity ``sim`` (N, N) with ``scores``
    (N,): suppress j when sim[i, j] > ``thresh`` for a kept i. ``valid``
    (N,) masks padded entries. Returns keep (N,) bool."""
    n = scores.shape[0]
    neg = float("-inf")
    scores = torch.as_tensor(scores, dtype=torch.float32, device=sim.device)
    if valid is not None:
        scores = torch.where(valid, scores, neg)
    idx = torch.arange(n, device=sim.device)
    alive = torch.isfinite(scores)      # neither kept nor suppressed yet
    keep = torch.zeros(n, dtype=torch.bool, device=sim.device)
    over = sim > thresh
    for _ in range(n):
        s = torch.where(alive, scores, neg)
        # the highest index among equal maxima (argmax gives the lowest)
        hit = idx == n - 1 - s.flip(0).argmax()
        # once nothing is alive the state is a fixed point
        keep = keep | (hit & alive.any())
        alive = alive & ~((hit[:, None] & over).any(0) | hit)
    return keep


def nms_boxes(boxes, scores, thresh, valid=None):
    """Greedy IoU NMS over (N, 4) xyxy boxes -> (N,) keep mask."""
    return greedy_nms_from_matrix(iou_matrix(boxes, boxes), scores, thresh,
                                  valid)


def oks_nms(kpts_xy, scores, areas, thresh, valid=None, sigmas=None,
            conf=None, in_vis_thre=None):
    """Greedy OKS-NMS over poses (N, K, 2) with scores and areas (N,)
    -> (N,) keep mask; ``conf`` (N, K) and ``in_vis_thre`` filter the
    candidates' joints as ``oks_matrix`` does."""
    sim = oks_matrix(kpts_xy, areas, kpts_xy, areas, sigmas=sigmas,
                     b_conf=conf, vis_thre=in_vis_thre)
    return greedy_nms_from_matrix(sim, scores, thresh, valid)


def oks_nms_np(kpts_list, thresh, sigmas=None, in_vis_thre=None):
    """The lineage's oks_nms: ``kpts_list`` of dicts with 'keypoints'
    (K, 3), 'score' and 'area' -> kept indices, by descending score."""
    if len(kpts_list) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_list])
    kpts = np.array([np.asarray(k["keypoints"]).reshape(-1)
                     for k in kpts_list])
    areas = np.array([k["area"] for k in kpts_list])
    order = scores.argsort(kind="stable")[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = oks_iou_np(kpts[i], kpts[order[1:]], areas[i],
                          areas[order[1:]], sigmas, in_vis_thre)
        order = order[1:][ious <= thresh]
    return keep


def nms_boxes_np(dets, thresh):
    """Greedy IoU NMS, numpy: dets (N, 5) [x1, y1, x2, y2, score] -> kept
    indices."""
    if len(dets) == 0:
        return []
    x1, y1, x2, y2, scores = [dets[:, i] for i in range(5)]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort(kind="stable")[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


def soft_oks_nms_np(kpts_list, thresh, max_dets=20, sigmas=None,
                    in_vis_thre=None):
    """Soft OKS-NMS, the lineage's gaussian rescoring: -> (kept indices,
    None)."""
    if len(kpts_list) == 0:
        return [], []
    scores = np.array([k["score"] for k in kpts_list], dtype=np.float64)
    kpts = np.array([np.asarray(k["keypoints"]).reshape(-1)
                     for k in kpts_list])
    areas = np.array([k["area"] for k in kpts_list])
    order = scores.argsort(kind="stable")[::-1]
    scores = scores[order]
    keep = np.zeros(max_dets, dtype=np.intp)
    keep_cnt = 0
    while order.size > 0 and keep_cnt < max_dets:
        i = order[0]
        ious = oks_iou_np(kpts[i], kpts[order[1:]], areas[i],
                          areas[order[1:]], sigmas, in_vis_thre)
        order = order[1:]
        sc = scores[1:] * np.exp(-(ious ** 2) / thresh)
        keep[keep_cnt] = i
        keep_cnt += 1
        resort = sc.argsort(kind="stable")[::-1]
        order = order[resort]
        scores = sc[resort]
    return list(keep[:keep_cnt]), None
