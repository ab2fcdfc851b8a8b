"""Plain operations of the benchmark's reference: the antialiased resize,
the person crop, the flip test, the heatmap decode and rescore, OKS, IoU
and greedy matching, joint propagation.

Each is written from the lineage's definition (Simple Baselines' test
transforms and ``get_final_preds``, COCO's OKS) in plain float32 PyTorch,
or float64 numpy where the lineage computes on the host. Nothing here
imports the program or JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_STD = 200.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16))
COCO_SIGMAS = (0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
               0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089)
SPACING = float(np.spacing(1))


# ---- resize ----------------------------------------------------------------

def shrink_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) antialiased bilinear weights of a shrinking resize
    along one axis (half-pixel centres, the triangle widened by the
    ratio, each output normalised to sum 1)."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    taps = torch.arange(n_in, dtype=torch.float32, device=device)
    wts = (1.0 - (sample[None] - taps[:, None]).abs() / max(inv, 1.0)).clamp(
        min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None], wts, 0.0)


def resize(x, out_hw):
    """(N, H, W, C) float -> (N, oh, ow, C): bilinear with half-pixel
    centres; an axis that shrinks is antialiased."""
    h, w = x.shape[1:3]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    if oh >= h and ow >= w:
        return F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow),
                             mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)
    y = x
    if oh != h:
        y = torch.einsum("nhwc,hk->nkwc", y, shrink_weights(h, oh, x.device))
    if ow != w:
        y = torch.einsum("nhwc,wk->nhkc", y, shrink_weights(w, ow, x.device))
    return y


# ---- person crops --------------------------------------------------------

def center_scale(boxes_xywh, aspect_ratio: float, padding: float = 1.25):
    """(..., 4) xywh float64 numpy -> centers, scales (..., 2) float32: the
    box grown to the crop's aspect ratio, in units of 200 px, times 1.25."""
    b = np.asarray(boxes_xywh, np.float64)
    x, y = b[..., 0], b[..., 1]
    w, h = np.maximum(b[..., 2], 1e-3), np.maximum(b[..., 3], 1e-3)
    centers = np.stack([x + w * 0.5, y + h * 0.5], -1)
    wide = w > aspect_ratio * h
    h = np.where(wide, w / aspect_ratio, h)
    w = np.where(~wide & (w < aspect_ratio * h), h * aspect_ratio, w)
    scales = np.stack([w, h], -1) / PIXEL_STD * padding
    return centers.astype(np.float32), scales.astype(np.float32)


def center_scale_xyxy(boxes, aspect_ratio: float, padding: float = 1.25):
    """Tensor (..., 4) xyxy -> centers, scales (..., 2), as the clip
    program turns its recovered boxes into crops."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-3)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-3)
    centers = torch.stack([boxes[..., 0] + w * 0.5, boxes[..., 1] + h * 0.5],
                          -1)
    wide = w > aspect_ratio * h
    h = torch.where(wide, w / aspect_ratio, h)
    w = torch.where(~wide & (w < aspect_ratio * h), h * aspect_ratio, w)
    return centers, torch.stack([w, h], -1) / PIXEL_STD * padding


def crop(frames, frame_idx, centers, scales, out_hw):
    """frames (N, H, W, 3) uint8, a frame index, center and scale per
    person -> normalised float32 crops (P, 3, oh, ow): bilinear taps, zero
    outside the frame, then ``(x / 255 - mean) / std``."""
    oh, ow = out_hw
    n, h, w, _ = frames.shape
    s = scales[:, 0] * PIXEL_STD / ow
    tx = centers[:, 0] - s * (ow * 0.5)
    ty = centers[:, 1] - s * (oh * 0.5)
    dev = frames.device
    sy = s[:, None] * torch.arange(oh, device=dev) + ty[:, None]
    sx = s[:, None] * torch.arange(ow, device=dev) + tx[:, None]
    y0, x0 = sy.floor(), sx.floor()
    wy, wx = sy - y0, sx - x0
    y0, x0 = y0.long(), x0.long()
    out = 0.0
    img = frames.float()
    fi = frame_idx.long()[:, None, None]
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        yy = y0 + dy
        oky = (yy >= 0) & (yy < h)
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            xx = x0 + dx
            okx = (xx >= 0) & (xx < w)
            v = img[fi, yy.clamp(0, h - 1)[:, :, None],
                    xx.clamp(0, w - 1)[:, None, :]]
            wgt = (wgt_y * oky)[:, :, None] * (wgt_x * okx)[:, None, :]
            out = out + v * wgt[..., None]
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return ((out / 255.0 - mean) / std).permute(0, 3, 1, 2)


# ---- heatmaps --------------------------------------------------------------

def flip_heatmaps(net, crops, flip_pairs=COCO_FLIP_PAIRS):
    """Heatmaps (P, K, h, w) of the crops averaged with those of their
    mirror images, flipped back (pairs swapped) and shifted one pixel
    right."""
    p = crops.shape[0]
    hm = net(torch.cat([crops, crops.flip(3)]))
    direct, flipped = hm[:p], hm[p:].flip(3)
    order = list(range(hm.shape[1]))
    for a, b in flip_pairs:
        order[a], order[b] = b, a
    flipped = flipped[:, order]
    flipped = torch.cat([flipped[..., :1], flipped[..., :-1]], -1)
    return (direct + flipped) * 0.5


def decode(hm, centers, scales):
    """Heatmaps (P, K, h, w) -> image joints (P, K, 2), maxvals (P, K):
    argmax (first on ties), a quarter pixel toward the larger neighbour
    strictly inside the border, back through the crop's map."""
    p, k, h, w = hm.shape
    flat = hm.reshape(p, k, h * w)
    maxvals, idx = flat.amax(-1), flat.argmax(-1)
    px, py = idx % w, idx // w
    pi = torch.arange(p, device=hm.device)[:, None]
    ki = torch.arange(k, device=hm.device)[None]

    def at(y, x):
        return hm[pi, ki, y.clamp(0, h - 1), x.clamp(0, w - 1)]

    dx = torch.sign(at(py, px + 1) - at(py, px - 1))
    dy = torch.sign(at(py + 1, px) - at(py - 1, px))
    inside = ((px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)).float()
    pos = maxvals > 0
    x = (px.float() + 0.25 * dx * inside) * pos
    y = (py.float() + 0.25 * dy * inside) * pos
    s = scales[:, 0] * PIXEL_STD / w
    tx = centers[:, 0] - s * w * 0.5
    ty = centers[:, 1] - s * h * 0.5
    joints = torch.stack([s[:, None] * x + tx[:, None],
                          s[:, None] * y + ty[:, None]], -1)
    return joints, maxvals


def heatmap_cell(joints, centers, scales, hm_hw):
    """Image joints (P, K, 2) -> the heatmap cell (P, K, 2) of x, y that
    ``decode`` took them from: the map undone, the quarter-pixel step
    rounded away."""
    h, w = hm_hw
    s = scales[:, 0] * PIXEL_STD / w
    tx = centers[:, 0] - s * w * 0.5
    ty = centers[:, 1] - s * h * 0.5
    x = (joints[..., 0] - tx[:, None]) / s[:, None]
    y = (joints[..., 1] - ty[:, None]) / s[:, None]
    return torch.stack([x.round().clamp(0, w - 1),
                        y.round().clamp(0, h - 1)], -1).long()


def rescore(box_scores, maxvals, in_vis_thre: float):
    vis = (maxvals > in_vis_thre).float()
    cnt = vis.sum(-1)
    mean = (maxvals * vis).sum(-1) / cnt.clamp(min=1.0)
    return box_scores * torch.where(cnt > 0, mean, torch.zeros_like(mean))


# ---- tracking primitives --------------------------------------------------

def sample_flow(flow, pts):
    """flow (..., H, W, 2) at points (..., S, 2): bilinear, clamped to the
    image -> (..., S, 2)."""
    h, w = flow.shape[-3:-1]
    sx = pts[..., 0].clamp(0, w - 1)
    sy = pts[..., 1].clamp(0, h - 1)
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    lead = flow.shape[:-3]
    flat = flow.reshape(*lead, h * w, 2)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(*lead, -1, 1).expand(*lead, -1, 2)
        return flat.gather(-2, idx).reshape(*yi.shape, 2)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def propagate(joints, flow):
    return joints + sample_flow(flow, joints)


def pose_area(xy):
    wh = (xy.amax(-2) - xy.amin(-2)).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def oks(a, b, sigmas=COCO_SIGMAS):
    """OKS between poses a (..., M, K, 2) and b (..., N, K, 2) -> (..., M, N),
    each pair's scale the mean of their boxes' areas."""
    var = (torch.tensor(sigmas, device=a.device) * 2.0) ** 2
    d2 = ((a[..., :, None, :, :] - b[..., None, :, :, :]) ** 2).sum(-1)
    norm = (pose_area(a)[..., :, None] + pose_area(b)[..., None, :]) / 2.0 \
        + SPACING
    return torch.exp(-d2 / var / norm[..., None] / 2.0).mean(-1)


def boxes_from_poses(joints, expand: float):
    lo, hi = joints.amin(-2), joints.amax(-2)
    wh = (hi - lo).clamp(min=0.0)
    return torch.cat([lo - wh * expand, hi + wh * expand], -1)


def iou(a, b):
    """xyxy boxes (..., M, 4) x (..., N, 4) -> IoU (..., M, N), areas with
    the lineage's +1 pixel."""
    ax1, ay1, ax2, ay2 = a[..., :, None, :].unbind(-1)
    bx1, by1, bx2, by2 = b[..., None, :, :].unbind(-1)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1) * (ay2 - ay1 + 1)
    area_b = (bx2 - bx1 + 1) * (by2 - by1 + 1)
    return inter / (area_a + area_b - inter)


def greedy(sim, thr: float, row_valid, col_valid):
    """Greedy global-max assignment on one (M, N) numpy matrix -> (N,) row
    or -1: each round takes the first maximum (row-major), keeps it if
    above ``thr``, and strikes its row and column."""
    s = np.where(row_valid[:, None] & col_valid[None, :], sim, -np.inf)
    n = s.shape[1]
    assign = np.full(n, -1, np.int64)
    for _ in range(min(s.shape)):
        i = int(np.argmax(s))
        if not s.flat[i] > thr:
            break
        r, c = divmod(i, n)
        assign[c] = r
        s[r, :] = -np.inf
        s[:, c] = -np.inf
    return assign
