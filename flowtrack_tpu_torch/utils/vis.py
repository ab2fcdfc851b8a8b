"""Visualization: skeleton drawing, heatmap grids, the flow color wheel.

Port of ``flowtrack_tpu/utils/vis.py``, copied as code: ``draw_skeleton``
(:26), ``heatmaps_to_grid`` (:52), ``save_debug_images`` (:66),
``flow_to_color`` (:128, the Middlebury color wheel) and ``save_image``
(:148). Host-side numpy; cv2 draws lines and discs when it imports, and
without it joints are drawn as 3x3 squares and no lines; ``save_image``
writes through cv2 or, without it, PIL.
"""

from __future__ import annotations

import numpy as np

# COCO skeleton (pairs of joint indices)
COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]


def _color(i):
    return tuple(int(c) for c in (
        (i * 67) % 256, (i * 151) % 256, 255 - (i * 101) % 256))


def draw_skeleton(img, joints, maxvals=None, thresh=0.2, track_id=0):
    """Draw one pose in place. img: (H, W, 3) uint8; joints: (K, 2)."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        cv2 = None
    color = _color(track_id)
    vis = (maxvals > thresh) if maxvals is not None else \
        np.ones(len(joints), bool)
    for a, b in COCO_SKELETON:
        if a < len(joints) and b < len(joints) and vis[a] and vis[b]:
            pa = tuple(int(round(v)) for v in joints[a])
            pb = tuple(int(round(v)) for v in joints[b])
            if cv2 is not None:
                cv2.line(img, pa, pb, color, 2)
    for j, (x, y) in enumerate(joints):
        if not vis[j]:
            continue
        xi, yi = int(round(x)), int(round(y))
        if cv2 is not None:
            cv2.circle(img, (xi, yi), 3, color, -1)
        elif 0 <= yi < img.shape[0] and 0 <= xi < img.shape[1]:
            img[max(0, yi - 1): yi + 2, max(0, xi - 1): xi + 2] = color
    return img


def heatmaps_to_grid(heatmaps, cols=5):
    """(H, W, K) heatmaps -> one (rows*H, cols*W) grayscale grid image."""
    h, w, k = heatmaps.shape
    rows = -(-k // cols)
    grid = np.zeros((rows * h, cols * w), np.float32)
    for i in range(k):
        r, c = divmod(i, cols)
        hm = heatmaps[:, :, i]
        rng = hm.max() - hm.min()
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = \
            (hm - hm.min()) / (rng if rng > 0 else 1.0)
    return (grid * 255).astype(np.uint8)


def save_debug_images(crops, heatmaps, out_dir, prefix="val", mean=None,
                      std=None, limit=8):
    """Reference validate-loop debug dump (lineage core/function.py
    ``save_debug_images``): for up to ``limit`` samples, write the
    de-normalized input crop with the heatmap-argmax pose drawn on it and
    the per-joint heatmap grid.

    crops: (N, H, W, 3) normalized floats ((x/255 - mean)/std);
    heatmaps: (N, h, w, K)."""
    import os

    from flowtrack_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

    os.makedirs(out_dir, exist_ok=True)
    mean = np.asarray(IMAGENET_MEAN if mean is None else mean, np.float32)
    std = np.asarray(IMAGENET_STD if std is None else std, np.float32)
    crops = np.asarray(crops, np.float32)
    heatmaps = np.asarray(heatmaps, np.float32)
    stride = crops.shape[1] / heatmaps.shape[1]
    for i in range(min(len(crops), limit)):
        img = np.clip((crops[i] * std + mean) * 255.0, 0,
                      255).astype(np.uint8).copy()
        hm = heatmaps[i]
        k = hm.shape[-1]
        flat = hm.reshape(-1, k)
        ys, xs = np.unravel_index(flat.argmax(axis=0), hm.shape[:2])
        joints = np.stack([xs, ys], axis=1).astype(np.float32) * stride
        draw_skeleton(img, joints, flat.max(axis=0), thresh=0.2,
                      track_id=i)
        save_image(os.path.join(out_dir, f"{prefix}_{i}_pred.png"), img)
        save_image(os.path.join(out_dir, f"{prefix}_{i}_hm.png"),
                   heatmaps_to_grid(hm))


def _make_color_wheel():
    """Middlebury flow color wheel (55 colors)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_color(flow, max_flow=None):
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury color rendering."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-6)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    ncols = len(_WHEEL)
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    # saturate by magnitude; an explicit max_flow below the true magnitude
    # drives col negative, which would wrap under the uint8 cast — clip
    col = np.clip(1 - rad[..., None] * (1 - col), 0.0, 1.0)
    return (col * 255).astype(np.uint8)


def save_image(path, img):
    try:
        import cv2

        cv2.imwrite(path, img[:, :, ::-1] if img.ndim == 3 else img)
    except ImportError:  # pragma: no cover
        from PIL import Image

        Image.fromarray(img).save(path)
