"""The benchmark's video traffic, made from a seed: a pool of short videos
of people walking, with their detector boxes.

Each video has a static background and ``persons`` people, each a
textured patch that moves at a constant velocity (after
``chip_smoke.video_detections``: boxes of constant size moving by a fixed
step a frame). Background and textures are smooth random fields (random
values on a coarse grid, enlarged bilinearly), so a person's crop changes
little from frame to frame, as in a real video, and the flow and pose
nets see structure rather than pixel noise. A detection is the person's
true box with the person's constant score; ``miss_rate`` of them are
dropped at random (detector misses, which the tracker's recovery fills),
and each frame's detections come in a random order.

Every number comes from the traffic file's parameters and the seed; the
same seed gives the same pool, bit for bit. ``videos`` (the pool's size)
and ``texture_cell`` (the fields' grid in pixels) take ``DEFAULTS`` where
the file leaves them out. The frames are drawn on the
device in a few large calls and kept on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

DEFAULTS = {"videos": 8, "texture_cell": 16}


@dataclass
class Video:
    frames: np.ndarray      # (N, H, W, 3) uint8
    boxes: list             # per frame: (D, 4) float32 xywh
    scores: list            # per frame: (D,) float32


def _smooth(gen, shape_hw, cell: int, device, channels: int = 3):
    """A smooth random field (channels, h, w) in [0, 255]: uniform values
    every ``cell`` pixels, enlarged bilinearly."""
    h, w = shape_hw
    coarse = torch.rand((1, channels, max(2, -(-h // cell) + 1),
                         max(2, -(-w // cell) + 1)), generator=gen,
                        device=device) * 255.0
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0]


def make_videos(params: dict, seed: int, device) -> list:
    """The pool of ``params["videos"]`` videos of ``params["video_frames"]``
    frames each (see the module docstring for the parameters)."""
    params = {**DEFAULTS, **params}
    h, w = params["frame_hw"]
    n_frames = params["video_frames"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 2]).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1))
    cell = params["texture_cell"]
    pool = []
    for _ in range(params["videos"]):
        lo, hi = params["persons"]
        p = int(rng.integers(lo, hi + 1))
        bw = rng.uniform(*params["box_width"], p)
        bh = np.minimum(bw * rng.uniform(*params["box_aspect"], p), h - 1)
        speed = params["speed"]
        vel = rng.uniform(-speed, speed, (p, 2))
        # start so that the whole walk stays inside the frame
        span = vel * (n_frames - 1)
        x0 = rng.uniform(np.maximum(0, -span[:, 0]),
                         np.maximum(1, w - bw - np.maximum(0, span[:, 0])))
        y0 = rng.uniform(np.maximum(0, -span[:, 1]),
                         np.maximum(1, h - bh - np.maximum(0, span[:, 1])))
        score = rng.uniform(*params["score"], p).astype(np.float32)
        t = np.arange(n_frames)[:, None]
        xs, ys = x0 + vel[:, 0] * t, y0 + vel[:, 1] * t
        seen = rng.random((n_frames, p)) >= params["miss_rate"]
        background = _smooth(gen, (h, w), cell, device)
        patches = [_smooth(gen, (int(round(bh[j])), int(round(bw[j]))),
                           cell, device) for j in range(p)]
        frames = torch.empty((n_frames, h, w, 3), dtype=torch.uint8,
                             device=device)
        boxes, scores = [], []
        for f in range(n_frames):
            img = background.clone()
            for j in range(p):
                x, y = int(round(xs[f, j])), int(round(ys[f, j]))
                ph, pw = patches[j].shape[1:]
                x1, y1 = min(w, x + pw), min(h, y + ph)
                if x1 > x >= 0 and y1 > y >= 0:
                    img[:, y:y1, x:x1] = patches[j][:, :y1 - y, :x1 - x]
            frames[f] = img.round().clamp(0, 255).to(torch.uint8).permute(
                1, 2, 0)
            order = rng.permutation(p)
            order = order[seen[f, order]]
            boxes.append(np.stack([xs[f, order], ys[f, order], bw[order],
                                   bh[order]], -1).astype(np.float32))
            scores.append(score[order])
        pool.append(Video(frames.cpu().numpy(), boxes, scores))
    return pool


def padded(video: Video, max_persons: int):
    """A video's detections padded to ``max_persons`` slots, as the tracker
    pads them (the highest scores kept): boxes (N, P, 4) xywh, scores and
    valid (N, P)."""
    n = len(video.boxes)
    boxes = np.zeros((n, max_persons, 4), np.float32)
    scores = np.zeros((n, max_persons), np.float32)
    valid = np.zeros((n, max_persons), bool)
    for f, (b, s) in enumerate(zip(video.boxes, video.scores)):
        if len(b) > max_persons:
            keep = np.argsort(-s)[:max_persons]
            b, s = b[keep], s[keep]
        boxes[f, :len(b)], scores[f, :len(b)], valid[f, :len(b)] = b, s, True
    return boxes, scores, valid
