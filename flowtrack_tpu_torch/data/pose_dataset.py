"""Top-down pose dataset: image loading, the crop and the train
augmentation.

Port of ``flowtrack_tpu/data/pose_dataset.py``: ``load_image`` (:42),
``warp_image`` (:57) and ``PoseDataset`` (:74-168), the port's own copy.

An item is one person: its image cropped by the affine of (center, scale)
and a rotation (cv2.warpAffine, or ``ops/affine.warp_affine`` where cv2 is
missing), normalised by the ImageNet mean and std, its Gaussian target
heatmaps (``ops/heatmap.generate_target_np``) and their weights, and the
meta. In training each item draws from its own generator
``np.random.default_rng((seed, epoch, idx))``, as the reference does, so
that the augmentations are the reference's bit for bit whatever the
worker order: scale x clip(N(0,1) * sf + 1, 1 - sf, 1 + sf), rotation
clip(N(0,1) * rf, -2 rf, 2 rf) with probability 0.6, then a horizontal flip
with probability ``flip_prob``. cv2 and PIL are imported when an image is
read, not when the module is.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from flowtrack_tpu_torch.config import Config, IMAGENET_MEAN, IMAGENET_STD
from flowtrack_tpu_torch.ops.affine import (
    affine_transform,
    fliplr_joints,
    get_affine_transform,
    warp_affine,
)
from flowtrack_tpu_torch.ops.heatmap import generate_target_np


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3). cv2 if available, PIL otherwise."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def warp_image(img: np.ndarray, trans: np.ndarray, out_wh) -> np.ndarray:
    """cv2.warpAffine (bilinear, border 0) of ``img`` by the forward
    ``trans`` to an ``out_wh`` = (w, h) crop; ``warp_affine`` on the CPU
    where cv2 is missing (float32 out)."""
    try:
        import cv2
    except ImportError:
        out = warp_affine(torch.from_numpy(np.ascontiguousarray(img,
                                                                np.float32)),
                          trans, (int(out_wh[1]), int(out_wh[0])))
        return out.numpy()
    return cv2.warpAffine(img, trans[:2].astype(np.float64),
                          (int(out_wh[0]), int(out_wh[1])),
                          flags=cv2.INTER_LINEAR)


class PoseDataset:
    """Base class: subclasses fill ``db`` (one dict a person) and set
    ``num_joints`` and ``flip_pairs``."""

    num_joints: int = 17
    flip_pairs = ()

    def __init__(self, cfg: Config, root: str, image_set: str,
                 is_train: bool, seed: Optional[int] = None):
        self.cfg = cfg
        self.root = root
        self.image_set = image_set
        self.is_train = is_train
        self.image_size = np.array(
            [cfg.model.image_size[1], cfg.model.image_size[0]])  # (w, h)
        self.heatmap_size = np.array(
            [cfg.model.heatmap_size[1], cfg.model.heatmap_size[0]])
        self.sigma = cfg.model.sigma
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.mean = np.array(IMAGENET_MEAN, np.float32)
        self.std = np.array(IMAGENET_STD, np.float32)
        self._seed = seed if seed is not None else cfg.train.seed
        self._epoch = 0
        self.db: List[dict] = []

    def set_epoch(self, epoch: int):
        """Move to another epoch's augmentations (BatchLoader calls it)."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.db)

    def _augment(self, rng, center, scale):
        sf = self.cfg.train.scale_factor
        rf = self.cfg.train.rot_factor
        scale = scale * np.clip(rng.normal() * sf + 1, 1 - sf, 1 + sf)
        rot = (np.clip(rng.normal() * rf, -rf * 2, rf * 2)
               if rng.random() <= 0.6 else 0.0)
        return scale, rot

    def __getitem__(self, idx: int):
        rec = self.db[idx]
        img = load_image(os.path.join(self.root, rec["image"]))
        joints = np.array(rec["joints"], np.float64).reshape(-1, 2).copy()
        joints_vis = np.array(rec["joints_vis"], np.float64).reshape(-1).copy()
        c = np.array(rec["center"], np.float64).copy()
        s = np.array(rec["scale"], np.float64).copy()
        score = rec.get("score", 1.0)
        r = 0.0

        if self.is_train:
            # a generator of the item's own: reproducible and thread-safe
            # whatever the order the loader's workers take the items in
            rng = np.random.default_rng((self._seed, self._epoch, idx))
            s, r = self._augment(rng, c, s)
            if rng.random() <= self.cfg.train.flip_prob:
                img = img[:, ::-1, :]
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, img.shape[1], self.flip_pairs)
                c[0] = img.shape[1] - c[0] - 1

        trans = get_affine_transform(c, s, r, self.image_size)
        inp = warp_image(img, trans, self.image_size).astype(np.float32)
        inp = (inp / 255.0 - self.mean) / self.std

        for j in range(self.num_joints):
            if joints_vis[j] > 0:
                joints[j] = affine_transform(joints[j], trans)

        target, target_weight = generate_target_np(
            joints, joints_vis,
            (int(self.heatmap_size[1]), int(self.heatmap_size[0])),
            (int(self.image_size[1]), int(self.image_size[0])),
            self.sigma)

        return {
            "input": inp,
            "target": target,
            "target_weight": target_weight.astype(np.float32),
            "image_id": rec.get("image_id", idx),
            "center": c.astype(np.float32),
            "scale": s.astype(np.float32),
            "rotation": np.float32(r),
            "score": np.float32(score),
            "joints": joints.astype(np.float32),
            "joints_vis": joints_vis.astype(np.float32),
        }
