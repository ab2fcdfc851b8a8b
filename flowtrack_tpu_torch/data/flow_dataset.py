"""Optical-flow pair datasets for FlowNet training.

Port of ``flowtrack_tpu/data/flow_dataset.py`` (:35-166): image pairs and
their .flo ground truth in the FlyingChairs layout (``<id>_img1.<ext>``,
``<id>_img2.<ext>``, ``<id>_flow.flo`` in one directory) or the Sintel one
(ordered frames, one .flo a consecutive pair), read on the host. In
training: a random crop to ``crop_size`` (a multiple of 64 for the FlowNet
encoders), a horizontal flip that negates u and a vertical one that
negates v, drawn from the generator ``flow_batches`` passes. The pair's
normalisation (``models/flownet.preprocess_pair``) runs on the device in
the train step.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.eval.flow_eval import read_flo
from flowtrack_tpu_torch.utils.video import IMG_EXTS


def _discover_triplets(root: str) -> List[Tuple[str, str, str]]:
    img1 = {}
    for name in sorted(os.listdir(root)):
        m = re.match(r"(.+)_img1(\.[A-Za-z]+)$", name)
        if m and name.lower().endswith(IMG_EXTS):
            img1[m.group(1)] = name
    triplets = []
    for key, name1 in img1.items():
        name2 = name1.replace("_img1", "_img2")
        flo = f"{key}_flow.flo"
        if (os.path.exists(os.path.join(root, name2))
                and os.path.exists(os.path.join(root, flo))):
            triplets.append((os.path.join(root, name1),
                             os.path.join(root, name2),
                             os.path.join(root, flo)))
    return triplets


def _discover_sequence(frames_dir: str,
                       flow_dir: str) -> List[Tuple[str, str, str]]:
    frames = sorted(f for f in os.listdir(frames_dir)
                    if f.lower().endswith(IMG_EXTS))
    flos = sorted(f for f in os.listdir(flow_dir) if f.endswith(".flo"))
    if len(flos) != len(frames) - 1:
        raise ValueError(
            f"{len(flos)} .flo files for {len(frames)} frames "
            f"(want n_frames - 1)")
    return [(os.path.join(frames_dir, frames[i]),
             os.path.join(frames_dir, frames[i + 1]),
             os.path.join(flow_dir, flos[i]))
            for i in range(len(flos))]


class FlowPairDataset:
    """(im1, im2, flow) samples: ``root`` for the triplet layout, or
    ``frames_dir`` and ``flow_dir`` for the sequence one."""

    def __init__(self, root: Optional[str] = None,
                 frames_dir: Optional[str] = None,
                 flow_dir: Optional[str] = None,
                 crop_size: Optional[Tuple[int, int]] = None,
                 is_train: bool = False,
                 flip_prob: float = 0.5,
                 vflip_prob: float = 0.1):
        if root is not None:
            self.samples = _discover_triplets(root)
        elif frames_dir is not None and flow_dir is not None:
            self.samples = _discover_sequence(frames_dir, flow_dir)
        else:
            raise ValueError("pass root= (triplets) or frames_dir+flow_dir")
        if not self.samples:
            raise ValueError("no flow samples found")
        self.crop_size = crop_size
        self.is_train = is_train
        self.flip_prob = flip_prob
        self.vflip_prob = vflip_prob

    def __len__(self):
        return len(self.samples)

    def load_raw(self, i: int):
        p1, p2, pf = self.samples[i]
        return (load_image(p1).astype(np.float32),
                load_image(p2).astype(np.float32), read_flo(pf))

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        im1, im2, flow = self.load_raw(i)
        if self.crop_size is not None:
            ch, cw = self.crop_size
            h, w = im1.shape[:2]
            if h < ch or w < cw:
                raise ValueError(f"crop {self.crop_size} > image {(h, w)}")
            if self.is_train and rng is not None:
                y0 = int(rng.integers(0, h - ch + 1))
                x0 = int(rng.integers(0, w - cw + 1))
            else:  # the centre crop for evaluation
                y0, x0 = (h - ch) // 2, (w - cw) // 2
            im1 = im1[y0:y0 + ch, x0:x0 + cw]
            im2 = im2[y0:y0 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        if self.is_train and rng is not None:
            if rng.random() < self.flip_prob:      # horizontal
                im1 = im1[:, ::-1]
                im2 = im2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            if rng.random() < self.vflip_prob:     # vertical
                im1 = im1[::-1]
                im2 = im2[::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)
        return (np.ascontiguousarray(im1), np.ascontiguousarray(im2),
                np.ascontiguousarray(flow, np.float32))


def flow_batches(dataset: FlowPairDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
    """Batches {"im1", "im2", "flow", "n_real"} of numpy arrays, all of one
    shape. Without ``drop_last`` a short last batch is filled by repeating
    samples in order (cyclically, should it need more than the corpus);
    ``n_real`` counts the real ones."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    n = len(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        n_real = len(idx)
        if n_real < batch_size:
            if drop_last:
                return
            idx = np.concatenate(
                [idx, np.resize(order, batch_size - n_real)])
        im1s, im2s, flows = zip(*(dataset.__getitem__(int(i), rng=rng)
                                  for i in idx))
        yield {"im1": np.stack(im1s), "im2": np.stack(im2s),
               "flow": np.stack(flows), "n_real": n_real}
