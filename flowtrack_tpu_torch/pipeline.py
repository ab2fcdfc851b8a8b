"""Inference pipelines of one frame: PosePredictor and FlowPredictor.

Port of ``flowtrack_tpu/pipeline.py``: ``batched_box_to_center_scale``
(pipeline.py:36), numpy on the host as in the reference, ``PosePredictor``
(:50) and ``FlowPredictor`` (:125). The frame goes to the device once;
crops (kernel K1 on the card), the pose net with the flip batch, the flip
merge, decode and rescore, or the resize, the flow net (with kernel K2 for
FlowNetC) and the flow's way back to the frame's size all run there. Only
boxes go in and keypoints come out.

Both take a model (the port's PoseResNet or flow net, for example loaded by
``utils/convert.load_pose_resnet`` / ``load_flownet``) and a device: 'cuda'
by default, which raises without a CUDA device; 'cpu' runs the plain
versions. The reference pads the persons of a frame to a ``max_persons``
multiple so that XLA compiles once per bucket; eager PyTorch compiles
nothing, so the port poses the real boxes, with the same results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flowtrack_tpu_torch.config import (
    COCO_FLIP_PAIRS,
    IMAGENET_MEAN,
    IMAGENET_STD,
    PIXEL_STD,
    Config,
)
from flowtrack_tpu_torch.models.flownet import (
    postprocess_flow,
    preprocess_pair,
    resize_bilinear,
)
from flowtrack_tpu_torch.ops.crop import crop_resize_normalize
from flowtrack_tpu_torch.ops.decode import get_final_preds, rescore
from flowtrack_tpu_torch.ops.heatmap import merge_flip_test


def batched_box_to_center_scale(boxes_xywh: np.ndarray, aspect_ratio: float,
                                scale_padding: float = 1.25):
    """(P, 4) xywh -> centers (P, 2), scales (P, 2), float64: the box grown
    to the crop's aspect ratio, in PIXEL_STD units, padded by 1.25."""
    boxes = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)
    x, y, w, h = boxes.T.copy()
    centers = np.stack([x + w * 0.5, y + h * 0.5], axis=1)
    wide = w > aspect_ratio * h
    h = np.where(wide, w / aspect_ratio, h)
    w = np.where(~wide & (w < aspect_ratio * h), h * aspect_ratio, w)
    scales = np.stack([w, h], axis=1) / PIXEL_STD * scale_padding
    return centers, scales


def model_device(device) -> torch.device:
    """``device`` as a torch.device; 'cuda' without a CUDA device raises
    (the plain versions run only when the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is needed; pass device='cpu' to "
                           "run the plain versions")
    return device


def flip_test_heatmaps(model, crops, flip_test: bool, shift: bool,
                       flip_pairs=COCO_FLIP_PAIRS):
    """(M, h, w, 3) crops -> heatmaps (M, h/4, w/4, K): with ``flip_test``
    one call on the crops and their mirror images, merged."""
    x = crops.permute(0, 3, 1, 2)
    if not flip_test:
        return model(x).permute(0, 2, 3, 1)
    m = x.shape[0]
    hm = model(torch.cat([x, x.flip(3)])).permute(0, 2, 3, 1)
    return merge_flip_test(hm[:m], hm[m:], flip_pairs, shift=shift)


class PosePredictor:
    """image + person boxes -> keypoints, confidences, rescored scores."""

    def __init__(self, cfg: Config, model, device="cuda"):
        self.cfg = cfg
        self.device = model_device(device)
        self.model = model.to(self.device).eval()
        img_h, img_w = cfg.model.image_size
        self.out_hw = (img_h, img_w)
        self.aspect_ratio = img_w / img_h

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, boxes_xywh: np.ndarray,
                 scores: np.ndarray):
        """image: (H, W, 3) RGB; boxes: (P, 4) xywh; scores: (P,).
        Returns (joints (P, K, 2), maxvals (P, K), rescored (P,)) numpy."""
        p = len(boxes_xywh)
        if p == 0:
            k = self.cfg.model.num_joints
            return (np.zeros((0, k, 2), np.float32),
                    np.zeros((0, k), np.float32), np.zeros((0,), np.float32))
        dev, tcfg = self.device, self.cfg.test
        c, s = batched_box_to_center_scale(boxes_xywh, self.aspect_ratio)
        centers = torch.as_tensor(c, dtype=torch.float32, device=dev)
        scales = torch.as_tensor(s, dtype=torch.float32, device=dev)
        image = torch.as_tensor(np.ascontiguousarray(image), device=dev)
        crops = crop_resize_normalize(image, centers, scales, self.out_hw,
                                      IMAGENET_MEAN, IMAGENET_STD)
        hm = flip_test_heatmaps(self.model, crops, tcfg.flip_test,
                                tcfg.shift_heatmap)
        preds, maxvals = get_final_preds(hm, centers, scales,
                                         post_process=tcfg.post_process,
                                         blur_kernel=tcfg.blur_kernel)
        rescored = rescore(torch.as_tensor(np.asarray(scores, np.float32),
                                           device=dev),
                           maxvals, tcfg.in_vis_thre)
        return preds.cpu().numpy(), maxvals.cpu().numpy(), \
            rescored.cpu().numpy()


def _round_up(v, m):
    return -(-v // m) * m


class FlowPredictor:
    """frame pair -> full-resolution flow (H, W, 2) in source pixels, a
    tensor on the device.

    The frames are resized to a /64 grid for the net (FlowNet's need) with
    jax's bilinear weights (``resize_bilinear``), and the flow comes back to
    (H, W) with its components rescaled."""

    def __init__(self, cfg: Config, model, device="cuda",
                 target_hw: Optional[Tuple[int, int]] = None):
        self.cfg = cfg
        self.device = model_device(device)
        self.model = model.to(self.device).eval()
        self.target_hw = target_hw

    @torch.inference_mode()
    def __call__(self, prev_image, image):
        fcfg = self.cfg.flow
        h, w = image.shape[:2]
        net_hw = self.target_hw or (_round_up(h, 64), _round_up(w, 64))
        pair = torch.stack([torch.as_tensor(np.asarray(im), device=self.device)
                            for im in (prev_image, image)]).float()
        pair = resize_bilinear(pair, net_hw)
        x = preprocess_pair(pair[:1], pair[1:], fcfg.rgb_max)
        flow_q = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return postprocess_flow(flow_q, fcfg.variant, (h, w),
                                fcfg.div_flow)[0]
