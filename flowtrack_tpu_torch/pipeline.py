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
versions. As in the reference, each is one device program per static
shape, the counterpart of its ``jax.jit``: ``PosePredictor`` pads a
frame's persons to a multiple of ``max_persons`` (the last box repeated,
score 0; the padded rows sliced off) and runs one program per (frame
shape, bucket), ``FlowPredictor`` one per (frame shape, net size). On the
card each program is a CUDA graph (``utils/graphs.py``), captured at its
first shape and replayed after; on the CPU it runs eagerly, on the same
padded batch. Padding changes results on the card, whose convolutions are
not batch-invariant: graph and eager run the same batch, and agree bit for
bit.
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
from flowtrack_tpu_torch.utils.graphs import GraphCache, net_state


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

    def __init__(self, cfg: Config, model, device="cuda",
                 max_persons: Optional[int] = None):
        self.cfg = cfg
        self.device = model_device(device)
        self.model = model.to(self.device).eval()
        self.max_persons = max_persons or cfg.track.max_persons
        img_h, img_w = cfg.model.image_size
        self.out_hw = (img_h, img_w)
        self.aspect_ratio = img_w / img_h
        # the program's graphs by (frame shape and dtype, bucket)
        self.graphs = GraphCache()

    def _program(self, image, centers, scales, scores):
        """The device program: crops, the pose net (flip-merged), decode,
        rescore -> (joints, maxvals, rescored) of every padded row."""
        tcfg = self.cfg.test
        crops = crop_resize_normalize(image, centers, scales, self.out_hw,
                                      IMAGENET_MEAN, IMAGENET_STD)
        hm = flip_test_heatmaps(self.model, crops, tcfg.flip_test,
                                tcfg.shift_heatmap)
        preds, maxvals = get_final_preds(hm, centers, scales,
                                         post_process=tcfg.post_process,
                                         blur_kernel=tcfg.blur_kernel)
        return preds, maxvals, rescore(scores, maxvals, tcfg.in_vis_thre)

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
        dev = self.device
        centers, scales = batched_box_to_center_scale(boxes_xywh,
                                                      self.aspect_ratio)
        # pad to the static person budget (repeat last, masked out after)
        pad = _round_up(p, self.max_persons) - p
        centers = np.concatenate([centers, np.repeat(centers[-1:], pad, 0)])
        scales = np.concatenate([scales, np.repeat(scales[-1:], pad, 0)])
        sc = np.concatenate([np.asarray(scores, np.float64), np.zeros(pad)])
        image = torch.as_tensor(np.ascontiguousarray(image), device=dev)
        args = [image] + [torch.as_tensor(a, dtype=torch.float32, device=dev)
                          for a in (centers, scales, sc)]
        out = self.graphs.run((image.shape, image.dtype, p + pad),
                              self._program, args,
                              lambda: net_state(self.model))
        return tuple(t[:p].cpu().numpy() for t in out)


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
        # the program's graphs by (frame shape and dtype, net size)
        self.graphs = GraphCache()

    def _program(self, prev_image, image, net_hw):
        fcfg = self.cfg.flow
        pair = torch.stack([prev_image, image]).float()
        pair = resize_bilinear(pair, net_hw)
        x = preprocess_pair(pair[:1], pair[1:], fcfg.rgb_max)
        flow_q = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h, w = image.shape[:2]
        return postprocess_flow(flow_q, fcfg.variant, (h, w),
                                fcfg.div_flow)[0]

    @torch.inference_mode()
    def __call__(self, prev_image, image):
        h, w = image.shape[:2]
        net_hw = self.target_hw or (_round_up(h, 64), _round_up(w, 64))
        args = [torch.as_tensor(np.asarray(im), device=self.device)
                for im in (prev_image, image)]
        return self.graphs.run(
            (args[1].shape, args[1].dtype, net_hw),
            lambda a, b: self._program(a, b, net_hw), args,
            lambda: net_state(self.model))
