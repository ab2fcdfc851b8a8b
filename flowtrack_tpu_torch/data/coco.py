"""The COCO keypoint dataset.

Port of ``flowtrack_tpu/data/coco.py`` (:33-150), the part training needs:

* the train db: one record per person annotation with labelled keypoints
  and a clean box (clamped to the image, positive area), its center and
  scale from the box with the aspect kept and 1.25 padding
  (``ops/affine.box_to_center_scale``);
* the eval db: the detections json (``cfg.test.bbox_file``) above
  ``image_thre``, after box NMS at ``nms_thre`` when that is under 1
  (``ops/nms.nms_boxes_np``, the numpy twin of the reference's native
  NMS), or the ground-truth boxes with ``use_gt_bbox``.

``evaluate`` needs the COCO keypoint evaluator (``eval/coco_eval.py``),
which is not ported yet (ROADMAP item 23): it raises NotImplementedError.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from flowtrack_tpu_torch.config import COCO_FLIP_PAIRS, COCO_NUM_JOINTS, Config
from flowtrack_tpu_torch.data.coco_io import COCOIndex
from flowtrack_tpu_torch.data.pose_dataset import PoseDataset
from flowtrack_tpu_torch.ops.affine import box_to_center_scale
from flowtrack_tpu_torch.ops.nms import nms_boxes_np


class COCODataset(PoseDataset):
    num_joints = COCO_NUM_JOINTS
    flip_pairs = list(COCO_FLIP_PAIRS)

    def __init__(self, cfg: Config, root: str, image_set: str,
                 is_train: bool, ann_file: Optional[str] = None,
                 bbox_file: Optional[str] = None, seed=None):
        super().__init__(cfg, root, image_set, is_train, seed)
        ann_file = ann_file or os.path.join(
            root, "annotations", f"person_keypoints_{image_set}.json")
        self.index = COCOIndex(ann_file)
        self.image_dir = os.path.join("images", image_set)
        if is_train or cfg.test.use_gt_bbox:
            self.db = self._load_gt_db()
        else:
            self.db = self._load_detection_db(
                bbox_file or cfg.test.bbox_file)

    def _img_path(self, image_id: int) -> str:
        return os.path.join(self.image_dir, self.index.file_name(image_id))

    def _load_gt_db(self) -> List[dict]:
        db = []
        for image_id in self.index.image_ids:
            im = self.index.imgs[image_id]
            width, height = im.get("width", 0), im.get("height", 0)
            for ann in self.index.load_anns(image_id):
                if ann.get("iscrowd", 0):
                    continue
                kp = np.array(ann.get("keypoints", []), np.float64)
                if kp.size == 0:
                    continue
                # without num_keypoints (PoseTrack-style jsons), count the
                # labelled joints
                nk = ann.get("num_keypoints")
                if nk is None:
                    nk = int(np.sum(kp.reshape(-1, 3)[:, 2] > 0))
                if nk == 0:
                    continue
                # the clean box: x1y1 clipped to the image, positive area
                x, y, w, h = ann["bbox"]
                x1, y1 = max(0, x), max(0, y)
                x2 = min(width - 1, x1 + max(0, w - 1)) if width else x1 + w
                y2 = min(height - 1, y1 + max(0, h - 1)) if height else y1 + h
                if ann.get("area", w * h) <= 0 or x2 < x1 or y2 < y1:
                    continue
                joints = kp.reshape(-1, 3)
                vis = (joints[:, 2] > 0).astype(np.float64)
                center, scale = box_to_center_scale(
                    [x1, y1, x2 - x1, y2 - y1], self.aspect_ratio)
                db.append({
                    "image": self._img_path(image_id),
                    "image_id": image_id,
                    "center": center, "scale": scale,
                    "joints": joints[:, :2], "joints_vis": vis,
                    "score": 1.0,
                })
        return db

    def _load_detection_db(self, bbox_file: str) -> List[dict]:
        if not bbox_file:
            raise ValueError(
                "eval without use_gt_bbox needs a detections bbox_file "
                "(cfg.test.bbox_file or the bbox_file argument)")
        with open(bbox_file) as f:
            dets = json.load(f)
        if self.cfg.test.nms_thre < 1.0 and dets:
            by_img = {}
            for d in dets:
                by_img.setdefault(d["image_id"], []).append(d)
            kept = []
            for img_dets in by_img.values():
                arr = np.array([[*d["bbox"][:2],
                                 d["bbox"][0] + d["bbox"][2],
                                 d["bbox"][1] + d["bbox"][3],
                                 d.get("score", 1.0)] for d in img_dets],
                               np.float32)
                for i in nms_boxes_np(arr.astype(np.float64),
                                      self.cfg.test.nms_thre):
                    kept.append(img_dets[i])
            dets = kept
        db = []
        for det in dets:
            if det.get("category_id", 1) != 1:
                continue
            score = float(det.get("score", 1.0))
            if score < self.cfg.test.image_thre:
                continue
            box = det["bbox"]
            if box[2] <= 0 or box[3] <= 0:
                continue  # a degenerate box gives a zero scale
            center, scale = box_to_center_scale(box, self.aspect_ratio)
            image_id = det["image_id"]
            db.append({
                "image": self._img_path(image_id),
                "image_id": image_id,
                "center": center, "scale": scale,
                "joints": np.zeros((self.num_joints, 2)),
                "joints_vis": np.ones(self.num_joints),
                "score": score,
            })
        return db

    def evaluate(self, preds, maxvals, scores, image_ids, output_dir=None):
        raise NotImplementedError(
            "COCO keypoint evaluation needs the port of eval/coco_eval.py "
            "(ROADMAP item 23)")
