"""The COCO keypoint dataset.

Port of ``flowtrack_tpu/data/coco.py``:

* the train db: one record per person annotation with labelled keypoints
  and a clean box (clamped to the image, positive area), its center and
  scale from the box with the aspect kept and 1.25 padding
  (``ops/affine.box_to_center_scale``);
* the eval db: the detections json (``cfg.test.bbox_file``) above
  ``image_thre``, after box NMS at ``nms_thre`` when that is under 1
  (``native.cpu_nms``), or the ground-truth boxes with ``use_gt_bbox``;
* ``evaluate`` (coco.py:147): per image OKS-NMS at ``oks_thre``
  (``native.cpu_oks_nms``) or soft OKS-NMS (``ops/nms.soft_oks_nms_np``)
  over the rescored poses, the results json in ``output_dir``, and the
  port's COCO keypoint AP (``eval/coco_eval.py``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np

from flowtrack_tpu_torch import native
from flowtrack_tpu_torch.config import COCO_FLIP_PAIRS, COCO_NUM_JOINTS, Config
from flowtrack_tpu_torch.data.coco_io import COCOIndex
from flowtrack_tpu_torch.data.pose_dataset import PoseDataset
from flowtrack_tpu_torch.eval.coco_eval import COCOKeypointEval, summarize
from flowtrack_tpu_torch.ops.affine import box_to_center_scale
from flowtrack_tpu_torch.ops.nms import soft_oks_nms_np


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
                for i in native.cpu_nms(arr, self.cfg.test.nms_thre):
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
        """COCO keypoint evaluation.

        preds: (N, K, 2) image-space keypoints; maxvals: (N, K) confidences;
        scores: (N,) rescored person scores (ops/decode.rescore output);
        image_ids: (N,) ints. Returns (stats dict, results list).
        """
        preds = np.asarray(preds)
        maxvals = np.asarray(maxvals)
        scores = np.asarray(scores)
        image_ids = np.asarray(image_ids)

        by_img = defaultdict(list)
        for i in range(len(preds)):
            kpts = np.concatenate([preds[i], maxvals[i][:, None]], axis=1)
            xs, ys = preds[i, :, 0], preds[i, :, 1]
            area = (xs.max() - xs.min()) * (ys.max() - ys.min())
            by_img[int(image_ids[i])].append({
                "keypoints": kpts, "score": float(scores[i]), "area": area,
            })

        results = []
        for img_id, kpt_list in by_img.items():
            if self.cfg.test.soft_nms:
                keep, _ = soft_oks_nms_np(kpt_list, self.cfg.test.oks_thre)
            else:
                keep = native.cpu_oks_nms(kpt_list, self.cfg.test.oks_thre)
            if len(keep) == 0:
                keep = range(len(kpt_list))
            for i in keep:
                k = kpt_list[i]
                results.append({
                    "image_id": img_id,
                    "category_id": 1,
                    "keypoints": [round(float(v), 3)
                                  for v in k["keypoints"].reshape(-1)],
                    "score": k["score"],
                })

        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            res_file = os.path.join(
                output_dir, f"keypoints_{self.image_set}_results.json")
            with open(res_file, "w") as f:
                json.dump(results, f)

        gts = self.index.person_gts_for_eval(self.num_joints)
        dts = [{"image_id": r["image_id"], "keypoints": r["keypoints"],
                "score": r["score"]} for r in results]
        stats = COCOKeypointEval(gts, dts).evaluate()
        return stats, results

    def print_eval(self, stats):
        print(summarize(stats))
