"""A minimal COCO-format json index (the read side of pycocotools).

Port of ``flowtrack_tpu/data/coco_io.py``: images, person annotations
grouped by image, categories, and the ground truth in the shape a COCO
keypoint evaluator reads.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List


class COCOIndex:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            raw = json.load(f)
        self.dataset = raw
        self.imgs: Dict[int, dict] = {im["id"]: im for im in raw.get("images", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.anns: Dict[int, dict] = {}
        for ann in raw.get("annotations", []):
            self.anns[ann.get("id", len(self.anns))] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        self.cats = {c["id"]: c for c in raw.get("categories", [])}

    @property
    def image_ids(self) -> List[int]:
        return sorted(self.imgs)

    def load_anns(self, image_id: int) -> List[dict]:
        return self.img_to_anns.get(image_id, [])

    def file_name(self, image_id: int) -> str:
        return self.imgs[image_id]["file_name"]

    def person_gts_for_eval(self, num_joints: int = 17) -> List[dict]:
        """One ground-truth dict per person annotation."""
        out = []
        for img_id, anns in self.img_to_anns.items():
            for a in anns:
                kp = a.get("keypoints", [0] * (3 * num_joints))
                out.append({
                    "image_id": img_id,
                    "keypoints": kp,
                    "area": a.get("area", 1.0),
                    "bbox": a.get("bbox", [0, 0, 1, 1]),
                    "iscrowd": a.get("iscrowd", 0),
                    "num_keypoints": a.get(
                        "num_keypoints",
                        int((len(kp) > 0) and (max(kp[2::3]) > 0))),
                })
        return out
