"""PoseTrack dataset: per-sequence frame lists over the COCO crop pipeline.

Port of ``flowtrack_tpu/data/posetrack.py`` (``PoseTrackDataset`` :23,
``sequences`` :41, ``frame_annotations`` :50, ``frame_path`` :65,
``_head_size`` :69): a COCO-format json (PoseTrack-2018 style) whose images
carry ``vid_id``/``frame_id`` and whose annotations carry ``track_id``;
person instances go through the same affine-crop pipeline as COCO;
tracking eval consumes per-frame pose sets (``eval/posetrack_eval.py``).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from flowtrack_tpu_torch.config import Config
from flowtrack_tpu_torch.data.coco import COCODataset


class PoseTrackDataset(COCODataset):
    """COCO pipeline + sequence structure. 17-slot keypoint arrays (the
    PoseTrack-2018 convention; ear joints unlabeled)."""

    def __init__(self, cfg: Config, root: str, image_set: str,
                 is_train: bool, ann_file: Optional[str] = None,
                 bbox_file: Optional[str] = None, seed=None):
        ann_file = ann_file or os.path.join(
            root, "annotations", f"{image_set}.json")
        super().__init__(cfg, root, image_set, is_train,
                         ann_file=ann_file, bbox_file=bbox_file, seed=seed)
        # image paths in posetrack json are relative to the data root already
        self.image_dir = ""
        for rec in self.db:
            rec["image"] = self.index.file_name(rec["image_id"])

    # -- sequence access (the tracker iterates these) ------------------------

    def sequences(self) -> Dict[str, List[int]]:
        """vid_id -> [image_id] sorted by frame_id."""
        seqs = defaultdict(list)
        for image_id, im in self.index.imgs.items():
            vid = str(im.get("vid_id", im.get("video_id", "0")))
            seqs[vid].append((im.get("frame_id", image_id), image_id))
        return {vid: [i for _, i in sorted(frames)]
                for vid, frames in seqs.items()}

    def frame_annotations(self, image_id: int) -> List[dict]:
        """GT poses + track ids of one frame (for tracking eval)."""
        out = []
        for ann in self.index.load_anns(image_id):
            kp = np.asarray(ann.get("keypoints", []), np.float64)
            if kp.size == 0:
                continue
            out.append({
                "track_id": ann.get("track_id", -1),
                "keypoints": kp.reshape(-1, 3),
                "bbox": ann.get("bbox", None),
                "head_size": _head_size(ann),
            })
        return out

    def frame_path(self, image_id: int) -> str:
        return os.path.join(self.root, self.index.file_name(image_id))


def _head_size(ann) -> float:
    """PCKh normalizer: 0.6 * diagonal of the head bbox (poseval convention);
    falls back to 0.6 * sqrt(person-bbox area) / 2 when absent."""
    hb = ann.get("bbox_head", ann.get("head_box"))
    if hb is not None:
        return 0.6 * float(np.hypot(hb[2], hb[3]))
    bb = ann.get("bbox")
    if bb is not None and bb[2] > 0 and bb[3] > 0:
        return 0.3 * float(np.sqrt(bb[2] * bb[3]))
    return 1.0
