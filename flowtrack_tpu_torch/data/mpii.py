"""MPII dataset (16 joints) and PCKh@0.5 evaluation.

Port of ``flowtrack_tpu/data/mpii.py`` (``MPIIDataset`` :27, ``evaluate``
:59, ``_mpii_head_size`` :94) on the port's ``PoseDataset``: json
annotations converted from the MPII mat files, records {image, center,
scale (scalar, person-height/200), joints (16, 2), joints_vis}; the lineage
shifts the center down by 15 * scale px and pads scale by 1.25; evaluation
is PCKh@0.5 (distance normalized by 0.6 * head-box diagonal), with pelvis
and thorax left out of the mean.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from flowtrack_tpu_torch.config import MPII_FLIP_PAIRS, MPII_NUM_JOINTS, Config
from flowtrack_tpu_torch.data.pose_dataset import PoseDataset

# MPII joint order: 0-rank 1-rknee 2-rhip 3-lhip 4-lknee 5-lank 6-pelvis
# 7-thorax 8-upperneck 9-headtop 10-rwri 11-relb 12-rsho 13-lsho 14-lelb 15-lwri
HEAD_TOP, UPPER_NECK = 9, 8


class MPIIDataset(PoseDataset):
    num_joints = MPII_NUM_JOINTS
    flip_pairs = list(MPII_FLIP_PAIRS)

    def __init__(self, cfg: Config, root: str, image_set: str,
                 is_train: bool, ann_file: Optional[str] = None, seed=None):
        super().__init__(cfg, root, image_set, is_train, seed)
        ann_file = ann_file or os.path.join(root, "annot",
                                            f"{image_set}.json")
        with open(ann_file) as f:
            anns = json.load(f)
        self.db = []
        for i, a in enumerate(anns):
            c = np.array(a["center"], np.float64)
            s = np.array([a["scale"], a["scale"]], np.float64)
            if c[0] != -1:
                # reference adjustment: lift the (person-centric) center and
                # pad the scale
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1  # mat is 1-based
            joints = np.array(a["joints"], np.float64).reshape(-1, 2) - 1
            vis = np.array(a["joints_vis"], np.float64).reshape(-1)
            self.db.append({
                "image": os.path.join("images", a["image"]),
                "image_id": i,
                "center": c, "scale": s,
                "joints": joints, "joints_vis": vis,
                "score": 1.0,
                "head_size": _mpii_head_size(a),
            })

    def evaluate(self, preds, image_ids=None):
        """PCKh@0.5. preds: (N, 16, 2) image-space keypoints in db order.

        Returns dict with per-joint-group and mean PCKh (reference output
        shape: Head/Shoulder/Elbow/Wrist/Hip/Knee/Ankle/Mean)."""
        preds = np.asarray(preds)
        n = len(preds)
        dists = np.full((n, self.num_joints), -1.0)
        for i in range(n):
            rec = self.db[i]
            gt = np.asarray(rec["joints"])
            vis = np.asarray(rec["joints_vis"]) > 0
            h = rec["head_size"]
            d = np.linalg.norm(preds[i] - gt, axis=-1) / max(h, 1e-6)
            dists[i, vis] = d[vis]

        def pckh(joint_ids):
            sel = dists[:, joint_ids]
            valid = sel >= 0
            if valid.sum() == 0:
                return 0.0
            return float(((sel <= 0.5) & valid).sum() / valid.sum())

        groups = {
            "Head": [HEAD_TOP, UPPER_NECK],
            "Shoulder": [12, 13], "Elbow": [11, 14], "Wrist": [10, 15],
            "Hip": [2, 3], "Knee": [1, 4], "Ankle": [0, 5],
        }
        stats = {k: pckh(v) for k, v in groups.items()}
        # reference protocol masks pelvis (6) and thorax (7) out of Mean
        stats["Mean"] = pckh([j for j in range(self.num_joints)
                              if j not in (6, 7)])
        return stats


def _mpii_head_size(a) -> float:
    if "headbox" in a:
        hb = np.asarray(a["headbox"], np.float64)
        return 0.6 * float(np.linalg.norm(hb[2:] - hb[:2]))
    # SC_BIAS-free fallback: MPII scale is person-height/200; head is ~1/8
    return max(float(a["scale"]) * 200.0 / 8.0, 1e-6)
