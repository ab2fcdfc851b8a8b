"""Optical-flow evaluation: end-point-error statistics and Middlebury .flo
files.

Port of ``flowtrack_tpu/eval/flow_eval.py``, the port's own copy. A .flo
file holds the magic float 202021.25, the int32 width and height, then the
row-major float32 (u, v) pairs, little-endian.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """.flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 2 * 4), "<f4")
    return data.reshape(h, w, 2).astype(np.float32)


def write_flo(path: str, flow: np.ndarray):
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.astype("<f4").tobytes())


def flow_error_stats(pred: np.ndarray, gt: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> Dict[str, float]:
    """EPE statistics of one field; ``valid`` an optional (H, W) mask."""
    d = np.linalg.norm(np.asarray(pred, np.float64) -
                       np.asarray(gt, np.float64), axis=-1)
    if valid is not None:
        d = d[np.asarray(valid, bool)]
    if d.size == 0:
        return {"epe": 0.0, "epe_1px": 0.0, "epe_3px": 0.0, "fl": 0.0}
    mag = np.linalg.norm(np.asarray(gt, np.float64), axis=-1)
    if valid is not None:
        mag = mag[np.asarray(valid, bool)]
    # Fl (KITTI's outlier rate): error over 3 px and over 5% of |gt|
    outlier = (d > 3.0) & (d > 0.05 * np.maximum(mag, 1e-9))
    return {
        "epe": float(d.mean()),
        "epe_1px": float((d <= 1.0).mean()),
        "epe_3px": float((d <= 3.0).mean()),
        "fl": float(outlier.mean()),
    }


def evaluate_flow_pairs(preds, gts, valids=None) -> Dict[str, float]:
    """The mean of the per-field statistics (Sintel's convention)."""
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions vs {len(gts)} GT "
                         "flow fields")
    if valids is not None and len(valids) != len(preds):
        raise ValueError(f"{len(valids)} valid masks for {len(preds)} "
                         "pairs")
    valids = valids if valids is not None else [None] * len(preds)
    per = [flow_error_stats(p, g, v) for p, g, v in zip(preds, gts, valids)]
    if not per:
        return {"epe": 0.0, "epe_1px": 0.0, "epe_3px": 0.0, "fl": 0.0,
                "n_frames": 0}
    out = {k: float(np.mean([s[k] for s in per])) for k in per[0]}
    out["n_frames"] = len(per)
    return out
