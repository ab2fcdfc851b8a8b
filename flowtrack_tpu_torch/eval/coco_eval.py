"""COCO keypoint AP evaluator (OKS-based), in numpy.

Port of ``flowtrack_tpu/eval/coco_eval.py``, copied as code:
``compute_oks`` (:42), ``_evaluate_img`` (:84), ``_accumulate`` (:141),
``COCOKeypointEval`` (:180) and ``summarize`` (:236), the pycocotools
'keypoints' branch written against its published algorithm:

  * OKS thresholds 0.50:0.05:0.95; maxDets = 20.
  * area ranges: all, medium [32^2, 96^2], large [96^2, 1e5^2].
  * OKS normalized by the GT annotation area + np.spacing(1); only labeled
    (v > 0) GT keypoints counted; GTs with no labeled keypoints fall back to
    a bbox-window proximity test (exactly computeOks' z/dx/dy clipping).
  * GTs flagged ignore (iscrowd / num_keypoints == 0 / out of area range)
    can absorb detections without counting as TP or FP.

Data model: plain dicts —
  gt: {image_id, area, bbox [x,y,w,h], keypoints [3K], iscrowd, num_keypoints}
  dt: {image_id, keypoints [3K], score}
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from flowtrack_tpu_torch.config import COCO_SIGMAS

OKS_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e5 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e5 ** 2),
}
MAX_DETS = 20


def compute_oks(gts: List[dict], dts: List[dict],
                sigmas: Optional[Sequence[float]] = None) -> np.ndarray:
    """OKS matrix (len(dts), len(gts)) for one image — computeOks twin."""
    sig = np.asarray(sigmas if sigmas is not None else COCO_SIGMAS,
                     np.float64)
    var = (sig * 2.0) ** 2
    k = len(sig)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        bb = np.asarray(gt["bbox"], np.float64)
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx ** 2 + dy ** 2) / var / (
                gt["area"] + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


def _dt_area(dt) -> float:
    """COCO.loadRes convention for keypoint results: bbox area of the
    predicted keypoints (no visibility filtering)."""
    if "area" in dt:
        return float(dt["area"])
    kp = np.asarray(dt["keypoints"], np.float64)
    x, y = kp[0::3], kp[1::3]
    return float((x.max() - x.min()) * (y.max() - y.min()))


def _evaluate_img(gts, dts, ious, area_rng, max_dets):
    """evaluateImg twin for one (image, areaRng). Returns match arrays."""
    for g in gts:
        too_small = g["area"] < area_rng[0] or g["area"] > area_rng[1]
        g["_ignore"] = 1 if (g.get("iscrowd", 0) or too_small
                             or g.get("num_keypoints", 1) == 0) else 0
    gtind = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
    gts = [gts[i] for i in gtind]
    dtind = np.argsort([-d["score"] for d in dts], kind="mergesort")
    dts = [dts[i] for i in dtind[:max_dets]]
    ious = ious[:, gtind][dtind[:max_dets]] if len(ious) else ious

    t_n = len(OKS_THRS)
    g_n, d_n = len(gts), len(dts)
    gtm = np.zeros((t_n, g_n))
    dtm = np.zeros((t_n, d_n))
    gt_ig = np.array([g["_ignore"] for g in gts])
    iscrowd = np.array([g.get("iscrowd", 0) for g in gts])
    dt_ig = np.zeros((t_n, d_n))

    if len(ious):
        for tind, t in enumerate(OKS_THRS):
            for dind in range(d_n):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gind in range(g_n):
                    # crowd GTs may absorb multiple detections
                    # (pycocotools: `if gtm>0 and not iscrowd: continue`)
                    if gtm[tind, gind] > 0 and not iscrowd[gind]:
                        continue
                    # best non-ignore match found and this gt is ignore: stop
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                        break
                    if ious[dind, gind] < iou:
                        continue
                    iou = ious[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dt_ig[tind, dind] = gt_ig[m]
                dtm[tind, dind] = 1
                gtm[tind, m] = 1
    # pycocotools: UNMATCHED dts whose area (keypoint bbox area computed by
    # COCO.loadRes) falls outside the range are ignored, so out-of-slice
    # detections don't count as FPs in the medium/large slices
    dt_area = np.array([_dt_area(d) for d in dts])
    out_of_rng = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
    if d_n:
        dt_ig = np.logical_or(
            dt_ig, np.logical_and(dtm == 0, out_of_rng[None, :]))
    return {
        "dtm": dtm, "dt_ig": dt_ig, "gt_ig": gt_ig,
        "dt_scores": np.array([d["score"] for d in dts]),
        "num_gt": int((gt_ig == 0).sum()),
    }


def _accumulate(img_results):
    """accumulate() twin over one (areaRng) slice -> precision/recall."""
    t_n, r_n = len(OKS_THRS), len(RECALL_THRS)
    precision = -np.ones((t_n, r_n))
    recall = -np.ones(t_n)
    num_gt = sum(r["num_gt"] for r in img_results)
    if num_gt == 0:
        return precision, recall

    dt_scores = np.concatenate([r["dt_scores"] for r in img_results])
    inds = np.argsort(-dt_scores, kind="mergesort")
    dtm = np.concatenate([r["dtm"] for r in img_results], axis=1)[:, inds]
    dt_ig = np.concatenate([r["dt_ig"] for r in img_results], axis=1)[:, inds]

    tps = np.logical_and(dtm, np.logical_not(dt_ig))
    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dt_ig))
    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

    for t in range(t_n):
        tp, fp = tp_sum[t], fp_sum[t]
        nd = len(tp)
        rc = tp / num_gt
        pr = tp / (fp + tp + np.spacing(1))
        recall[t] = rc[-1] if nd else 0.0
        # make precision monotonically decreasing
        pr = pr.tolist()
        for i in range(nd - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds_r = np.searchsorted(rc, RECALL_THRS, side="left")
        q = np.zeros(r_n)
        for ri, pi in enumerate(inds_r):
            if pi < nd:
                q[ri] = pr[pi]
        precision[t] = q
    return precision, recall


class COCOKeypointEval:
    """End-to-end keypoint evaluation over gt/dt dict lists."""

    def __init__(self, gts: List[dict], dts: List[dict],
                 sigmas: Optional[Sequence[float]] = None):
        self.gts_by_img: Dict = defaultdict(list)
        self.dts_by_img: Dict = defaultdict(list)
        for g in gts:
            self.gts_by_img[g["image_id"]].append(dict(g))
        for d in dts:
            self.dts_by_img[d["image_id"]].append(dict(d))
        self.img_ids = sorted(
            set(self.gts_by_img) | set(self.dts_by_img))
        self.sigmas = sigmas

    def evaluate(self) -> Dict[str, float]:
        ious = {img: compute_oks(self.gts_by_img[img], self.dts_by_img[img],
                                 self.sigmas)
                for img in self.img_ids}
        stats = {}
        per_rng = {}
        for rng_name, rng in AREA_RNGS.items():
            img_results = [
                _evaluate_img(self.gts_by_img[img], self.dts_by_img[img],
                              ious[img], rng, MAX_DETS)
                for img in self.img_ids
            ]
            per_rng[rng_name] = _accumulate(img_results)

        def ap(rng_name, thr=None):
            precision, _ = per_rng[rng_name]
            p = precision if thr is None else precision[
                [np.argmin(np.abs(OKS_THRS - thr))]]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def ar(rng_name, thr=None):
            _, recall = per_rng[rng_name]
            r = recall if thr is None else recall[
                [np.argmin(np.abs(OKS_THRS - thr))]]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        stats["AP"] = ap("all")
        stats["AP50"] = ap("all", 0.5)
        stats["AP75"] = ap("all", 0.75)
        stats["APm"] = ap("medium")
        stats["APl"] = ap("large")
        stats["AR"] = ar("all")
        stats["AR50"] = ar("all", 0.5)
        stats["AR75"] = ar("all", 0.75)
        stats["ARm"] = ar("medium")
        stats["ARl"] = ar("large")
        return stats


def summarize(stats: Dict[str, float]) -> str:
    names = {
        "AP": "Average Precision (AP) @[ IoU=0.50:0.95 | area=   all ]",
        "AP50": "Average Precision (AP) @[ IoU=0.50      | area=   all ]",
        "AP75": "Average Precision (AP) @[ IoU=0.75      | area=   all ]",
        "APm": "Average Precision (AP) @[ IoU=0.50:0.95 | area=medium ]",
        "APl": "Average Precision (AP) @[ IoU=0.50:0.95 | area= large ]",
        "AR": "Average Recall    (AR) @[ IoU=0.50:0.95 | area=   all ]",
        "AR50": "Average Recall    (AR) @[ IoU=0.50      | area=   all ]",
        "AR75": "Average Recall    (AR) @[ IoU=0.75      | area=   all ]",
        "ARm": "Average Recall    (AR) @[ IoU=0.50:0.95 | area=medium ]",
        "ARl": "Average Recall    (AR) @[ IoU=0.50:0.95 | area= large ]",
    }
    return "\n".join(f" {names[k]} = {v:0.3f}" for k, v in stats.items())
