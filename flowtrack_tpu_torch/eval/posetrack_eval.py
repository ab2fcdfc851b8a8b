"""PoseTrack evaluation: per-joint mAP and CLEAR-MOT MOTA.

Port of ``flowtrack_tpu/eval/posetrack_eval.py``, copied as code
(``match_frame`` :86, ``_average_precision`` :114, ``evaluate_posetrack``
:147, ``evaluate_posetrack_mot`` :247). The protocol, from its published
definition (PoseTrack, arXiv:1710.10000; MPII multi-person eval; CLEAR-MOT,
Bernardin & Stiefelhagen 2008):

  * a predicted joint hits a labeled GT joint when dist <= 0.5 * GT head
    size (PCKh@0.5);
  * poses are matched per frame greedily by descending PCKh fraction (hit
    count over the GT pose's labeled joints);
  * per-joint AP: each matched prediction adds its per-keypoint confidence
    to that joint's PR curve; MPII/poseval VOCap (monotone precision
    envelope, summed at recall change points);
  * MOTA per joint: 1 - (misses + FPs + switches) / #labeled GT joints; a
    switch is a GT track's matched predicted id differing from its most
    recent match (py-motmetrics: gaps do not reset the association).

Two formulations of the FP count: ``evaluate_posetrack`` (joints of
unmatched predicted poses and non-hit joints of matched poses are FPs) and
``evaluate_posetrack_mot`` (motmetrics-accumulator event streams per joint:
objects = labeled GT joints, hypotheses = all predicted joints). Misses,
switches and AP agree exactly; the second also counts a matched pose's
predicted joint whose GT joint is unlabeled as an FP (``fp_unlabeled``).

Inputs are per-frame lists:
  gt:   {track_id, keypoints (K, 3) [x, y, labeled], head_size}
  pred: {track_id, keypoints (K, 3) [x, y, conf], score}
(pred["score"] is used only as the per-joint confidence fallback when a
keypoint confidence is not finite.)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

PCKH_THRESH = 0.5


def _joint_conf(pred_pose):
    """Per-keypoint confidences for the AP curves (poseval stores scores
    per keypoint); non-finite entries fall back to the pose score."""
    conf = np.asarray(pred_pose["keypoints"], np.float64)[:, 2].copy()
    bad = ~np.isfinite(conf)
    if bad.any():
        conf[bad] = float(pred_pose.get("score", 0.0))
    return conf


def _joint_hits(gt_pose, pred_pose):
    """(K,) bool: predicted joint within 0.5*head of the labeled GT joint."""
    g = np.asarray(gt_pose["keypoints"], np.float64)
    p = np.asarray(pred_pose["keypoints"], np.float64)
    labeled = g[:, 2] > 0
    dist = np.linalg.norm(p[:, :2] - g[:, :2], axis=1)
    thresh = PCKH_THRESH * max(float(gt_pose["head_size"]), 1e-6)
    return (dist <= thresh) & labeled


def match_frame(gts: List[dict], preds: List[dict]):
    """Greedy pose assignment by descending PCKh fraction (poseval's pck:
    hit count normalized by the GT pose's labeled-joint count, so a fully
    recovered sparse pose outranks a grazing hit on a dense one).

    Returns list of (gt_idx, pred_idx, hits (K,) bool)."""
    if not gts or not preds:
        return []
    scores = np.zeros((len(gts), len(preds)))
    hits_all = {}
    for i, g in enumerate(gts):
        n_labeled = max(int((np.asarray(g["keypoints"])[:, 2] > 0).sum()), 1)
        for j, p in enumerate(preds):
            h = _joint_hits(g, p)
            hits_all[(i, j)] = h
            scores[i, j] = h.sum() / n_labeled
    matches = []
    s = scores.copy()
    while True:
        i, j = np.unravel_index(np.argmax(s), s.shape)
        if s[i, j] <= 0:
            break
        matches.append((int(i), int(j), hits_all[(i, j)]))
        s[i, :] = -1
        s[:, j] = -1
    return matches


def _average_precision(scores, is_tp, num_gt):
    """MPII/poseval VOCap: precision made monotone non-increasing from the
    right (the envelope), then summed at recall change points."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores), kind="mergesort")
    tp = np.asarray(is_tp)[order]
    fp = ~tp
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recall = tp_c / num_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    change = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[change] - mrec[change - 1]) * mpre[change]))


def _check_lengths(gt_sequences, pred_sequences):
    """zip would silently truncate ragged inputs, inflating MOTA/mAP by
    never counting the dropped frames' GT as misses — be strict instead."""
    if len(gt_sequences) != len(pred_sequences):
        raise ValueError(f"{len(gt_sequences)} GT sequences vs "
                         f"{len(pred_sequences)} prediction sequences")
    for si, (g, p) in enumerate(zip(gt_sequences, pred_sequences)):
        if len(g) != len(p):
            raise ValueError(f"sequence {si}: {len(g)} GT frames vs "
                             f"{len(p)} prediction frames")


def evaluate_posetrack(gt_sequences: Sequence[Sequence[List[dict]]],
                       pred_sequences: Sequence[Sequence[List[dict]]],
                       num_joints: int = 17,
                       joint_names: Dict[int, str] = None):
    """Evaluate over sequences (lists of per-frame pose lists).

    Returns {"mAP": ..., "MOTA": ..., "per_joint_AP": (K,),
    "per_joint_MOTA": (K,), "num_switches": int}."""
    # -- AP accumulation
    joint_scores = [[] for _ in range(num_joints)]
    joint_tp = [[] for _ in range(num_joints)]
    joint_gt_count = np.zeros(num_joints, np.int64)
    # -- MOT accumulation
    miss = np.zeros(num_joints, np.int64)
    fp = np.zeros(num_joints, np.int64)
    switches = np.zeros(num_joints, np.int64)

    _check_lengths(gt_sequences, pred_sequences)
    for gt_seq, pred_seq in zip(gt_sequences, pred_sequences):
        # switches are counted per joint class (one association map each)
        last_match_joint = [dict() for _ in range(num_joints)]
        for gts, preds in zip(gt_seq, pred_seq):
            # parse once per frame, not per joint (same hoisting as the
            # MOT backend)
            labeled_all = [np.asarray(g["keypoints"])[:, 2] > 0
                           for g in gts]
            conf_all = [_joint_conf(p) for p in preds]
            for labeled in labeled_all:
                joint_gt_count += labeled.astype(np.int64)
            matches = match_frame(gts, preds)
            matched_gt = {m[0] for m in matches}
            matched_pred = {m[1] for m in matches}

            for gi, pi, hits in matches:
                g, p = gts[gi], preds[pi]
                labeled, pconf = labeled_all[gi], conf_all[pi]
                for k in range(num_joints):
                    if labeled[k]:
                        if hits[k]:
                            joint_scores[k].append(pconf[k])
                            joint_tp[k].append(True)
                            # ID continuity per joint
                            gtid, prid = g["track_id"], p["track_id"]
                            prev = last_match_joint[k].get(gtid)
                            if prev is not None and prev != prid:
                                switches[k] += 1
                            last_match_joint[k][gtid] = prid
                        else:
                            miss[k] += 1
                    # predicted joint with no labeled GT joint in its
                    # matched pose counts as FP below

            # FPs: joints of unmatched predicted poses + missed joints of
            # matched poses whose prediction landed elsewhere
            for pi, p in enumerate(preds):
                if pi not in matched_pred:
                    pconf = conf_all[pi]
                    for k in range(num_joints):
                        joint_scores[k].append(pconf[k])
                        joint_tp[k].append(False)
                        fp[k] += 1
            for gi, pi, hits in matches:
                labeled, pconf = labeled_all[gi], conf_all[pi]
                for k in range(num_joints):
                    if labeled[k] and not hits[k]:
                        joint_scores[k].append(pconf[k])
                        joint_tp[k].append(False)
                        fp[k] += 1
            # unmatched GT poses: all their labeled joints are misses
            for gi, g in enumerate(gts):
                if gi in matched_gt:
                    continue
                miss += labeled_all[gi].astype(np.int64)

    per_joint_ap = np.array([
        _average_precision(joint_scores[k], joint_tp[k], joint_gt_count[k])
        for k in range(num_joints)])
    return _finalize(per_joint_ap, joint_gt_count, miss, fp, switches)


def _finalize(per_joint_ap, joint_gt_count, miss, fp, switches,
              extra=None):
    with np.errstate(divide="ignore", invalid="ignore"):
        per_joint_mota = 1.0 - (miss + fp + switches) / np.maximum(
            joint_gt_count, 1)
    valid = joint_gt_count > 0
    out = {
        "mAP": float(np.nanmean(per_joint_ap[valid])) if valid.any() else 0.0,
        "MOTA": float(np.mean(per_joint_mota[valid])) if valid.any() else 0.0,
        "per_joint_AP": per_joint_ap,
        "per_joint_MOTA": per_joint_mota,
        "num_switches": int(switches.sum()),
        "num_misses": int(miss.sum()),
        "num_fps": int(fp.sum()),
    }
    if extra:
        out.update(extra)
    return out


def evaluate_posetrack_mot(gt_sequences: Sequence[Sequence[List[dict]]],
                           pred_sequences: Sequence[Sequence[List[dict]]],
                           num_joints: int = 17):
    """Second backend (module docstring "FP accounting"): per-joint
    MOTAccumulator-style event streams, py-motmetrics semantics — the
    formulation poseval actually feeds.

    Per sequence, per frame, per joint k:
      objects     O = GT track ids whose joint k is labeled
      hypotheses  H = ALL predicted track ids (our prediction format always
                      carries K joints, as the reference's output does)
      distance    d[o, h] = 0 iff the pose-level greedy PCKh correspondence
                  matched o's pose to h's pose AND joint k hit, else inf

    Events: previous associations are re-used when still finite (motmetrics
    association memory), remaining finite entries are matched (each row/col
    has at most one finite entry here, so Munkres degenerates to a direct
    pairing); MATCH checks the gap-tolerant last-association for IDSW;
    MISS = |O| - matches; FP = |H| - matches.

    Extra key ``fp_unlabeled``: FPs charged for matched poses' predicted
    joints whose GT joint is unlabeled — exactly the term by which this
    backend differs from ``evaluate_posetrack`` (differentially tested).

    AP is association-free and identical to the direct backend's.
    """
    joint_scores = [[] for _ in range(num_joints)]
    joint_tp = [[] for _ in range(num_joints)]
    joint_gt_count = np.zeros(num_joints, np.int64)
    miss = np.zeros(num_joints, np.int64)
    fp = np.zeros(num_joints, np.int64)
    fp_unlabeled = np.zeros(num_joints, np.int64)
    switches = np.zeros(num_joints, np.int64)

    _check_lengths(gt_sequences, pred_sequences)
    for gt_seq, pred_seq in zip(gt_sequences, pred_sequences):
        # gap-tolerant association memory, one map per joint class
        last_assoc = [dict() for _ in range(num_joints)]
        for gts, preds in zip(gt_seq, pred_seq):
            matches = match_frame(gts, preds)
            pose_match = {gi: (pi, hits) for gi, pi, hits in matches}
            matched_pred = {pi for _, pi, _ in matches}
            # parse once per frame, not per joint (review finding)
            labeled_all = [np.asarray(g["keypoints"])[:, 2] > 0
                           for g in gts]
            conf_all = [_joint_conf(p) for p in preds]

            # AP accumulation — same entries in the same insertion order as
            # the direct backend (the VOCap mergesort keeps insertion order
            # on score ties, so order is part of bitwise equality)
            for gi, pi, hits in matches:
                labeled, pconf = labeled_all[gi], conf_all[pi]
                for k in range(num_joints):
                    if labeled[k] and hits[k]:
                        joint_scores[k].append(pconf[k])
                        joint_tp[k].append(True)
            for pi, p in enumerate(preds):
                if pi not in matched_pred:
                    pconf = conf_all[pi]
                    for k in range(num_joints):
                        joint_scores[k].append(pconf[k])
                        joint_tp[k].append(False)
            for gi, pi, hits in matches:
                labeled, pconf = labeled_all[gi], conf_all[pi]
                for k in range(num_joints):
                    if labeled[k] and not hits[k]:
                        joint_scores[k].append(pconf[k])
                        joint_tp[k].append(False)

            for k in range(num_joints):
                objects = []      # (gt_track_id, matched hyp id or None)
                for gi, g in enumerate(gts):
                    if not labeled_all[gi][k]:
                        continue
                    joint_gt_count[k] += 1
                    hyp = None
                    if gi in pose_match:
                        pi, hits = pose_match[gi]
                        if hits[k]:
                            hyp = preds[pi]["track_id"]
                    objects.append((g["track_id"], hyp))
                n_hyp = len(preds)
                n_match = 0
                for oid, hyp in objects:
                    if hyp is None:
                        miss[k] += 1
                        continue
                    n_match += 1
                    prev = last_assoc[k].get(oid)
                    if prev is not None and prev != hyp:
                        switches[k] += 1
                    last_assoc[k][oid] = hyp
                fp[k] += n_hyp - n_match
                # attribution of the divergence term: matched poses whose
                # GT joint k is unlabeled contribute a hypothesis with no
                # object
                for gi in pose_match:
                    if not labeled_all[gi][k]:
                        fp_unlabeled[k] += 1

    per_joint_ap = np.array([
        _average_precision(joint_scores[k], joint_tp[k], joint_gt_count[k])
        for k in range(num_joints)])
    return _finalize(per_joint_ap, joint_gt_count, miss, fp, switches,
                     extra={"fp_unlabeled": int(fp_unlabeled.sum())})
