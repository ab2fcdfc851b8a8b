"""FlowTrack over PoseTrack sequences: detections and frames -> flow
propagation -> pose -> greedy OKS ids -> PoseTrack json, mAP and MOTA.

Port of ``tools/track.py`` (detections and ``collect_sequence`` :35-78,
``track_all`` :80, ``track_all_clips`` :103, ``main`` :145), with the same
arguments but the XLA compile cache's, and ``--device`` (default
``cuda``). ``--engine stream`` runs the per-frame ``FlowTracker`` over
``PosePredictor`` (the crop kernel on the card) and ``FlowPredictor`` (the
correlation kernel under FlowNetC); ``--engine clip`` runs ``ClipTracker``
over overlapping clips (``utils/video.track_video_clips``) of frames read
as they are needed. It writes ``tracks.json`` and prints the evaluator's
scalar stats as one json line.

    python3 -m flowtrack_tpu_torch.tools.track --pose-weights pose.npz \\
        --flow-weights flow.npz data.root=data/posetrack [--engine clip]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from collections import defaultdict
from dataclasses import replace
from types import SimpleNamespace

import numpy as np

from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.data import PoseTrackDataset
from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.eval.posetrack_eval import (evaluate_posetrack,
                                                     evaluate_posetrack_mot)
from flowtrack_tpu_torch.pipeline import FlowPredictor, PosePredictor
from flowtrack_tpu_torch.tools.common import add_device_arg, flow_net, pose_net
from flowtrack_tpu_torch.tracking import FlowTracker
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
from flowtrack_tpu_torch.tracking.tracker import tracks_to_posetrack_json
from flowtrack_tpu_torch.utils.logging import setup_logging
from flowtrack_tpu_torch.utils.video import (LazyFrameSequence,
                                             track_video_clips)

log = logging.getLogger("flowtrack.track")


def load_detections(path):
    """detection json -> image_id -> (boxes xywh, scores)."""
    with open(path) as f:
        dets = json.load(f)
    by_img = defaultdict(lambda: ([], []))
    for d in dets:
        if d.get("category_id", 1) != 1:
            continue
        by_img[d["image_id"]][0].append(d["bbox"])
        by_img[d["image_id"]][1].append(d.get("score", 1.0))
    return {k: (np.asarray(b, np.float32), np.asarray(s, np.float32))
            for k, (b, s) in by_img.items()}


def gt_detections(dataset, image_id):
    anns = dataset.frame_annotations(image_id)
    boxes, scores = [], []
    for a in anns:
        if a["bbox"] is not None:
            boxes.append(a["bbox"])
            scores.append(1.0)
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(scores, np.float32))


def frame_detections(dataset, image_id, detections):
    if detections is not None:
        return detections.get(image_id, (np.zeros((0, 4), np.float32),
                                         np.zeros((0,), np.float32)))
    return gt_detections(dataset, image_id)


def collect_sequence(per_frame, frame_ids, dataset):
    """Tracker output -> (pred_seq for the evaluator, gt_seq)."""
    pred_seq, gt_seq = [], []
    for image_id, tracks in zip(frame_ids, per_frame):
        pred_seq.append([
            {"track_id": t.track_id,
             "keypoints": np.concatenate(
                 [t.joints, t.maxvals[:, None]], axis=1),
             "score": t.score} for t in tracks])
        gt_seq.append(dataset.frame_annotations(image_id))
    return pred_seq, gt_seq


def track_all(cfg, dataset, pose_pred, flow_pred, detections=None,
              max_frames=None, device="cuda"):
    """Run the streaming tracker over every sequence; returns
    (pred_sequences, gt_sequences, all PoseTrack-format annotations)."""
    pred_sequences, gt_sequences, all_json = [], [], []
    for vid, frame_ids in sorted(dataset.sequences().items()):
        if max_frames:
            frame_ids = frame_ids[:max_frames]
        tracker = FlowTracker(cfg=cfg, pose_fn=pose_pred, flow_fn=flow_pred,
                              device=device)
        per_frame = []
        for image_id in frame_ids:
            img = load_image(dataset.frame_path(image_id))
            boxes, scores = frame_detections(dataset, image_id, detections)
            per_frame.append(list(tracker.step(img, boxes, scores)))
        all_json += tracks_to_posetrack_json(per_frame, frame_ids)

        pred_seq, gt_seq = collect_sequence(per_frame, frame_ids, dataset)
        pred_sequences.append(pred_seq)
        gt_sequences.append(gt_seq)
        log.info("sequence %s: %d frames tracked", vid, len(frame_ids))
    return pred_sequences, gt_sequences, all_json


def track_all_clips(dataset, clip_tracker, detections=None,
                    max_frames=None, clip_len=16):
    """The clip engine's ``track_all``: each sequence runs through the
    ClipTracker over overlapping clips with the cross-clip seed
    (``utils/video.track_video_clips``). The same outputs, so the evaluator
    and the json writer are shared with the streaming engine. Frames load
    a clip window at a time (LazyFrameSequence)."""
    pred_sequences, gt_sequences, all_json = [], [], []
    for vid, frame_ids in sorted(dataset.sequences().items()):
        if max_frames:
            frame_ids = frame_ids[:max_frames]
        frames = LazyFrameSequence(
            [dataset.frame_path(i) for i in frame_ids])
        det_boxes, det_scores = [], []
        for image_id in frame_ids:
            boxes, scores = frame_detections(dataset, image_id, detections)
            det_boxes.append([np.asarray(b, np.float32) for b in boxes])
            det_scores.append([float(s) for s in scores])
        results = track_video_clips(clip_tracker, frames, det_boxes,
                                    det_scores, clip_len=clip_len)
        per_frame = [[SimpleNamespace(track_id=p["track_id"],
                                      joints=np.asarray(p["joints"]),
                                      maxvals=np.asarray(p["maxvals"]),
                                      score=p["score"]) for p in fr]
                     for fr in results]
        all_json += tracks_to_posetrack_json(per_frame, frame_ids)

        pred_seq, gt_seq = collect_sequence(per_frame, frame_ids, dataset)
        pred_sequences.append(pred_seq)
        gt_sequences.append(gt_seq)
        log.info("sequence %s: %d frames tracked (clip engine)", vid,
                 len(frame_ids))
    return pred_sequences, gt_sequences, all_json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="flowtrack_posetrack")
    ap.add_argument("--pose-weights", required=True)
    ap.add_argument("--flow-weights", default=None)
    ap.add_argument("--detections", default=None,
                    help="detection json (default: GT boxes)")
    ap.add_argument("--out", default="output/track")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--engine", choices=("stream", "clip"),
                    default="stream",
                    help="stream: the per-frame FlowTracker loop; clip: "
                         "ClipTracker over overlapping clips with "
                         "cross-clip id carry (requires --flow-weights)")
    ap.add_argument("--clip-len", type=int, default=16,
                    help="frames per clip for --engine clip (>= 2: clips "
                         "overlap by one frame)")
    ap.add_argument("--eval-backend", choices=("direct", "mot"),
                    default="direct",
                    help="MOTA formulation: direct per-frame accounting or"
                         " the motmetrics-accumulator event streams "
                         "(see eval/posetrack_eval.py)")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    setup_logging()

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    if not cfg.test.bbox_file:
        # the tracker takes the detections itself; the dataset supplies
        # frames and the ground truth
        cfg = replace(cfg, test=replace(cfg.test, use_gt_bbox=True))
    dataset = PoseTrackDataset(cfg, cfg.data.root, cfg.data.test_set,
                               is_train=False)

    pose = pose_net(cfg, args.pose_weights)
    flow = flow_net(cfg, args.flow_weights) if args.flow_weights else None

    detections = load_detections(args.detections) if args.detections else None
    if args.engine == "clip":
        if flow is None:
            ap.error("--engine clip requires --flow-weights")
        if args.clip_len < 2:
            ap.error("--clip-len must be >= 2 (clips overlap by 1 frame)")
        clip_tracker = ClipTracker(cfg, pose, flow, device=args.device)
        preds, gts, ann_json = track_all_clips(
            dataset, clip_tracker, detections, args.max_frames,
            clip_len=args.clip_len)
    else:
        pose_pred = PosePredictor(cfg, pose, device=args.device)
        flow_pred = (FlowPredictor(cfg, flow, device=args.device)
                     if flow is not None else None)
        preds, gts, ann_json = track_all(cfg, dataset, pose_pred, flow_pred,
                                         detections, args.max_frames,
                                         device=args.device)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "tracks.json"), "w") as f:
        json.dump({"annotations": ann_json}, f)
    eval_fn = (evaluate_posetrack_mot if args.eval_backend == "mot"
               else evaluate_posetrack)
    stats = eval_fn(gts, preds)
    log.info("PoseTrack: mAP %.4f MOTA %.4f (switches %d, misses %d, "
             "fps %d)", stats["mAP"], stats["MOTA"], stats["num_switches"],
             stats["num_misses"], stats["num_fps"])
    print(json.dumps({k: v for k, v in stats.items()
                      if not hasattr(v, "shape")}))
    return stats


if __name__ == "__main__":
    main()
