"""Clip-batched video tracking: video or frame directory + detection json ->
ClipTracker over overlapping clips with cross-clip ids -> PoseTrack-style
json (and skeleton renders with ``--render``).

Port of ``tools/track_video.py`` (``load_stream`` :40,
``track_streams_batched`` :62, ``main`` :96, ``write_outputs`` :162), with
the same arguments but the XLA compile cache's, and ``--device`` (default
``cuda``). More than one ``--video`` runs the streams as lanes of one
batched run a step (``serving.MultiStreamTracker``).

    python3 -m flowtrack_tpu_torch.tools.track_video --pose-weights pose.npz \\
        --flow-weights flow.npz --video frames/ --detections dets.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.serving import MultiStreamTracker
from flowtrack_tpu_torch.tools.common import add_device_arg, flow_net, pose_net
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
from flowtrack_tpu_torch.utils.logging import setup_logging
from flowtrack_tpu_torch.utils.video import (
    LazyFrameSequence,
    SequentialVideoFrames,
    frame_paths,
    iter_video_frames,
    track_video_clips,
)
from flowtrack_tpu_torch.utils.vis import draw_skeleton, save_image

log = logging.getLogger("flowtrack.track_video")


def load_stream(video_path: str, det_path: str):
    """One stream's (lazy frames, det_boxes, det_scores)."""
    # frame directories index at random, video files decode forward; both
    # hold about one clip window in host memory
    if os.path.isdir(video_path):
        frames = LazyFrameSequence(frame_paths(video_path))
    else:
        try:
            frames = SequentialVideoFrames(video_path)
        except ValueError as e:  # no usable frame-count metadata
            log.warning("%s; loading eagerly", e)
            frames = np.stack(list(iter_video_frames(video_path)))
    with open(det_path) as f:
        dets = json.load(f)  # list per frame: [{bbox, score}, ...]
    det_boxes = [[d["bbox"] for d in fr] for fr in dets]
    det_scores = [[d.get("score", 1.0) for d in fr] for fr in dets]
    if len(det_boxes) != len(frames):
        raise ValueError(f"{det_path}: {len(det_boxes)} det frames vs "
                         f"{len(frames)} video")
    return frames, det_boxes, det_scores


def track_streams_batched(tracker, streams, clip_len: int):
    """Several videos as lanes of one batched run a step
    (serving.MultiStreamTracker): per-stream results in the
    track_video_clips format."""
    mst = MultiStreamTracker(tracker, clip_len=clip_len,
                             batch_streams=len(streams))
    results = {sid: [None] * len(frames)
               for sid, (frames, _, _) in streams.items()}
    emitted = []
    t = 0
    while True:
        fed = False
        for sid, (frames, db, dsc) in streams.items():
            if t < len(frames):
                mst.submit(sid, frames[[t]][0], db[t], dsc[t])
                fed = True
        if not fed:
            break
        # force once any stream has run out: unequal lengths must not
        # starve the batch
        emitted += mst.step(force=any(t + 1 >= len(f)
                                      for f, _, _ in streams.values()))
        t += 1
    emitted += mst.drain()  # remaining full clips + ragged tails
    for sid, first, tracks in emitted:
        for i, fr in enumerate(tracks):
            results[sid][first + i] = fr
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="flowtrack_posetrack")
    ap.add_argument("--pose-weights", required=True)
    ap.add_argument("--flow-weights", required=True)
    ap.add_argument("--video", required=True, nargs="+",
                    help="video file(s) or director(ies) of frames; more "
                         "than one = multi-stream serving (the videos' "
                         "clips batched as lanes of one run)")
    ap.add_argument("--detections", required=True, nargs="+",
                    help="per-video json: per-frame list of {bbox, score}")
    ap.add_argument("--out", default="output/video")
    ap.add_argument("--clip-len", type=int, default=16)
    ap.add_argument("--render", action="store_true")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    setup_logging()
    if len(args.video) != len(args.detections):
        raise SystemExit("--video and --detections counts must match")

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    tracker = ClipTracker(cfg, pose_net(cfg, args.pose_weights),
                          flow_net(cfg, args.flow_weights),
                          device=args.device)

    if len(args.video) > 1:
        streams = {}
        for i, (v, d) in enumerate(zip(args.video, args.detections)):
            sid = os.path.basename(os.path.normpath(v)) or f"s{i}"
            if sid in streams:  # same filename under different dirs
                sid = f"{sid}.{i}"
            streams[sid] = load_stream(v, d)
        per_stream = track_streams_batched(tracker, streams, args.clip_len)
        total = 0
        for sid, results in per_stream.items():
            frames = streams[sid][0]
            out_dir = os.path.join(args.out, sid)
            total += write_outputs(cfg, frames, results, out_dir,
                                   args.render)
        out = {"streams": len(per_stream), "instances": total}
        print(json.dumps(out))
        return out

    frames, det_boxes, det_scores = load_stream(args.video[0],
                                                args.detections[0])
    results = track_video_clips(tracker, frames, det_boxes, det_scores,
                                clip_len=args.clip_len)

    n = write_outputs(cfg, frames, results, args.out, args.render)
    out = {"frames": len(frames), "instances": n,
           "tracks": len({p["track_id"] for fr in results for p in fr})}
    print(json.dumps(out))
    return out


def write_outputs(cfg, frames, results, out_dir: str,
                  render: bool) -> int:
    """tracks.json (and the skeleton renders) of one stream; returns the
    pose-instance count."""
    os.makedirs(out_dir, exist_ok=True)
    out_json = []
    for t, poses in enumerate(results):
        for p in poses:
            kp = []
            for (x, y), v in zip(p["joints"], p["maxvals"]):
                kp += [float(x), float(y), float(v)]
            out_json.append({"frame": t, "track_id": p["track_id"],
                             "keypoints": kp, "score": p["score"]})
    with open(os.path.join(out_dir, "tracks.json"), "w") as f:
        json.dump(out_json, f)
    log.info("%d frames, %d pose instances -> %s", len(frames),
             len(out_json), out_dir)
    if render:
        for t, poses in enumerate(results):
            canvas = frames[[t]][0].astype(np.uint8).copy()
            for p in poses:
                draw_skeleton(canvas, p["joints"], p["maxvals"],
                              cfg.test.in_vis_thre, p["track_id"])
            save_image(os.path.join(out_dir, f"{t:06d}.png"), canvas)
    return len(out_json)


if __name__ == "__main__":
    main()
