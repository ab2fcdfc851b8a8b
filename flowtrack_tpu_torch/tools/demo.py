"""Single-image pose demo: person boxes (json) + image -> PosePredictor ->
skeletons drawn on the image.

Port of ``tools/demo.py`` (``main`` :25), with the same arguments but the
XLA compile cache's, and ``--device`` (default ``cuda``). Prints the
persons, their rescored scores and the output path as one json line.

    python3 -m flowtrack_tpu_torch.tools.demo --weights pose.npz \\
        --image img.png --boxes boxes.json --out demo_out.png
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.pipeline import PosePredictor
from flowtrack_tpu_torch.tools.common import add_device_arg, pose_net
from flowtrack_tpu_torch.utils.vis import draw_skeleton, save_image


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="coco_res50_256x192")
    ap.add_argument("--weights", required=True,
                    help=".npz variables of the JAX package or a torch "
                         ".pth state dict")
    ap.add_argument("--image", required=True)
    ap.add_argument("--boxes", required=True,
                    help="json: [[x, y, w, h], ...] or detection dicts")
    ap.add_argument("--out", default="demo_out.png")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    img = load_image(args.image)
    with open(args.boxes) as f:
        raw = json.load(f)
    if raw and isinstance(raw[0], dict):
        boxes = np.asarray([d["bbox"] for d in raw], np.float32)
        scores = np.asarray([d.get("score", 1.0) for d in raw], np.float32)
    else:
        boxes = np.asarray(raw, np.float32).reshape(-1, 4)
        scores = np.ones(len(boxes), np.float32)

    predictor = PosePredictor(cfg, pose_net(cfg, args.weights),
                              device=args.device)
    joints, maxvals, rescored = predictor(img, boxes, scores)

    canvas = img.copy()
    for i in range(len(joints)):
        draw_skeleton(canvas, joints[i], maxvals[i],
                      thresh=cfg.test.in_vis_thre, track_id=i)
    save_image(args.out, canvas)
    out = {"persons": len(joints), "scores": [float(s) for s in rescored],
           "out": args.out}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
