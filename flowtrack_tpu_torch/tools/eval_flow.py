"""Optical-flow inference and end-point-error evaluation over a directory
of frames.

Port of ``tools/eval_flow.py`` (``main`` :31), with the same arguments but
the XLA compile cache's, and ``--device`` (default ``cuda``):
``FlowPredictor`` on consecutive frame pairs (the correlation kernel under
FlowNetC, the warp under a FlowNet2 variant), then the EPE / 1px / 3px / Fl
statistics against ``--gt-flow`` (``eval/flow_eval.py``), the predicted
flow as ``.flo`` files with ``--save-flo``, and color-wheel renders with
``--render``.

    python3 -m flowtrack_tpu_torch.tools.eval_flow --weights flow.npz \\
        --frames frames/ --gt-flow flo/ [--cfg flownet_c]
"""

from __future__ import annotations

import argparse
import json
import os

from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.eval.flow_eval import (evaluate_flow_pairs, read_flo,
                                                write_flo)
from flowtrack_tpu_torch.pipeline import FlowPredictor
from flowtrack_tpu_torch.tools.common import add_device_arg, flow_net
from flowtrack_tpu_torch.utils.video import IMG_EXTS
from flowtrack_tpu_torch.utils.vis import flow_to_color, save_image


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="flownet_s")
    ap.add_argument("--weights", required=True,
                    help=".npz variables of the JAX package or a torch "
                         ".pth state dict")
    ap.add_argument("--frames", required=True,
                    help="directory of ordered frames")
    ap.add_argument("--gt-flow", default=None,
                    help="directory of .flo files (one per pair, sorted); "
                         "omit for pure inference with --save-flo")
    ap.add_argument("--save-flo", default=None,
                    help="write predicted flow per pair as .flo here")
    ap.add_argument("--render", action="store_true",
                    help="with --save-flo: also write Middlebury "
                         "color-wheel .png renders")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    if not args.gt_flow and not args.save_flo:
        ap.error("nothing to do: pass --gt-flow (evaluate) and/or "
                 "--save-flo (inference)")

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    predictor = FlowPredictor(cfg, flow_net(cfg, args.weights),
                              device=args.device)

    frame_files = sorted(
        f for f in os.listdir(args.frames)
        if f.lower().endswith(IMG_EXTS))
    if not frame_files:
        ap.error(f"no frame images ({'/'.join(IMG_EXTS)}) in {args.frames}")
    flo_files = None
    if args.gt_flow:
        flo_files = sorted(f for f in os.listdir(args.gt_flow)
                           if f.endswith(".flo"))
        if len(flo_files) != len(frame_files) - 1:
            ap.error(f"{len(flo_files)} .flo files for {len(frame_files)} "
                     "frames")
    if args.save_flo:
        os.makedirs(args.save_flo, exist_ok=True)

    preds, gts = [], []
    prev = load_image(os.path.join(args.frames, frame_files[0]))
    for i in range(len(frame_files) - 1):
        cur = load_image(os.path.join(args.frames, frame_files[i + 1]))
        pred = predictor(prev, cur).float().cpu().numpy()
        if args.save_flo:
            stem = os.path.splitext(frame_files[i])[0]
            write_flo(os.path.join(args.save_flo, f"{stem}.flo"), pred)
            if args.render:
                save_image(os.path.join(args.save_flo, f"{stem}.png"),
                           flow_to_color(pred))
        if flo_files is not None:
            preds.append(pred)
            gts.append(read_flo(os.path.join(args.gt_flow, flo_files[i])))
        prev = cur

    out = {"metric": "flow_epe", "pairs": len(frame_files) - 1}
    if flo_files is not None:
        out.update(evaluate_flow_pairs(preds, gts))
    if args.save_flo:
        out["saved_to"] = args.save_flo
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
