"""Export the serving clip program as a compile-once artifact.

Port of ``tools/export_program.py`` with the same arguments, but
``--device`` (default ``cuda``; ``cpu`` exports the plain versions) in
place of ``--platforms``: ``ClipTracker``'s clip program (optionally the
``--streams``-lane serving layout) exported by ``torch.export``
(``flowtrack_tpu_torch/aot.py``), written as one ``.pt2`` blob with a JSON
sidecar of its geometry. A serving process loads it with
``flowtrack_tpu_torch.aot.load_clip_program`` and passes the weights as
state dicts.

    python3 -m flowtrack_tpu_torch.tools.export_program \\
        --cfg flowtrack_posetrack --pose-weights p.npz --flow-weights f.npz \\
        --clip-len 64 --frame-size 256x192 --streams 6 --out clip_prog.pt2
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from flowtrack_tpu_torch import aot
from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.tools.common import add_device_arg, flow_net, pose_net
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default="flowtrack_posetrack")
    ap.add_argument("--pose-weights", required=True)
    ap.add_argument("--flow-weights", required=True)
    ap.add_argument("--out", required=True, help="artifact path "
                    "(a .json sidecar is written next to it)")
    ap.add_argument("--clip-len", type=int, default=64)
    ap.add_argument("--frame-size", default="256x192",
                    help="video frame HxW the artifact is specialized to")
    ap.add_argument("--streams", type=int, default=None,
                    help="export the N-stream batched serving layout "
                         "instead of the single-clip program")
    add_device_arg(ap)
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and run zero inputs through "
                         "it on --device; lists the kernels' ops it calls")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    h, w = (int(v) for v in args.frame_size.lower().split("x"))
    cfg = apply_overrides(get_config(args.cfg), args.opts)
    tracker = ClipTracker(cfg, pose_net(cfg, args.pose_weights),
                          flow_net(cfg, args.flow_weights),
                          device=args.device)

    blob = aot.export_clip_program(tracker, args.clip_len, (h, w),
                                   streams=args.streams)
    with open(args.out, "wb") as f:
        f.write(blob)
    sidecar = os.path.splitext(args.out)[0] + ".json"
    with open(sidecar, "w") as f:
        f.write(aot.artifact_meta(tracker, args.clip_len, (h, w),
                                  args.streams, tracker.device))

    checked, kernel_ops = False, None
    if args.check:
        call = aot.load_clip_program(blob)
        specs = aot.clip_arg_specs(tracker, args.clip_len, (h, w),
                                   args.streams)
        with torch.no_grad():
            out = call(*aot.zero_args(specs, tracker.device))
        checked = out[3].shape[-2] == args.clip_len
        kernel_ops = sorted(op for op in call.ops
                            if op.startswith("flowtrack."))
    info = {"out": args.out, "sidecar": sidecar, "bytes": len(blob),
            "platforms": [tracker.device.type], "streams": args.streams,
            "checked": checked, "kernel_ops": kernel_ops}
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
