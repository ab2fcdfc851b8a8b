"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed in the nearest precision below
the configuration's bfloat16, fp8 (e4m3, one scale a tensor, as fp8
inference quantizes), judged exactly as a run's outputs are. It has to
come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--out FILE]

On the card, at the cell's own size: the cell's traffic and weights of
each seed, the videos a run would judge (drawn from the seed from the
pool), every clip of each run through the fp8 reference, chained by its
seed as the tracker chains them. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

FP8_MAX = 448.0


def fp8(x):
    """``x`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def control_readings(cell, seed: int, dev):
    """The check's readings of the reference computed with ``quant`` in the
    program's place, on the videos a run of ``seed`` would judge."""
    import numpy as np

    from portbench import check, video
    from portbench.drivers import offline
    from portbench.reference.clip import ClipReference
    from portbench.reference.nets import set_quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell.traffic
    pool = video.make_videos(tr, seed, dev)
    p = cell.config["track"]["max_persons"]
    padded = [video.padded(v, p) for v in pool]
    pose_sd, flow_sd = offline.states(cell.config, seed, dev)
    nets = {}
    for name, q in (("control", fp8), ("reference", None)):
        pose, flow = offline.reference_nets(cell.config, dev)
        pose.load_state_dict(pose_sd)
        flow.load_state_dict(flow_sd)
        if q is not None:
            set_quant(pose, q)
            set_quant(flow, q)
        nets[name] = ClipReference(cell.config, pose, flow, dev)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))
    # as a run judges one video of each stream
    k = min(tr["streams"], len(pool))
    readings = check.Readings()
    clip_len = tr["clip_len"]
    for v in sorted(rng.choice(len(pool), k, replace=False)):
        boxes, scores, valid = padded[v]
        frames = pool[v].frames
        seed_v = nets["control"].empty_seed()
        clips = []
        for lo in range(0, len(frames) - 1, clip_len - 1):
            sl = slice(lo, lo + clip_len)
            out, seed_v = nets["control"].run_clip(
                torch.as_tensor(frames[sl], device=dev), boxes[sl],
                scores[sl], valid[sl], seed_v)
            clips.append(out)
        check.judge_video(nets["reference"], frames, boxes, scores, valid,
                          clips, clip_len, readings)
    return readings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from portbench import spec

    cell = spec.cell(root, args.workload)
    limits = cell.limits["limits"]
    for seed in args.seeds:
        r = control_readings(cell, seed, torch.device("cuda"))
        line = {"workload": cell.name, "seed": seed, "control": "fp8",
                "correct": all(v <= limits[n] for n, v in r.values.items()
                               if limits[n] is not None),
                "readings": r.values, "info": r.info,
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
