"""Kernel K1's share of its roofline in the traced steps, in percent: the
least time of the useful work (each frame that gives a crop read once as
uint8, each reported detection's and recovered person's crop written
once) at the H100's memory rate, over the device time of the crop
kernels of those steps (two launches a step: the detections, then the
recovered boxes)."""

import re

from portbench import counts

KERNEL = re.compile(r"\bcrop_band_kernel\b")


def read(run):
    batches = getattr(run, "traced_batches", None)
    if not batches:
        return None
    p = run.config["track"]["max_persons"]
    frames = crops = 0
    for det_valid, out in batches:
        rec = out["valid"][..., p:]
        frames += int(det_valid.any(-1).sum()) + int(rec.any(-1).sum())
        crops += int(det_valid.sum()) + int(rec.sum())
    times = [(e - s) / 1e6 for name, s, e in run.trace_ops
             if KERNEL.search(name)][-2 * len(batches):]
    if len(times) < 2 * len(batches) or not crops:
        return None
    out_bytes = 2 if run.config["model"]["dtype"] == "bfloat16" else 4
    bound = counts.crop_bound_s(frames, crops, run.traffic["frame_hw"],
                                run.config["model"]["image_size"], out_bytes)
    return bound / sum(times) * 100.0
