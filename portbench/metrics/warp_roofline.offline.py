"""Kernels K3/K4's share of their roofline in the traced steps, in
percent: each of the cascade's four dense warps a frame pair reads its
float32 image and flow once and writes its image once at the net's input
size (the flow module's ``net_input``), at the memory rate, over the
device time of the warp kernels (four launches a step)."""

import re

from portbench import counts, spec

KERNEL = re.compile(r"\bresample2d_kernel\b")
WARPS_PER_PAIR = 4


def read(run):
    batches = getattr(run, "traced_batches", None)
    if not batches:
        return None
    times = [(e - s) / 1e6 for name, s, e in run.trace_ops
             if KERNEL.search(name)][-WARPS_PER_PAIR * len(batches):]
    if len(times) < WARPS_PER_PAIR * len(batches):
        return None
    pairs = sum(dv.shape[0] * (dv.shape[1] - 1) for dv, _ in batches)
    net_hw = spec.reference(run.config, "flow").net_input(
        run.config, run.traffic["frame_hw"])[-2:]
    return counts.warp_bound_s(WARPS_PER_PAIR * pairs, net_hw) \
        / sum(times) * 100.0
