"""Kernel K2's share of its roofline in the traced steps, in percent: the
larger of the cost volumes' operations at the bf16 peak and their bytes
(two bf16 feature maps in, the float32 volume out) at the memory rate,
for every frame pair of the steps, over the device time of the
correlation kernels (one launch a step). The volume's shape is the flow
module's (``cost_volume``), asked only where the kernel ran."""

import re

from portbench import counts, spec

KERNEL = re.compile(r"\bcorrelation(_mma)?_kernel\b")


def read(run):
    batches = getattr(run, "traced_batches", None)
    if not batches:
        return None
    times = [(e - s) / 1e6 for name, s, e in run.trace_ops
             if KERNEL.search(name)][-len(batches):]
    if len(times) < len(batches):
        return None
    pairs = sum(dv.shape[0] * (dv.shape[1] - 1) for dv, _ in batches)
    volume = spec.reference(run.config, "flow").cost_volume(
        run.config, run.traffic["frame_hw"])
    return counts.corr_bound_s(volume, pairs) / sum(times) * 100.0
