"""Useful model operations of the window over its seconds over the H100's
bf16 peak, in percent: each reported detection and recovered person posed
twice (the flip test), one flow pair per new frame of a video. Padded
slots are not counted. The operations per crop and per pair come from the
reference nets at the cell's shapes (``counts.py``); the window is the
traced run's, before its profiler started."""

from portbench import counts
from portbench.reference.ops import net_size


def read(run):
    useful = getattr(run, "useful", None)
    if useful is None or useful.seconds <= 0 or not useful.pose_forwards:
        return None
    net_hw = net_size(*run.traffic["frame_hw"])
    flops = (useful.pose_forwards * counts.pose_flops(run.config["model"])
             + useful.pairs * counts.flow_flops(run.config["flow"], net_hw))
    return flops / useful.seconds / counts.PEAK_BF16_FLOPS * 100.0
