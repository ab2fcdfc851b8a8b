"""Host milliseconds a batched step of the program's spans
``serving.stack`` (the lanes' frames and detections stacked and padded)
and ``clip.host_lanes`` (centres, scales and boxes), per
``serving.dispatch``, over the traced steps."""

from portbench import spans


def read(run):
    return spans.ms_per(run, ("serving.stack", "clip.host_lanes"),
                        "serving.dispatch")
