"""Share of the pose rows the program ran that held a reported person, in
percent: its counters ``pose.useful`` (each lane's detections and valid
recovered slots from its first new frame on, the useful work
``mfu.offline`` counts) over ``pose.forwards`` (every row of both pose
passes, padded slots and the recovery budget included), both with the
flip test's second half, over the batches fetched in the traced steps."""

from portbench import spans


def read(run):
    return spans.share(run, "pose.useful", "pose.forwards")
