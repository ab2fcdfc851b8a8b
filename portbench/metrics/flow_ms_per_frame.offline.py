"""Device milliseconds of stage 1 (the ``clip.flow`` range) per new frame,
in one clip of the traced run's batch on the eager route."""


def read(run):
    stages = getattr(run, "stage_s", None)
    if not stages or "clip.flow" not in stages:
        return None
    return stages["clip.flow"] * 1e3 / run.stage_frames
