"""Device milliseconds of stage 2 and the recovery's pose pass (the
``clip.pose`` and ``clip.recovery_pose`` ranges) per new frame, in one
clip of the traced run's batch on the eager route."""


def read(run):
    stages = getattr(run, "stage_s", None)
    names = ("clip.pose", "clip.recovery_pose")
    if not stages or not all(n in stages for n in names):
        return None
    return sum(stages[n] for n in names) * 1e3 / run.stage_frames
