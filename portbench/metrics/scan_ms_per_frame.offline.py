"""Device milliseconds of the recovery and id scans (the
``clip.recovery_scan`` and ``clip.id_scan`` ranges) per new frame, in one
clip of the traced run's batch on the eager route."""


def read(run):
    stages = getattr(run, "stage_s", None)
    names = ("clip.recovery_scan", "clip.id_scan")
    if not stages or not all(n in stages for n in names):
        return None
    return sum(stages[n] for n in names) * 1e3 / run.stage_frames
