"""Host milliseconds of each call to ``ClipTracker.prepare_lanes`` in the
window (stacking, padding, the copies to the device), per batched step:
the benchmark's own span around the tracker's public call."""


def read(run):
    if not run.prepare_s:
        return None
    return sum(run.prepare_s) / len(run.prepare_s) * 1e3
