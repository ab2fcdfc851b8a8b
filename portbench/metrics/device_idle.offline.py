"""Share of the traced steps' wall time in which no device operation ran,
in percent."""


def read(run):
    window = getattr(run, "trace_window_s", 0.0)
    if window <= 0:
        return None
    return (1.0 - run.busy_s / window) * 100.0
