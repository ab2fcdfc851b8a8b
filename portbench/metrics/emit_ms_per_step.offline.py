"""Host milliseconds a batched step of the program's span
``serving.emit`` (each lane's frames turned into track lists), per
``serving.fetch``, over the traced steps."""

from portbench import spans


def read(run):
    return spans.ms_per(run, ("serving.emit",), "serving.fetch")
