"""The program's own host spans and counters, as the per-layer metrics
read them.

The program (``flowtrack_tpu_torch.utils.profiling``) records its spans
and counters into one process-wide registry while a torch.profiler
records, so after a ``--trace 1`` run the registry holds what the traced
steps did: the last ``TRACE_S`` seconds of the window and the step that
drains the pipeline after it. One run is one process, so the registry is
the run's. A version of the program without the registry, or a run that
recorded no such name, gives None.
"""

from __future__ import annotations

from typing import Optional, Sequence


def registry() -> Optional[dict]:
    """The program's registry, ``{name: {"total_s", "count"}}``, or None
    where the program keeps none."""
    try:
        from flowtrack_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


def ms_per(run, names: Sequence[str], per: str) -> Optional[float]:
    """Host milliseconds of the spans ``names`` together, per occurrence
    of the span ``per``, in a traced run; None where there is nothing to
    read."""
    reg = registry() if getattr(run, "traced", False) else None
    if not reg or not reg.get(per, {}).get("count") \
            or any(n not in reg for n in names):
        return None
    return sum(reg[n]["total_s"] for n in names) / reg[per]["count"] * 1e3


def share(run, part: str, whole: str) -> Optional[float]:
    """The counter ``part`` over the counter ``whole``, in percent, in a
    traced run; None where there is nothing to read."""
    reg = registry() if getattr(run, "traced", False) else None
    if not reg or not reg.get(whole, {}).get("count") or part not in reg:
        return None
    return reg[part]["count"] / reg[whole]["count"] * 100.0
