"""Reading torch.profiler's trace of a run: the device's operations, how
long the device was busy, its idle gaps and what the host did in them.

A device operation is a kernel, copy or set recorded on the card; the
device-side copies of host ranges (``clip.*``, ``portbench.*``) are not
work and are left out. Times are the profiler's, in microseconds.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

RANGES = ("clip.", "portbench.")


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_ops(prof) -> list:
    """(name, start, end) of each device operation, by start."""
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(RANGES)]
    return sorted(ops, key=lambda o: o[1])


def host_range(prof, name: str) -> tuple:
    """(start, end) of the host range ``name`` (the first of that name)."""
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name == name:
            return e.time_range.start, e.time_range.end
    raise KeyError(f"no host range {name!r} in the trace")


def busy_and_gaps(ops, lo: float, hi: float) -> tuple:
    """Seconds within [lo, hi] in which some device operation ran, and the
    idle gaps (start, end) between them."""
    busy, gaps, at = 0.0, [], lo
    for _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        busy += max(0.0, e - max(s, at))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return busy / 1e6, gaps


def host_at(prof, t: float) -> str:
    """The innermost host operation or range running at time ``t``."""
    best = None
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.time_range.start <= t <= e.time_range.end
                and (best is None or e.time_range.start > best.time_range.start)):
            best = e
    return best.name if best is not None else "idle host"


def breakdown(prof, ops, gaps, top: int = 10) -> dict:
    """The device operations that took most time (by name, seconds) and the
    longest idle gaps, each named by what the host was doing at its
    middle."""
    by_name = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in heavy],
            "idle_gaps": [[host_at(prof, (a + b) / 2), (b - a) / 1e6]
                          for a, b in longest]}


def range_device_s(prof, prefix: str = "clip.") -> dict:
    """Device seconds of the kernels launched inside each host range whose
    name starts with ``prefix``."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(prefix) and e.cpu_time_total > 0:
            out[e.key] = e.device_time_total / 1e6
    return out
