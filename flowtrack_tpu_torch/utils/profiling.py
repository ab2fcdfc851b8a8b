"""Tracing and stage timing.

Port of ``flowtrack_tpu/utils/profiling.py``:

* ``trace(logdir)`` (:28): ``torch.profiler`` over the host and, with a
  card, the device; the trace is written under ``logdir`` in the format
  TensorBoard's profiler plugin and Perfetto read
  (``<host>_<pid>.<time>.pt.trace.json``). The program's spans (below)
  record under it; it leaves the switch as it finds it, so a warm tracker
  keeps replaying the graph it captured;
* ``annotate(name)`` (:36): a named span in that trace
  (``torch.profiler.record_function``);
* ``StageTimer`` (:78): host wall time per named stage; with ``sync`` each
  stage waits for the device work it launched;
* ``deterministic_guard`` (:130): asserts the settings that run-to-run
  repeatability rests on.

The program's own tracing, which the reference does not have:

* ``enable()``, ``disable()``, ``enabled()``: a process-wide switch, off by
  default. On, the clip program stamps the device's clock between its
  stages (``stamp``), so its stage times survive CUDA graph capture;
* ``span(name)``: a named host span where the program works (serving's
  dispatch and fetch, the clip's host preparation, copies and replay, a
  graph's warm-up and capture). It records while the switch is on or a
  torch.profiler is recording: it then enters ``record_function(name)``, so
  the span lies in the profiler's trace on the device's timeline, and adds
  its host seconds to one process-wide ``StageTimer``. Otherwise it is a
  shared no-op context that reads no clock;
* ``count(name, n)`` and ``add(name, seconds)``: counters and device
  seconds in the same registry, under the same rule;
* ``snapshot()``: a copy of the registry, ``{name: {"total_s", "count"}}``;
  the difference of two snapshots is what happened between them.

Names: ``serving.dispatch`` (``serving.stack``, ``clip.host_lanes``,
``clip.put_lanes``, ``clip.replay``), ``serving.fetch`` (``clip.to_host``,
``serving.emit``), ``graphs.warmup``, ``graphs.capture``; counters
``graphs.captures``, ``pose.forwards`` and ``pose.useful`` (pose rows run
and rows that hold a reported person, flip test counted twice),
``pose.bucket.<Pb>`` (clip batches prepared whose first pose pass runs Pb
slots a frame, ``ClipTracker.host_lanes``),
``device.frames`` (new frames fetched); device seconds
``device.clip.<stage>`` from the stamps (``ClipTracker.STAGES``).

The reference's persistent XLA compile cache (:40, :61) has no counterpart:
eager PyTorch compiles nothing, and the kernels are built once into
``build/`` (``kernels/__init__.py``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import record_function


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


def _cuda_devices(outputs) -> set:
    devices = set()
    for out in outputs:
        if isinstance(out, torch.Tensor):
            if out.is_cuda:
                devices.add(out.device)
        elif isinstance(out, dict):
            devices |= _cuda_devices(out.values())
        elif isinstance(out, (list, tuple)):
            devices |= _cuda_devices(out)
    return devices


class StageTimer:
    """Wall time per named stage.

    With ``sync=True`` a stage is charged until the device work it launched
    has finished, not the microseconds its launches take: append the
    stage's outputs to the list the context manager yields
    (``with t.stage("pose") as out: out.append(f(x))``) and the stage waits
    on each CUDA device they lie on; with no outputs it waits on the
    current CUDA device, if CUDA is in use. On the CPU there is nothing to
    wait for."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        outputs: list = []
        t0 = time.perf_counter()
        yield outputs
        if self.sync:
            devices = _cuda_devices(outputs)
            if not outputs and torch.cuda.is_initialized():
                devices = {torch.device("cuda", torch.cuda.current_device())}
            for device in devices:
                torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000.0 * self.totals[k] /
                               max(self.counts[k], 1)}
                for k in self.totals}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


_ON = False
_REGISTRY = StageTimer()
_IDLE = contextlib.nullcontext()


def enable() -> None:
    """Turn the program's tracing on: spans, counters and the clip's
    stamps (the switch is part of a clip graph's key, so a tracker runs a
    graph with the stamps, captured at its first use)."""
    global _ON
    _ON = True


def disable() -> None:
    """Turn the program's tracing off (spans still record while a
    torch.profiler records)."""
    global _ON
    _ON = False


def enabled() -> bool:
    """The switch: whether the clip program stamps its stages."""
    return _ON


def recording() -> bool:
    """Whether spans and counters record: the switch is on, or a
    torch.profiler is recording (an operator's own profile then carries
    the program's spans)."""
    return _ON or torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def _span(name: str):
    with record_function(name), _REGISTRY.stage(name):
        yield


def span(name: str):
    """A named host span (see the module docstring); a no-op unless
    ``recording()``."""
    return _span(name) if recording() else _IDLE


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while ``recording()``."""
    if recording():
        _REGISTRY.totals[name] += 0.0
        _REGISTRY.counts[name] += int(n)


def add(name: str, seconds: float) -> None:
    """Add ``seconds`` (measured elsewhere, e.g. on the device) to
    ``name`` as one more occurrence, while ``recording()``."""
    if recording():
        _REGISTRY.totals[name] += float(seconds)
        _REGISTRY.counts[name] += 1


def snapshot() -> Dict[str, Dict[str, float]]:
    """A copy of the registry: ``{name: {"total_s", "count"}}``."""
    return {k: {"total_s": _REGISTRY.totals[k],
                "count": _REGISTRY.counts[k]} for k in list(_REGISTRY.totals)}


def stamps(n: int, device) -> Optional[torch.Tensor]:
    """A buffer of ``n`` device clock readings for ``stamp`` while the
    switch is on, else None."""
    return torch.empty(n, dtype=torch.int64, device=device) if _ON else None


def stamp(buf: Optional[torch.Tensor], i: int) -> None:
    """Write the device's clock, in ns, into ``buf[i]`` once the work queued
    before it on the current stream has run (``flowtrack::stamp``); nothing
    for ``buf`` None."""
    if buf is not None:
        torch.ops.flowtrack.stamp(buf, i)


def stamp_cuda(buf: torch.Tensor, i: int) -> None:
    """Launch the stamp kernel: one thread writes ``%globaltimer`` into
    ``buf[i]`` (int64, contiguous, on a CUDA device) on the current
    stream, in a CUDA graph as well."""
    from flowtrack_tpu_torch import kernels

    if (buf.device.type != "cuda" or buf.dtype != torch.int64
            or not buf.is_contiguous() or not 0 <= i < buf.numel()):
        raise ValueError(f"stamp needs a contiguous int64 CUDA buffer and an "
                         f"index in it, got {buf.dtype} {tuple(buf.shape)} "
                         f"on {buf.device}, index {i}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device):
        err = kernels.library().ft_stamp(buf.data_ptr(), i, stream)
    kernels.check(err, "stamp")


@torch.library.custom_op("flowtrack::stamp", mutates_args=("buf",),
                         device_types=("cpu", "cuda"))
def _stamp_op(buf: torch.Tensor, i: int) -> None:
    if buf.device.type != "cpu":
        stamp_cuda(buf, i)
    else:
        # the plain version: the host's clock, as the eager program runs
        buf[i] = time.perf_counter_ns()


@_stamp_op.register_fake
def _(buf, i):
    return None


def deterministic_guard():
    """Assert the settings that make two runs of the port's inference, on
    the same inputs on the same card, give the same bits; change none.

    * ``torch.backends.cudnn.benchmark`` is off: on, cuDNN picks each
      convolution's algorithm by timing candidates, so two runs may take
      different algorithms, which sum in different orders;
    * the hand-written kernels (crop, correlation, warp, fused stage) and
      the plain versions have no atomics in their forwards, and the seeds
      of every random weight and data stream are explicit generators.

    Training on the card is not bitwise repeatable under these settings:
    cuDNN's backward algorithms and the warp's plain backward
    (``scatter_add_``) add with atomics. ``torch.use_deterministic_algorithms``
    is the switch for that; the guard does not require it."""
    assert not torch.backends.cudnn.benchmark, (
        "cudnn.benchmark picks convolution algorithms by timing, which "
        "breaks run-to-run repeatability")
    return True
