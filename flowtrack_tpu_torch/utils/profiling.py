"""Tracing and stage timing.

Port of ``flowtrack_tpu/utils/profiling.py``:

* ``trace(logdir)`` (:28): ``torch.profiler`` over the host and, with a
  card, the device; the trace is written under ``logdir`` in the format
  TensorBoard's profiler plugin and Perfetto read
  (``<host>_<pid>.<time>.pt.trace.json``);
* ``annotate(name)`` (:36): a named span in that trace
  (``torch.profiler.record_function``);
* ``StageTimer`` (:78): host wall time per named stage; with ``sync`` each
  stage waits for the device work it launched;
* ``deterministic_guard`` (:130): asserts the settings that run-to-run
  repeatability rests on.

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
