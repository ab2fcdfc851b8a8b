"""Ahead-of-time export of the clip program (``torch.export``).

Port of ``flowtrack_tpu/aot.py`` (:37-104): ``ClipTracker._clip``, one clip
or the ``streams``-lane serving layout, traced once by ``torch.export`` for
one geometry and saved as an ``ExportedProgram`` (``.pt2`` bytes) that a
serving process loads and calls without the tracker's Python.

* Weights stay call arguments, as in the reference: the program takes the
  pose and flow nets' state dicts (``module.state_dict()``) as its first two
  arguments and runs the nets through ``torch.func.functional_call``, so one
  artifact serves any weights of the same architecture and holds none.
* Shapes are static: one artifact per (clip length, frame H x W, person
  padding, optional stream count) geometry; a call of another shape raises.
  The pose pass runs every person slot: prepare a call's arguments with
  ``ClipTracker.prepare(..., slots=max_persons)``, not at the bucket of
  the clip's boxes.
* The port's kernels appear in the program as their custom ops
  (``torch.ops.flowtrack.crop_frames``, ``correlation``, ``resample2d``,
  ``fused_stage``), not as their plain versions: an artifact exported on
  the card launches the kernels when it runs there, and one exported on
  the CPU runs the plain versions.
* The reference's ``platforms=`` is the device of the example inputs here:
  ``device``, by default the tracker's, recorded in the sidecar's
  ``platforms``.
"""

from __future__ import annotations

import io
import json
from typing import Optional, Tuple

import numpy as np
import torch

# the kernels' custom ops must be registered before a program that calls
# them is loaded
from flowtrack_tpu_torch.ops import correlation, crop, fused_resnet, warp  # noqa: F401


class _Nets(torch.nn.Module):
    """The tracker's two nets as submodules, whose forward is the clip
    program, for ``functional_call`` to swap their weights."""

    def __init__(self, tracker):
        super().__init__()
        self.pose = tracker.pose_model
        self.flow = tracker.flow_model
        self.clip = tracker._clip

    def forward(self, *args):
        return self.clip(*args)


class ClipProgram(torch.nn.Module):
    """``(pose_weights, flow_weights, *prepared, *seed)`` -> the clip
    program's (preds, maxvals, scores, ids, valid, seed_out), with a
    leading lane axis when ``streams`` is given, without one otherwise. The
    nets are kept out of this module's state, so an export holds no
    weights."""

    def __init__(self, tracker, streams: Optional[int] = None):
        super().__init__()
        self._nets = (_Nets(tracker),)
        self.streams = streams

    def forward(self, pose_weights, flow_weights, *args):
        weights = {**{f"pose.{k}": v for k, v in pose_weights.items()},
                   **{f"flow.{k}": v for k, v in flow_weights.items()}}
        if self.streams is None:
            args = tuple(a[None] for a in args)
        out = torch.func.functional_call(self._nets[0], weights, args)
        if self.streams is None:
            out = (*(x[0] for x in out[:5]), tuple(s[0] for s in out[5]))
        return out


def clip_arg_specs(tracker, clip_len: int, frame_hw: Tuple[int, int],
                   streams: Optional[int] = None):
    """The clip program's argument list as meta tensors (shape and dtype):
    (pose state dict, flow state dict, 7 prepared clip args, 6 seed
    leaves), the prepared args from running the real ``prepare`` (or
    ``prepare_lanes``) on zero inputs, so that padding and layout cannot
    drift from production; the person padding is the tracker's own
    ``max_persons``, for the pose pass too (``slots``): a program takes any
    count of persons, so its callers prepare with ``slots=max_persons``."""
    h, w = frame_hw
    p = tracker.max_persons
    c = 1 if streams is None else streams
    frames = np.zeros((c, clip_len, h, w, 3), np.float32)
    boxes = np.tile(np.asarray([0.0, 0.0, 1.0, 1.0], np.float32),
                    (c, clip_len, p, 1))
    prepared = tracker.prepare_lanes(frames, boxes,
                                     np.zeros((c, clip_len, p), np.float32),
                                     np.ones((c, clip_len, p), bool),
                                     slots=p)
    seed = [s.expand(c, *s.shape) for s in tracker.empty_seed()]
    if streams is None:
        prepared = [a[0] for a in prepared]
        seed = [s[0] for s in seed]

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    return ({k: meta(v) for k, v in tracker.pose_model.state_dict().items()},
            {k: meta(v) for k, v in tracker.flow_model.state_dict().items()},
            *(meta(a) for a in prepared), *(meta(s) for s in seed))


def _sorted(weights) -> dict:
    """A state dict as the program takes it: a plain dict, keys sorted
    (its pytree structure is part of the program's signature)."""
    return {k: weights[k] for k in sorted(weights)}


def zero_args(specs, device):
    """Zero tensors on ``device`` for ``clip_arg_specs``' specs: example
    or check inputs of the program."""
    def zero(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return tuple(_sorted({k: zero(v) for k, v in s.items()})
                 if isinstance(s, dict) else zero(s) for s in specs)


def export_clip_program(tracker, clip_len: int, frame_hw: Tuple[int, int],
                        streams: Optional[int] = None,
                        device=None) -> bytes:
    """The clip program (one clip, or the ``streams``-lane serving layout)
    for one geometry, exported by ``torch.export`` on example inputs on
    ``device`` (default: the tracker's) and saved: the ``.pt2`` bytes."""
    device = torch.device(device or tracker.device)
    example = zero_args(clip_arg_specs(tracker, clip_len, frame_hw, streams),
                     device)
    with torch.no_grad():
        exported = torch.export.export(ClipProgram(tracker, streams), example)
    # the example inputs (zero weights among them) are not saved with it
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_clip_program(blob: bytes):
    """Load an exported clip program. The callable takes the clip program's
    positional arguments ``(pose_weights, flow_weights, *prepared_args,
    *seed)``, the weights as state dicts, and raises on any other shape.
    Its ``ops`` are the names of the operators the program calls (its
    subgraphs' included), and ``exported`` the ``ExportedProgram``."""
    exported = torch.export.load(io.BytesIO(blob))
    module = exported.module()

    def call(pose_weights, flow_weights, *args):
        return module(_sorted(pose_weights), _sorted(flow_weights), *args)

    call.exported = exported
    # the nets' autocast regions are subgraphs of their own
    call.ops = {str(n.target) for gm in exported.graph_module.modules()
                if isinstance(gm, torch.fx.GraphModule)
                for n in gm.graph.nodes if n.op == "call_function"}
    return call


def artifact_meta(tracker, clip_len: int, frame_hw: Tuple[int, int],
                  streams: Optional[int], device) -> str:
    """JSON sidecar of an artifact's geometry, the reference's keys; its
    ``platforms`` is the export's device type."""
    return json.dumps({
        "program": "clip_tracker",
        "clip_len": clip_len,
        "frame_hw": list(frame_hw),
        "streams": streams,
        "platforms": [torch.device(device or tracker.device).type],
        "max_persons": tracker.max_persons,
        "num_slots": tracker.num_slots,
        "num_joints": tracker.num_joints,
        "pose": tracker.cfg.model.num_layers,
        "flow": tracker.cfg.flow.variant,
    })
