"""The check fails what it must: the fp8 control, and a run whose timed
path is broken underneath (the card's look skipped, the rest of a run
driven on the CPU at a small size, held to the crowd cell's limits),
stage 1's flow among them.

A one-chip cell has no exchange between chips, so that fault has no
case here."""

import pytest
import torch

CELL = "r50c-offline-crowd"


def correct(cell, ns, readings):
    from portbench import run

    return run.result(cell, ns, readings, False, {})["correct"]


def _broken(fault):
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    real = ClipTracker.run_prepared_lanes

    @torch.inference_mode()
    def run_prepared_lanes(self, device_args, seeds=None, budget_frames=None):
        out = list(real(self, device_args, seeds, budget_frames))
        c = out[0].shape[0]
        if fault == "state_unchanged":
            empty = self.empty_seed()
            out[5] = tuple(torch.stack(leaves) for leaves in zip(
                *[empty if s is None else s for s in (seeds or [None] * c)]))
        elif fault == "half_the_batch":
            for i in range(5):
                out[i] = out[i].clone()
                out[i][c // 2:] = out[i][:1]
        elif fault == "joint_altered":
            out[0] = out[0].clone()
            out[0][0, 1, :, 0] += 12.0
        elif fault == "id_altered":
            out[3] = out[3].clone()
            out[3][0, 2] += 1
        elif fault == "recovery_left_out":
            out[4] = out[4].clone()
            out[4][:, :, self.max_persons:] = False
        return tuple(out)

    return run_prepared_lanes


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "joint_altered", "id_altered",
                                   "recovery_left_out"])
def test_a_broken_timed_path_is_not_correct(fault, tiny, run_cpu,
                                            monkeypatch):
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    monkeypatch.setattr(ClipTracker, "run_prepared_lanes", _broken(fault))
    cell = tiny(limits_of=CELL)
    ns, readings = run_cpu(cell, seconds=25.0)
    assert readings.info["videos"] >= 1
    assert not correct(cell, ns, readings), readings.values


def test_a_shifted_flow_is_not_correct(tiny, run_cpu, monkeypatch):
    """Stage 1 a pixel off (as a warp or resize off by one would leave it):
    the recovered crops move, and the flow's own numbers see it."""
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    real = ClipTracker._flows

    def flows(self, frames):
        out = real(self, frames)
        return out + torch.tensor([1.0, 0.0], device=out.device)

    monkeypatch.setattr(ClipTracker, "_flows", flows)
    ns, readings = run_cpu(tiny(limits_of=CELL), seconds=25.0)
    assert readings.info["rec_compared"] >= 1
    # held to the sparse cell's limits too, where the recovered poses' peak
    # values are not compared and the flow's numbers alone see it (the
    # FlowNet2 cell compares none of them: no upper reading, PERF.md)
    for of in (CELL, "r50c-offline-sparse"):
        cell = tiny(limits_of=of)
        limits = cell.limits["limits"]
        assert not correct(cell, ns, readings), (of, readings.values)
        assert any(limits[n] is not None and readings.values[n] > limits[n]
                   for n in ("rec_shift_share", "rec_unlocated")), (
            of, readings.values)


def test_a_sound_run_is_correct(tiny, run_cpu):
    cell = tiny(limits_of=CELL)
    ns, readings = run_cpu(cell, seconds=25.0)
    assert correct(cell, ns, readings), readings.values


def test_the_control_is_not_correct(tiny):
    from portbench import control

    cell = tiny(limits_of=CELL)
    readings = control.control_readings(cell, 41, torch.device("cpu"))
    limits = cell.limits["limits"]
    assert any(v > limits[n] for n, v in readings.values.items()
               if limits[n] is not None), readings.values


@pytest.mark.card
@pytest.mark.parametrize("workload", ["r50c-offline-crowd",
                                      "fn2-offline-posetrack",
                                      "r50c-offline-sparse"])
def test_the_control_is_not_correct_at_the_cells_size(card, workload):
    from conftest import ROOT
    from portbench import control, spec

    cell = spec.cell(ROOT, workload)
    readings = control.control_readings(cell, 2 ** 31 + 7, card)
    limits = cell.limits["limits"]
    assert any(v > limits[n] for n, v in readings.values.items()
               if limits[n] is not None), readings.values
