"""The port's ``utils/profiling``: ``StageTimer`` with the reference's
summary and dump fields, ``deterministic_guard``, and ``trace`` writing a
trace file with the ``annotate`` spans in it; on the CPU (no device to
wait for)."""

import json
import os

import pytest
import torch

from flowtrack_tpu.utils import profiling as ref_profiling
from flowtrack_tpu_torch.utils import profiling


@pytest.mark.parametrize("sync", [False, True])
def test_stage_timer_matches_reference_fields(sync, tmp_path):
    """Both timers over the same stages: the same stage names, counts and
    summary keys; the totals are wall time, so only their sign is held.
    With ``sync`` the stage's outputs may be tensors, nested or none."""
    timers = {"port": profiling.StageTimer(sync=sync),
              "ref": ref_profiling.StageTimer(sync=False)}
    for t in timers.values():
        for name in ("pose", "flow", "pose"):
            with t.stage(name) as out:
                out.append({"x": [torch.ones(2)]})
        with t.stage("idle"):
            pass
    got, want = timers["port"].summary(), timers["ref"].summary()
    assert got.keys() == want.keys() == {"pose", "flow", "idle"}
    for k in want:
        assert got[k].keys() == want[k].keys() == {"total_s", "count",
                                                   "mean_ms"}
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["total_s"] >= 0
        assert got[k]["mean_ms"] == pytest.approx(
            1000 * got[k]["total_s"] / got[k]["count"])
    path = tmp_path / "stages.json"
    text = timers["port"].dump(str(path))
    assert json.loads(path.read_text()) == json.loads(text) == json.loads(
        json.dumps(got))


def test_deterministic_guard_asserts_and_changes_nothing():
    before = (torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled())
    assert profiling.deterministic_guard() is True
    assert (torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()) == before
    torch.backends.cudnn.benchmark = True
    try:
        with pytest.raises(AssertionError, match="benchmark"):
            profiling.deterministic_guard()
    finally:
        torch.backends.cudnn.benchmark = before[0]


def test_trace_writes_a_trace_with_the_spans(tmp_path):
    """A traced matmul under an annotated span: one trace file under the
    directory, Chrome-trace json, holding the span by name."""
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with profiling.annotate("flowtrack.span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(logdir)
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "flowtrack.span" for e in events)
