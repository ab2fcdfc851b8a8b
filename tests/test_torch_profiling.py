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


@pytest.fixture
def tracing():
    """The program's tracing on for the test, off after it."""
    profiling.enable()
    yield
    profiling.disable()


def _grown(before):
    """The registry's growth since the snapshot ``before``."""
    return {k: {"total_s": v["total_s"] - before.get(k, {}).get("total_s", 0),
                "count": v["count"] - before.get(k, {}).get("count", 0)}
            for k, v in profiling.snapshot().items()
            if v != before.get(k)}


def test_tracing_off_records_nothing(monkeypatch):
    """Off, and with no profiler running, a span is one shared no-op
    context that enters no ``record_function``, and counters and device
    seconds add nothing."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not profiling.enabled() and not profiling.recording()
    before = profiling.snapshot()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        with profiling.span("b"):
            profiling.count("c", 3)
            profiling.add("d", 0.5)
    assert profiling.snapshot() == before
    assert profiling.stamps(7, "cpu") is None


def test_spans_nest_and_their_totals_add_up(tracing, monkeypatch):
    """On, each span enters ``record_function`` under its name and adds
    its host seconds once; an enclosing span's total holds its inner
    spans'; counters add their counts and device seconds their seconds;
    a snapshot is a copy."""
    import time

    entered = []
    real = profiling.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", spy)
    before = profiling.snapshot()
    with profiling.span("t.outer"):
        for _ in range(2):
            with profiling.span("t.inner"):
                time.sleep(0.002)
        with profiling.span("t.other"):
            time.sleep(0.001)
    profiling.count("t.rows", 5)
    profiling.count("t.rows", 2)
    profiling.add("t.device", 0.25)
    profiling.add("t.device", 0.5)
    grown = _grown(before)
    assert entered == ["t.outer", "t.inner", "t.inner", "t.other"]
    assert {k: v["count"] for k, v in grown.items()} == {
        "t.outer": 1, "t.inner": 2, "t.other": 1, "t.rows": 7, "t.device": 2}
    assert grown["t.inner"]["total_s"] >= 0.004
    assert grown["t.outer"]["total_s"] >= (grown["t.inner"]["total_s"]
                                           + grown["t.other"]["total_s"])
    assert grown["t.rows"]["total_s"] == 0
    assert grown["t.device"]["total_s"] == pytest.approx(0.75)
    snap = profiling.snapshot()
    snap["t.rows"]["count"] = 0
    assert profiling.snapshot()["t.rows"]["count"] == before.get(
        "t.rows", {}).get("count", 0) + 7


def test_spans_record_while_a_profiler_records():
    """With the switch off, a running torch.profiler turns the spans on:
    the span lies in the profiler's events and in the registry; the clip
    stamps only with the switch."""
    from torch.profiler import ProfilerActivity, profile

    before = profiling.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording() and not profiling.enabled()
        with profiling.span("t.profiled"):
            torch.ones(8) + 1
        assert profiling.stamps(7, "cpu") is None
    assert not profiling.recording()
    assert _grown(before)["t.profiled"]["count"] == 1
    assert any(e.name == "t.profiled" for e in prof.events())


def test_stamp_op_reads_the_clock_in_order():
    """``flowtrack::stamp`` is a custom op (schema, fake, registration);
    on the CPU it writes the host's clock, so stamps taken in order do not
    decrease; the kernel's wrapper refuses a CPU buffer."""
    buf = torch.zeros(7, dtype=torch.int64)
    torch.library.opcheck(torch.ops.flowtrack.stamp.default, (buf, 1),
                          test_utils=("test_schema",
                                      "test_autograd_registration",
                                      "test_faketensor"))
    for i in range(7):
        profiling.stamp(buf, i)
    assert (buf > 0).all() and (buf.diff() >= 0).all()
    with pytest.raises(ValueError, match="CUDA"):
        profiling.stamp_cuda(buf, 0)


def test_trace_records_the_spans_and_leaves_the_switch(tmp_path):
    """Under ``trace`` the program's spans record, into the registry and
    the trace file, while the switch stays off (a warm tracker keeps its
    graph); a switch turned on before stays on."""
    logdir = tmp_path / "trace"
    before = profiling.snapshot()
    assert not profiling.enabled()
    with profiling.trace(str(logdir)):
        assert not profiling.enabled() and profiling.recording()
        with profiling.span("t.traced"):
            pass
    assert not profiling.enabled()
    assert _grown(before)["t.traced"]["count"] == 1
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    with open(logdir / files[0]) as f:
        assert any(e.get("name") == "t.traced"
                   for e in json.load(f)["traceEvents"])
    profiling.enable()
    try:
        with profiling.trace(str(tmp_path / "again")):
            pass
        assert profiling.enabled()
    finally:
        profiling.disable()
