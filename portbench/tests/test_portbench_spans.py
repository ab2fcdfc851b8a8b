"""The per-layer metrics that read the program's own spans and counters
(``portbench/spans.py``): each reader on a synthetic registry, None where
there is nothing to read, and a traced run on the CPU that reports them
all."""

import json
from types import SimpleNamespace

import pytest

from portbench import spans, spec

NEW = ("host_prep_ms_per_step.offline", "emit_ms_per_step.offline",
       "pose_slot_use.offline")


FULL = {"serving.dispatch": {"total_s": 2.0, "count": 4},
        "serving.stack": {"total_s": 0.16, "count": 4},
        "clip.host_lanes": {"total_s": 0.04, "count": 4},
        "serving.fetch": {"total_s": 2.5, "count": 5},
        "serving.emit": {"total_s": 0.05, "count": 5},
        "pose.forwards": {"total_s": 0.0, "count": 4000},
        "pose.useful": {"total_s": 0.0, "count": 1000}}
WANT = {"host_prep_ms_per_step.offline": 50.0,
        "emit_ms_per_step.offline": 10.0,
        "pose_slot_use.offline": 25.0}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_the_registry(name, monkeypatch):
    """A traced run's registry gives the reading; an untraced run, a
    program without the registry (None), an empty one, or one without
    the span or counter read, gives None."""
    read = spec.reader(name)
    traced = SimpleNamespace(traced=True)
    monkeypatch.setattr(spans, "registry", lambda: FULL)
    assert read(traced) == pytest.approx(WANT[name])
    assert read(SimpleNamespace(traced=False)) is None
    assert read(SimpleNamespace()) is None
    for reg in (None, {}, {k: v for k, v in FULL.items()
                           if k not in ("serving.dispatch", "serving.fetch",
                                        "pose.forwards")}):
        monkeypatch.setattr(spans, "registry", lambda reg=reg: reg)
        assert read(traced) is None


def test_the_registry_is_none_for_a_program_without_it(monkeypatch):
    """A program whose ``utils.profiling`` has no ``snapshot`` (a version
    before the spans) gives None, and no error."""
    from flowtrack_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert spans.registry() is None
    assert spec.reader("emit_ms_per_step.offline")(
        SimpleNamespace(traced=True)) is None


def test_a_traced_run_reports_every_new_metric(tiny, run_cpu):
    """A ``--trace 1`` run on the CPU (a window no longer than the trace,
    so every step is traced): its last line carries the three metrics,
    none null, the pose rows' share between 0 and 100."""
    from conftest import ROOT
    from portbench import run

    bench = spec.benchmark(ROOT)
    cell = tiny()
    cell.per_layer = [m for m in bench["per_layer"] if m["name"] in NEW]
    ns, readings = run_cpu(cell, seconds=3.0, traced=True)
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": ns.memory_peak_bytes}
    line = json.loads(json.dumps(run.result(cell, ns, readings, True,
                                            device)))
    assert set(line["metrics"]) == set(NEW)
    for m in line["metrics"].values():
        assert m["value"] is not None and m["value"] >= 0
    assert 0 < line["metrics"]["pose_slot_use.offline"]["value"] <= 100
