"""A run's last line has the contract's shape, and a run without the
cards it needs prints no result."""

import json

import pytest


def test_the_last_line_has_the_contracts_shape(tiny, run_cpu):
    from conftest import ROOT
    from portbench import run, spec

    bench = spec.benchmark(ROOT)
    cell = tiny()
    cell.end_to_end = bench["end_to_end"]
    ns, readings = run_cpu(cell, seconds=20.0)
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": ns.memory_peak_bytes}
    line = json.loads(json.dumps(run.result(cell, ns, readings, False,
                                            device)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["limit"] is not None


def test_no_card_no_result(capsys):
    import torch

    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "r50c-offline-crowd", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
