"""Where the benchmark finds its parts, by the names in ``BENCHMARK.json``:

* a configuration ``<name>``: ``configs/<name>.json``, the program's
  settings section by section (the port's field names), the rules of its
  seeded weights, its source and what differs from it, and its
  ``reference`` section;
* a reference net ``<module>``, named by a configuration's ``reference``
  section for its pose and its flow net: ``reference/<module>.py``, whose
  ``build(config, device)`` gives the float32 net (the contracts are in
  ``reference/nets.py``);
* a traffic mix ``<name>``: ``traffic/<name>.json``, the parameters that
  the generator of its ``kind`` reads (``drivers/<kind>.py`` drives it);
* a cell ``<name>``: ``cells/<name>.json``, the limits of the comparison
  that decides ``correct``;
* a per-layer metric ``<name>``: ``metrics/<name>.py``, whose ``read(run)``
  returns the metric's value or None where the run has nothing to read.

A later change adds a configuration, a reference net, a cell or a metric
by adding such a file and its entry in ``BENCHMARK.json``; no file here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict          # the cell's entry in BENCHMARK.json
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # cells/<name>.json
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports


def benchmark(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files; a
    per-layer metric without ``workloads`` goes to every cell that reports
    the end-to-end metric it moves."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, work, _json(HERE / "configs" / f"{work['config']}.json"),
                _json(HERE / "traffic" / f"{work['traffic']}.json"),
                _json(HERE / "cells" / f"{name}.json"), e2e, layer)


def driver(kind: str):
    """The module that drives traffic of ``kind``."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def _load(path: Path, name: str):
    """The Python file ``path`` as a module of its own named ``name``."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read`` (a name may hold dots)."""
    return _load(HERE / "metrics" / f"{metric}.py",
                 f"portbench_metric_{metric}").read


def reference(config: dict, role: str):
    """The module ``reference/<name>.py`` that the configuration's
    ``reference`` section names for ``role`` (``pose`` or ``flow``)."""
    name = config["reference"][role]
    return _load(HERE / "reference" / f"{name}.py",
                 f"portbench_reference_{name}")


def port_config(config: dict):
    """The program's ``Config`` of a configuration file: each section's
    keys replace the defaults (lists become tuples)."""
    from dataclasses import replace

    from flowtrack_tpu_torch.config import Config

    cfg = Config(name=config["name"])
    for section in ("model", "flow", "test", "track"):
        values = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in config[section].items()}
        cfg = replace(cfg, **{section: replace(getattr(cfg, section),
                                               **values)})
    return cfg
