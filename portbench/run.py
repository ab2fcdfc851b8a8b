"""One run of one cell of the benchmark of ``flowtrack_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. The
run makes its weights and traffic from the seed, warms up the cell's own
shapes, measures for ``--seconds``, checks the outputs against the plain
reference (``check.py``) and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, with ``--trace 1``, ``breakdown``; last, ``checks``: each
compared number beside its limit, which also end standard error.

It exits non-zero and prints no result without the cards the cell asks
for, or if JAX or the JAX package got imported.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "flowtrack_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``flowtrack_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "unknown"


def result(cell, ns, readings, traced: bool, device: dict) -> dict:
    """The run's last line (``checks`` last)."""
    from portbench import spec

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ns)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ns.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    # a number whose limit is null has no upper reading in this cell
    # (PERF.md section 2): read and reported, not compared
    limits = cell.limits["limits"]
    checks = {name: {"value": v, "limit": limits[name]}
              for name, v in readings.values.items()
              if limits[name] is not None}
    correct = (readings.info["videos"] > 0 and ns.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": correct, "attempted": ns.attempted,
            "failed": ns.failed, "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = ns.breakdown
    line["info"] = dict(readings.info, not_compared={
        name: v for name, v in readings.values.items() if name not in checks})
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # import the benchmark as the package ``portbench``, never its files as
    # top-level modules (``trace`` would shadow the standard library's)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import spec

    cell = spec.cell(ROOT, args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {cell.name} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = spec.driver(cell.traffic["kind"])
    ns, readings = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                              STARTED)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": ns.memory_peak_bytes,
              "power_limit": power_limit()}
    if args.trace:
        device.update(busy_s=ns.busy_s, window_s=ns.trace_window_s)
    line = result(cell, ns, readings, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
