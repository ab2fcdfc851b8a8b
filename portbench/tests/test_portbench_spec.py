"""BENCHMARK.json and the files it names: every part loads by name, the
file keeps to the benchmark's contract, and a configuration, a cell and a
metric can be added by adding files alone."""

import hashlib
import json
import re
import shutil

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.load(open(ROOT / "BENCHMARK.json"))


def test_every_part_loads_by_name():
    from portbench import spec

    b = bench()
    for w in b["workloads"]:
        cell = spec.cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        spec.port_config(cell.config)
        spec.driver(cell.traffic["kind"])
        assert set(cell.limits["limits"]) == {
            "det_joint_gap", "det_maxval_err", "det_score_err",
            "det_valid_miss", "rec_shift_share",
            "rec_joint_gap", "rec_maxval_err", "rec_unlocated",
            "rec_unexplained", "rec_count_err", "track_gap",
            "rec_disp_mean", "rec_far_share"}
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
    assert {w["config"] for w in b["workloads"]} == configs
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert len(json.dumps(b)) < 64 * 1024


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_config_a_cell_and_a_metric_are_added_by_files(tmp_path):
    """On a copy: a new configuration, traffic mix, cell and per-layer
    metric are files and BENCHMARK.json entries; no file that was there
    changes, and the harness finds them by name."""
    import importlib

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.load(open(pb / "configs" / "simplebaseline-r50-flownetc.json"))
    cfg["name"] = "simplebaseline-r101-flownetc"
    cfg["model"]["num_layers"] = 101
    json.dump(cfg, open(pb / "configs" / f"{cfg['name']}.json", "w"))
    tr = json.load(open(pb / "traffic" / "offline-crowd.json"))
    tr["clip_len"] = 8
    tr["video_frames"] = 1 + 7 * 4
    json.dump(tr, open(pb / "traffic" / "offline-crowd-short.json", "w"))
    json.dump(json.load(open(pb / "cells" / "r50c-offline-crowd.json")),
              open(pb / "cells" / "r101c-offline-short.json", "w"))
    (pb / "metrics" / "window_s.offline.py").write_text(
        "def read(run):\n    return run.window_s\n")
    b = json.load(open(tmp_path / "BENCHMARK.json"))
    b["configs"].append({"name": cfg["name"], "source": "x",
                         "file": f"portbench/configs/{cfg['name']}.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "r101c-offline-short",
                           "config": cfg["name"],
                           "traffic": "offline-crowd-short", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "window_s.offline", "unit": "s",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving", "moves": "frames_per_s",
                           "workloads": ["r101c-offline-short"]})
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    after = _digest(pb)
    assert all(after[p] == d for p, d in before.items())

    spec = importlib.import_module("portbench.spec")
    here = spec.HERE
    try:
        spec.HERE = pb
        cell = spec.cell(tmp_path, "r101c-offline-short")
        assert cell.config["model"]["num_layers"] == 101
        assert cell.traffic["clip_len"] == 8
        assert [m["name"] for m in cell.per_layer][-1] == "window_s.offline"
        assert spec.reader("window_s.offline")(type("R", (), {
            "window_s": 2.5})) == 2.5
    finally:
        spec.HERE = here


# A flow architecture unlike FlowNet: frames padded to a /8 grid (not
# resized to /64), normalised as 2 x / 255 - 1 (no pair mean), an all-pairs
# volume as a plain matmul whose operands go through ``corr_quant``, and
# full-resolution flow in pixels from its own upsampling.
ALL_PAIRS = '''
"""A toy all-pairs flow net under the flow contract of ``nets.py``."""

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nets import QConv2d, identity


class AllPairs(nn.Module):
    corr_quant = staticmethod(identity)

    def __init__(self, dim):
        super().__init__()
        self.fnet = QConv2d(3, dim, 8, 8)
        self.head = QConv2d(2, 2, 3, 1, 1)

    def core(self, x):
        f1, f2 = self.fnet(x[:, :3]), self.fnet(x[:, 3:])
        n, _, h, w = f1.shape
        a = self.corr_quant(f1).flatten(2).transpose(1, 2)
        b = self.corr_quant(f2).flatten(2)
        volume = torch.matmul(a, b).softmax(-1)
        ys, xs = torch.meshgrid(torch.arange(h, device=x.device),
                                torch.arange(w, device=x.device),
                                indexing="ij")
        at = torch.stack([xs, ys], -1).reshape(h * w, 2).float()
        moved = torch.matmul(volume, at) - at
        return self.head(moved.transpose(1, 2).reshape(n, 2, h, w))

    def forward(self, prev, nxt):
        h, w = prev.shape[1:3]
        x = torch.cat([prev, nxt], -1).permute(0, 3, 1, 2).float()
        x = F.pad(2 * x / 255 - 1, (0, -w % 8, 0, -h % 8))
        up = F.interpolate(self.core(x) * 8, scale_factor=8)
        return up[:, :, :h, :w].permute(0, 2, 3, 1)


def build(config, device):
    return AllPairs(config["flow"]["feature_dim"]).to(device).eval()


def net_input(config, frame_hw):
    h, w = frame_hw
    return (1, 6, -(-h // 8) * 8, -(-w // 8) * 8)


def uncounted_flops(config, frame_hw):
    return 0
'''


def test_a_flow_architecture_is_added_by_files(tmp_path):
    """On a copy: a configuration whose flow reference is a new module file
    (``ALL_PAIRS``) is built, seeded, run, counted and rounded by the
    harness through the configuration's ``reference`` section alone; no
    file that was there changes."""
    import importlib

    import torch

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    before = _digest(pb)
    (pb / "reference" / "allpairs.py").write_text(ALL_PAIRS)
    cfg = json.load(open(pb / "configs" / "simplebaseline-r50-flownetc.json"))
    cfg["name"] = "simplebaseline-r50-allpairs"
    cfg["reference"]["flow"] = "allpairs"
    cfg["flow"] = {"variant": "allpairs", "feature_dim": 16}
    cfg["model"]["image_size"] = [64, 48]
    json.dump(cfg, open(pb / "configs" / f"{cfg['name']}.json", "w"))
    after = _digest(pb)
    assert all(after[p] == d for p, d in before.items())

    spec = importlib.import_module("portbench.spec")
    from portbench import counts
    from portbench.drivers import offline
    from portbench.reference.clip import ClipReference
    from portbench.reference.nets import set_quant

    here = spec.HERE
    cpu = torch.device("cpu")
    try:
        spec.HERE = pb
        pose, flow = offline.reference_nets(cfg, cpu)
        assert type(flow).__name__ == "AllPairs"
        pose_sd, flow_sd = offline.states(cfg, 2 ** 31 + 3, cpu)
        assert set(flow_sd) == {"fnet.weight", "fnet.bias", "head.weight",
                                "head.bias"}
        pose.load_state_dict(pose_sd)
        flow.load_state_dict(flow_sd)

        g = torch.Generator().manual_seed(3)
        frames = (torch.rand(5, 60, 100, 3, generator=g) * 255).to(
            torch.uint8)
        flows = ClipReference(cfg, pose, flow, cpu).flows(frames)
        assert flows.shape == (4, 60, 100, 2) and flows.dtype == torch.float32
        assert flows.abs().max() > 0

        # 60x100 frames pad to 64x104: p = 8 x 13 features of 16 channels
        p, dim = 8 * 13, 16
        fnet = 2 * (2 * 3 * 64 * dim * p)
        volume = 2 * p * dim * p
        head = 2 * 2 * 9 * 2 * p
        assert counts.flow_flops(cfg, (60, 100)) == (
            fnet + volume + 2 * p * p * 2 + head)

        seen = []

        def quant(x):
            seen.append(tuple(x.shape))
            return x

        set_quant(flow, quant)
        with torch.no_grad():
            flow(frames[:1], frames[1:2])
        assert seen.count((1, dim, 8, 13)) == 2           # the volume's maps
        assert seen.count((dim, 3, 8, 8)) == 2            # fnet's weight
        assert seen.count((2, 2, 3, 3)) == 1              # head's weight
    finally:
        spec.HERE = here
