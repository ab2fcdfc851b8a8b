"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of a checkout (a few minutes on the CPU). Tests marked ``card``
need a CUDA card and skip without one; on the card's machine the same
command runs them."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NUMBERS = ("det_joint_gap", "det_maxval_err", "det_score_err",
           "det_valid_miss", "rec_shift_share",
           "rec_joint_gap", "rec_maxval_err", "rec_unlocated",
           "rec_unexplained", "rec_count_err", "track_gap",
           "rec_disp_mean", "rec_far_share")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def tiny_cell(dtype="float32", limits_of=None):
    """The crowd cell cut to a CPU test's size: R50 at 64x48 crops,
    FlowNetC, 128x192 frames, 2 streams of 10-frame videos in 4-frame
    clips, 2-3 people. ``limits_of`` takes a real cell's limits."""
    from portbench import spec

    here = ROOT / "portbench"
    cfg = json.load(open(here / "configs" / "simplebaseline-r50-flownetc.json"))
    cfg["model"].update(image_size=[64, 48], heatmap_size=[16, 16],
                        dtype=dtype)
    cfg["flow"].update(dtype=dtype)
    tr = json.load(open(here / "traffic" / "offline-crowd.json"))
    tr.update(frame_hw=[128, 192], streams=2, clip_len=4, video_frames=10,
              videos=2, box_width=[20, 40], persons=[2, 3], texture_cell=8,
              warmup_steps=1)
    limits = ({"limits": {n: 1e9 for n in NUMBERS}}
              if limits_of is None else
              json.load(open(here / "cells" / f"{limits_of}.json")))
    return spec.Cell("tiny", {"name": "tiny", "config": "tiny",
                              "traffic": "tiny", "chips": 1}, cfg, tr, limits,
                     [], [])


@pytest.fixture
def tiny():
    return tiny_cell


def run_tiny(cell, seed=7, seconds=30.0, traced=False):
    """One run of ``cell`` on the CPU: (namespace, readings)."""
    import time

    import torch

    from portbench.drivers import offline

    torch.manual_seed(0)
    return offline.run(cell, seed, seconds, traced, time.perf_counter(),
                       torch.device("cpu"))


@pytest.fixture
def run_cpu():
    return run_tiny
