"""AOT program export of the port (flowtrack_tpu_torch/aot.py), the
counterparts of tests/test_aot.py's five checks against the port's live
tracker: an exported and reloaded clip program reproduces ``run_prepared``
bit for bit, seed chaining included, and the multi-stream layout
``track_clips``; the specs honour the tracker's ``max_persons``; a call of
another shape raises; and the CLI writes a reloadable artifact. The
program calls the kernels' custom ops, not their plain versions.

The exports are shared through module fixtures: one export costs seconds.
"""

import json

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from flowtrack_tpu_torch import aot
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
from tests.test_clip_pipeline import make_cfg
from tests.test_torch_clip_scenarios import StubFlowTorch, StubPoseTorch

F, H, W, P = 5, 128, 160, 4


def _scenario(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([10.0, 10.0, 30.0, 40.0], np.float32),
                    (F, P, 1))
    boxes[:, 1, 0] += 60.0
    scores = np.full((F, P), 0.9, np.float32)
    valid = np.zeros((F, P), bool)
    valid[:, :2] = True
    return frames, boxes, scores, valid


def _assert_trees_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.fixture(scope="module")
def tracker():
    return ClipTracker(make_cfg(), StubPoseTorch(), StubFlowTorch(),
                       device="cpu")


@pytest.fixture(scope="module")
def single(tracker):
    """The one-clip program, exported and loaded."""
    return aot.load_clip_program(aot.export_clip_program(tracker, F, (H, W)))


def _weights(tracker):
    return tracker.pose_model.state_dict(), tracker.flow_model.state_dict()


def test_aot_clip_bitwise_and_seed_chain(tracker, single):
    """Two clips, the second seeded by the first: the artifact's outputs
    and seeds equal the live tracker's bit for bit, and its seed_out
    feeds its own next call; the program runs the crop kernel's op."""
    call = single
    args1 = tracker.prepare(*_scenario(0))
    args2 = tracker.prepare(*_scenario(1))
    live1 = tracker.run_prepared(args1)
    live2 = tracker.run_prepared(args2, seed=live1[5])

    aot1 = call(*_weights(tracker), *args1, *tracker.empty_seed())
    _assert_trees_equal(live1, aot1)
    aot2 = call(*_weights(tracker), *args2, *aot1[5])
    _assert_trees_equal(live2, aot2)
    assert live2[4].any()
    ops = call.ops
    assert not call.exported.state_dict, "weights are call arguments"
    assert "flowtrack.crop_frames.default" in ops
    # the plain crop's interpolation products stay inside the op
    assert not any("einsum" in op or "bmm" in op for op in ops)


def test_aot_streams_layout_bitwise(tracker):
    """The two-stream serving program exports too and matches
    track_clips, every slot."""
    call = aot.load_clip_program(
        aot.export_clip_program(tracker, F, (H, W), streams=2))
    scen = [_scenario(2), _scenario(3)]
    stack = [np.stack([s[i] for s in scen]) for i in range(4)]
    live = tracker.track_clips(*stack)

    args = tracker.prepare_lanes(*stack)
    seed = [s.expand(2, *s.shape) for s in tracker.empty_seed()]
    out = tracker.to_host(call(*_weights(tracker), *args, *seed))
    for key in ("joints", "maxvals", "scores", "ids", "valid"):
        np.testing.assert_array_equal(out[key], live[key], err_msg=key)
    assert live["valid"].any()


def test_aot_specs_honor_max_persons_override():
    """clip_arg_specs uses the tracker's own person padding
    (ClipTracker(max_persons=...) overrides cfg.track.max_persons), as
    production's prepare does; the sidecar records it."""
    cfg = make_cfg()  # cfg.track.max_persons == 4
    tracker = ClipTracker(cfg, StubPoseTorch(), StubFlowTorch(),
                          max_persons=2, device="cpu")
    specs = aot.clip_arg_specs(tracker, F, (H, W))
    frames = np.zeros((F, H, W, 3), np.float32)
    args = tracker.prepare(frames, np.zeros((F, 2, 4), np.float32),
                           np.zeros((F, 2), np.float32),
                           np.ones((F, 2), bool))
    assert len(specs) == 2 + 7 + 6
    for spec, arg in zip(specs[2:9], args):
        assert (spec.shape, spec.dtype) == (arg.shape, arg.dtype)
    for spec, leaf in zip(specs[9:], tracker.empty_seed()):
        assert (spec.shape, spec.dtype) == (leaf.shape, leaf.dtype)
    meta = json.loads(aot.artifact_meta(tracker, F, (H, W), None, "cpu"))
    assert meta["max_persons"] == 2 and meta["platforms"] == ["cpu"]


def test_aot_rejects_wrong_shapes(tracker, single):
    """Shape specialization holds at call time: a clip one frame short is
    refused, not padded."""
    call = single
    args = tracker.prepare(*_scenario(4))
    short = (args[0][: F - 1],) + args[1:]
    with pytest.raises(Exception):
        call(*_weights(tracker), *short, *tracker.empty_seed())


def test_export_program_cli(tmp_path):
    """Real nets end to end (R18 and FlowNetC from .npz through
    tools/common.py): the CLI writes the blob and its sidecar, --check
    reloads it and runs it on --device cpu and lists the kernels' ops it
    calls (crop and correlation), and the artifact holds no weights."""
    from flowtrack_tpu_torch.config import FlowConfig, ModelConfig
    from flowtrack_tpu_torch.engine.checkpoint import save_npz_variables
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tools import export_program
    from flowtrack_tpu_torch.utils import convert

    gen = torch.Generator().manual_seed(0)
    mcfg = ModelConfig(num_layers=18, image_size=(64, 64),
                       heatmap_size=(16, 16), dtype="float32")
    save_npz_variables(str(tmp_path / "pose.npz"), convert.convert_pose_resnet(
        get_pose_net(mcfg, "cpu", gen).state_dict()))
    save_npz_variables(
        str(tmp_path / "flow.npz"), convert.FLOW_CONVERTERS["flownet_c"]
        .convert(get_flow_net(FlowConfig(variant="flownet_c",
                                         dtype="float32"), "cpu", gen)
                 .state_dict()))

    out = tmp_path / "clip_prog.pt2"
    info = export_program.main([
        "--cfg", "flowtrack_posetrack",
        "--pose-weights", str(tmp_path / "pose.npz"),
        "--flow-weights", str(tmp_path / "flow.npz"),
        "--out", str(out), "--clip-len", "3", "--frame-size", "96x128",
        "--device", "cpu", "--check",
        "model.num_layers=18", "model.image_size=64,64",
        "model.heatmap_size=16,16", "model.dtype=float32",
        "flow.variant=flownet_c", "flow.dtype=float32",
        "track.max_persons=4"])
    assert info["checked"] is True and info["platforms"] == ["cpu"]
    assert out.exists() and out.stat().st_size == info["bytes"]
    meta = json.loads((tmp_path / "clip_prog.json").read_text())
    assert meta["clip_len"] == 3 and meta["frame_hw"] == [96, 128]
    assert meta["pose"] == 18 and meta["flow"] == "flownet_c"
    assert {"flowtrack.crop_frames.default",
            "flowtrack.correlation.default"} <= set(info["kernel_ops"])
    # R18 and FlowNetC hold 0.2 GB of float32 weights
    assert info["bytes"] < 2 ** 24, "the artifact holds weights"
