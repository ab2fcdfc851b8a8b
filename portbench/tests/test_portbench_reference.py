"""The plain reference against the program's plain versions on the CPU,
at small sizes, in float32: the nets, the crop and decode, the whole clip
program; and a float32 run of the program reads (near) nought on every
compared number."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT


def configs(dtype="float32"):
    out = {}
    for name in ("simplebaseline-r50-flownetc", "flowtrack-r152-flownet2"):
        cfg = json.load(open(ROOT / "portbench" / "configs" / f"{name}.json"))
        cfg["model"].update(image_size=[64, 48], heatmap_size=[16, 12],
                            dtype=dtype)
        cfg["flow"]["dtype"] = dtype
        out[name] = cfg
    return out


@pytest.mark.parametrize("name", ["simplebaseline-r50-flownetc",
                                  "flowtrack-r152-flownet2"])
def test_nets_match_the_port(name):
    """The reference nets under their contracts (crops in, heatmaps out;
    frames in, pixels out) against the program's nets with its own pre-
    and post-processing of the flow."""
    from flowtrack_tpu_torch.models.flownet import (get_flow_net,
                                                    postprocess_flow,
                                                    preprocess_pair,
                                                    resize_bilinear)
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from portbench import spec
    from portbench.drivers import offline

    cfg = configs()[name]
    port = spec.port_config(cfg)
    dev = torch.device("cpu")
    pose_sd, flow_sd = offline.states(cfg, 2 ** 32 + 5, dev)
    pose, flow = get_pose_net(port.model, dev), get_flow_net(port.flow, dev)
    pose.load_state_dict(pose_sd)
    flow.load_state_dict(flow_sd)
    rpose, rflow = offline.reference_nets(cfg, dev)
    rpose.load_state_dict(pose_sd)
    rflow.load_state_dict(flow_sd)
    g = torch.Generator().manual_seed(1)
    crops = torch.randn(3, 3, 64, 48, generator=g)
    with torch.no_grad():
        want = pose(crops)
        assert (rpose(crops) - want).abs().max() <= 1e-5 * want.abs().max()
        frames = (torch.rand(3, 60, 100, 3, generator=g) * 255).round().to(
            torch.uint8)
        x = resize_bilinear(frames.float(), (64, 128))   # the /64 grid
        want = postprocess_flow(flow(preprocess_pair(
            x[:-1], x[1:], 255.0).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
            cfg["flow"]["variant"], (60, 100), 20.0)
        got = rflow(frames[:-1], frames[1:])
    assert got.shape == (2, 60, 100, 2)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


def test_crop_flip_and_decode_match_the_port():
    from flowtrack_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from flowtrack_tpu_torch.ops.crop import crop_frames_plain
    from flowtrack_tpu_torch.ops.decode import get_final_preds
    from flowtrack_tpu_torch.pipeline import (batched_box_to_center_scale,
                                              flip_test_heatmaps)
    from portbench.reference import ops

    g = torch.Generator().manual_seed(2)
    frames = (torch.rand(2, 70, 90, 3, generator=g) * 255).round().to(
        torch.uint8)
    boxes = np.array([[10.5, 5.25, 30, 50], [-8, 40, 60, 45], [60, 2, 50, 90]],
                     np.float32)
    c, s = ops.center_scale(boxes, 48 / 64)
    c2, s2 = batched_box_to_center_scale(boxes, 48 / 64)
    assert np.array_equal(c, c2.astype(np.float32))
    assert np.array_equal(s, s2.astype(np.float32))
    idx = torch.tensor([0, 1, 1])
    c, s = torch.as_tensor(c), torch.as_tensor(s)
    want = crop_frames_plain(frames, idx, c, s, (64, 48), IMAGENET_MEAN,
                             IMAGENET_STD)
    got = ops.crop(frames, idx, c, s, (64, 48)).permute(0, 2, 3, 1)
    assert (got - want).abs().max() < 1e-4

    net = torch.nn.Conv2d(3, 17, 4, 4)
    with torch.no_grad():
        want = flip_test_heatmaps(net, want, True, True)
        hm = ops.flip_heatmaps(net, got.permute(0, 3, 1, 2))
        assert (hm.permute(0, 2, 3, 1) - want).abs().max() < 1e-4
        j, mv = get_final_preds(want, c, s)
        rj, rmv = ops.decode(want.permute(0, 3, 1, 2), c, s)
    assert torch.equal(mv, rmv) and (rj - j).abs().max() < 1e-4
    cells = ops.heatmap_cell(rj, c, s, (16, 12))
    flat = want.permute(0, 3, 1, 2).reshape(3, 17, -1).argmax(-1)
    assert torch.equal(cells[..., 1] * 12 + cells[..., 0], flat)


def test_the_clip_program_matches_the_port():
    """Three chained clips of a small video: the reference's reported
    outputs against ``ClipTracker.track_clip``'s, ids and valid masks equal,
    poses within float32 rounding."""
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
    from portbench import spec, video
    from portbench.drivers import offline
    from portbench.reference.clip import ClipReference
    from conftest import tiny_cell

    cell = tiny_cell()
    cfg = cell.config
    dev = torch.device("cpu")
    pose_sd, flow_sd = offline.states(cfg, 31, dev)
    port = spec.port_config(cfg)
    pose, flow = get_pose_net(port.model, dev), get_flow_net(port.flow, dev)
    pose.load_state_dict(pose_sd)
    flow.load_state_dict(flow_sd)
    tracker = ClipTracker(port, pose, flow, device=dev)
    rpose, rflow = offline.reference_nets(cfg, dev)
    rpose.load_state_dict(pose_sd)
    rflow.load_state_dict(flow_sd)
    ref = ClipReference(cfg, rpose, rflow, dev)
    tr = dict(cell.traffic, persons=[4, 5], miss_rate=0.2)
    v = video.make_videos(tr, 31, dev)[0]
    boxes, scores, valid = video.padded(v, 32)
    seed, rseed = None, ref.empty_seed()
    recovered = 0
    for lo in (0, 3, 6):
        sl = slice(lo, lo + 4)
        want, seed = tracker.track_clip(v.frames[sl], boxes[sl], scores[sl],
                                        valid[sl], seed=seed, frame_offset=lo,
                                        return_seed=True)
        got, rseed = ref.run_clip(torch.as_tensor(v.frames[sl]), boxes[sl],
                                  scores[sl], valid[sl], rseed)
        assert np.array_equal(got["valid"], want["valid"])
        assert np.array_equal(got["ids"], want["ids"])
        m = want["valid"]
        assert np.abs(got["joints"][m] - want["joints"][m]).max() < 1e-3
        assert np.abs(got["maxvals"][m] - want["maxvals"][m]).max() < 1e-4
        recovered += int(m[:, 32:].sum())
    assert recovered and want["valid"].any()


def test_a_float32_run_reads_nought(tiny, run_cpu):
    ns, readings = run_cpu(tiny(), seconds=25.0)
    assert readings.info["videos"] >= 1 and readings.info["rec_compared"]
    for name, value in readings.values.items():
        assert value < 1e-3, (name, value)
