"""The port's ClipTracker on the stub-model scenarios of
tests/test_clip_pipeline.py, against the JAX ClipTracker.

The stubs are the reference tests' own, in torch: a pose net whose heatmaps
are a fixed star of 17 peaks around the crop centre (so decoded joints
follow the boxes through the real crop and decode geometry) and a flow net
that returns the true constant motion. Each scenario runs through both
trackers: ids and valid must be equal and the valid joints within 1e-3 px;
each also keeps its own assertion about the tracking behaviour.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
from torch import nn

from flowtrack_tpu.ops.heatmap import generate_target_np
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JaxClipTracker
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker, pad_detections
from tests.test_clip_pipeline import (
    HM_HW,
    IMG_HW,
    K,
    OFFS,
    VEL,
    StubFlow,
    StubPose,
    _dropout_scenario,
    default_tracker,
    make_cfg,
)


class StubPoseTorch(nn.Module):
    """(n, 3, h, w) crops -> the fixed (n, K, hh, hw) heatmaps of StubPose."""

    def __init__(self):
        super().__init__()
        joints = OFFS * np.array([IMG_HW[1], IMG_HW[0]])
        hm, _ = generate_target_np(joints, np.ones(K), HM_HW, IMG_HW, 1.5)
        self.register_buffer("hm", torch.from_numpy(hm).permute(2, 0, 1)
                             .contiguous())

    def forward(self, x):
        return self.hm.expand(x.shape[0], -1, -1, -1)


class StubFlowTorch(nn.Module):
    """(n, 6, h, w) pairs -> constant quarter-res flow VEL / div_flow."""

    def __init__(self, div_flow=20.0):
        super().__init__()
        self.register_buffer("vel", torch.tensor(VEL / div_flow,
                                                 dtype=torch.float32))

    def forward(self, x):
        n, _, h, w = x.shape
        return self.vel.view(1, 2, 1, 1).expand(n, 2, h // 4, w // 4)


def _moving(f, persons, t0=0, drop=()):
    """frames (f, 128, 160, 3) zeros; person i at (x_i, y_i) + VEL * t with
    a 30 px box, absent at the global frames in drop[i]."""
    boxes, scores = [], []
    for i in range(f):
        t = t0 + i
        bs, sc = [], []
        for j, (x, y, s) in enumerate(persons):
            if t in (drop[j] if j < len(drop) else ()):
                continue
            bs.append([x + VEL[0] * t - 15, y + VEL[1] * t - 15, 30, 30])
            sc.append(s)
        boxes.append(bs)
        scores.append(sc)
    return np.zeros((f, 128, 160, 3), np.float32), boxes, scores


def _track(tr, cfg, frames, boxes, scores, **kw):
    db, dsc, dv = pad_detections(boxes, scores, cfg.track.max_persons)
    return tr.track_clip(frames, db, dsc, dv, **kw)


def scen_ids_stable_and_new_id(tr, cfg):
    # A moves from (40, 50); B appears at frame 2
    frames, boxes, scores = _moving(5, [(40, 50, 0.9), (110 - 2 * VEL[0],
                                     60 - 2 * VEL[1], 0.8)],
                                    drop=((), (0, 1)))
    return [_track(tr, cfg, frames, boxes, scores)]


def check_ids_stable_and_new_id(outs):
    ids = outs[0]["ids"]
    assert (ids[:, 0] == ids[0, 0]).all()
    assert ids[2, 1] >= 0 and ids[2, 1] != ids[2, 0]
    assert (ids[2:, 1] == ids[2, 1]).all() and (ids[:2, 1] == -1).all()


def scen_swap_resistance(tr, cfg):
    frames, boxes, scores = _moving(4, [(40, 50, 0.9), (58, 56, 0.85)])
    return [_track(tr, cfg, frames, boxes, scores)]


def check_swap_resistance(outs):
    ids = outs[0]["ids"]
    assert (ids[:, 0] == ids[0, 0]).all() and (ids[:, 1] == ids[0, 1]).all()
    assert ids[0, 0] != ids[0, 1]


def scen_detector_miss_recovered(tr, cfg):
    frames, boxes, scores, _ = _dropout_scenario()
    return [_track(tr, cfg, frames, boxes, scores)]


def check_detector_miss_recovered(outs):
    ids, valid = outs[0]["ids"], outs[0]["valid"]
    p = 4
    b_id = ids[0, 1]
    assert not valid[3, 1] and (ids[3, p:] == b_id).sum() == 1
    assert (ids[4:, 1] == b_id).all()


def scen_age_cap(tr, cfg):
    frames, boxes, scores = _moving(7, [(40, 50, 0.9), (90, 60, 0.8)],
                                    drop=((), range(2, 7)))
    return [_track(tr, cfg, frames, boxes, scores)]


def check_age_cap(outs):
    ids, valid = outs[0]["ids"], outs[0]["valid"]
    b_id = ids[0, 1]
    for t in (2, 3):
        assert (ids[t][valid[t]] == b_id).sum() == 1
    for t in (4, 5, 6):
        assert b_id not in set(ids[t][valid[t]].tolist())


def scen_keyframe_interval(tr, cfg):
    frames, boxes, scores, _ = _dropout_scenario(f=6, drop_frame=-1)
    return [_track(tr, cfg, frames, boxes, scores)]


def check_keyframe_interval(outs):
    ids, valid = outs[0]["ids"], outs[0]["valid"]
    a_id, b_id = ids[0, 0], ids[0, 1]
    for t in range(6):
        assert {a_id, b_id} <= set(ids[t][valid[t]].tolist())
        if t % 2:
            assert not valid[t, :4].any()


def scen_recover_off(tr, cfg):
    frames, boxes, scores, _ = _dropout_scenario(f=4)
    return [_track(tr, cfg, frames, boxes, scores)]


def check_recover_off(outs):
    assert outs[0]["ids"].shape == (4, 4)


def scen_budget_pressure(tr, cfg):
    # both persons dropped at frames 2 and 3: 4 recovery candidates for a
    # budget of ceil(5 * 0.5) = 3; then the same clip padded to 8 frames
    f, fpad = 5, 8
    frames, boxes, scores = _moving(f, [(30, 40, 0.9), (90, 70, 0.85)],
                                    drop=((2, 3), (2, 3)))
    db, dsc, dv = pad_detections(boxes, scores, cfg.track.max_persons)
    want = tr.to_host(tr.run_prepared(tr.prepare(frames, db, dsc, dv)))
    pad = fpad - f
    padded = tr.prepare(np.concatenate([frames, np.repeat(frames[-1:], pad, 0)]),
                        np.concatenate([db, np.zeros((pad,) + db.shape[1:],
                                                     np.float32)]),
                        np.concatenate([dsc, np.zeros((pad,) + dsc.shape[1:],
                                                      np.float32)]),
                        np.concatenate([dv, np.zeros((pad,) + dv.shape[1:],
                                                     bool)]),
                        np.arange(fpad) < f)
    return [want, tr.to_host(tr.run_prepared(padded, budget_frames=f))]


def check_budget_pressure(outs):
    want, got = outs
    assert int(want["valid"][:, 4:].sum()) == 3
    for key in ("joints", "maxvals", "scores", "ids", "valid"):
        np.testing.assert_array_equal(got[key][:5], want[key], err_msg=key)


def scen_uint8_frames(tr, cfg):
    frames, boxes, scores = _moving(4, [(20, 25, 0.9)])
    frames8 = np.random.default_rng(0).integers(0, 256, (4, 64, 96, 3),
                                                dtype=np.uint8)
    return [_track(tr, cfg, frames8, boxes, scores),
            _track(tr, cfg, frames8.astype(np.float32), boxes, scores)]


def check_uint8_frames(outs):
    np.testing.assert_array_equal(outs[0]["ids"], outs[1]["ids"])
    np.testing.assert_allclose(outs[0]["joints"], outs[1]["joints"], atol=1e-5)


def scen_chained_occluded_boundary(tr, cfg):
    frames, boxes, scores = _moving(4, [(40, 50, 0.9)])
    out1, seed = _track(tr, cfg, frames, boxes, scores, return_seed=True)
    frames, boxes, scores = _moving(4, [(40, 50, 0.9)], t0=3, drop=((3,),))
    return [out1, _track(tr, cfg, frames, boxes, scores, seed=seed,
                         frame_offset=3)]


def check_chained_occluded_boundary(outs):
    out1, out2 = outs
    id1 = out1["ids"][0][out1["valid"][0]][0]
    for t in range(4):
        assert out2["ids"][t][out2["valid"][t]].tolist() == [id1]


def _cfg_for(name):
    cfg = make_cfg()
    track = {
        "age_cap": dict(max_miss_age=2),
        "keyframe_interval": dict(keyframe_interval=2, max_miss_age=2),
        "recover_off": dict(clip_recover=False),
        "budget_pressure": dict(max_recovered=2, recover_budget=0.5,
                                max_miss_age=3),
    }.get(name, {})
    return replace(cfg, track=replace(cfg.track, **track))


SCENARIOS = ["ids_stable_and_new_id", "swap_resistance",
             "detector_miss_recovered", "age_cap", "keyframe_interval",
             "recover_off", "budget_pressure", "uint8_frames",
             "chained_occluded_boundary"]


def _reference(cfg):
    """The JAX tracker of ``cfg``: the default configuration's is
    tests/test_clip_pipeline.py's shared ``default_tracker`` (one jit cache
    for every scenario of that configuration and clip shape)."""
    if cfg == make_cfg():
        return default_tracker()
    return JaxClipTracker(cfg, StubPose(), {}, StubFlow(), {})


@pytest.mark.parametrize("name", SCENARIOS)
def test_stub_scenario_matches_reference(name):
    cfg = _cfg_for(name)
    scenario = globals()[f"scen_{name}"]
    want = scenario(_reference(cfg), cfg)
    got = scenario(ClipTracker(cfg, StubPoseTorch(), StubFlowTorch(),
                               device="cpu"), cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ids"], w["ids"])
        np.testing.assert_array_equal(g["valid"], w["valid"])
        v = w["valid"]
        np.testing.assert_allclose(g["joints"][v], w["joints"][v], atol=1e-3)
    globals()[f"check_{name}"](got)


class ThreeLaneTracker(ClipTracker):
    """Runs every clip as lane 1 of a batch of three: lane 0 holds the same
    frames with every box moved 7 px, lane 2 the same clip with no valid
    detection, both from the empty seed."""

    def run_prepared(self, device_args, budget_frames=None, seed=None):
        moved = list(device_args)
        moved[1] = moved[1] + 7.0
        moved[5] = moved[5] + 7.0
        none = list(device_args)
        none[4] = torch.zeros_like(device_args[4])
        lanes = [torch.stack(x) for x in zip(moved, device_args, none)]
        out = self.run_prepared_lanes(lanes, [None, seed, None],
                                      budget_frames)
        return (*(x[1] for x in out[:5]), tuple(s[1] for s in out[5]))


@pytest.mark.parametrize("name", SCENARIOS)
def test_stub_scenario_as_a_lane_of_three(name):
    """A clip tracked as one lane of a three-lane batch (run_prepared_lanes,
    as MultiStreamTracker and track_clips run it) gives the one-lane run's
    outputs and seed bit for bit: nothing crosses lanes, the recovery
    budget is per lane, and the lanes' seeds stay apart."""
    cfg = _cfg_for(name)
    scenario = globals()[f"scen_{name}"]
    want = scenario(ClipTracker(cfg, StubPoseTorch(), StubFlowTorch(),
                                device="cpu"), cfg)
    got = scenario(ThreeLaneTracker(cfg, StubPoseTorch(), StubFlowTorch(),
                                    device="cpu"), cfg)
    for g, w in zip(got, want):
        for key in ("joints", "maxvals", "scores", "ids", "valid"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    globals()[f"check_{name}"](got)


def test_clip_run_never_syncs_with_host():
    """The clip program queues device work only: no .item(), bool() or
    int() of a tensor (aten::_local_scalar_dense) anywhere in run_prepared
    or in a batched run_prepared_lanes of two lanes, one seeded, scans
    included; the one copy back is to_host's."""
    cfg = _cfg_for("detector_miss_recovered")
    tracker = ClipTracker(cfg, StubPoseTorch(), StubFlowTorch(), device="cpu")
    frames, boxes, scores, _ = _dropout_scenario()
    args = tracker.prepare(frames, *pad_detections(boxes, scores,
                                                   cfg.track.max_persons))
    seed = tracker.run_prepared(args)[5]
    runs = {(6, tracker.num_slots): lambda: tracker.run_prepared(args),
            (2, 6, tracker.num_slots): lambda: tracker.run_prepared_lanes(
                [torch.stack([a, a]) for a in args], [seed, None])}
    for shape, run in runs.items():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = run()
        names = {e.name for e in prof.events()}
        assert "aten::_local_scalar_dense" not in names
        assert "aten::item" not in names
        assert {"clip.flow", "clip.pose", "clip.recovery_scan",
                "clip.recovery_pose", "clip.id_scan"} <= names
        assert tracker.to_host(out)["ids"].shape == shape


class ContentPoseTorch(nn.Module):
    """Heatmaps that are the crop's (resized) intensity, so every crop
    decodes differently and a chunk-order or flip-merge slip shows."""

    def forward(self, x):
        g = x.float().mean(1, keepdim=True)
        hm = nn.functional.interpolate(g, size=HM_HW, mode="bilinear",
                                       align_corners=False)
        return hm.expand(-1, K, -1, -1)


def test_pose_and_flow_chunks_match_one_call():
    """track.pose_chunk / flow_chunk only cap memory: 24 crops in chunks of
    8 (exact) and of 7 (a 3-crop tail call), the flip double batch inside
    each chunk, and 5 pairs in flow chunks of 2 give the one-call results
    to 1e-6."""
    base = make_cfg()
    cfg = replace(base, test=replace(base.test, flip_test=True))
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 255, (6, 128, 160, 3)).astype(np.float32)
    _, boxes, scores = _moving(6, [(40, 50, 0.9), (85, 60, 0.8)])
    db, dsc, dv = pad_detections(boxes, scores, cfg.track.max_persons)
    want = ClipTracker(cfg, ContentPoseTorch(), StubFlowTorch(),
                       device="cpu").track_clip(frames, db, dsc, dv)
    for pose_chunk in (8, 7):
        ccfg = replace(cfg, track=replace(cfg.track, pose_chunk=pose_chunk,
                                          flow_chunk=2))
        got = ClipTracker(ccfg, ContentPoseTorch(), StubFlowTorch(),
                          device="cpu").track_clip(frames, db, dsc, dv)
        for key in ("joints", "maxvals", "scores", "ids", "valid"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-6, err_msg=key)
