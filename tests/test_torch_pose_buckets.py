"""The clip's first pose pass at the bucket of its occupied slots
(``clip_pipeline.pose_slots``): a frame's detections lie in its first
slots, so a batch whose frames hold at most n boxes poses the first Pb of
its P slots, Pb the smallest of 8, 16, 32, ... above n (P where none lies
below P), and its padded slots past Pb take the poses of slot Pb-1, whose
zero box they share. Every output keeps P slots.

The nets are tests/test_torch_clip_pipeline.py's (PoseResNet-18 at 64x48,
FlowNetC at 64x64 frames, float32, random weights) with P = 32 slots and
2-6 persons a frame: the bucketed route against the same tracker made to
pose every slot, and against the JAX ClipTracker, which poses every slot.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JaxClipTracker
from flowtrack_tpu_torch import aot
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.serving import MultiStreamTracker
from flowtrack_tpu_torch.tracking.clip_pipeline import (ClipTracker,
                                                        pad_detections,
                                                        pose_slots)
from flowtrack_tpu_torch.utils import profiling
from flowtrack_tpu_torch.utils.convert import load_flownet, load_pose_resnet
from tests.test_torch_clip_pipeline import (_assert_outputs_match, _cfg,
                                            _random_variables)

P, F = 32, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the whole suite runs in six
    workers on the host's cores at once, and torch's pool of spinning
    threads slowed these tests a hundredfold there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wide():
    cfg = _cfg()
    cfg = replace(cfg, track=replace(cfg.track, max_persons=P))
    jpose, jflow = jax_pose_net(cfg.model), jax_flow_net(cfg.flow)
    pv = _random_variables(jpose, (1, 64, 48, 3), 0)
    fv = _random_variables(jflow, (1, 64, 64, 6), 1)
    ref = JaxClipTracker(cfg, jpose, pv, jflow, fv)
    port = ClipTracker(cfg, load_pose_resnet(get_pose_net(cfg.model), pv),
                       load_flownet(get_flow_net(cfg.flow), fv),
                       device="cpu")
    return ref, port


def _sparse_clip(counts, seed=0):
    """Six persons of 14x24 px on a textured 64x64 background, moving 1 px
    a frame; frame t shows the first ``counts[t]`` of them, so persons
    leave and come back and the recovery pass has work."""
    rng = np.random.default_rng(seed)
    base = np.random.default_rng(99).uniform(0, 255, (64, 64, 3))
    frames = np.stack([np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
                       for _ in counts]).astype(np.float32)
    starts = rng.uniform(2, 40, (6, 2))
    scores = rng.uniform(0.6, 0.95, 6)
    boxes = [[[x + t, y + t * 0.5, 14, 24] for x, y in starts[:n]]
             for t, n in enumerate(counts)]
    return (frames, *pad_detections(boxes, [scores[:n] for n in counts], P))


def _lanes(*clips):
    return [np.stack(x) for x in zip(*clips)]


def _leaves(out):
    return [*out[:5], *out[5]]


@pytest.mark.parametrize("route", ["every_slot", "reference"])
def test_sparse_clip_poses_its_bucket(wide, route):
    """Two lanes of 2-6 persons a frame pose 8 slots a frame: each output,
    seed included, equals the same tracker's run made to pose all 32
    (``slots=P``); one clip equals the reference's, which poses all 32."""
    ref, port = wide
    clips = [_sparse_clip((6, 2, 4)), _sparse_clip((3, 5, 2), seed=1)]
    args = port.prepare_lanes(*_lanes(*clips))
    assert args[1].shape == args[2].shape == (2, F, 8, 2)
    assert args[3].shape == args[4].shape == (2, F, P)
    if route == "every_slot":
        every = port.prepare_lanes(*_lanes(*clips), slots=P)
        assert every[1].shape == (2, F, P, 2)
        for a, b in zip(args[1:3], every[1:3]):
            np.testing.assert_array_equal(a.numpy(), b[:, :, :8].numpy())
        got, want = (port.run_prepared_lanes(a) for a in (args, every))
        assert got[0].shape == (2, F, P + 2, 17, 2)
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert got[4][:, :, P:].any(), "no recovered slot"
    else:
        got = port.track_clip(*clips[0])
        _assert_outputs_match(got, ref.track_clip(*clips[0]))
        assert got["valid"][:, :P].sum() == 12


@pytest.mark.parametrize("used, p, slots", [
    (0, 32, 8), (7, 32, 8), (8, 32, 16), (15, 32, 16), (16, 32, 32),
    (32, 32, 32), (13, 20, 16), (16, 20, 20),
    # P <= 8 never compacts
    (0, 8, 8), (8, 8, 8), (0, 3, 3), (2, 3, 3)])
def test_pose_slots(used, p, slots):
    """The bucket holds the last occupied slot of the batch's fullest
    frame; a zero box is padding, any other box occupies its slot."""
    boxes = np.zeros((2, 3, p, 4), np.float32)
    boxes[:, :, :min(used, 2)] = (5.0, 5.0, 10.0, 20.0)
    boxes[1, 2, :used] = (0.0, 0.0, 0.0, 1.0)
    assert pose_slots(boxes, p) == slots


def test_trailing_invalid_box_is_posed(wide):
    """A slot that det_valid drops but that holds a real box is occupied:
    five valid persons and a dropped box in slot 8 take the bucket of 16;
    each bucket is a graph geometry of its own, the switch counts the
    bucket (``pose.bucket.16``), and slots below the bucket are refused."""
    _, port = wide
    frames, boxes, scores, valid = _sparse_clip((5, 5, 5))
    boxes[1, 8] = (30.0, 20.0, 14.0, 24.0)
    profiling.enable()
    try:
        before = profiling.snapshot().get("pose.bucket.16", {}).get("count", 0)
        args = port.prepare(frames, boxes, scores, valid)
        after = profiling.snapshot()["pose.bucket.16"]["count"]
    finally:
        profiling.disable()
    assert after == before + 1
    assert args[1].shape == (F, 16, 2) and not args[4][:, 8].any()
    lanes = [a[None] for a in args]
    every = [a[None] for a in port.prepare(frames, boxes, scores, valid,
                                           slots=P)]
    assert port.graph_key(lanes, None) != port.graph_key(every, None)
    with pytest.raises(ValueError):
        port.prepare(frames, boxes, scores, valid, slots=8)


def test_serving_counts_the_rows_posed(wide):
    """A serving batch of two sparse streams counts the rows its pose
    passes ran: 2 lanes x 3 frames x 8 slots and each lane's recovery
    budget of 3, twice for the flip test; the exported program's specs
    keep all P slots."""
    _, port = wide
    mst = MultiStreamTracker(port, clip_len=F, batch_streams=2)
    streams = [_sparse_clip((2, 4, 6)), _sparse_clip((5, 3, 2), seed=1)]
    profiling.enable()
    try:
        before = profiling.snapshot()
        for t in range(F):
            for sid, (frames, boxes, scores, valid) in enumerate(streams):
                mst.submit(sid, frames[t], boxes[t][valid[t]],
                           scores[t][valid[t]])
            mst.step()
        mst.flush()
        after = profiling.snapshot()
    finally:
        profiling.disable()

    def grown(name):
        return after[name]["count"] - before.get(name, {}).get("count", 0)

    assert port.recovery_budget(F) == 3
    assert grown("pose.forwards") == port.pose_rows(2, F, 8) == \
        2 * (2 * F * 8 + 2 * 3)
    assert grown("pose.bucket.8") == 1
    specs = aot.clip_arg_specs(port, F, (64, 64))
    assert specs[3].shape == specs[4].shape == (F, P, 2)
    assert specs[5].shape == (F, P)
