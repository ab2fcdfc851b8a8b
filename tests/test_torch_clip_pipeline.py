"""The port's ClipTracker against the JAX ClipTracker with real small models.

PoseResNet-18 at 64x48 and FlowNetC at 64x64 frames, float32, random
weights shared through ``torch_convert.reverse_*``; the JAX FlowNetC uses
``correlation_xla`` (its Pallas correlation needs interpret mode on the
CPU, which the model does not forward; tests/test_correlation_warp.py pins
the kernel to the XLA twin). ``pose_score_thre`` is lowered so that the
random-weight candidates stay valid and the scans have work to do.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import Config, FlowConfig, ModelConfig
from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JaxClipTracker
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker, pad_detections
from flowtrack_tpu_torch.utils.convert import load_flownet, load_pose_resnet

P = 3


def _cfg():
    cfg = Config(model=ModelConfig(num_layers=18, image_size=(64, 48),
                                   heatmap_size=(16, 12), dtype="float32"),
                 flow=FlowConfig(variant="flownet_c", dtype="float32",
                                 use_pallas_corr=False))
    return replace(cfg, track=replace(cfg.track, max_persons=P,
                                      max_recovered=2, pose_score_thre=-1.0,
                                      track_oks_thre=0.1))


# the reference's modules whose kernels start N(0, 0.001): every
# ConvTransposeTorch (layers.py:45; the pose head's deconv{i}, FlowNet's
# deconv and upsampled_flow*) and the pose net's final conv
# (pose_resnet.py:144)
_SMALL_INIT = ("deconv", "upsampled_flow", "final")


def _random_variables(model, input_shape, seed):
    """The model's variable tree (shapes from ``jax.eval_shape``, no
    compile) drawn from numpy with the reference's own initializers: a
    kernel of a module named in ``_SMALL_INIT`` N(0, 0.001), every other
    conv kernel he_normal (layers.py:80: flax's truncated normal, std
    sqrt(2 / fan_in) / 0.8796 cut at two of its stds), biases and
    batch-norm means 0, batch-norm scales and variances 1 (layers.py:110)."""
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(input_shape), train=False))
    rng = np.random.default_rng(seed)

    def truncated(shape):
        x = rng.standard_normal(shape)
        while (out := np.abs(x) > 2).any():
            x[out] = rng.standard_normal(out.sum())
        return x

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            if path[-2].key.startswith(_SMALL_INIT):
                return rng.normal(0.0, 0.001, shape).astype(np.float32)
            std = np.sqrt(2.0 / np.prod(shape[:-1])) / 0.87962566103423978
            return (truncated(shape) * std).astype(np.float32)
        return np.full(shape, 1.0 if name in ("scale", "var") else 0.0,
                       np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def trackers():
    cfg = _cfg()
    jpose, jflow = jax_pose_net(cfg.model), jax_flow_net(cfg.flow)
    pv = _random_variables(jpose, (1, 64, 48, 3), 0)
    fv = _random_variables(jflow, (1, 64, 64, 6), 1)
    ref = JaxClipTracker(cfg, jpose, pv, jflow, fv)
    port = ClipTracker(cfg, load_pose_resnet(get_pose_net(cfg.model), pv),
                       load_flownet(get_flow_net(cfg.flow), fv),
                       device="cpu")
    return ref, port


def _clip(t0, f, drop_at=None, seed=0):
    """Two persons on a fixed textured background, moving 1 px per frame;
    the second person's detection is dropped at global frame ``drop_at``."""
    rng = np.random.default_rng(seed)
    base = np.random.default_rng(99).uniform(0, 255, (64, 64, 3))
    frames = np.stack([np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
                       for _ in range(f)]).astype(np.float32)
    boxes, scores = [], []
    for i in range(f):
        t = t0 + i
        b, s = [[8 + t, 10, 20, 30], [36, 12 + t, 18, 28]], [0.9, 0.8]
        if t == drop_at:
            b, s = b[:1], s[:1]
        boxes.append(b)
        scores.append(s)
    return (frames, *pad_detections(boxes, scores, P))


def _assert_outputs_match(got, want):
    """ids and valid equal; joints within 1e-3 px of image coordinates in
    [0, 64) (observed 2e-5), maxvals and scores within 1e-6 relative."""
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["joints"], want["joints"], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got["maxvals"], want["maxvals"], rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-9)


def test_chained_clips_match_reference(trackers):
    """Two 4-frame clips overlapping by one frame, the second seeded by the
    first; a detection drop inside the second exercises the recovery slots
    and the seed carries global ids across the boundary."""
    ref, port = trackers
    c1, c2 = _clip(0, 4), _clip(3, 4, drop_at=4, seed=1)
    want1, wseed = ref.track_clip(*c1, return_seed=True)
    want2 = ref.track_clip(*c2, seed=wseed, frame_offset=3)
    got1, gseed = port.track_clip(*c1, return_seed=True)
    got2 = port.track_clip(*c2, seed=gseed, frame_offset=3)
    assert got1["ids"].shape == (4, P + 2)
    _assert_outputs_match(got1, want1)
    _assert_outputs_match(got2, want2)
    # the scenario really carries ids: clip 2's first frame reuses clip 1's
    assert set(got2["ids"][0][got2["valid"][0]]) & set(
        got1["ids"][-1][got1["valid"][-1]])
    for a, b in zip(gseed, wseed):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-5)


def test_padded_clip_matches_reference(trackers):
    """A 4-frame clip padded to 6 with invalid frames, budget_frames=4:
    equal to the reference's padded run, and to the port's own unpadded
    run on the real frames."""
    ref, port = trackers
    frames, db, dsc, dv = _clip(0, 4, drop_at=2, seed=2)
    pad = 2
    padded = (np.concatenate([frames, np.repeat(frames[-1:], pad, 0)]),
              np.concatenate([db, np.zeros((pad, P, 4), np.float32)]),
              np.concatenate([dsc, np.zeros((pad, P), np.float32)]),
              np.concatenate([dv, np.zeros((pad, P), bool)]),
              np.arange(4 + pad) < 4)
    want = ref.to_host(ref.run_prepared(ref.prepare(*padded), budget_frames=4))
    got_dev = port.run_prepared(port.prepare(*padded), budget_frames=4)
    got = port.to_host(got_dev)
    _assert_outputs_match(got, want)
    unpadded_dev = port.run_prepared(port.prepare(frames, db, dsc, dv))
    unpadded = port.to_host(unpadded_dev)
    for key in ("ids", "valid", "joints", "scores"):
        np.testing.assert_array_equal(got[key][:4], unpadded[key], err_msg=key)
    for a, b in zip(got_dev[5], unpadded_dev[5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _lanes(*clips):
    return [np.stack(x) for x in zip(*clips)]


def test_track_clips_matches_separate_clips_and_reference(trackers):
    """Three 4-frame clips of one shape (one with a dropped detection) in
    one batched run: each lane equals its own track_clip, and the whole
    equals the reference's vmapped track_clips, with a leading C of 3."""
    ref, port = trackers
    clips = [_clip(0, 4), _clip(2, 4, drop_at=3, seed=3), _clip(5, 4, seed=4)]
    got = port.track_clips(*_lanes(*clips))
    want = ref.track_clips(*_lanes(*clips))
    assert got["ids"].shape == (3, 4, P + 2)
    _assert_outputs_match(got, want)
    for i, clip in enumerate(clips):
        _assert_outputs_match({k: v[i] for k, v in got.items()},
                              port.track_clip(*clip))


def test_seeded_lanes_match_chained_clips(trackers):
    """prepare_lanes and run_prepared_lanes with a seed per lane, as
    MultiStreamTracker dispatches a batch: lane i's second clip, seeded by
    lane i's first,
    equals the chained track_clip of that stream alone, and the lanes'
    output seeds equal the chained runs' seeds."""
    _, port = trackers
    streams = [(_clip(0, 4), _clip(3, 4, drop_at=4, seed=1)),
               (_clip(1, 4, seed=5), _clip(4, 4, drop_at=5, seed=6))]
    first = port.run_prepared_lanes(
        port.prepare_lanes(*_lanes(*(s[0] for s in streams))))
    seeds = [tuple(leaf[i] for leaf in first[5]) for i in range(2)]
    second = port.run_prepared_lanes(port.prepare_lanes(
        *_lanes(*(s[1] for s in streams)), frame_offsets=[3, 3]), seeds)
    got = port.to_host(second)
    for i, (c1, c2) in enumerate(streams):
        _, seed = port.track_clip(*c1, return_seed=True)
        want, want_seed = port.track_clip(*c2, seed=seed, frame_offset=3,
                                          return_seed=True)
        _assert_outputs_match({k: v[i] for k, v in got.items()}, want)
        for a, b in zip(second[5], want_seed):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), atol=1e-3,
                                       rtol=1e-5)


@pytest.mark.parametrize("keyframe_interval", [1, 3])
def test_prepare_lanes_matches_reference_prepare(trackers, keyframe_interval):
    """prepare_lanes of three clips with their own first global frames
    gives, lane by lane, the reference's prepare of each clip alone (the
    keyframe mask following each lane's offset), and prepare is its one-lane
    case."""
    import copy

    ref, port = trackers
    ref, port = copy.copy(ref), copy.copy(port)
    for t in (ref, port):
        t.cfg = replace(t.cfg, track=replace(
            t.cfg.track, keyframe_interval=keyframe_interval))
    clips = [_clip(0, 4), _clip(2, 4, drop_at=3, seed=3), _clip(5, 4, seed=4)]
    offsets = [0, 4, 2]
    lanes = port.prepare_lanes(*_lanes(*clips), frame_offsets=offsets)
    for i, (clip, off) in enumerate(zip(clips, offsets)):
        want = ref.prepare(*clip, frame_offset=off)
        one = port.prepare(*clip, frame_offset=off)
        for got, single, ref_leaf in zip(lanes, one, want):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref_leaf))
            np.testing.assert_array_equal(single.numpy(), np.asarray(ref_leaf))
