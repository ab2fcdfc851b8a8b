"""The port's suppression, OKS and streaming-tracker pieces against the JAX
reference, on the CPU.

Inputs are made with numpy from fixed seeds and go through both packages.
Masks, indices, assignments and ids must be equal; each float comparison
states its tolerance. The streaming ``FlowTracker`` runs with the port's
``PosePredictor`` and ``FlowPredictor`` against the reference's with the
same random PoseResNet-18 (64x48 crops) and FlowNetC weights, loaded into
the port by ``utils/convert``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.ops import nms as jnms
from flowtrack_tpu.ops import oks as joks
from flowtrack_tpu.tracking import clip_pipeline as jclip
from flowtrack_tpu.tracking import tracker as jtracker
from flowtrack_tpu_torch.ops import nms as tnms
from flowtrack_tpu_torch.ops import oks as toks
from flowtrack_tpu_torch.ops.warp import flow_gather
from flowtrack_tpu_torch.tracking import clip_pipeline as tclip
from flowtrack_tpu_torch.tracking import tracker as ttracker


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _poses(rng, n, spread=30.0):
    base = rng.uniform(50, 200, (n, 1, 2))
    return (base + rng.normal(0, spread, (n, 17, 2))).astype(np.float32)


def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(10, 60, (n, 2))],
                          1).astype(np.float32)


# ------------------------------------------------------------- greedy NMS

def _nms_cases():
    """(boxes, scores, valid): random, tied scores, padded, all padded,
    one box, a chain of overlaps."""
    rng = np.random.default_rng(30)
    boxes = _boxes(rng, 12)
    boxes[5] = boxes[2] + 2.0             # near-duplicates
    boxes[9] = boxes[2] + 4.0
    scores = rng.uniform(0.1, 1.0, 12).astype(np.float32)
    tied = np.round(scores * 3) / 3       # few distinct values
    tied[[2, 5, 9]] = 0.5                 # a tie among the duplicates
    valid = rng.uniform(size=12) > 0.3
    chain = np.array([[0, 0, 10, 10], [5, 0, 15, 10], [10, 0, 20, 10],
                      [15, 0, 25, 10]], np.float32)
    return [(boxes, scores, None), (boxes, tied.astype(np.float32), None),
            (boxes, tied.astype(np.float32), valid),
            (boxes, scores, np.zeros(12, bool)),
            (boxes[:1], scores[:1], None),
            (chain, np.array([0.9, 0.8, 0.7, 0.6], np.float32), None)]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("thresh", [0.3, 0.5])
def test_box_nms_matches_reference(case, thresh):
    """nms_boxes and greedy_nms_from_matrix keep the reference's mask;
    equal scores keep the highest index; without padding the kept set is
    nms_boxes_np's."""
    boxes, scores, valid = _nms_cases()[case]
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    want = np.asarray(jnms.nms_boxes(jnp.asarray(boxes), jnp.asarray(scores),
                                     thresh, jv))
    got = N(tnms.nms_boxes(T(boxes), T(scores), thresh, tv))
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    got_m = N(tnms.greedy_nms_from_matrix(tnms.iou_matrix(T(boxes), T(boxes)),
                                          T(scores), thresh, tv))
    np.testing.assert_array_equal(got_m, want)
    if valid is None:
        dets = np.concatenate([boxes, scores[:, None]], 1)
        assert sorted(tnms.nms_boxes_np(dets, thresh)) == \
            sorted(np.flatnonzero(got).tolist())


def test_nms_padding_changes_nothing():
    """Padded entries (any box, any score) are never kept and never
    suppress: the real entries' mask equals the unpadded run's."""
    boxes, scores, _ = _nms_cases()[1]
    rng = np.random.default_rng(31)
    pad_boxes = np.concatenate([boxes, _boxes(rng, 4)])
    pad_scores = np.concatenate([scores, np.full(4, 2.0, np.float32)])
    valid = np.arange(16) < 12
    got = N(tnms.nms_boxes(T(pad_boxes), T(pad_scores), 0.4, T(valid)))
    want = N(tnms.nms_boxes(T(boxes), T(scores), 0.4))
    np.testing.assert_array_equal(got[:12], want)
    assert not got[12:].any()


@pytest.mark.parametrize("vis", [False, True])
def test_oks_nms_matches_reference(vis):
    """OKS-NMS keeps the reference's mask, with and without the candidate
    visibility filter, and the numpy twins keep the reference twins'
    indices (oks_nms_np, soft_oks_nms_np)."""
    rng = np.random.default_rng(32)
    k = _poses(rng, 8)
    k[3] = k[1] + rng.normal(0, 1, (17, 2))
    k[6] = k[1] + rng.normal(0, 2, (17, 2))
    scores = rng.uniform(0.2, 1, 8).astype(np.float32)
    scores[6] = scores[1]                  # tie with a duplicate
    areas = rng.uniform(2000, 8000, 8).astype(np.float32)
    conf = rng.uniform(0, 1, (8, 17)).astype(np.float32)
    kw_j = dict(conf=jnp.asarray(conf), in_vis_thre=0.3) if vis else {}
    kw_t = dict(conf=T(conf), in_vis_thre=0.3) if vis else {}
    want = np.asarray(jnms.oks_nms(jnp.asarray(k), jnp.asarray(scores),
                                   jnp.asarray(areas), 0.5, **kw_j))
    got = N(tnms.oks_nms(T(k), T(scores), T(areas), 0.5, **kw_t))
    np.testing.assert_array_equal(got, want)
    assert not got.all()
    kpts = [{"keypoints": np.concatenate([k[i], conf[i][:, None]], 1),
             "score": float(scores[i]), "area": float(areas[i])}
            for i in range(8)]
    thre = 0.3 if vis else None
    assert tnms.oks_nms_np(kpts, 0.5, in_vis_thre=thre) == \
        jnms.oks_nms_np(kpts, 0.5, in_vis_thre=thre)
    got_soft, _ = tnms.soft_oks_nms_np(kpts, 0.5, max_dets=5, in_vis_thre=thre)
    want_soft, _ = jnms.soft_oks_nms_np(kpts, 0.5, max_dets=5,
                                        in_vis_thre=thre)
    assert got_soft == want_soft
    assert tnms.oks_nms_np([], 0.5) == [] and tnms.nms_boxes_np([], 0.5) == []


# ---------------------------------------------------------------- OKS

def test_oks_matrix_visibility_filter_matches_reference():
    """b_conf / vis_thre count only the candidates' joints above the
    threshold; a candidate with none has OKS 0 (1e-6 relative)."""
    rng = np.random.default_rng(33)
    a, b = _poses(rng, 4), _poses(rng, 6)
    b[2] = a[1] + rng.normal(0, 2, (17, 2))
    conf = rng.uniform(0, 1, (6, 17)).astype(np.float32)
    conf[4] = 0.0
    aa, ba = joks.pose_area(a), joks.pose_area(b)
    want = np.asarray(joks.oks_matrix(a, aa, b, ba, b_conf=conf,
                                      vis_thre=0.4))
    got = N(toks.oks_matrix(T(a), T(np.asarray(aa)), T(b), T(np.asarray(ba)),
                            b_conf=T(conf), vis_thre=0.4))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[:, 4] == 0).all() and got[1, 2] > 0.5
    # without the threshold every joint counts
    plain = N(toks.oks_matrix(T(a), T(np.asarray(aa)), T(b),
                              T(np.asarray(ba)), b_conf=T(conf)))
    np.testing.assert_allclose(plain, np.asarray(joks.oks_matrix(a, aa, b, ba)),
                               rtol=1e-6)


def test_oks_one_to_many_pose_area_and_numpy_twin_match_reference():
    """oks_one_to_many with (N, K) and (K,) visibilities, pose_area over
    visible joints, and oks_iou_np (the candidate-visibility quirk)."""
    rng = np.random.default_rng(34)
    g, d = _poses(rng, 1)[0], _poses(rng, 5)
    d_vis = (rng.uniform(size=(5, 17)) > 0.4).astype(np.float32)
    d_vis[3] = 0.0
    d_area = np.full(5, 2500.0, np.float32)
    for vis, thre in ((d_vis, 0.5), (d_vis[0], 0.5), (d_vis, None)):
        want = np.asarray(joks.oks_one_to_many(
            jnp.asarray(g), jnp.asarray(vis), 2000.0, jnp.asarray(d),
            jnp.asarray(d_area), in_vis_thre=thre))
        got = N(toks.oks_one_to_many(T(g), T(vis), 2000.0, T(d), T(d_area),
                                     in_vis_thre=thre))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[3] > 0 and N(toks.oks_one_to_many(
        T(g), T(d_vis), 2000.0, T(d), T(d_area), in_vis_thre=0.5))[3] == 0
    np.testing.assert_allclose(
        N(toks.pose_area(T(d), T(d_vis))),
        np.asarray(joks.pose_area(jnp.asarray(d), jnp.asarray(d_vis))),
        rtol=1e-6)
    gflat = np.stack([g[:, 0], g[:, 1], np.ones(17)], 1).reshape(-1)
    dflat = np.concatenate([d, d_vis[..., None]], -1).reshape(5, -1)
    for thre in (None, 0.5):
        np.testing.assert_array_equal(
            toks.oks_iou_np(gflat, dflat, 2000.0, d_area, in_vis_thre=thre),
            joks.oks_iou_np(gflat, dflat, 2000.0, d_area, in_vis_thre=thre))
    assert toks.oks_iou_np(gflat, [], 1.0, []).shape == (0,)


def test_boxes_from_poses_conf_matches_reference():
    """Boxes around the confident joints only (1e-6 of coordinates < 300);
    conf None is every joint."""
    rng = np.random.default_rng(35)
    j = _poses(rng, 5)
    conf = rng.uniform(0, 1, (5, 17)).astype(np.float32)
    for c, thre in ((conf, 0.3), (conf, 0.0), (None, 0.0)):
        want = np.asarray(jtracker.boxes_from_poses(
            jnp.asarray(j), 0.15, None if c is None else jnp.asarray(c), thre))
        got = N(ttracker.boxes_from_poses(T(j), 0.15,
                                          None if c is None else T(c), thre))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------- lanes: one call, C lanes

def test_batched_primitives_equal_each_lane():
    """The scans' primitives with a leading lane axis give, lane by lane,
    the one-lane results bit for bit: oks_matrix, pose_area, greedy_match
    (ties and padding included), iou_matrix, flow_gather, _assign_ids and
    _top_k."""
    rng = np.random.default_rng(36)
    c = 3
    a = np.stack([_poses(rng, 5) for _ in range(c)])
    b = np.stack([_poses(rng, 4) for _ in range(c)])
    b[1, 2] = a[1, 0]
    valid_a = rng.uniform(size=(c, 5)) > 0.3
    valid_b = rng.uniform(size=(c, 4)) > 0.2
    flow = rng.normal(0, 3, (c, 40, 50, 2)).astype(np.float32)
    boxes_a = np.stack([_boxes(rng, 5) for _ in range(c)])
    boxes_b = np.stack([_boxes(rng, 4) for _ in range(c)])
    oks = N(toks.oks_matrix(T(a), toks.pose_area(T(a)), T(b),
                            toks.pose_area(T(b))))
    sim = oks.copy()
    sim[2, 1, :] = sim[2, 3, :] = 0.8     # ties
    assign = N(ttracker.greedy_match(T(sim), 0.1, T(valid_a), T(valid_b)))
    gathered = N(flow_gather(T(flow), T(a)))
    iou = N(tnms.iou_matrix(T(boxes_a), T(boxes_b)))
    tids = rng.integers(0, 50, (c, 5)).astype(np.int32)
    nid = np.array([50, 60, 70], np.int32)
    ids, nids = (N(x) for x in tclip._assign_ids(T(assign), T(valid_b),
                                                 T(tids), T(nid)))
    top_v, top_i = (N(x) for x in tclip._top_k(T(sim.reshape(c, -1)), 6))
    for i in range(c):
        np.testing.assert_array_equal(
            oks[i], N(toks.oks_matrix(T(a[i]), toks.pose_area(T(a[i])),
                                      T(b[i]), toks.pose_area(T(b[i])))))
        np.testing.assert_array_equal(
            assign[i], N(ttracker.greedy_match(T(sim[i]), 0.1, T(valid_a[i]),
                                               T(valid_b[i]))))
        np.testing.assert_array_equal(
            assign[i], np.asarray(jtracker.greedy_match(
                jnp.asarray(sim[i]), 0.1, jnp.asarray(valid_a[i]),
                jnp.asarray(valid_b[i]))))
        np.testing.assert_array_equal(gathered[i],
                                      N(flow_gather(T(flow[i]), T(a[i]))))
        np.testing.assert_array_equal(
            iou[i], N(tnms.iou_matrix(T(boxes_a[i]), T(boxes_b[i]))))
        want_ids, want_nid = jclip._assign_ids(
            jnp.asarray(assign[i]), jnp.asarray(valid_b[i]),
            jnp.asarray(tids[i]), jnp.asarray(nid[i]))
        np.testing.assert_array_equal(ids[i], np.asarray(want_ids))
        assert nids[i] == int(want_nid)
        wv, wi = jax.lax.top_k(jnp.asarray(sim[i].reshape(-1)), 6)
        np.testing.assert_array_equal(top_i[i], np.asarray(wi))
        np.testing.assert_array_equal(top_v[i], np.asarray(wv))


def test_match_step_and_propagate_and_boxes_match_reference():
    """The streaming tracker's device steps: propagation and boxes (1e-4 of
    coordinates < 300), and the assignment (equal), at unpadded counts."""
    rng = np.random.default_rng(37)
    tracks = _poses(rng, 3)
    flow = np.broadcast_to(np.array([4.0, -2.0], np.float32),
                           (240, 320, 2)).copy()
    cand = tracks[[2, 0]] + np.array([4.0, -2.0], np.float32) + \
        rng.normal(0, 0.5, (2, 17, 2)).astype(np.float32)
    prop_w, box_w = jtracker.propagate_and_boxes(jnp.asarray(tracks),
                                                 jnp.asarray(flow), 0.15)
    prop_g, box_g = ttracker.propagate_and_boxes(T(tracks), T(flow), 0.15)
    np.testing.assert_allclose(N(prop_g), np.asarray(prop_w), atol=1e-4)
    np.testing.assert_allclose(N(box_g), np.asarray(box_w), atol=1e-4)
    tv, cv = np.ones(3, bool), np.ones(2, bool)
    want_a, _ = jtracker.match_step(jnp.asarray(tracks), jnp.asarray(tv),
                                    jnp.asarray(cand), jnp.asarray(cv),
                                    jnp.asarray(flow), track_thr=0.5)
    got_a, got_p = ttracker.match_step(T(tracks), T(tv), T(cand), T(cv),
                                       T(flow), track_thr=0.5)
    np.testing.assert_array_equal(N(got_a), np.asarray(want_a))
    np.testing.assert_array_equal(N(got_a), [2, 0])
    np.testing.assert_array_equal(N(got_p), N(prop_g))
    np.testing.assert_array_equal(
        N(ttracker.match_propagated(got_p, T(tv), T(cand), T(cv), 0.5)),
        N(got_a))


# ------------------------------------------------ the streaming tracker

@pytest.fixture(scope="module")
def predictors():
    """The reference's and the port's PosePredictor / FlowPredictor over
    the same random R18 (64x48) and FlowNetC (64x64) weights."""
    from flowtrack_tpu.config import Config, FlowConfig, ModelConfig
    from flowtrack_tpu.models.flownet import get_flow_net as j_flow_net
    from flowtrack_tpu.models.pose_resnet import get_pose_net as j_pose_net
    from flowtrack_tpu.pipeline import FlowPredictor as JFlowPredictor
    from flowtrack_tpu.pipeline import PosePredictor as JPosePredictor
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.pipeline import FlowPredictor, PosePredictor
    from flowtrack_tpu_torch.utils.convert import load_flownet, load_pose_resnet
    from tests.test_torch_clip_pipeline import _random_variables

    cfg = Config(model=ModelConfig(num_layers=18, image_size=(64, 48),
                                   heatmap_size=(16, 12), dtype="float32"),
                 flow=FlowConfig(variant="flownet_c", dtype="float32",
                                 use_pallas_corr=False))
    # every posed candidate survives, so tracks pile up and the
    # propagation, the NMS and the matching all have work
    cfg = replace(cfg, track=replace(cfg.track, max_persons=3,
                                     pose_score_thre=0.0,
                                     track_oks_thre=0.1))
    jpose, jflow = j_pose_net(cfg.model), j_flow_net(cfg.flow)
    pv = _random_variables(jpose, (1, 64, 48, 3), 0)
    fv = _random_variables(jflow, (1, 64, 64, 6), 1)
    ref = (JPosePredictor(cfg, pv, model=jpose),
           JFlowPredictor(cfg, fv, model=jflow))
    port = (PosePredictor(cfg, load_pose_resnet(get_pose_net(cfg.model), pv),
                          device="cpu"),
            FlowPredictor(cfg, load_flownet(get_flow_net(cfg.flow), fv),
                          device="cpu"))
    return cfg, ref, port


def _sequence(f=6):
    """Textured 60x64 float frames; two persons moving 1 px a frame, the
    second one missed at frame 3."""
    rng = np.random.default_rng(38)
    base = rng.uniform(0, 255, (60, 64, 3))
    frames = [np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
              .astype(np.float32) for _ in range(f)]
    dets = []
    for t in range(f):
        boxes = np.array([[8 + t, 10, 20, 30], [30, 12 + t, 18, 28]],
                         np.float32)
        scores = np.array([0.9, 0.8], np.float32)
        n = 1 if t == 3 else 2
        dets.append((boxes[:n], scores[:n]))
    return frames, dets


def test_predictors_match_reference(predictors):
    """One frame's boxes through PosePredictor (joints 1e-3 px, maxvals and
    scores 1e-5 relative) and one pair through FlowPredictor (1e-3 px of
    flow of order 1)."""
    _, (jpose, jflow), (pose, flow) = predictors
    frames, dets = _sequence()
    boxes, scores = dets[0]
    want = [np.asarray(x) for x in jpose(frames[0], boxes, scores)]
    got = pose(frames[0], boxes, scores)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-9)
    assert [x.shape for x in pose(frames[0], boxes[:0], scores[:0])] == [
        (0, 17, 2), (0, 17), (0,)]
    fl = flow(frames[0], frames[1])
    assert isinstance(fl, torch.Tensor) and fl.shape == (60, 64, 2)
    np.testing.assert_allclose(N(fl), np.asarray(jflow(frames[0], frames[1])),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("variant", ["flow", "keyframe_2", "flow_free"])
def test_flow_tracker_matches_reference(predictors, variant):
    """FlowTracker.track_sequence over 6 frames with the port's predictors
    against the reference's: the same tracks in the same order with the
    same ids every frame; joints within 1e-3 px, maxvals and scores 1e-5
    relative. ``keyframe_2`` consumes detections on even frames only;
    ``flow_free`` matches unpropagated poses."""
    from flowtrack_tpu.tracking import FlowTracker as JFlowTracker
    from flowtrack_tpu_torch.tracking import FlowTracker

    cfg, (jpose, jflow), (pose, flow) = predictors
    if variant == "keyframe_2":
        cfg = replace(cfg, track=replace(cfg.track, keyframe_interval=2))
    with_flow = variant != "flow_free"
    frames, dets = _sequence()
    want = JFlowTracker(cfg, jpose, jflow if with_flow else None
                        ).track_sequence(frames, dets)
    got = FlowTracker(cfg, pose, flow if with_flow else None, device="cpu"
                      ).track_sequence(frames, dets)
    assert [len(x) for x in want][-1] >= 2
    for t, (g, w) in enumerate(zip(got, want)):
        assert [x.track_id for x in g] == [x.track_id for x in w], t
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.joints, b.joints, atol=1e-3, rtol=0)
            np.testing.assert_allclose(a.maxvals, b.maxvals, rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(a.score, b.score, rtol=1e-5)
            assert a.last_frame == b.last_frame == t
    got_json = ttracker.tracks_to_posetrack_json(got, range(100, 106))
    want_json = jtracker.tracks_to_posetrack_json(want, range(100, 106))
    assert [(a["image_id"], a["track_id"]) for a in got_json] == \
        [(a["image_id"], a["track_id"]) for a in want_json]
    for a, b in zip(got_json, want_json):
        np.testing.assert_allclose(a["keypoints"], b["keypoints"], atol=1e-3)


def test_tracks_to_posetrack_json_equal():
    """The serialization of the same tracks is equal, key for key."""
    rng = np.random.default_rng(39)
    per_frame = [[ttracker.Track(i + t, rng.uniform(0, 99, (17, 2)),
                                 rng.uniform(0, 1, 17), 0.5 + 0.1 * i, t)
                  for i in range(t + 1)] for t in range(3)]
    ref_frames = [[jtracker.Track(x.track_id, x.joints, x.maxvals, x.score,
                                  x.last_frame) for x in fr]
                  for fr in per_frame]
    assert ttracker.tracks_to_posetrack_json(per_frame, [7, 8, 9]) == \
        jtracker.tracks_to_posetrack_json(ref_frames, [7, 8, 9])
