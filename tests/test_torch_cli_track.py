"""The port's ``tools/track`` CLI against the JAX package's ``tools/track.py``
on the CPU: the same PoseTrack fixture, the same ``.npz`` weights (R18 at
64x64, FlowNetS or FlowNetC), the same arguments plus ``--device cpu``.
The track ids, the counts and the structure of tracks.json are equal,
joints within 1e-3 px, mAP and MOTA within 1e-6, the evaluators' integer
counts equal. The port's clip engine gives the stream engine's stats, and
``--device cuda`` without a card raises.

Each reference run (its jit compiles dominate) happens once per module.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.data import posetrack as ref_posetrack
from flowtrack_tpu.engine.checkpoint import save_npz_variables as ref_save_npz
from flowtrack_tpu.eval import posetrack_eval as ref_pt_eval
from flowtrack_tpu.models.flownet import get_flow_net as ref_get_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_get_pose_net
from flowtrack_tpu_torch.tools import track
from tests.fixtures import make_posetrack_fixture
from tools import track as ref_track

OPTS = ["model.num_layers=18", "model.image_size=64,64",
        "model.heatmap_size=16,16", "model.dtype=float32",
        "flow.dtype=float32", "track.pose_score_thre=0.0"]
JOINT_TOL = 1e-3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_track_cli.py's setup: the fixture (1 video of 3 frames, 2
    persons) and the reference's initialised R18 and FlowNetS, with a
    FlowNetC beside them, as .npz trees."""
    tmp = tmp_path_factory.mktemp("track_cli")
    root, _ = make_posetrack_fixture(tmp / "pt", n_videos=1, n_frames=3)
    pose = ref_get_pose_net(ref_config.ModelConfig(
        num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32"))
    x = jnp.zeros((1, 64, 64, 3))
    ref_save_npz(str(tmp / "pose.npz"), jax.jit(
        pose.init, static_argnames="train")(jax.random.PRNGKey(0), x,
                                            train=False))
    for variant, key in (("flownet_s", 1), ("flownet_c", 2)):
        flow = ref_get_flow_net(ref_config.FlowConfig(variant=variant,
                                                      dtype="float32"))
        ref_save_npz(str(tmp / f"{variant}.npz"), jax.jit(
            flow.init, static_argnames="train")(
                jax.random.PRNGKey(key), jnp.zeros((1, 64, 64, 6)),
                train=False))
    return tmp, root


def args_for(tmp, root, out, variant, *extra):
    return ["--pose-weights", str(tmp / "pose.npz"),
            "--flow-weights", str(tmp / f"{variant}.npz"),
            "--out", str(tmp / out), *extra, *OPTS,
            f"flow.variant={variant}", f"data.root={root}",
            "data.test_set=val"]


def run(main, argv, monkeypatch=None):
    """Run a CLI's main; -> (its last printed json line, tracks.json's
    annotations)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["track.py", *argv])
            main()
    out = argv[argv.index("--out") + 1]
    with open(f"{out}/tracks.json") as f:
        anns = json.load(f)["annotations"]
    return json.loads(buf.getvalue().strip().splitlines()[-1]), anns


def run_reference(argv):
    mp = pytest.MonkeyPatch()
    try:
        # --compile-cache= keeps the reference's XLA cache off
        return run(ref_track.main, ["--compile-cache=", *argv], mp)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ref_stream(setup):
    tmp, root = setup
    return run_reference(args_for(tmp, root, "ref_s", "flownet_s"))


@pytest.fixture(scope="module")
def port_stream(setup):
    tmp, root = setup
    return run(track.main, args_for(tmp, root, "port_s", "flownet_s",
                                    "--device", "cpu"))


def assert_same_tracks(got, want):
    """Stats within 1e-6 (counts equal); tracks.json: the same annotations
    in the same order, ids equal, keypoints and scores within 1e-3."""
    stats, anns = got
    ref_stats, ref_anns = want
    assert stats.keys() == ref_stats.keys()
    for k, v in ref_stats.items():
        if isinstance(v, int):
            assert stats[k] == v, k
        else:
            assert stats[k] == pytest.approx(v, abs=1e-6), k
    assert len(anns) == len(ref_anns) > 0
    for a, b in zip(anns, ref_anns):
        assert a.keys() == b.keys()
        for key in ("image_id", "track_id", "category_id"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["keypoints"], b["keypoints"], rtol=0,
                                   atol=JOINT_TOL)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0,
                                   atol=JOINT_TOL)
        assert a["score"] == pytest.approx(b["score"], abs=JOINT_TOL)


def test_track_stream_matches_reference(port_stream, ref_stream):
    assert_same_tracks(port_stream, ref_stream)
    stats, _ = port_stream
    assert {"mAP", "MOTA", "num_switches", "num_misses", "num_fps"} <= \
        set(stats)


def test_track_clip_engine_matches_reference(setup):
    """--engine clip over 2-frame clips (the cross-clip seed at each
    one-frame overlap), against the reference's clip engine."""
    tmp, root = setup
    extra = ("--engine", "clip", "--clip-len", "2")
    want = run_reference(args_for(tmp, root, "ref_c", "flownet_s", *extra))
    got = run(track.main, args_for(tmp, root, "port_c", "flownet_s",
                                   *extra, "--device", "cpu"))
    assert_same_tracks(got, want)


def test_track_flownet_c_matches_reference(setup):
    """The stream engine with FlowNetC (the correlation's plain version on
    the CPU), against the reference."""
    tmp, root = setup
    want = run_reference(args_for(tmp, root, "ref_fc", "flownet_c"))
    got = run(track.main, args_for(tmp, root, "port_fc", "flownet_c",
                                   "--device", "cpu"))
    assert_same_tracks(got, want)


def test_port_clip_engine_matches_port_stream(setup, port_stream):
    """As tests/test_track_cli.py holds the reference: the port's two
    engines give the same stats and the same number of poses."""
    tmp, root = setup
    clip = run(track.main, args_for(tmp, root, "port_c2", "flownet_s",
                                    "--engine", "clip", "--clip-len", "2",
                                    "--device", "cpu"))
    stream, s_anns = port_stream
    assert len(clip[1]) == len(s_anns)
    for k in ("num_misses", "num_switches", "num_fps"):
        assert clip[0][k] == stream[k], k
    assert clip[0]["MOTA"] == pytest.approx(stream["MOTA"], abs=1e-9)
    assert clip[0]["mAP"] == pytest.approx(stream["mAP"], abs=1e-6)


def test_track_mot_backend_matches_reference_evaluator(setup, ref_stream):
    """--eval-backend mot prints what the reference's accumulator backend
    gives on the reference's own tracks.json."""
    tmp, root = setup
    got, _ = run(track.main, args_for(tmp, root, "port_m", "flownet_s",
                                      "--eval-backend", "mot",
                                      "--device", "cpu"))
    _, anns = ref_stream
    ds = ref_posetrack.PoseTrackDataset(
        ref_config.Config(test=ref_config.TestConfig(use_gt_bbox=True)),
        str(root), "val", False)
    frames = sorted(ds.sequences().items())[0][1]
    preds = [[{"track_id": a["track_id"],
               "keypoints": np.asarray(a["keypoints"]).reshape(-1, 3),
               "score": a["score"]}
              for a in anns if a["image_id"] == i] for i in frames]
    gts = [ds.frame_annotations(i) for i in frames]
    want = ref_pt_eval.evaluate_posetrack_mot([gts], [preds])
    assert "fp_unlabeled" in got
    for k, v in got.items():
        assert v == pytest.approx(want[k], abs=1e-6), k


def test_track_on_cuda_raises_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    tmp, root = setup
    for engine in ("stream", "clip"):
        with pytest.raises(RuntimeError, match="CUDA"):
            track.main(args_for(tmp, root, "port_x", "flownet_s",
                                "--engine", engine))
